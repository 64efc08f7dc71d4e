"""The check fails what it has to fail.

* A whole run with its timed path broken underneath (the harness's look for
  a chip skipped, everything else as a run does it) comes out not correct,
  once for each fault a profile call can have (``harness/faults.py``):
  fits that return their start unchanged, on every toy or on every other
  one; half of the batch left out, the rest's results standing in for it;
  an answer altered where it is produced.
* The lower-precision control (the reference with its anchor payloads in
  bfloat16, computing in float32) put in the program's place fails the
  configurations' limits, on toys of the cells' own batch."""

import pytest
import torch

from benchmark.harness import check, ensemble, faults, runner


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
def test_broken_path_is_not_correct(checkout, fault):
    # a window of one call (``--seconds 0``): 8 of its 12 toys are judged,
    # so the half left out, or the toys left unfitted, are among them
    result, lines = runner.run_cell('tiny.tiny_mix', 2 ** 32 + 11, 0.0,
                                    False, device='cpu', root=str(checkout),
                                    study_hook=faults.FAULTS[fault])
    assert result['seconds']['calls'] == 1
    assert not result['correct'], lines


def test_half_unfitted_fails_the_fit_gap(checkout):
    """With every other toy's fits left at their start, the fits' number
    fails, and the numbers of the likelihood and of t, which the program's
    own consistent results pass, do not."""
    result, lines = runner.run_cell('tiny.tiny_mix', 2 ** 32 + 12, 0.0,
                                    False, device='cpu', root=str(checkout),
                                    study_hook=faults.half_start_unchanged)
    check_ = result['check']
    assert check_['ll_fit_gap']['value'] > check_['ll_fit_gap']['limit']
    for n in ('ll_eval_gap', 't_eval_gap'):
        assert check_[n]['value'] <= check_[n]['limit'], lines


@pytest.mark.parametrize('cell', ['xenon.ensemble', 'xenon_bb.ensemble'])
def test_control_fails_the_limits(cell):
    """Two toys drawn as the cell draws them (from a call of 64: the
    cell's own batch does not fit a test run on the CPU, nor do more of
    the reference's fits), judged as a run judges them."""
    cx = runner.prepare(cell, 'cpu')
    reference = cx.kind.reference
    traffic = dict(cx.traffic, toys_per_call=64)
    ens = ensemble.Ensemble(traffic, reference.sampler(
        cx.model, cx.model.defaults, 64, 'cpu', cx.dtype), 2 ** 31 + 3,
        'cpu')
    counts = reference.take(ens.datasets(0), [0, 1])
    control = reference.build(cx.config, 'cpu', storage=torch.bfloat16)
    ctrl = reference.profile_fits(control, counts, cx.target, cx.hypothesis)
    numbers = check.judge(reference, cx.model, counts, ctrl, cx.target,
                          cx.hypothesis)[0]
    ok, lines = check.verdict(numbers, cx.limits)
    assert not ok, lines
