"""The port's profiler hooks on the CPU: ``profile_to`` records a
``torch.profiler`` profile of a region into a directory as a Chrome trace,
in which a ``trace`` span and the region's torch operations are named;
``trace`` alone, with no profile taken, only runs its body."""

import json
import os

import torch

from blueice_tpu_torch.utils import profile_to, trace
from blueice_tpu_torch.parallel import BinnedToyStudy
from blueice_tpu_torch.examples.xenon_like import build_likelihood

from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)


def test_profile_to_writes_a_trace_naming_the_span(tmp_path):
    log_dir = str(tmp_path / 'profile')
    with profile_to(log_dir) as prof:
        with trace('outer span'):
            torch.ones(64, dtype=torch.float64).cumsum(0)
    assert os.path.dirname(prof.trace_path) == log_dir
    assert os.listdir(log_dir) == [os.path.basename(prof.trace_path)]
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name') for e in events}
    assert 'outer span' in names
    assert 'aten::cumsum' in names


def test_trace_spans_a_profile_of_the_study(tmp_path):
    """A small XENON-style profile inside ``profile_to`` and ``trace``:
    the same result as without them, and the span in the trace."""
    lf = build_likelihood('binned', n_cs1_bins=4, n_cs2_bins=3,
                          livetime_days=5.0)
    study = BinnedToyStudy(lf, device='cpu', max_iter=30)
    ref = study.profile_ts(0, 2, 'wimp_rate_multiplier', 1.0)
    with profile_to(str(tmp_path)) as prof:
        with trace('xenon profile'):
            out = study.profile_ts(0, 2, 'wimp_rate_multiplier', 1.0)
    assert torch.equal(torch.as_tensor(out[0]), torch.as_tensor(ref[0]))
    with open(prof.trace_path) as f:
        assert 'xenon profile' in {e.get('name')
                                   for e in json.load(f)['traceEvents']}
    with trace('no profiler'):
        assert float(torch.ones(3).sum()) == 3.0
