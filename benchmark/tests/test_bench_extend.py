"""A configuration, a traffic mix, a cell, a per-layer metric and a
likelihood kind added as new files (and entries), which the harness finds
with no existing file edited; a whole run of each new cell on the CPU,
untraced and traced."""

import hashlib
import json
import subprocess
import sys

import pytest

import events_kind
from benchmark.harness import faults, runner


@pytest.mark.parametrize('cell', ['tiny.tiny_mix', 'tiny_bb.tiny_mix'])
def test_new_cell_runs_from_files(checkout, cell):
    result, lines = runner.run_cell(cell, 2 ** 33 + 5, 0.5, False,
                                    device='cpu', root=str(checkout))
    assert result['correct'], lines
    assert result['attempted'] > 0 and result['failed'] == 0
    assert set(result['metrics']) == {'toys_per_s', 'setup_s'}
    assert list(result['check'])[:3] == ['ll_eval_gap', 't_eval_gap',
                                         'll_fit_gap']
    assert list(result)[-1] == 'check'


def test_new_metric_is_read_in_the_traced_run(checkout):
    result, lines = runner.run_cell('tiny.tiny_mix', 12345, 0.5, True,
                                    device='cpu', root=str(checkout))
    assert result['correct'], lines
    # median_t comes from the new file; the device metrics find nothing to
    # read without a card and stay out of the line
    assert 'median_t' in result['metrics']
    assert 'iters_per_fit' in result['metrics']
    assert 'device_idle_pct' not in result['metrics']
    assert result['device']['window_s'] > 0
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}


def test_same_seed_same_datasets(checkout):
    cx = runner.prepare('tiny.tiny_mix', 'cpu', root=str(checkout))
    a, b = cx.ensemble(2 ** 31 + 7), cx.ensemble(2 ** 31 + 7)
    take = cx.kind.reference.take
    assert (a.datasets(0) == b.datasets(0)).all()
    assert (take(a.datasets(1), [3, 1])
            == a.datasets(1)[[3, 1]].reshape(2, -1)).all()
    assert not (a.datasets(0) == a.datasets(1)).all()


def test_run_in_a_process_loads_no_jax(checkout):
    code = ("import sys; sys.path.insert(0, %r);"
            "from benchmark.harness import runner;"
            "r, _ = runner.run_cell('tiny.tiny_mix', 3, 0.2, False, "
            "device='cpu', root=%r);"
            "print(r['correct'], runner.forbidden_modules())"
            % (str(checkout), str(checkout)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=str(checkout))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split('\n')[-2] == 'True []'


def test_benchmark_json_keeps_the_contract_shape():
    with open(runner.ROOT + '/BENCHMARK.json') as f:
        spec = json.load(f)
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    names = [c['name'] for c in spec['workloads']]
    assert names == ['xenon.ensemble', 'xenon_bb.ensemble']
    for m in spec['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert all(w in names for w in m['workloads'])
    for c in spec['workloads']:
        cx = runner.load_cell(c['name'])
        assert cx[2]['name'] == c['config']


def _hashes(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob('*'))
            if p.is_file() and '__pycache__' not in p.parts}


@pytest.mark.parametrize('traced', [False, True], ids=['untraced', 'traced'])
def test_new_likelihood_kind_runs_from_files(checkout, traced):
    """An event-set kind (``events_kind.py``: an unbinned likelihood through
    ``UnbinnedToyStudy``) added as new files and entries: its cell runs
    correct, and no file that the checkout had is changed."""
    before = _hashes(checkout)
    before.pop('BENCHMARK.json')
    events_kind.add(checkout)
    result, lines = runner.run_cell(events_kind.CELL, 2 ** 33 + 9, 0.5,
                                    traced, device='cpu', root=str(checkout))
    assert result['correct'], lines
    assert result['attempted'] > 0 and result['failed'] == 0
    assert result['judged_toys'] == events_kind.MIX['check_toys']
    assert set(result['metrics']) == (
        {'iters_per_fit', 'median_t'} if traced
        else {'toys_per_s', 'setup_s'})
    after = _hashes(checkout)
    assert {k: after.get(k) for k in before} == before


@pytest.mark.parametrize('fault', ['half_left_out', 'answer_altered'])
def test_new_likelihood_kind_fails_a_broken_path(checkout, fault):
    events_kind.add(checkout)
    result, lines = runner.run_cell(events_kind.CELL, 2 ** 33 + 10, 0.0,
                                    False, device='cpu', root=str(checkout),
                                    study_hook=faults.FAULTS[fault])
    assert not result['correct'], lines
