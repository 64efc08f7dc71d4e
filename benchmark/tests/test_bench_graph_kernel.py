"""``graph_kernel_share_pct``: the program's ``graph.kernel`` and
``graph.torch`` counters of the traced window as the share of the parameter
graph's calls that ran as its CUDA kernels. On the CPU every call runs on
the PyTorch graph, so the share is 0; a program that counts neither reads
nothing."""

import importlib.util
import json
import os

from benchmark.harness import runner
from benchmark.harness.program_trace import TRACER

METRIC = 'graph_kernel_share_pct'


def _reader():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        'metrics', METRIC + '.py')
    spec = importlib.util.spec_from_file_location(METRIC, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Run:
    trace = object()


def test_a_cpu_traced_run_reads_no_kernel_calls(checkout):
    path = checkout / 'BENCHMARK.json'
    spec = json.loads(path.read_text())
    for m in spec['per_layer']:
        if m['name'] == METRIC:
            m['workloads'].append('tiny.tiny_mix')
    path.write_text(json.dumps(spec))
    result, lines = runner.run_cell('tiny.tiny_mix', 2 ** 33 + 77, 0.5, True,
                                    device='cpu', root=str(checkout))
    assert result['correct'], lines
    assert result['metrics'][METRIC] == {'value': 0.0, 'unit': '%'}
    assert TRACER.counters['graph.torch'] > 0
    assert 'graph.kernel' not in TRACER.counters


def test_the_share_of_kernel_calls(monkeypatch):
    read = _reader().read
    monkeypatch.setattr(TRACER, 'counters',
                        {'graph.kernel': 30, 'graph.torch': 10})
    assert read(_Run) == 75.0
    monkeypatch.setattr(TRACER, 'counters', {'graph.kernel': 7})
    assert read(_Run) == 100.0
    monkeypatch.setattr(TRACER, 'counters', {'study.toys': 12})
    assert read(_Run) is None

    class Untraced:
        trace = None
    assert read(Untraced) is None
