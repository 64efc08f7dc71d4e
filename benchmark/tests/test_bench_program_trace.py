"""The program's spans and counters as per-layer metrics: the recorder is on
only in the traced window, its four host readings come out on the CPU, and
the card's idle split stays out of the line where there is no card."""

import json

from benchmark.harness import runner
from benchmark.harness.program_trace import TRACER

#: The metrics read from the program's spans and counters
HOST = {'host_ms_per_iter', 'sync_wait_pct', 'lane_occupancy_pct',
        'refit_share_pct'}
IDLE = {'glue_idle_pct.graph', 'glue_idle_pct.step', 'glue_idle_pct.lanes',
        'glue_idle_pct.study'}


def report_in_tiny(checkout):
    """The checkout's tiny cell added to the workloads of the metrics that
    read the program's spans."""
    path = checkout / 'BENCHMARK.json'
    spec = json.loads(path.read_text())
    for m in spec['per_layer']:
        if m['name'] in HOST | IDLE:
            m['workloads'].append('tiny.tiny_mix')
    path.write_text(json.dumps(spec))


def test_traced_run_reads_the_programs_spans(checkout):
    from blueice_tpu_torch.utils import progress
    report_in_tiny(checkout)
    result, lines = runner.run_cell('tiny.tiny_mix', 2 ** 33 + 21, 0.5, True,
                                    device='cpu', root=str(checkout))
    assert result['correct'], lines
    metrics = result['metrics']
    assert HOST <= set(metrics)
    assert not IDLE & set(metrics)
    assert metrics['host_ms_per_iter']['value'] > 0
    assert metrics['host_ms_per_iter']['unit'] == 'ms'
    assert 0 < metrics['sync_wait_pct']['value'] < 100
    assert 0 < metrics['lane_occupancy_pct']['value'] <= 100
    assert 0 <= metrics['refit_share_pct']['value'] <= 100
    # the window's one call, and tracing off again after it
    assert [s.name for s in TRACER.spans if s.parent is None] == [
        'study.profile']
    assert TRACER.counters['study.toys'] == 12
    assert not progress._TRACING and not TRACER.recording


def test_untraced_run_records_nothing(checkout):
    from blueice_tpu_torch.utils import progress
    report_in_tiny(checkout)
    progress.take()
    result, lines = runner.run_cell('tiny.tiny_mix', 2 ** 32 + 9, 0.3, False,
                                    device='cpu', root=str(checkout))
    assert result['correct'], lines
    assert set(result['metrics']) == {'toys_per_s', 'setup_s'}
    assert progress.take() == {'spans': [], 'counters': {}}


def test_installing_twice_is_one_install():
    before = TRACER.recording
    TRACER.install()
    TRACER.install()
    TRACER.recording = True
    TRACER.recording = True
    TRACER.uninstall()
    TRACER.uninstall()
    assert not TRACER.recording and not before


def test_idle_gaps_take_the_innermost_program_span():
    """A window of 100 ns: the card busy 0-12, 26-28 and 38-39; the gaps
    begin in the bare ``study.profile`` (14 ns), in lane selection's
    ``sync`` (10 ns) and in ``graph.cells`` (61 ns)."""
    from benchmark.harness.program_trace import ProgramTrace
    from benchmark.harness.trace import Records
    from blueice_tpu_torch.utils.progress import Span
    spans = [Span('study.profile', 11, 89, None, 0, {}, {}),
             Span('newton.fit', 20, 80, 0, 0, {}, {}),
             Span('newton.iter', 20, 50, 1, 0, {}, {}),
             Span('newton.select', 20, 30, 2, 0, {}, {}),
             Span('sync', 25, 30, 3, 0, {}, {}),
             Span('graph.cells', 35, 40, 2, 0, {}, {})]
    ops = [('k', 0.0, 'newton_loop_glue', None, 'kernel', a, b)
           for a, b in ((0, 12), (26, 28), (38, 39))]
    rec = Records(100e-9, 15e-9, ops, [],
                  [('bench.window', 0, 100), ('bench.study', 10, 90),
                   ('bench.record', 42, 46)])
    tracer = ProgramTrace()
    tracer.spans = spans

    class Run:
        trace = rec
    idle = tracer.idle_s(Run)
    assert {k: round(v * 1e9) for k, v in idle.items()} == {
        'study/study.profile': 14, 'lanes/sync': 10, 'graph/graph.cells': 61}
    assert round(tracer.glue_idle_pct(Run, 'graph'), 6) == 61.0
    assert round(tracer.glue_idle_pct(Run, 'lanes'), 6) == 10.0
    assert round(tracer.glue_idle_pct(Run, 'study'), 6) == 14.0
    assert tracer.glue_idle_pct(Run, 'step') == 0.0
    # 30 ns of the one iteration, 5 of them waiting on the card and 4
    # keeping the harness's books
    assert tracer.host_ms_per_iter(Run) == 21e-6
    assert round(tracer.sync_wait_pct(), 6) == round(500 / 78, 6)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """The readers on a program that has no ``set_tracing``: no error, and
    every reading None."""
    from benchmark.harness.program_trace import ProgramTrace
    from blueice_tpu_torch.utils import progress
    monkeypatch.delattr(progress, 'set_tracing')
    tracer = ProgramTrace()
    tracer.install()
    tracer.recording = True
    tracer.recording = False
    tracer.uninstall()

    class Run:
        trace = None
    assert tracer.glue_idle_pct(Run, 'graph') is None
    assert (tracer.host_ms_per_iter(Run), tracer.sync_wait_pct(),
            tracer.lane_occupancy_pct(), tracer.refit_share_pct()) == (
                None, None, None, None)
