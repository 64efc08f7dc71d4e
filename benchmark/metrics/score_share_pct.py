"""score_share_pct: 100 x the traced window's wall time inside the study's
event scoring and centring (the program's ``study.score`` and
``study.center`` spans, their union) over ``window_s``
(``benchmark/harness/program_trace.py``). None where the program has no
such span."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER
#: The spans of the event scoring
SPANS = ('study.score', 'study.center')


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    inside = sorted((s.start_ns, s.end_ns) for s in TRACER.spans
                    if s.name in SPANS)
    if not inside:
        return None
    ns, end = 0, None
    for a, b in inside:
        if end is not None and a < end:
            a = end
        if b > a:
            ns += b - a
        end = b if end is None else max(end, b)
    return 100.0 * ns / 1e9 / run.trace.window_s
