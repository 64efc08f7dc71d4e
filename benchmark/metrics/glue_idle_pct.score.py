"""glue_idle_pct.score: 100 x the card's idle time in the traced window that
began with the host innermost in the study's event scoring or centring
(``study.score``, ``study.center``), over ``window_s``: the gaps labelled by
the program's spans merged with the benchmark's
(``benchmark/harness/program_trace.py``, labels ``study/study.score`` and
``study/study.center``). None without a card, or where the program has no
such span."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER
#: The spans of the event scoring, and the gap labels they give
SPANS = ('study.score', 'study.center')
LABELS = tuple('study/' + s for s in SPANS)


def read(run):
    if not any(s.name in SPANS for s in TRACER.spans):
        return None
    idle = TRACER.idle_s(run)
    if idle is None or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(idle.get(label, 0.0)
                       for label in LABELS) / run.trace.window_s
