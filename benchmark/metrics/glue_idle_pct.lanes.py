"""glue_idle_pct.lanes: 100 x the card's idle time in the traced window that
began inside the self time of the fit, its iterations, lane selection, state
write-back, value and vgh calls (``newton.fit``, ``.iter``, ``.select``,
``.scatter``, ``.value``, ``.vgh``) or their ``sync``, over ``window_s``:
the gaps labelled by the program's spans merged with the benchmark's
(``benchmark/harness/program_trace.py``). None without a card."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    return TRACER.glue_idle_pct(run, 'lanes')
