"""glue_idle_pct.study: 100 x the card's idle time in the traced window that
began inside the self time of the study's spans (``study.profile``,
``.stage``, ``.gather``, ``.refine``) or their ``sync``, over ``window_s``:
the gaps labelled by the program's spans merged with the benchmark's
(``benchmark/harness/program_trace.py``). None without a card."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    return TRACER.glue_idle_pct(run, 'study')
