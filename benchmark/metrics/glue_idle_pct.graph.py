"""glue_idle_pct.graph: 100 x the card's idle time in the traced window that
began inside the parameter graph's calls (``graph.cells``, ``graph.values``,
``graph.chain``), over ``window_s``: the gaps labelled by the program's
spans merged with the benchmark's (``benchmark/harness/program_trace.py``).
None without a card."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    return TRACER.glue_idle_pct(run, 'graph')
