"""sync_wait_pct: 100 x the host's time in calls that block on the card in the
traced window (the program's ``sync`` spans: lane selection's two ``nonzero``
calls an iteration, each batched Cholesky solve, the write-back's host
scalars, each fit's tables, the gathers' and refines' copies) over its
``study.profile`` spans' time (``benchmark/harness/program_trace.py``)."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    return None if run.trace is None else TRACER.sync_wait_pct()
