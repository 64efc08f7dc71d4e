"""refit_share_pct: 100 x the toys the straggler pass refitted in the traced
window over the toys that entered its study calls: the program's
``study.refit_toys`` over ``study.toys``
(``benchmark/harness/program_trace.py``)."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    return None if run.trace is None else TRACER.refit_share_pct()
