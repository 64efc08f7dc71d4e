"""host_ms_per_iter: the mean host time of one Newton iteration in the traced
window, ms: each ``newton.iter`` span of the program less the time inside it
in the program's ``sync`` spans and the benchmark's own ``bench.record``
spans (``benchmark/harness/program_trace.py``)."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    return None if run.trace is None else TRACER.host_ms_per_iter(run)
