"""step_kernel_share_pct: 100 x the Newton steps of the traced window that
ran as the step's CUDA kernels, over all its Newton steps: the program's
``newton.step_kernel`` over ``newton.step_kernel`` + ``newton.step_torch``
counters (``benchmark/harness/program_trace.py``). None where the program
counts neither."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    if run.trace is None:
        return None
    kernel = TRACER.counters.get('newton.step_kernel', 0)
    steps = kernel + TRACER.counters.get('newton.step_torch', 0)
    return 100.0 * kernel / steps if steps else None
