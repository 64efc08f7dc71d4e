"""graph_kernel_share_pct: 100 x the parameter-graph calls of the traced
window that ran as the graph's CUDA kernels, over all its graph calls: the
program's ``graph.kernel`` over ``graph.kernel`` + ``graph.torch`` counters
(``benchmark/harness/program_trace.py``). None where the program counts
neither."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    if run.trace is None:
        return None
    kernel = TRACER.counters.get('graph.kernel', 0)
    calls = kernel + TRACER.counters.get('graph.torch', 0)
    return 100.0 * kernel / calls if calls else None
