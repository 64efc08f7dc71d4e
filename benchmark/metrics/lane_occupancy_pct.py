"""lane_occupancy_pct: 100 x the lanes the Newton loop stepped over the lanes
it could have (iterations x lanes started), summed over the traced window's
fits: the program's ``newton.lanes_stepped``, ``newton.iterations`` and
``newton.lanes_started`` counts of each ``newton.fit`` span
(``benchmark/harness/program_trace.py``)."""

from benchmark.harness.program_trace import TRACER

INTERPOSE = TRACER


def read(run):
    return None if run.trace is None else TRACER.lane_occupancy_pct()
