"""The program's own spans and counters in a traced run: the port's
``blueice_tpu_torch.utils.progress`` recorder switched on around the traced
window, and the readings the per-layer metrics take from it.

The port stamps its spans with ``time.time_ns()``, the clock
``torch.profiler`` stamps its host events with, so they merge with the
benchmark's own spans (:class:`~.trace.Records` ``spans``), and each idle
stretch of the card is labelled by the innermost span open when it began
(:func:`~.trace.busy_and_gaps`, unchanged). A program span's label is its
part of the host glue and its name, ``<part>/<name>``: ``graph`` (the
parameter graph), ``step`` (the Newton step, its solves and the polish
step), ``lanes`` (the fit, its iterations, lane selection, state
write-back, value and vgh calls) or ``study`` (the study's calls, stages,
gathers and refines); a ``sync`` span takes its parent's part.

A program without the recorder (no ``set_tracing`` or ``take``) records
nothing, and every reading is None."""

import bisect
import collections
import importlib

from . import trace

__all__ = ['PARTS', 'ProgramTrace', 'TRACER']

#: A program span's name -> its part of the host glue (``study.*`` are
#: ``study``; ``sync`` is its parent's)
PARTS = {'graph.cells': 'graph', 'graph.values': 'graph',
         'graph.chain': 'graph', 'newton.step': 'step',
         'newton.solve': 'step', 'newton.polish': 'step',
         'newton.fit': 'lanes', 'newton.iter': 'lanes',
         'newton.select': 'lanes', 'newton.scatter': 'lanes',
         'newton.value': 'lanes', 'newton.vgh': 'lanes'}


def part_of(spans, i):
    """The part of span ``i`` of the program's ``spans`` (None: none)."""
    s = spans[i]
    if s.name == 'sync':
        return None if s.parent is None else part_of(spans, s.parent)
    if s.name.startswith('study.'):
        return 'study'
    return PARTS.get(s.name)


def _union(intervals):
    """The union of [(start, end)] as sorted disjoint [start, end]."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(union, starts, a, b):
    """The length of :func:`_union`'s ``union`` (``starts`` its starts)
    inside [a, b]."""
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    n = 0
    while k < len(union) and union[k][0] < b:
        n += max(0, min(b, union[k][1]) - max(a, union[k][0]))
        k += 1
    return n


class ProgramTrace:
    """An interposer (``name``, :meth:`install`, :meth:`uninstall`,
    :attr:`recording`) that records the program's spans and counters while
    :attr:`recording`. Every reader of these metrics declares the one
    :data:`TRACER`, so installing and recording again are no-ops."""

    name = 'program_trace'

    def __init__(self):
        self._progress = None
        self._installed = self._recording = False
        self.spans, self.counters = [], {}
        self._idle = (None, None)

    def install(self):
        if self._installed:
            return
        self._installed = True
        progress = importlib.import_module('blueice_tpu_torch.utils.progress')
        self._progress = (progress if hasattr(progress, 'set_tracing')
                          and hasattr(progress, 'take') else None)

    def uninstall(self):
        if self._installed:
            self.recording = False
            self._installed = False

    @property
    def recording(self):
        return self._recording

    @recording.setter
    def recording(self, on):
        on = bool(on)
        if on == self._recording:
            return
        self._recording = on
        if self._progress is None:
            return
        if on:
            self._progress.take()
            self.spans, self.counters = [], {}
            self._idle = (None, None)
            self._progress.set_tracing(True)
        else:
            self._progress.set_tracing(False)
            got = self._progress.take()
            self.spans, self.counters = got['spans'], got['counters']

    def idle_s(self, run):
        """{label: idle seconds of the card} over the traced window, every
        gap labelled with the benchmark's and the program's spans merged
        (the harness's bookkeeping left out, as ``window_s`` leaves it);
        None without a card's timeline or the program's spans."""
        rec = run.trace
        if rec is None or rec.busy_s <= 0 or not self.spans:
            return None
        if self._idle[0] is rec:
            return self._idle[1]
        window = next((s[1], s[2]) for s in rec.spans
                      if s[0] == 'bench.window')
        merged = list(rec.spans) + [
            ('%s/%s' % (part_of(self.spans, i), s.name), s.start_ns, s.end_ns)
            for i, s in enumerate(self.spans)]
        idle = collections.Counter()
        for label, seconds in trace.busy_and_gaps(merged, rec.ops, window)[1]:
            if label != 'harness_record':
                idle[label] += seconds
        self._idle = (rec, dict(idle))
        return self._idle[1]

    def glue_idle_pct(self, run, part):
        """100 x the card's idle time begun inside a program span of
        ``part`` (in its self time or its ``sync``) over ``window_s``."""
        idle = self.idle_s(run)
        if idle is None or run.trace.window_s <= 0:
            return None
        inside = sum(s for label, s in idle.items()
                     if label.startswith(part + '/'))
        return 100.0 * inside / run.trace.window_s

    def _ns(self, name):
        return [(i, s.end_ns - s.start_ns) for i, s in enumerate(self.spans)
                if s.name == name]

    def host_ms_per_iter(self, run):
        """The mean ``newton.iter`` span less the time inside it that the
        host waited on the card (the program's ``sync`` spans) or kept the
        harness's books (the benchmark's ``bench.record`` spans), in ms;
        None without one."""
        iters = [s for s in self.spans if s.name == 'newton.iter']
        if not iters or run.trace is None:
            return None
        out = _union([(s.start_ns, s.end_ns) for s in self.spans
                      if s.name == 'sync']
                     + [(s[1], s[2]) for s in run.trace.spans
                        if s[0] == 'bench.record'])
        starts = [a for a, _ in out]
        ns = 0
        for s in iters:
            ns += s.end_ns - s.start_ns - _inside(out, starts, s.start_ns,
                                                   s.end_ns)
        return ns / len(iters) / 1e6

    def sync_wait_pct(self):
        """100 x the ``sync`` spans' time over the ``study.profile`` spans'
        time."""
        calls = sum(ns for _, ns in self._ns('study.profile'))
        if calls <= 0:
            return None
        waits = sum(ns for i, ns in self._ns('sync')
                    if self.spans[self.spans[i].call].name == 'study.profile')
        return 100.0 * waits / calls

    def lane_occupancy_pct(self):
        """100 x the lanes stepped over iterations x lanes started, summed
        over the window's fits (``newton.fit`` spans' counts)."""
        stepped = offered = 0
        for s in self.spans:
            if s.name == 'newton.fit':
                stepped += s.counts.get('newton.lanes_stepped', 0)
                offered += (s.counts.get('newton.iterations', 0)
                            * s.counts.get('newton.lanes_started', 0))
        return 100.0 * stepped / offered if offered else None

    def refit_share_pct(self):
        """100 x the toys refitted by the straggler pass over the toys that
        entered the window's study calls."""
        toys = self.counters.get('study.toys', 0)
        if not toys:
            return None
        return 100.0 * self.counters.get('study.refit_toys', 0) / toys


#: The one recorder every reader of the program's spans declares
TRACER = ProgramTrace()
