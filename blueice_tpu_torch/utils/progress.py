"""Progress reporting for long host loops, profiler hooks, and the port's
own spans and counters.

Role parity with the reference's tqdm instrumentation on every long host loop
(reference: blueice/likelihood.py:191-208, parallel.py:55-66,
pdf_morphers.py:173) — tqdm is used when importable, with a lightweight stderr
ticker fallback, and everything can be silenced globally. Device work is
observed with ``torch.profiler``: :func:`trace` names a region of the trace,
:func:`profile_to` records one (host and, where there is a card, CUDA
activity) into a directory as a Chrome trace.

The port marks its study, Newton-loop and parameter-graph steps with
:func:`trace` and counts their work with :func:`count`. With
:func:`set_tracing` on, each span is kept in memory as (name, start and end
in ``time.time_ns()``, the clock ``torch.profiler`` stamps its host events
with, parent, call id, attributes, the counts made inside it), and
:func:`take` hands the spans and counters over. A span or counter reads no
device value and waits for nothing.
"""

import collections
import contextlib
import functools
import os
import sys
import time

__all__ = ['progress_iter', 'set_progress', 'trace', 'traced', 'profile_to',
           'count', 'set_tracing', 'take', 'Span']

_ENABLED = True


def set_progress(enabled):
    """Globally enable/disable host-side progress reporting."""
    global _ENABLED
    _ENABLED = bool(enabled)


def progress_iter(iterable, desc=None, total=None):
    """Iterate with progress feedback: tqdm when available, otherwise a plain
    stderr ticker (1 line/s max). Silent when disabled."""
    if not _ENABLED:
        yield from iterable
        return
    # Import in its OWN try: wrapping the yield-from would also catch an
    # ImportError raised inside the CALLER's loop body (thrown into the
    # generator), silently swallowing it and re-iterating the sequence
    # through the fallback ticker below.
    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = None
    if tqdm is not None:
        yield from tqdm(iterable, desc=desc, total=total)
        return

    if total is None:
        try:
            total = len(iterable)
        except TypeError:
            total = None
    start = last = time.time()
    for i, item in enumerate(iterable):
        yield item
        now = time.time()
        if now - last > 1.0:
            last = now
            msg = ("%s: %d/%s (%.1fs)"
                   % (desc or 'progress', i + 1, total or '?', now - start))
            print(msg, file=sys.stderr, flush=True)



#: One recorded span: ``parent`` is the index of the span it opened in (None
#: for a root), ``call`` the index of its root span, ``counts`` what
#: :func:`count` added while it was open
Span = collections.namedtuple(
    'Span', 'name start_ns end_ns parent call attrs counts')

_TRACING = False     # set_tracing: spans and counts are recorded
_PROFILED = 0        # open profile_to regions: spans reach the profiler
_LIVE = False        # either of the two: trace() makes a span
_SPANS = []          # rows [name, start, end, parent, call, attrs, counts, i]
_OPEN = []           # the rows of the recorded spans open now, outermost first
_COUNTERS = {}
_OFF = contextlib.nullcontext()


def _relive():
    global _LIVE
    _LIVE = _TRACING or _PROFILED > 0


def set_tracing(on):
    """Switch the recording of the port's spans and counters on or off."""
    global _TRACING
    _TRACING = bool(on)
    _relive()


def take():
    """``{'spans': [Span], 'counters': {name: int}}`` recorded since the last
    call, in the order the spans opened; clears them. Spans still open are
    dropped."""
    spans = [Span(*row[:7]) for row in _SPANS]
    counters = dict(_COUNTERS)
    _SPANS.clear()
    _OPEN.clear()
    _COUNTERS.clear()
    return {'spans': spans, 'counters': counters}


def count(name, n=1):
    """Add the host integer ``n`` to counter ``name``, and to the counts of
    every span open now, while tracing is on."""
    if _TRACING:
        n = int(n)
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n
        for row in _OPEN:
            row[6][name] = row[6].get(name, 0) + n


class _Span:
    """A span while it is open: recorded while tracing is on, and a
    ``record_function`` of its name inside :func:`profile_to`."""

    __slots__ = ('name', 'attrs', 'row', 'region')

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs
        self.row = self.region = None

    def __enter__(self):
        if _PROFILED:
            # the profiler's region first, so that its cost stays out
            import torch
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        if _TRACING:
            parent = _OPEN[-1] if _OPEN else None
            i = len(_SPANS)
            self.row = [self.name, time.time_ns(), None,
                        None if parent is None else parent[7],
                        i if parent is None else parent[4], self.attrs, {}, i]
            _SPANS.append(self.row)
            _OPEN.append(self.row)
        return self

    def __exit__(self, *exc):
        if self.row is not None:
            self.row[2] = time.time_ns()
            if _OPEN and _OPEN[-1] is self.row:
                _OPEN.pop()
        if self.region is not None:
            self.region.__exit__(*exc)
        return False


def trace(name, **attrs):
    """Name a region: a :class:`Span` while tracing is on
    (:func:`set_tracing`), and a ``torch.profiler.record_function`` span of
    that name inside :func:`profile_to`. Other profilers do not see it: a
    ``record_function`` under CUDA activity also leaves an annotation on
    the device's timeline, which a reduction of the trace can take for
    device work. Otherwise a shared no-op context: one flag check, 0.27-0.50
    us a ``with`` on the host of an H100 machine, where a
    ``record_function`` costs 8.4-9.7 us with no profiler running."""
    if not _LIVE:
        return _OFF
    return _Span(name, attrs)


def traced(name):
    """Decorator: each call of the function inside ``trace(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _LIVE:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return spanned
    return wrap


@contextlib.contextmanager
def profile_to(log_dir):
    """Record a ``torch.profiler`` profile of the region, CPU activity and
    CUDA activity when a card is present, with every :func:`trace` span in
    it, and write it into ``log_dir`` as a Chrome trace (open it in
    chrome://tracing or Perfetto)::

        with profile_to('prof'):
            study.profile_ts(0, 512, 'wimp_rate_multiplier', 1.0)

    Yields the profiler, whose ``trace_path`` is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    global _PROFILED
    _PROFILED += 1
    _relive()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        _PROFILED -= 1
        _relive()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, 'trace_%d_%d.json' % (os.getpid(), time.time_ns()))
    prof.export_chrome_trace(prof.trace_path)
