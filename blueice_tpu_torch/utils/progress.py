"""Progress reporting for long host loops, and profiler hooks.

Role parity with the reference's tqdm instrumentation on every long host loop
(reference: blueice/likelihood.py:191-208, parallel.py:55-66,
pdf_morphers.py:173) — tqdm is used when importable, with a lightweight stderr
ticker fallback, and everything can be silenced globally. Device work is
observed with ``torch.profiler``: :func:`trace` names a region of the trace,
:func:`profile_to` records one (host and, where there is a card, CUDA
activity) into a directory as a Chrome trace.
"""

import contextlib
import os
import sys
import time

__all__ = ['progress_iter', 'set_progress', 'trace', 'profile_to']

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



@contextlib.contextmanager
def trace(name):
    """Name a region for the profiler (``torch.profiler.record_function``:
    a span of that name in the trace); negligible cost when no profile is
    being taken."""
    import torch
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir):
    """Record a ``torch.profiler`` profile of the region, CPU activity and
    CUDA activity when a card is present, and write it into ``log_dir`` as
    a Chrome trace (open it in chrome://tracing or Perfetto)::

        with profile_to('prof'):
            study.profile_ts(0, 512, 'wimp_rate_multiplier', 1.0)

    Yields the profiler, whose ``trace_path`` is set on exit."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, 'trace_%d_%d.json' % (os.getpid(), time.time_ns()))
    prof.export_chrome_trace(prof.trace_path)
