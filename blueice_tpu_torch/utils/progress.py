"""Progress reporting for long host loops.

Role parity with the reference's tqdm instrumentation on every long host loop
(reference: blueice/likelihood.py:191-208, parallel.py:55-66,
pdf_morphers.py:173) — tqdm is used when importable, with a lightweight stderr
ticker fallback, and everything can be silenced globally. Device work is
observed with ``torch.profiler``; the JAX package's profiler hooks
(``trace`` / ``profile_to``) are not ported.
"""

import sys
import time

__all__ = ['progress_iter', 'set_progress']

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

