#!/usr/bin/env python3
"""Device-time account of the port's statistics on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 measure_statistics.py

For each phase of ``chip_smoke.py``'s statistics part (``STATS``: the xenon
sensitivity band, 256 toys; the xenon observed upper limit; the Gaussian
unbinned band, 1,024 toys; the unbinned_xenon observed upper limit; the
combined SR0+SR1 observed upper limit), float32 on the card, on the study
of its path:

1. the call once cold and once warm, unprofiled (a band on seed 0, then on
   seed 1; an interval on one simulated background-only dataset bound with
   ``set_data``, or for the combined Sum passed as ``counts=``, twice);
2. the warm call under torch.profiler: the device's kernels by name, their
   summed time over the wall time (one stream, so they do not overlap: the
   card idles the rest);
3. the warm call once more, unprofiled, and the same device time over its
   wall time.

It checks nothing that chip_smoke.py does not; it only measures. Without
CUDA it exits with code 2. It prints the card's name and power limit first
and last.
"""

import sys
import time

import torch

from chip_smoke import (PATHS, STATS, build_model, log, observed_dataset,
                        sum_dataset)
from measure_unbinned import device_kernels, log_kernels


def statistics_call(study, label, kind, n_toys, seed, counts=None):
    """The phase's call: ``sensitivity_band`` ('auto' grid, background-only
    truth) on ``seed``, or ``observed_interval`` (upper, 90%) on the bound
    dataset (a Sum's: ``counts``)."""
    from blueice_tpu_torch.parallel import (observed_interval,
                                            sensitivity_band)
    target = PATHS[label][1]
    if kind == 'band':
        return sensitivity_band(study, seed, target, 'auto', n_toys)
    return observed_interval(study, target, kind='upper', cl=0.9,
                             counts=counts)


def timed(fn):
    """Seconds of ``fn()`` on the host's clock, the card synchronized
    before and after."""
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def account(phase, study, label, kind, n_toys):
    from torch.profiler import ProfilerActivity, profile

    counts = None
    if kind == 'interval' and hasattr(study.compiled, 'children'):
        counts = sum_dataset(study, PATHS[label][1])
    elif kind == 'interval':
        observed_dataset(study.lf)

    def run(seed):
        return timed(lambda: statistics_call(study, label, kind, n_toys,
                                             seed, counts))
    cold, warm = run(0), run(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run(1)
    bare = run(1)
    by_name = device_kernels(prof)
    busy = sum(total for total, _ in by_name.values()) / 1e6
    log("%s (torch.profiler, one warm call): cold %.3f s, warm %.3f s; "
        "profiled %.3f s: %d kernels on the device, %.1f ms in all (%.2f%% "
        "of the wall time, idle %.2f%%); unprofiled again %.3f s (device "
        "time %.2f%% of it, idle %.2f%%)"
        % (phase, cold, warm, wall, sum(c for _, c in by_name.values()),
           1e3 * busy, 100 * busy / wall, 100 - 100 * busy / wall, bare,
           100 * busy / bare, 100 - 100 * busy / bare))
    log_kernels(by_name, 10)


def main():
    if not torch.cuda.is_available():
        print("measure_statistics: CUDA is not available", file=sys.stderr)
        return 2
    from blueice_tpu_torch import likelihood, test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import fused, fused_unbinned
    from blueice_tpu_torch.parallel import BinnedToyStudy, UnbinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    from blueice_tpu_torch.utils.roofline import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_progress(False)
    log(card_line())
    fused.build_libraries([fused.SOURCE, fused_unbinned.SOURCE])
    fused.load_library()
    fused_unbinned.load_library()
    studies = {}
    for phase, (label, kind, n_toys) in STATS.items():
        if label not in studies:
            lf = build_model(label, xenon_like, test_helpers, likelihood)
            cls = (UnbinnedToyStudy if PATHS[label][0].startswith('unbinned')
                   else BinnedToyStudy)
            studies[label] = cls(lf, max_iter=96, tol=3e-4)
        account(phase, studies[label], label, kind, n_toys)
    log(card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
