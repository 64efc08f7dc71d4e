#!/usr/bin/env python3
"""Device-time account and engine A/B of the port's unbinned toy studies on
one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 measure_unbinned.py

For each unbinned path of ``chip_smoke.py`` (``unbinned_xenon``, 256 toys;
``unbinned``, bench.py's Gaussian model, 1,024 toys), float32 on the card:

1. torch.profiler over one warm ``profile_ts`` (seed 1): the device's kernels
   by name, their summed time over the wall time (one stream, so they do not
   overlap: the card idles the rest), and each unbinned kernel's own time
   per call (without its wrapper's table set-up, which chip_smoke.py's
   CUDA-event times include); then the same profile unprofiled;
2. an engine A/B: warm ``profile_ts`` on seed 1 with ``engine='fused'`` (the
   CUDA kernels) and ``engine='analytic'`` (their plain PyTorch versions),
   in the order f a a f f a, host clock around a synchronize.

It checks nothing that chip_smoke.py does not; it only measures. Without
CUDA it exits with code 2. It prints the card's name and power limit
first and last.
"""

import sys
import time

import numpy as np
import torch

from chip_smoke import PATHS, build_model, log

UNBINNED = ('unbinned_xenon', 'unbinned')
AB_ORDER = ('fused', 'analytic', 'analytic', 'fused', 'fused', 'analytic')


def run_profile(study, label):
    _, target, n_toys, _, _ = PATHS[label]
    return study.profile_ts(1, n_toys=n_toys, target=target, hypothesis=1.0)


def device_kernels(prof):
    """{name: (summed device time in us, calls)} of the kernels that ran
    on the card in a torch.profiler run."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    return by_name


def log_kernels(by_name, top):
    """The ``top`` kernels of ``device_kernels`` by summed time."""
    for name, (total, count) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][0])[:top]:
        log("  %10.2f ms  %7d calls  %s" % (total / 1e3, count, name[:90]))


def profile_account(label, study):
    """torch.profiler over one warm profile_ts, then one unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    run_profile(study, label)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_profile(study, label)
        torch.cuda.synchronize()
        wall = time.time() - t0
    t0 = time.time()
    run_profile(study, label)
    torch.cuda.synchronize()
    bare = time.time() - t0
    by_name = device_kernels(prof)
    busy_us = sum(total for total, _ in by_name.values())
    log("%s profile (torch.profiler, one warm profile_ts on seed 1): wall "
        "%.3f s; %d kernels on the device, %.1f ms in all (%.1f%% of the "
        "wall time; the card idles the rest); unprofiled %.3f s (%.1f%%)"
        % (label, wall, sum(c for _, c in by_name.values()), busy_us / 1e3,
           100 * busy_us / 1e6 / wall, bare, 100 * busy_us / 1e6 / bare))
    log_kernels(by_name, 12)
    for symbol in ('uvgh_kernel<', 'ull_kernel<'):
        hits = [v for name, v in by_name.items() if '::' + symbol in name]
        total = sum(us for us, _ in hits)
        count = sum(n for _, n in hits)
        log("%s %s> on the device: %.2f ms in %d calls, %.1f us per call"
            % (label, symbol, total / 1e3, count,
               total / count if count else 0.0))


def engine_ab(label, study, cls):
    studies = {'fused': study,
               'analytic': cls(study.lf, n_max=study.n_max, max_iter=96,
                               tol=3e-4, engine='analytic')}
    for s in studies.values():
        run_profile(s, label)
    times = {'fused': [], 'analytic': []}
    for engine in AB_ORDER:
        torch.cuda.synchronize()
        t0 = time.time()
        t, free, cond = run_profile(studies[engine], label)
        torch.cuda.synchronize()
        times[engine].append(time.time() - t0)
        log("%s A/B %s: %.3f s, median t %.5f, mean iterations %.2f / %.2f"
            % (label, engine, times[engine][-1], np.median(t),
               free.n_iter.mean(), cond.n_iter.mean()))
    fused, analytic = (np.median(times[e]) for e in ('fused', 'analytic'))
    log("%s A/B medians: fused %.3f s, analytic %.3f s (%.2fx)"
        % (label, fused, analytic, analytic / fused))


def main():
    if not torch.cuda.is_available():
        print("measure_unbinned: CUDA is not available", file=sys.stderr)
        return 2
    from blueice_tpu_torch import likelihood, test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import fused_unbinned
    from blueice_tpu_torch.parallel import UnbinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    from blueice_tpu_torch.utils.roofline import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_progress(False)
    log(card_line())
    fused_unbinned.load_library()
    for label in UNBINNED:
        lf = build_model(label, xenon_like, test_helpers, likelihood)
        study = UnbinnedToyStudy(lf, max_iter=96, tol=3e-4)
        profile_account(label, study)
        engine_ab(label, study, UnbinnedToyStudy)
    log(card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
