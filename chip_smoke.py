#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blueice_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``blueice_tpu_torch/csrc`` (nvcc,
sm_90a, into ``build/``) and drives the port's main path: the XENON1T-style
binned profile-likelihood toy study (6 sources, 3^4 = 81 anchors, 50x62
bins, 8 floating parameters), 512 toys, float32. Phases:

1. kernels vs their plain PyTorch versions at the XENON shape, on the card
   (ll relative 1e-5; g and H within 1e-4 of each toy's largest entry),
   with warm times (median of 20, CUDA events);
2. the main path, twice, with the kernels' launch counters read around it
   and the profile statistic checked against the reference's statistics;
3. 16 toys' counts fitted on CUDA in float32 and on the CPU in float64
   (plain versions): max |d max_ll| <= 0.05, median |d t| <= 0.01.

Any failure raises (exit code != 0, no result line). Without CUDA it exits
with code 2 before doing anything. The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

TARGET = 'wimp_rate_multiplier'
N_TOYS = 512
TIMED_RUNS = 20


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, torch, runs=TIMED_RUNS, warmup=3):
    """Median warm time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_to_toy_max(a, b):
    """max |a - b| relative to each toy's largest |b| entry."""
    scale = b.abs().flatten(1).max(1).values.reshape(
        (-1,) + (1,) * (b.dim() - 1))
    return float(((a - b).abs() / scale).max())


def kernel_inputs(compiled, rng, torch, lead):
    """Kernel inputs at the XENON shape from a fixed seed: random lower
    corners and lerp weights, rates within 20% of the default expectations,
    Poisson counts at the default expectations."""
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    dev = compiled.device
    mus = compiled.rates(compiled.defaults).cpu().numpy()
    expected = compiled.expected_counts(compiled.defaults).cpu().numpy()
    idx = rng.integers(0, 2, lead + (K,))
    t = rng.random(lead + (K,))
    m = mus * rng.uniform(0.8, 1.2, lead + (S,))
    observed = rng.poisson(expected.ravel(), (lead[0], expected.size))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    return (torch.as_tensor(idx, device=dev), f32(t), f32(m), f32(observed))


def check_kernels(compiled, fused, torch):
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    anchor = compiled.ps_tensor.reshape(G, S, -1).contiguous()
    grid = [len(a) for a in compiled.anchor_arrays]
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    rng = np.random.default_rng(0)
    rows = []

    idx, t, m, obs = kernel_inputs(compiled, rng, torch, (N_TOYS,))
    args = (anchor, strides, idx, t, m, obs)
    out = fused.binned_vgh_fused(*args)
    ref = fused.binned_vgh_plain(*args)
    torch.cuda.synchronize()
    ll_rel = float(((out[0] - ref[0]).abs() / ref[0].abs()).max())
    g_rel = rel_to_toy_max(out[1], ref[1])
    h_rel = rel_to_toy_max(out[2], ref[2])
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    ms = cuda_ms(lambda: fused.binned_vgh_fused(*args), torch)
    plain_ms = cuda_ms(lambda: fused.binned_vgh_plain(*args), torch)
    log("vgh kernel   B=%d: ll rel err %.3g, g %.3g, H %.3g (of toy max); "
        "%.4f ms vs plain %.4f ms" % (N_TOYS, ll_rel, g_rel, h_rel, ms,
                                      plain_ms))
    if not (ll_rel <= 1e-5 and g_rel <= 1e-4 and h_rel <= 1e-4):
        raise AssertionError("vgh kernel disagrees with its plain version")
    rows.append(dict(name='binned_vgh_fused', route='cuda',
                     source='blueice_tpu_torch/csrc/fused_binned.cu',
                     replaces='blueice_tpu/ops/fused.py:144',
                     also_replaces='blueice_tpu/ops/fused.py:597',
                     max_abs_err=abs_err, max_rel_err=max(ll_rel, g_rel,
                                                          h_rel),
                     ms=ms, plain_ms=plain_ms))

    value = dict(name='binned_ll_fused_multi', route='cuda',
                 source='blueice_tpu_torch/csrc/fused_binned.cu',
                 replaces='blueice_tpu/ops/fused.py:251',
                 also_replaces='blueice_tpu/ops/fused.py:690',
                 max_abs_err=0.0, max_rel_err=0.0)
    for A in (12, 20):
        idx, t, m, _ = kernel_inputs(compiled, rng, torch, (N_TOYS, A))
        args = (anchor, strides, idx, t, m, obs)
        out = fused.binned_ll_fused_multi(*args)
        ref = fused.binned_ll_plain(*args)
        torch.cuda.synchronize()
        rel = float(((out - ref).abs() / ref.abs()).max())
        ms = cuda_ms(lambda: fused.binned_ll_fused_multi(*args), torch)
        plain_ms = cuda_ms(lambda: fused.binned_ll_plain(*args), torch)
        log("value kernel B=%d A=%d: ll rel err %.3g; %.4f ms vs plain "
            "%.4f ms" % (N_TOYS, A, rel, ms, plain_ms))
        if not rel <= 1e-5:
            raise AssertionError("value kernel (A=%d) disagrees with its "
                                 "plain version" % A)
        value['max_abs_err'] = max(value['max_abs_err'],
                                   float((out - ref).abs().max()))
        value['max_rel_err'] = max(value['max_rel_err'], rel)
        suffix = '' if A == 12 else '_A%d' % A
        value['ms' + suffix] = ms
        value['plain_ms' + suffix] = plain_ms
    rows.append(value)
    return rows


def check_statistics(t, free):
    wimp = float(np.mean(free[TARGET]))
    med = float(np.median(t))
    if not np.isfinite(free.max_ll).all():
        raise AssertionError("non-finite free-fit max_ll")
    if not (t >= 0).all():
        raise AssertionError("negative profile statistic")
    if not 0.7 < wimp < 1.3:
        raise AssertionError("mean fitted %s %.4f outside (0.7, 1.3)"
                             % (TARGET, wimp))
    if not 0.10 < med < 0.20:
        raise AssertionError("median t %.4f outside (0.10, 0.20)" % med)
    return wimp, med


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import fused
    from blueice_tpu_torch.parallel import BinnedToyStudy
    from blueice_tpu_torch.utils import set_progress

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_progress(False)
    log(card_line())
    log("torch %s, CUDA %s, device %s" % (torch.__version__,
                                          torch.version.cuda,
                                          torch.cuda.get_device_name(0)))
    t0 = time.time()
    fused.load_library()
    log("kernel build + load: %.1f s" % (time.time() - t0))

    t0 = time.time()
    lf = xenon_like.build_likelihood('binned')
    study = BinnedToyStudy(lf, dtype=torch.float32, device='cuda',
                           max_iter=96, tol=3e-4)
    log("XENON likelihood: anchor tensor %s (grid, sources, bins), built "
        "in %.1f s" % (tuple(study.compiled.ps_tensor.shape),
                       time.time() - t0))

    # 1. kernels vs plain versions (launches here are not counted below)
    rows = check_kernels(study.compiled, fused, torch)

    # 2. the main path, twice, around the launch counters
    fused.reset_launch_counts()
    results = []
    for seed in (0, 1):
        t0 = time.time()
        t, free, cond = study.profile_ts(seed, n_toys=N_TOYS, target=TARGET,
                                         hypothesis=1.0)
        torch.cuda.synchronize()
        results.append((time.time() - t0, t, free, cond))
    launches = fused.launch_counts()
    log("kernel launches in the main path: %s" % launches)
    if not all(launches.values()):
        raise AssertionError("a kernel of the main path never launched")
    for (secs, t, free, cond), label in zip(results, ('first', 'warm')):
        wimp, med = check_statistics(t, free)
        log("profile_ts %s run: %d toys in %.3f s (%.1f profile fits/s); "
            "median t %.4f; mean %s %.4f; mean Newton iterations free "
            "%.1f, conditional %.1f" % (label, N_TOYS, secs, N_TOYS / secs,
                                        med, TARGET, wimp,
                                        free.n_iter.mean(),
                                        cond.n_iter.mean()))
    for row in rows:
        row['launches'] = launches[row['name']]

    # 3. same counts, two precisions
    counts = study.simulate(0, N_TOYS)[:16]
    t32, f32, c32 = study._run_profile(counts, TARGET, 1.0, None)
    cpu_study = BinnedToyStudy(lf, dtype=torch.float64, device='cpu',
                               max_iter=96, tol=3e-4)
    t0 = time.time()
    t64, f64, c64 = cpu_study._run_profile(counts.cpu().double(), TARGET,
                                           1.0, None)
    d_ll = np.maximum(np.abs(f32.max_ll - f64.max_ll),
                      np.abs(c32.max_ll - c64.max_ll))
    d_t = np.abs(t32 - t64)
    worst = int(np.argmax(d_ll))
    log("float32 (CUDA) vs float64 (CPU, %.1f s), 16 toys: max |d max_ll| "
        "%.4g, median |d t| %.4g; worst toy %d: free %.4f vs %.4f, "
        "conditional %.4f vs %.4f, t %.4f vs %.4f"
        % (time.time() - t0, d_ll.max(), np.median(d_t), worst,
           f32.max_ll[worst], f64.max_ll[worst], c32.max_ll[worst],
           c64.max_ll[worst], t32[worst], t64[worst]))
    if not (d_ll.max() <= 0.05 and np.median(d_t) <= 0.01):
        raise AssertionError("float32 fits disagree with float64")

    log(card_line())
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
