#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blueice_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``blueice_tpu_torch/csrc`` (one nvcc
per source, all started together, sm_90a, into ``build/``) and drives three
paths of the port, each the XENON1T-style binned profile-likelihood toy
study (6 sources, 3^4 = 81 anchors, 50x62 bins, 8 floating parameters,
float32):

* ``xenon``: the plain binned likelihood, 512 toys;
* ``bb``: Beeston-Barlow ``bb_single`` on the ER source, 256 toys;
* ``bblite``: Barlow-Beeston-lite on all sources, 256 toys.

For each path:

1. its two kernels vs their plain PyTorch versions at the XENON shape, on
   the card: the vgh at B = 512, the value kernel at A = 12 and 20 (ll
   relative 1e-5; g and H within 1e-4 of each toy's largest entry), with
   warm times (median of 20, CUDA events);
2. the path itself, twice (seeds 0 and 1), with all six launch counters
   set to 0 just before and read just after: the path's own two kernels
   must have launched, the others not; the profile statistic is checked
   against the reference's statistics;
3. the same counts fitted on CUDA in float32 and on the CPU in float64
   (plain versions): max |d max_ll| <= 0.05, median |d t| <= 0.01 (16
   toys for xenon, 8 for bb and bblite).

Any failure raises (exit code != 0, no result line). Without CUDA it exits
with code 2 before doing anything. The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

TARGET = 'wimp_rate_multiplier'
KERNEL_TOYS = 512
TIMED_RUNS = 20
CSRC = 'blueice_tpu_torch/csrc/'

# label: (build_likelihood's bb argument, toys of the main path, toys
# compared between float32 and float64, band of the median t)
PATHS = {
    'xenon': (False, 512, 16, (0.10, 0.20)),
    'bb': (True, 256, 8, (0.08, 0.20)),
    'bblite': ('bb_lite', 256, 8, (0.08, 0.20)),
}


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


def ptxas_report(lib_paths):
    """The -Xptxas -v lines (registers, spills) of the XENON-shape (S = 6,
    K = 4) instantiations, from the logs kept beside the libraries."""
    lines = []
    for path in lib_paths:
        with open(path[:-3] + '.log') as f:
            text = f.read()
        for entry in text.split("Compiling entry function '")[1:]:
            name = entry.split("'", 1)[0]
            if 'ILi6ELi4E' not in name:
                continue
            kernel = re.search(r'([a-z_]+_kernel)ILi6ELi4E', name)
            spills = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                               r'loads', entry)
            regs = re.search(r'Used (\d+) registers', entry)
            lines.append('%s<6,4>: %s registers, spill stores/loads %s/%s B'
                         % (kernel.group(1) if kernel else name,
                            regs.group(1) if regs else '?',
                            *(spills.groups() if spills else ('?', '?'))))
    return lines


def path_ops(label, compiled, ops, torch):
    """(vgh kernel, vgh plain, value kernel, value plain) of a path, each
    called as f(anchor, strides, idx, t, m, observed), and the row metadata
    of its two kernels."""
    fused, fused_bb, fused_bb_lite = ops
    S = len(compiled.rate_names)
    if label == 'xenon':
        return ((fused.binned_vgh_fused, fused.binned_vgh_plain,
                 fused.binned_ll_fused_multi, fused.binned_ll_plain),
                [dict(name='binned_vgh_fused', source=CSRC + 'fused_binned.cu',
                      replaces='blueice_tpu/ops/fused.py:144',
                      also_replaces='blueice_tpu/ops/fused.py:597'),
                 dict(name='binned_ll_fused_multi',
                      source=CSRC + 'fused_binned.cu',
                      replaces='blueice_tpu/ops/fused.py:251',
                      also_replaces='blueice_tpu/ops/fused.py:690')])
    G = compiled.mus_tensor.numel() // S
    nme = compiled.nme_tensor_host.reshape(G, S, -1)
    if label == 'bb':
        rows = nme[:, compiled.bb_source_i]
        fns = (fused_bb.binned_bb_vgh_fused, fused_bb.binned_bb_vgh_plain,
               fused_bb.binned_bb_ll_fused_multi, fused_bb.binned_bb_ll_plain)
        extra = (compiled.bb_source_i,)
        meta = [dict(name='binned_bb_vgh_fused', source=CSRC + 'fused_bb.cu',
                     replaces='blueice_tpu/ops/fused_bb.py:191',
                     also_replaces='blueice_tpu/ops/fused_bb.py:458'),
                dict(name='binned_bb_ll_fused_multi',
                     source=CSRC + 'fused_bb.cu',
                     replaces='blueice_tpu/ops/fused_bb.py:227',
                     also_replaces='blueice_tpu/ops/fused_bb.py:605')]
    else:
        rows = nme.sum(axis=1)
        fns = (fused_bb_lite.binned_bblite_vgh_fused,
               fused_bb_lite.binned_bblite_vgh_plain,
               fused_bb_lite.binned_bblite_ll_fused_multi,
               fused_bb_lite.binned_bblite_ll_plain)
        extra = ()
        meta = [dict(name='binned_bblite_vgh_fused',
                     source=CSRC + 'fused_bb_lite.cu',
                     replaces='blueice_tpu/ops/fused_bb_lite.py:154',
                     also_replaces='blueice_tpu/ops/fused_bb_lite.py:417'),
                dict(name='binned_bblite_ll_fused_multi',
                     source=CSRC + 'fused_bb_lite.cu',
                     replaces='blueice_tpu/ops/fused_bb_lite.py:189',
                     also_replaces='blueice_tpu/ops/fused_bb_lite.py:511')]
    rows = torch.as_tensor(rows, dtype=torch.float32,
                           device=compiled.device).contiguous()

    def bind(fn):
        return lambda anchor, strides, idx, t, m, obs: fn(
            anchor, rows, strides, idx, t, m, obs, *extra)
    return tuple(bind(fn) for fn in fns), meta


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


def check_kernels(label, compiled, fns, meta, torch):
    vgh, vgh_plain, value, value_plain = fns
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    anchor = compiled.ps_tensor.reshape(G, S, -1).contiguous()
    grid = [len(a) for a in compiled.anchor_arrays]
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    rng = np.random.default_rng(0)

    idx, t, m, obs = kernel_inputs(compiled, rng, torch, (KERNEL_TOYS,))
    args = (anchor, strides, idx, t, m, obs)
    out = vgh(*args)
    ref = vgh_plain(*args)
    torch.cuda.synchronize()
    ll_rel = float(((out[0] - ref[0]).abs() / ref[0].abs()).max())
    g_rel = rel_to_toy_max(out[1], ref[1])
    h_rel = rel_to_toy_max(out[2], ref[2])
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    ms = cuda_ms(lambda: vgh(*args), torch)
    plain_ms = cuda_ms(lambda: vgh_plain(*args), torch)
    log("%s vgh kernel   B=%d: ll rel err %.3g, g %.3g, H %.3g (of toy max);"
        " %.4f ms vs plain %.4f ms" % (label, KERNEL_TOYS, ll_rel, g_rel,
                                       h_rel, ms, plain_ms))
    if not (ll_rel <= 1e-5 and g_rel <= 1e-4 and h_rel <= 1e-4):
        raise AssertionError("%s vgh kernel disagrees with its plain "
                             "version" % label)
    rows = [dict(meta[0], route='cuda', max_abs_err=abs_err,
                 max_rel_err=max(ll_rel, g_rel, h_rel), ms=ms,
                 plain_ms=plain_ms)]

    row = dict(meta[1], route='cuda', max_abs_err=0.0, max_rel_err=0.0)
    for A in (12, 20):
        idx, t, m, _ = kernel_inputs(compiled, rng, torch, (KERNEL_TOYS, A))
        args = (anchor, strides, idx, t, m, obs)
        out = value(*args)
        ref = value_plain(*args)
        torch.cuda.synchronize()
        rel = float(((out - ref).abs() / ref.abs()).max())
        ms = cuda_ms(lambda: value(*args), torch)
        plain_ms = cuda_ms(lambda: value_plain(*args), torch)
        log("%s value kernel B=%d A=%d: ll rel err %.3g; %.4f ms vs plain "
            "%.4f ms" % (label, KERNEL_TOYS, A, rel, ms, plain_ms))
        if not rel <= 1e-5:
            raise AssertionError("%s value kernel (A=%d) disagrees with its "
                                 "plain version" % (label, A))
        row['max_abs_err'] = max(row['max_abs_err'],
                                 float((out - ref).abs().max()))
        row['max_rel_err'] = max(row['max_rel_err'], rel)
        suffix = '' if A == 12 else '_A%d' % A
        row['ms' + suffix] = ms
        row['plain_ms' + suffix] = plain_ms
    rows.append(row)
    return rows


def check_statistics(label, t, free, band):
    wimp = float(np.mean(free[TARGET]))
    med = float(np.median(t))
    if not np.isfinite(free.max_ll).all():
        raise AssertionError("%s: non-finite free-fit max_ll" % label)
    if not (t >= 0).all():
        raise AssertionError("%s: negative profile statistic" % label)
    if not 0.7 < wimp < 1.3:
        raise AssertionError("%s: mean fitted %s %.4f outside (0.7, 1.3)"
                             % (label, TARGET, wimp))
    if not band[0] < med < band[1]:
        raise AssertionError("%s: median t %.4f outside %s"
                             % (label, med, band))
    return wimp, med


def run_path(label, xenon_like, BinnedToyStudy, ops, torch):
    """Phases 1-3 of one path; returns its kernel rows."""
    bb, n_toys, n_compare, band = PATHS[label]
    t0 = time.time()
    lf = xenon_like.build_likelihood('binned', bb=bb)
    study = BinnedToyStudy(lf, dtype=torch.float32, device='cuda',
                           max_iter=96, tol=3e-4)
    log("%s likelihood: anchor tensor %s (grid, sources, bins), built in "
        "%.1f s" % (label, tuple(study.compiled.ps_tensor.shape),
                    time.time() - t0))

    # 1. kernels vs plain versions (launches here are not counted below)
    fns, meta = path_ops(label, study.compiled, ops, torch)
    rows = check_kernels(label, study.compiled, fns, meta, torch)

    # 2. the path, twice, around all six launch counters
    for module in ops:
        module.reset_launch_counts()
    results = []
    for seed in (0, 1):
        t0 = time.time()
        t, free, cond = study.profile_ts(seed, n_toys=n_toys, target=TARGET,
                                         hypothesis=1.0)
        torch.cuda.synchronize()
        results.append((time.time() - t0, t, free, cond))
    launches = {}
    for module in ops:
        launches.update(module.launch_counts())
    log("%s kernel launches in the main path: %s" % (label, launches))
    own = [r['name'] for r in rows]
    if not all(launches[name] > 0 for name in own):
        raise AssertionError("%s: a kernel of the path never launched"
                             % label)
    if any(n for name, n in launches.items() if name not in own):
        raise AssertionError("%s: another path's kernel launched" % label)
    for (secs, t, free, cond), run in zip(results, ('first', 'warm')):
        wimp, med = check_statistics(label, t, free, band)
        log("%s profile_ts %s run: %d toys in %.3f s (%.1f profile fits/s); "
            "median t %.4f; mean %s %.4f; mean Newton iterations free %.1f, "
            "conditional %.1f" % (label, run, n_toys, secs, n_toys / secs,
                                  med, TARGET, wimp, free.n_iter.mean(),
                                  cond.n_iter.mean()))
    for row in rows:
        row['launches'] = launches[row['name']]

    # 3. same counts, two precisions
    counts = study.simulate(0, n_toys)[:n_compare]
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
    log("%s float32 (CUDA) vs float64 (CPU, %.1f s), %d toys: max |d "
        "max_ll| %.4g, median |d t| %.4g; worst toy %d: free %.4f vs %.4f, "
        "conditional %.4f vs %.4f, t %.4f vs %.4f"
        % (label, time.time() - t0, n_compare, d_ll.max(), np.median(d_t),
           worst, f32.max_ll[worst], f64.max_ll[worst], c32.max_ll[worst],
           c64.max_ll[worst], t32[worst], t64[worst]))
    if not (d_ll.max() <= 0.05 and np.median(d_t) <= 0.01):
        raise AssertionError("%s: float32 fits disagree with float64" % label)
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import fused, fused_bb, fused_bb_lite
    from blueice_tpu_torch.parallel import BinnedToyStudy
    from blueice_tpu_torch.utils import set_progress

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_progress(False)
    log(card_line())
    log("torch %s, CUDA %s, device %s" % (torch.__version__,
                                          torch.version.cuda,
                                          torch.cuda.get_device_name(0)))
    ops = (fused, fused_bb, fused_bb_lite)
    t0 = time.time()
    libs = fused.build_libraries([m.SOURCE for m in ops])
    for module in ops:
        module.load_library()
    log("kernel build + load (%d sources in parallel): %.1f s"
        % (len(libs), time.time() - t0))
    for line in ptxas_report(libs):
        log("ptxas " + line)

    rows = []
    for label in PATHS:
        rows += run_path(label, xenon_like, BinnedToyStudy, ops, torch)

    log(card_line())
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
