#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blueice_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``blueice_tpu_torch/csrc`` (one nvcc
per source, all started together, sm_90a, into ``build/``) and drives five
paths of the port, each a profile-likelihood toy study at the width of a
model the repo supports, float32 on the card:

* ``xenon``: the XENON1T-style binned likelihood (6 sources, 3^4 = 81
  anchors, 50x62 bins, 8 floating parameters), 512 toys;
* ``bb``: the same with Beeston-Barlow ``bb_single`` on the ER source, 256
  toys;
* ``bblite``: the same with Barlow-Beeston-lite on all sources, 256 toys;
* ``unbinned_xenon``: the same sources and anchors as an extended unbinned
  likelihood at 3 live days (~1,880 events per toy), 256 toys;
* ``unbinned``: bench.py's Gaussian unbinned model (2 Monte-Carlo sources
  over 100 bins, shape parameter mu on 3 anchors, ~2,000 events per toy),
  1,024 toys, target s0_rate_multiplier.

For each path:

1. its two kernels vs their plain PyTorch versions on the card (ll relative
   1e-5; g and H within 1e-4 of each toy's largest entry), with warm times
   (CUDA events) of a whole wrapper call (``ms``, median of 20) and of the
   kernel alone (``kernel_ms``: the wrapper's tables built once, then 20
   launches captured in a CUDA graph, its replay timed, median of 5; and
   ``kernel_ms_cold``, the launches cycling over copies of the path's data
   that together outgrow the 50 MB L2, ``roofline.cold_launches``) beside
   the least time the card could take for the same work (``bound_ms``:
   bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is
   larger, counted from this run's inputs, see
   ``blueice_tpu_torch.utils.roofline.work``). Binned paths at the XENON
   shape (512 toys; the value kernel at A = 12 and 20); unbinned paths on
   the study's own scored event tensors (all toys of the path, A = 12 and
   20);
2. the path itself, twice (seeds 0 and 1), with every launch counter set
   to 0 just before and read just after: the path's own two kernels must
   have launched, the others not; the profile statistic is checked against
   the reference's statistics (median t band, mean fitted target in
   (0.7, 1.3)); on xenon, then, the value kernel over one profile's own
   calls (``replay_value_calls``: every call recorded, their launches
   replayed from CUDA graphs, summed time beside summed bound);
3. the same toys (counts, or event sets) fitted on CUDA in float32 and on
   the CPU in float64 (plain versions): max |d max_ll| <= 0.05, median
   |d t| <= 0.01.

Then the roofline part (``blueice_tpu_torch.utils.roofline``):

4. the op-mix kernel (``csrc/op_mix.cu``) vs its plain version for each mix
   (fma, bb, bblite, poisson), one loop trip on the check inputs
   (``op_mix_inputs(check=True)``) at the mix's check nudge (``MIXES``),
   within 1e-5 of the float64 scale of each element's terms
   (``op_mix_scale``), over the elements that fill the card;
5. the op-mix ceilings (``op_mix_record``) with every launch counter set to
   0 just before and read just after: the op-mix kernel must have launched,
   no fit kernel; then the vgh kernels' roofline verdicts
   (``roofline_record``), printed as a table, and per kernel warm and
   L2-cold (an L2-cold HBM share above 100% fails).

It takes no options; ``measure_unbinned.py`` holds the torch.profiler
account and the engine A/B of the unbinned paths.

Any failure raises (exit code != 0, no result line). Without CUDA it exits
with code 2 before doing anything. The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_TOYS = 512
TIMED_RUNS = 20
CSRC = 'blueice_tpu_torch/csrc/'
TPU = 'blueice_tpu/ops/'

# label: (model, target, toys of the main path, toys compared between
# float32 and float64, band of the median t)
PATHS = {
    'xenon': ('binned', 'wimp_rate_multiplier', 512, 16, (0.10, 0.20)),
    'bb': ('bb', 'wimp_rate_multiplier', 256, 8, (0.08, 0.20)),
    'bblite': ('bblite', 'wimp_rate_multiplier', 256, 8, (0.08, 0.20)),
    'unbinned_xenon': ('unbinned_xenon', 'wimp_rate_multiplier', 256, 8,
                       (0.25, 0.80)),
    'unbinned': ('unbinned_gauss', 's0_rate_multiplier', 1024, 16,
                 (0.33, 0.66)),
}

# kernel row metadata per path: (wrapper, source, Pallas body it replaces,
# the other Pallas flavour of the same contract)
META = {
    'xenon': [('binned_vgh_fused', 'fused_binned.cu', 'fused.py:144',
               'fused.py:597'),
              ('binned_ll_fused_multi', 'fused_binned.cu', 'fused.py:251',
               'fused.py:690')],
    'bb': [('binned_bb_vgh_fused', 'fused_bb.cu', 'fused_bb.py:191',
            'fused_bb.py:458'),
           ('binned_bb_ll_fused_multi', 'fused_bb.cu', 'fused_bb.py:227',
            'fused_bb.py:605')],
    'bblite': [('binned_bblite_vgh_fused', 'fused_bb_lite.cu',
                'fused_bb_lite.py:154', 'fused_bb_lite.py:417'),
               ('binned_bblite_ll_fused_multi', 'fused_bb_lite.cu',
                'fused_bb_lite.py:189', 'fused_bb_lite.py:511')],
    # G = 81 > 16: the TPU ran the per-toy gather flavour (when it fit VMEM)
    'unbinned_xenon': [('unbinned_vgh_fused', 'fused_unbinned.cu',
                        'fused_unbinned.py:245', 'fused_unbinned.py:81'),
                       ('unbinned_ll_fused_multi', 'fused_unbinned.cu',
                        'fused_unbinned.py:332', 'fused_unbinned.py:156')],
    # G = 3 <= 16: the block flavour
    'unbinned': [('unbinned_vgh_fused', 'fused_unbinned.cu',
                  'fused_unbinned.py:81', 'fused_unbinned.py:245'),
                 ('unbinned_ll_fused_multi', 'fused_unbinned.cu',
                  'fused_unbinned.py:156', 'fused_unbinned.py:332')],
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, runs=TIMED_RUNS, warmup=3):
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
    """The -Xptxas -v lines (registers, spills, static shared memory) of the
    instantiations the paths run: S = 6, K = 4 (XENON) and S = 2, K = 1
    (Gaussian unbinned), and of the four op-mix kernels, from the logs kept
    beside the libraries."""
    lines = []
    for path in lib_paths:
        with open(path[:-3] + '.log') as f:
            text = f.read()
        for entry in text.split("Compiling entry function '")[1:]:
            name = entry.split("'", 1)[0]
            shape = re.search(r'([a-z_]+_kernel)ILi(\d)ELi(\d)E', name)
            mix = re.search(r'(op_mix_kernel)ILi(\d)E', name)
            if mix:
                label = '%s<%s>' % mix.groups()
            elif shape and (shape.group(2, 3) == ('6', '4') or (
                    shape.group(2, 3) == ('2', '1') and 'unbinned' in path)):
                label = '%s<%s,%s>' % shape.groups()
            else:
                continue
            spills = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                               r'loads', entry)
            regs = re.search(r'Used (\d+) registers', entry)
            smem = re.search(r'(\d+) bytes smem', entry)
            lines.append('%s: %s registers, spill stores/loads %s/%s B, %s '
                         'B static shared memory'
                         % (label, regs.group(1) if regs else '?',
                            *(spills.groups() if spills else ('?', '?')),
                            smem.group(1) if smem else '0'))
    return lines


def sass_census(lib_path):
    """Per op-mix kernel, its SASS instruction count and its FFMA and MUFU
    instructions (``cuobjdump -sass``), where the toolkit has cuobjdump:
    the fma kernel's 16-step body over 4 elements must hold at least 64
    FFMA, or the compiler folded the mix. Returns the report lines."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.exists(tool):
        return ['cuobjdump not found: no SASS census']
    out = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    lines = []
    for block in out.split('Function : ')[1:]:
        kind = re.search(r'op_mix_kernelILi(\d)E', block.split('\n', 1)[0])
        if not kind:
            continue
        ops = re.findall(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)',
                         block)
        ffma = sum(op.startswith('FFMA') for op in ops)
        mufu = sum(op.startswith('MUFU') for op in ops)
        lines.append('op_mix_kernel<%s>: %d SASS instructions, %d FFMA, %d '
                     'MUFU' % (kind.group(1), len(ops), ffma, mufu))
        if kind.group(1) == '0' and ffma < 64:
            raise AssertionError("the fma mix compiled to %d FFMA (< 64): "
                                 "its loop was folded" % ffma)
    return lines


# -- the paths ---------------------------------------------------------------

def build_model(label, xenon_like, test_helpers, likelihood):
    model = PATHS[label][0]
    if model == 'unbinned_xenon':
        return xenon_like.build_likelihood('unbinned', livetime_days=3.0)
    if model == 'unbinned_gauss':
        # bench.py's `unbinned` scenario (bench.py:125-146); the MC template
        # draws come from numpy's global state
        np.random.seed(0)
        conf = test_helpers.conf_for_test(
            n_sources=2, mc=True,
            analysis_space=[['x', np.linspace(-10, 10, 101)]],
            n_events_for_pdf=int(2e5))
        conf['sources'][1]['mu'] = 3.0
        lf = likelihood.UnbinnedLogLikelihood(conf)
        lf.add_rate_parameter('s0')
        lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
        lf.prepare()
        return lf
    return xenon_like.build_likelihood(
        'binned', bb={'binned': False, 'bb': True, 'bblite': 'bb_lite'}[model])


def binned_ops(label, compiled, mods):
    """(vgh kernel, vgh plain, vgh launcher, value kernel, value plain,
    value launcher) of a binned path, the MC-count rows (G, N) its kernels
    also read (None on xenon) and their trailing arguments: each is called
    as f(anchor, strides, idx, t, m, observed) on xenon, else as
    f(anchor, rows, strides, idx, t, m, observed, *extra)."""
    fused, fused_bb, fused_bb_lite = mods['fused'], mods['fused_bb'], \
        mods['fused_bb_lite']
    if label == 'xenon':
        return (fused.binned_vgh_fused, fused.binned_vgh_plain,
                fused.binned_vgh_launcher, fused.binned_ll_fused_multi,
                fused.binned_ll_plain, fused.binned_ll_launcher), None, ()
    S = len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    nme = compiled.nme_tensor_host.reshape(G, S, -1)
    if label == 'bb':
        rows = nme[:, compiled.bb_source_i]
        fns = (fused_bb.binned_bb_vgh_fused, fused_bb.binned_bb_vgh_plain,
               fused_bb.binned_bb_vgh_launcher,
               fused_bb.binned_bb_ll_fused_multi, fused_bb.binned_bb_ll_plain,
               fused_bb.binned_bb_ll_launcher)
        extra = (compiled.bb_source_i,)
    else:
        rows = nme.sum(axis=1)
        fns = (fused_bb_lite.binned_bblite_vgh_fused,
               fused_bb_lite.binned_bblite_vgh_plain,
               fused_bb_lite.binned_bblite_vgh_launcher,
               fused_bb_lite.binned_bblite_ll_fused_multi,
               fused_bb_lite.binned_bblite_ll_plain,
               fused_bb_lite.binned_bblite_ll_launcher)
        extra = ()
    rows = torch.as_tensor(rows, dtype=torch.float32,
                           device=compiled.device).contiguous()
    return fns, rows, extra


def random_point(compiled, rng, lead):
    """Random lower corners, lerp weights and rates within 20% of the
    default expectations (float32 tensors on the card)."""
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    dev = compiled.device
    mus = compiled.rates(compiled.defaults).cpu().numpy()
    hi = [len(a) - 1 for a in compiled.anchor_arrays]
    idx = np.stack([rng.integers(0, h, lead) for h in hi], axis=-1) \
        if K else np.zeros(lead + (0,), int)
    t = rng.random(lead + (K,))
    m = mus * rng.uniform(0.8, 1.2, lead + (S,))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    return torch.as_tensor(idx, device=dev), f32(t), f32(m)


def check_pair(label, name, out, ref, ll_scale):
    """(max abs err, max rel err, text) of a kernel against its plain
    version; raises unless the ll is within 1e-5 of ``ll_scale`` (per toy,
    see ``term_scale``) and g and H within 1e-4 of each toy's largest
    entry."""
    ll, ll_ref = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
    ll_rel = float(((ll - ll_ref).abs() / ll_scale).max())
    rel, ok = ll_rel, ll_rel <= 1e-5
    detail = 'll err %.3g (of its terms)' % ll_rel
    if isinstance(out, tuple):
        g_rel = rel_to_toy_max(out[1], ref[1])
        h_rel = rel_to_toy_max(out[2], ref[2])
        ok = ok and g_rel <= 1e-4 and h_rel <= 1e-4
        rel = max(ll_rel, g_rel, h_rel)
        detail += ', g %.3g, H %.3g (of toy max)' % (g_rel, h_rel)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    if not (ok and all(bool(torch.isfinite(o).all()) for o in outs)):
        raise AssertionError("%s %s disagrees with its plain version: %s"
                             % (label, name, detail))
    abs_err = max(float((a - b).abs().max()) for a, b in zip(outs, refs))
    return abs_err, rel, detail


def term_scale(ps, strides, lanes, idx, t, m, mask, inv_ref, moff, outlier):
    """Per lane (and candidate) sum of the magnitudes of the centered
    unbinned ll's terms, sum_e |log(lam_e * inv_ref_e)| + |moff|, in
    float64: the scale of that ll's float32 rounding. (A centered ll near
    the reference point is a small difference of O(1) terms, so its own
    magnitude is no scale for a relative error; the binned deviance ll has
    terms of one sign, so there the scale is |ll|.)"""
    from blueice_tpu_torch.ops import fused
    from blueice_tpu_torch.ops.binned_vgh import corner_weight_tables
    single = idx.dim() == 2
    if single:
        idx, t, m, moff = idx[:, None], t[:, None], m[:, None], moff[:, None]
    ids = fused.corner_ids(strides, idx, ps.shape[1])          # (L, A, C)
    w = corner_weight_tables(t.double())[0]
    mk, ir = mask[lanes], inv_ref[lanes].double()
    cols = []
    for a in range(ids.shape[1]):
        lam = 0.0
        for c in range(ids.shape[2]):
            rows = ps[lanes, ids[:, a, c]].double()             # (L, S, E)
            lam = lam + w[:, a, c, None] * torch.einsum(
                'ls,lse->le', m[:, a].double(), rows)
        if outlier:
            lam = torch.where(lam > 0, lam, torch.full_like(lam, outlier))
        terms = torch.where(mk, torch.log(lam * ir).abs(),
                            torch.zeros_like(lam))
        cols.append(terms.sum(-1) + moff[:, a].double().abs())
    out = torch.stack(cols, dim=1)
    return out[:, 0] if single else out


def kernel_rows(label, study, mods):
    """Phase 1: each kernel of the path against its plain version, timed
    (a whole wrapper call, and the kernel alone), beside its bound. Returns
    the path's two kernel rows."""
    from blueice_tpu_torch.utils.roofline import (N_INNER, bound,
                                                  cold_launches,
                                                  distinct_rows,
                                                  launch_elapsed_s,
                                                  row_events, work)
    compiled = study.compiled
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    grid = [len(a) for a in compiled.anchor_arrays]
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    rng = np.random.default_rng(0)
    fused, fu = mods['fused'], mods['fused_unbinned']
    unbinned = not compiled.is_binned

    if unbinned:
        n_toys = PATHS[label][2]
        ps, mask, (inv_ref, ref_msum, _) = study._fit_data(
            study.simulate(0, n_toys))
        B, n = ps.shape[0], ps.shape[-1]
        lanes = torch.randperm(B, generator=torch.Generator().manual_seed(0)
                               ).to(compiled.device)

        def moff_of(m):
            return (m.sum(-1) - (ref_msum[lanes] if m.dim() == 2
                                 else ref_msum[lanes][:, None])).contiguous()
        data = (ps, mask, inv_ref)

        def call(fn, idx, t, m, data=data):
            ps, mask, inv_ref = data
            return fn(ps, strides, lanes, idx, t, m, mask, inv_ref,
                      moff_of(m), compiled.outlier_likelihood)

        def ll_scale(idx, t, m, ref_ll):
            return term_scale(ps, strides, lanes, idx, t, m, mask, inv_ref,
                              moff_of(m), compiled.outlier_likelihood)

        valid = mask[lanes].sum(-1)          # valid events of each lane

        def costs(ids, lead):
            # the whole mask (1 B an event) and the valid events' inv_ref
            per_lane = int(np.prod(lead[1:]))
            return dict(row_floats=S * row_events(ids, valid),
                        data_bytes=mask.numel() + 4 * int(valid.sum()),
                        items=per_lane * int(valid.sum()))
        fns = (fu.unbinned_vgh_fused, fu.unbinned_vgh_plain,
               fu.unbinned_vgh_launcher, fu.unbinned_ll_fused_multi,
               fu.unbinned_ll_plain, fu.unbinned_ll_launcher)
        shape = 'B=%d E=%d (%.1f valid events a toy)' % (
            B, n, float(valid.double().mean()))
    else:
        B = KERNEL_TOYS
        anchor = compiled.ps_tensor.reshape(G, S, -1).contiguous()
        n = anchor.shape[-1]
        expected = compiled.expected_counts(compiled.defaults).cpu().numpy()
        obs = torch.as_tensor(rng.poisson(expected.ravel(), (B, n)),
                              dtype=torch.float32, device=compiled.device)
        fns, mc, extra = binned_ops(label, compiled, mods)
        data = (anchor, obs, mc)

        def call(fn, idx, t, m, data=data):
            anchor, obs, mc = data
            if mc is None:
                return fn(anchor, strides, idx, t, m, obs)
            return fn(anchor, mc, strides, idx, t, m, obs, *extra)

        def ll_scale(idx, t, m, ref_ll):
            return ref_ll.abs()

        def costs(ids, lead):
            rows = distinct_rows(ids)
            return dict(row_floats=(S + (mc is not None)) * rows * n,
                        data_bytes=B * n * 4, items=int(np.prod(lead)) * n,
                        mc_rows=mc is not None)
        shape = 'B=%d N=%d' % (B, n)

    meta = [dict(name=w, path=label, route='cuda', source=CSRC + src,
                 replaces=TPU + rep, also_replaces=TPU + alt,
                 library_ms=None)
            for w, src, rep, alt in META[label]]
    vgh, vgh_plain, vgh_launcher, value, value_plain, value_launcher = fns

    def kernel_ms(launcher, idx, t, m):
        """(warm, cold) ms of the kernel alone: on one input that stays in
        L2 between launches (the path's condition for the shared anchor
        tensor), and cycling over copies of the path's data that together
        outgrow L2 (``roofline.cold_launches``)."""
        warm = 1e3 * launch_elapsed_s(call(launcher, idx, t, m)[0])
        cold = cold_launches(lambda *d: call(launcher, idx, t, m, d), data)
        cold_ms = 1e3 * launch_elapsed_s(cold, max(N_INNER, len(cold)))
        del cold
        return warm, cold_ms

    idx, t, m = random_point(compiled, rng, (B,))
    out, ref = call(vgh, idx, t, m), call(vgh_plain, idx, t, m)
    torch.cuda.synchronize()
    abs_err, rel, detail = check_pair(label, 'vgh kernel', out, ref,
                                      ll_scale(idx, t, m, ref[0]))
    ms = cuda_ms(lambda: call(vgh, idx, t, m))
    alone_ms, cold_ms = kernel_ms(vgh_launcher, idx, t, m)
    plain_ms = cuda_ms(lambda: call(vgh_plain, idx, t, m))
    ids = fused.corner_ids(strides, idx, G)
    nbytes, flops = work('vgh', S, K, (B,), **costs(ids, (B,)))
    bound_ms, bound_by = bound(nbytes, flops)
    log("%s vgh kernel   %s: %s; wrapper %.4f ms, kernel alone %.4f ms "
        "(L2-cold %.4f) vs plain %.4f ms; bound %.4f ms (%s: %.1f MB, %.3f "
        "GFLOP)" % (label, shape, detail, ms, alone_ms, cold_ms, plain_ms,
                    bound_ms, bound_by, nbytes / 1e6, flops / 1e9))
    rows = [dict(meta[0], max_abs_err=abs_err, max_rel_err=rel, ms=ms,
                 kernel_ms=alone_ms, kernel_ms_cold=cold_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)]

    row = dict(meta[1], max_abs_err=0.0, max_rel_err=0.0)
    for A in (12, 20):
        idx, t, m = random_point(compiled, rng, (B, A))
        out, ref = call(value, idx, t, m), call(value_plain, idx, t, m)
        torch.cuda.synchronize()
        abs_err, rel, detail = check_pair(label, 'value kernel (A=%d)' % A,
                                          out, ref, ll_scale(idx, t, m, ref))
        ms = cuda_ms(lambda: call(value, idx, t, m))
        alone_ms, cold_ms = kernel_ms(value_launcher, idx, t, m)
        plain_ms = cuda_ms(lambda: call(value_plain, idx, t, m))
        ids = fused.corner_ids(strides, idx, G)
        nbytes, flops = work('value', S, K, (B, A), **costs(ids, (B, A)))
        bound_ms, bound_by = bound(nbytes, flops)
        log("%s value kernel %s A=%d: %s; wrapper %.4f ms, kernel alone "
            "%.4f ms (L2-cold %.4f) vs plain %.4f ms; bound %.4f ms (%s: "
            "%.1f MB, %.3f GFLOP)" % (label, shape, A, detail, ms, alone_ms,
                                      cold_ms, plain_ms, bound_ms, bound_by,
                                      nbytes / 1e6, flops / 1e9))
        row['max_abs_err'] = max(row['max_abs_err'], abs_err)
        row['max_rel_err'] = max(row['max_rel_err'], rel)
        suffix = '' if A == 12 else '_A%d' % A
        row.update({'ms' + suffix: ms, 'kernel_ms' + suffix: alone_ms,
                    'kernel_ms_cold' + suffix: cold_ms,
                    'plain_ms' + suffix: plain_ms,
                    'bound_ms' + suffix: bound_ms,
                    'bound_by' + suffix: bound_by})
    rows.append(row)
    return rows


def check_statistics(label, t, free, band):
    target = PATHS[label][1]
    mean_target = float(np.mean(free[target]))
    med = float(np.median(t))
    if not np.isfinite(free.max_ll).all():
        raise AssertionError("%s: non-finite free-fit max_ll" % label)
    if not (t >= 0).all():
        raise AssertionError("%s: negative profile statistic" % label)
    if not 0.7 < mean_target < 1.3:
        raise AssertionError("%s: mean fitted %s %.4f outside (0.7, 1.3)"
                             % (label, target, mean_target))
    if not band[0] < med < band[1]:
        raise AssertionError("%s: median t %.4f outside %s"
                             % (label, med, band))
    return mean_target, med


def main_path(label, study, mods, rows):
    """Phase 2: the path twice between reset and read of every counter."""
    _, target, n_toys, _, band = PATHS[label]
    for module in mods.values():
        module.reset_launch_counts()
    results = []
    for seed in (0, 1):
        t0 = time.time()
        t, free, cond = study.profile_ts(seed, n_toys=n_toys, target=target,
                                         hypothesis=1.0)
        torch.cuda.synchronize()
        results.append((time.time() - t0, t, free, cond))
    launches = {}
    for module in mods.values():
        launches.update(module.launch_counts())
    log("%s kernel launches in the main path: %s" % (label, launches))
    own = [name for name, _, _, _ in META[label]]
    if not all(launches[name] > 0 for name in own):
        raise AssertionError("%s: a kernel of the path never launched"
                             % label)
    if any(count for name, count in launches.items() if name not in own):
        raise AssertionError("%s: another path's kernel launched" % label)
    for (secs, t, free, cond), run in zip(results, ('first', 'warm')):
        mean_target, med = check_statistics(label, t, free, band)
        log("%s profile_ts %s run: %d toys in %.3f s (%.1f profile fits/s); "
            "median t %.4f; mean %s %.4f; mean Newton iterations free %.1f, "
            "conditional %.1f" % (label, run, n_toys, secs, n_toys / secs,
                                  med, target, mean_target,
                                  free.n_iter.mean(), cond.n_iter.mean()))
    for row in rows:
        row['launches'] = launches[row['name']]


def distinct_per_row(x):
    """Distinct values of each row of an integer tensor (R, M), -1 not
    counted (padding)."""
    s = x.sort(-1).values
    return 1 + (s[:, 1:] != s[:, :-1]).sum(-1) - (s[:, 0] < 0).long()


def replay_value_calls(study, mods, rows):
    """The xenon value kernel over the profile's own calls: every call of
    ``fused.binned_ll_fused_multi`` in one 512-toy ``profile_ts`` (seed 0,
    a fresh study whose fitters take the wrapper through a recorder; the
    kernels are built and loaded) is recorded with its inputs cloned; each
    call's launcher is then built once, the launches of each candidate
    count A captured in one CUDA graph in call order, and the replays timed
    (``roofline.launch_elapsed_s``). Prints the calls, their mean lanes L,
    candidates A and distinct corner rows U per toy (and per group of 8
    candidates, what one CTA stages), the summed kernel time and the summed
    bound; adds them to the value kernel's row."""
    from blueice_tpu_torch.utils.roofline import (bound, distinct_rows,
                                                  launch_elapsed_s, work)
    fused = mods['fused']
    _, target, n_toys, _, _ = PATHS['xenon']
    wrapper, calls = fused.binned_ll_fused_multi, []

    def recorder(anchor, strides, idx, t, m, observed):
        calls.append((anchor, strides, idx.clone(), t.clone(), m.clone(),
                      observed.clone()))
        return wrapper(anchor, strides, idx, t, m, observed)
    recorder.launches = 0
    fused.binned_ll_fused_multi = recorder      # read when fitters are built
    try:
        fresh = type(study)(study.lf, dtype=study.compiled.dtype,
                            device=study.device, max_iter=study.max_iter,
                            tol=study.tol, engine=study.engine)
        fresh.profile_ts(0, n_toys=n_toys, target=target, hypothesis=1.0)
        torch.cuda.synchronize()
    finally:
        fused.binned_ll_fused_multi = wrapper

    if not calls:
        raise AssertionError("xenon: the profile made no value-kernel call")
    compiled = study.compiled
    K, S = len(compiled.shape_names), len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    by_A, stats = {}, dict(lanes=0, cands=0, toy_rows=0, groups=0,
                           group_rows=0, bound_ms=0.0)
    for anchor, strides, idx, t, m, obs in calls:
        L, A = idx.shape[:2]
        N = anchor.shape[-1]
        by_A.setdefault(A, []).append(fused.binned_ll_launcher(
            anchor, strides, idx, t, m, obs)[0])
        ids = fused.corner_ids(strides, idx, G)                 # (L, A, C)
        n_grp = -(-A // 8)
        grouped = torch.nn.functional.pad(ids, (0, 0, 0, 8 * n_grp - A),
                                          value=-1)
        stats['toy_rows'] += int(distinct_per_row(ids.reshape(L, -1)).sum())
        stats['group_rows'] += int(distinct_per_row(
            grouped.reshape(L * n_grp, -1)).sum())
        stats['groups'] += L * n_grp
        stats['lanes'] += L
        stats['cands'] += L * A
        nbytes, flops = work('value', S, K, (L, A),
                             row_floats=S * distinct_rows(ids) * N,
                             data_bytes=L * N * 4, items=L * A * N)
        stats['bound_ms'] += bound(nbytes, flops)[0]
    per_A = {A: 1e3 * len(fns) * launch_elapsed_s(fns, len(fns))
             for A, fns in sorted(by_A.items())}
    n = len(calls)
    out = dict(replay_calls=n, replay_ms=sum(per_A.values()),
               replay_bound_ms=stats['bound_ms'],
               replay_mean_lanes=stats['lanes'] / n,
               replay_mean_A=stats['cands'] / stats['lanes'],
               replay_mean_U_toy=stats['toy_rows'] / stats['lanes'],
               replay_mean_U_group=stats['group_rows'] / stats['groups'])
    log("xenon value kernel over one profile's own calls: %d calls, mean "
        "lanes L %.1f, mean A %.2f (lane-weighted), mean distinct corner "
        "rows U %.2f a toy, %.2f a group of 8 candidates; kernel time "
        "summed %.4f ms (%s), bound summed %.4f ms"
        % (n, out['replay_mean_lanes'], out['replay_mean_A'],
           out['replay_mean_U_toy'], out['replay_mean_U_group'],
           out['replay_ms'], ', '.join('A=%d: %d calls %.4f ms' % (
               A, len(by_A[A]), ms) for A, ms in per_A.items()),
           out['replay_bound_ms']))
    next(r for r in rows if r['name'] == 'binned_ll_fused_multi').update(out)


def two_precisions(label, study, cls):
    """Phase 3: the same toys in float32 on the card and in float64 on the
    CPU (plain versions)."""
    _, target, n_toys, n_compare, _ = PATHS[label]
    if study.compiled.is_binned:
        toys = study.simulate(0, n_toys)[:n_compare]
        cpu_toys = toys.cpu().double()
        cpu_study = cls(study.lf, dtype=torch.float64, device='cpu',
                        max_iter=96, tol=3e-4)
    else:
        toys = tuple(x[:n_compare] for x in study.simulate(0, n_toys))
        cpu_toys = tuple(x.cpu() for x in toys)
        cpu_study = cls(study.lf, n_max=study.n_max, dtype=torch.float64,
                        device='cpu', max_iter=96, tol=3e-4)
    t32, f32, c32 = study._run_profile(toys, target, 1.0, None)
    t0 = time.time()
    t64, f64, c64 = cpu_study._run_profile(cpu_toys, target, 1.0, None)
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


def check_on_card(label, compiled):
    """The study's defaults: float32 on the card."""
    if compiled.device.type != 'cuda' or compiled.dtype != torch.float32:
        raise AssertionError("%s: the study did not default to float32 on "
                             "the card" % label)


def run_path(label, mods, api):
    model = PATHS[label][0]
    t0 = time.time()
    lf = build_model(label, api['xenon_like'], api['test_helpers'],
                     api['likelihood'])
    if model.startswith('unbinned'):
        cls = api['UnbinnedToyStudy']
        study = cls(lf, max_iter=96, tol=3e-4)          # the card, float32
        log("%s likelihood: anchor pdf tensor %s (grid, sources, bins), "
            "n_max %d, built in %.1f s"
            % (label, tuple(study._pdf_tensor.shape), study.n_max,
               time.time() - t0))
    else:
        cls = api['BinnedToyStudy']
        study = cls(lf, max_iter=96, tol=3e-4)          # the card, float32
        log("%s likelihood: anchor tensor %s (grid, sources, bins), built in "
            "%.1f s" % (label, tuple(study.compiled.ps_tensor.shape),
                        time.time() - t0))
    check_on_card(label, study.compiled)
    rows = kernel_rows(label, study, mods)
    main_path(label, study, mods, rows)
    if label == 'xenon':
        replay_value_calls(study, mods, rows)
    two_precisions(label, study, cls)
    return rows


def roofline_part(mods):
    """Parts 4 and 5: the op-mix kernel against its plain version, the
    op-mix ceilings between reset and read of every counter, and the vgh
    kernels' roofline verdicts. Returns the op-mix kernel rows (row 17)."""
    roofline = mods['roofline']
    rows = []
    for kind, mix in roofline.MIXES.items():
        x, aux = roofline.op_mix_inputs(kind, roofline.op_mix_elements(kind),
                                        check=True)
        out = roofline.op_mix(kind, x, aux, 1, mix.check_eps)
        ref = roofline.op_mix_plain(kind, x, aux, 1, mix.unroll,
                                    mix.check_eps)
        torch.cuda.synchronize()
        scale = roofline.op_mix_scale(kind, x, aux, 1, mix.unroll,
                                      mix.check_eps)
        rel = float(((out.double() - ref.double()).abs() / scale).max())
        if not (rel <= 1e-5 and bool(torch.isfinite(out).all())):
            raise AssertionError("op mix %s disagrees with its plain version: "
                                 "%.3g of its terms' scale" % (kind, rel))
        log("roofline op-mix kernel %s, %d elements, one trip (%d steps) at "
            "eps %g: err %.3g of its terms' scale" % (
                kind, x.numel(), mix.unroll, mix.check_eps, rel))
        rows.append(dict(name='op_mix:%s' % kind, path='roofline',
                         route='cuda', source=CSRC + 'op_mix.cu',
                         replaces='blueice_tpu/utils/roofline.py:338',
                         library_ms=None,
                         max_abs_err=float((out - ref).abs().max()),
                         max_rel_err=rel))

    for module in mods.values():
        module.reset_launch_counts()
    record = roofline.op_mix_record()
    launches = {}
    for module in mods.values():
        launches.update(module.launch_counts())
    log("roofline kernel launches in the op-mix part: %s" % launches)
    if launches.pop('op_mix') != sum(
            d['launches'] for d in record['detail'].values()) or not all(
            d['launches'] > 0 for d in record['detail'].values()):
        raise AssertionError("roofline: the op-mix launch counter did not "
                             "count the op-mix part's launches")
    if any(launches.values()):
        raise AssertionError("roofline: a fit kernel launched in the op-mix "
                             "part")

    for row, (kind, mix) in zip(rows, roofline.MIXES.items()):
        d = record['detail'][kind]
        x, aux = roofline.op_mix_inputs(kind, d['elements'])
        plain_ms = cuda_ms(lambda: roofline.op_mix_plain(
            kind, x, aux, d['reps'], mix.unroll, d['eps']), runs=1, warmup=0)
        flops = float(mix.charge * mix.unroll * d['elements'] * d['reps'])
        nbytes = 4 * d['elements'] * (2 + mix.n_aux)
        bound_ms, bound_by = roofline.bound(nbytes, flops)
        row.update(launches=d['launches'], ms=1e3 * d['t_single_s'],
                   ms_double=1e3 * d['t_double_s'], plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   gflops=d['gflops_achieved'],
                   frac_of_fp32=d['frac_of_nominal_fp32'], reps=d['reps'],
                   elements=d['elements'], threads=d['threads'])
        log("roofline op mix %-7s %d elements (%d blocks of 256 threads, %d "
            "each), %d trips x %d steps: t(r) %.4f ms, t(2r) %.4f ms, %.1f "
            "GFLOP/s charged, %.4f of the fp32 peak; bound %.4f ms (%s: "
            "%.3f GFLOP, %.1f MB); plain %.1f ms; %d launches"
            % (kind, d['elements'], d['grid'], d['V'], d['reps'], mix.unroll,
               row['ms'], row['ms_double'], d['gflops_achieved'],
               d['frac_of_nominal_fp32'], bound_ms, bound_by, flops / 1e9,
               nbytes / 1e6, plain_ms, d['launches']))
    log("roofline op-mix record: %s" % json.dumps(
        {k: v for k, v in record.items() if k != 'detail'}))

    verdicts = roofline.roofline_record()['kernels']
    for line in roofline.format_report(verdicts).splitlines():
        log("roofline " + line)
    for v in verdicts:
        log("roofline %s: kernel alone %.4f ms (L2-cold %.4f, %d input "
            "copies), wrapper %.4f ms, bound %.4f ms (%s), %.4f (cold %.4f) "
            "of the fp32 peak, %.4f (cold %.4f) of HBM" % (
                v['kernel'], 1e3 * v['elapsed_s'], 1e3 * v['elapsed_cold_s'],
                v['copies'], 1e3 * v['dispatch_s'],
                1e3 * max(v['t_compute_s'], v['t_hbm_s']), v['binding'],
                v['frac_of_compute_roof'], v['frac_of_compute_roof_cold'],
                v['frac_of_hbm_roof'], v['frac_of_hbm_roof_cold']))
        if v['frac_of_hbm_roof_cold'] > 1.0:
            raise AssertionError("roofline %s: an L2-cold HBM share above "
                                 "100%%: its inputs stayed in L2"
                                 % v['kernel'])
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from blueice_tpu_torch import likelihood, test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import (fused, fused_bb, fused_bb_lite,
                                       fused_unbinned)
    from blueice_tpu_torch.parallel import BinnedToyStudy, UnbinnedToyStudy
    from blueice_tpu_torch.utils import roofline, set_progress

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_progress(False)
    log(roofline.card_line())
    log("torch %s, CUDA %s, device %s" % (torch.__version__,
                                          torch.version.cuda,
                                          torch.cuda.get_device_name(0)))
    mods = dict(fused=fused, fused_bb=fused_bb, fused_bb_lite=fused_bb_lite,
                fused_unbinned=fused_unbinned, roofline=roofline)
    api = dict(xenon_like=xenon_like, test_helpers=test_helpers,
               likelihood=likelihood, BinnedToyStudy=BinnedToyStudy,
               UnbinnedToyStudy=UnbinnedToyStudy)
    t0 = time.time()
    libs = fused.build_libraries([m.SOURCE for m in mods.values()])
    for module in mods.values():
        module.load_library()
    log("kernel build + load (%d sources in parallel): %.1f s"
        % (len(libs), time.time() - t0))
    for line in ptxas_report(libs):
        log("ptxas " + line)
    for line in sass_census(dict(zip(mods, libs))['roofline']):
        log("sass " + line)

    rows = []
    for label in PATHS:
        rows += run_path(label, mods, api)
    t0 = time.time()
    rows += roofline_part(mods)
    log("roofline part: %.1f s" % (time.time() - t0))

    log(roofline.card_line())
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
