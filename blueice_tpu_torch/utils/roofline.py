"""Roofline accounting for the fit kernels on an NVIDIA GPU, and the op-mix
probe (a hand-written CUDA kernel).

Counterpart of :mod:`blueice_tpu.utils.roofline`, with the same public
names: per-kernel flop and byte cost models (the reference's formulas, so a
verdict counts the same work whatever implements it; the verdicts count
their corner combine as the corner tree does it, :func:`tree_flops`, the
least of the port's combines), the card's peaks, a
microbenchmark per fit kernel that times the kernel alone at ensemble batch
size and reports its achieved rates as fractions of the binding roof, and
:func:`measure_op_mix`, the rate a kernel's per-bin op mix reaches on the
card when memory plays no part (``csrc/op_mix.cu``, with its plain PyTorch
version :func:`op_mix_plain` beside it).

Only the cost models, :func:`work` / :func:`bound`, the verdict,
:func:`format_report`, :func:`op_cost` and the plain mixes run on the CPU.
Every measuring function needs a CUDA device and raises ``RuntimeError``
without one: a CPU timing is no device metric.

Peaks (``PEAKS['h100-sxm']``, NVIDIA's H100 SXM data sheet, dense, at the
full 700 W power limit): HBM3 3.35 TB/s, float32 on the CUDA cores 67
TFLOP/s (the fit kernels' roof: they use no tensor cores), TF32 and bf16 on
the tensor cores 495 and 989 TFLOP/s. A card capped below 700 W reaches
less; :func:`card_line` reads the cap.
"""

import collections
import ctypes
import functools
import math
import os
import subprocess

import numpy as np
import torch

from ..ops import fused

__all__ = ['PEAKS', 'binned_vgh_cost', 'bb_vgh_cost', 'bblite_vgh_cost',
           'unbinned_vgh_cost', 'tree_flops', 'op_cost', 'work', 'bound',
           'distinct_rows',
           'card_line', 'launch_elapsed_s', 'roofline_verdict',
           'measure_binned_kernel', 'measure_bb_kernel',
           'measure_bblite_kernel', 'measure_unbinned_kernel',
           'measure_unbinned_jnp', 'MIXES', 'op_mix', 'op_mix_launcher',
           'op_mix_plain', 'op_mix_scale', 'op_mix_inputs',
           'op_mix_elements', 'measure_op_mix', 'format_report',
           'roofline_record', 'op_mix_record', 'load_library',
           'launch_counts', 'reset_launch_counts', 'row_events',
           'L2_BYTES', 'l2_copies', 'cold_launches']

PEAKS = {
    'h100-sxm': dict(hbm_gbps=3.35e12, fp32=67e12, tf32_tc=495e12,
                     bf16_tc=989e12),
    # The reference's 1-core host entry under the port's keys, so the
    # verdict logic can be held against the JAX package on equal numbers
    'cpu-1core': dict(hbm_gbps=2e10, fp32=5e10, tf32_tc=5e10, bf16_tc=5e10),
}

SOURCE = os.path.join(fused.CSRC_DIR, 'op_mix.cu')
#: Launches in the CUDA graph that :func:`launch_elapsed_s` replays
N_INNER = 20
#: The H100's L2 cache (bytes), which :func:`l2_copies` outgrows
L2_BYTES = 50 * 2 ** 20
#: Timed runs (CUDA-event windows) a measurement takes the median of
RUNS = 5
#: The op-mix nudge when timing: below float32 resolution, so the values
#: stay put, yet a runtime value the compiler cannot fold
TIMING_EPS = 1e-30
#: The least time of one op-mix launch at the ``reps`` it is timed at (s)
TARGET_S = 0.01
#: The reference's op-mix block, which the probe's inputs tile
BLOCK = (64, 512)


def _pairs(K):
    return K * (K - 1) // 2


# -- cost models (the reference's formulas) ----------------------------------

def binned_vgh_cost(G, S, N, K, dtype_bytes=4):
    """Per-toy FLOPs / bytes of one fused binned (ll, g, H) kernel call.
    Dominant terms only (elementwise transcendental ops counted as 1 flop).

    The TPU model holds the anchor tensor in VMEM, so the per-toy HBM here
    excludes it; on the GPU the anchor rows come through L2, and the
    measuring functions add the bytes of the rows a call touches once per
    call (``roofline_verdict(call_bytes=...)``).

    :return: dict(flops, hbm_bytes, vmem_bytes) per toy per invocation.
    """
    C = 2 ** K
    NP = _pairs(K)
    acc = 1 + K + NP                 # accumulated corner-combine targets
    P = S + K
    flops = N * (
        2 * C * acc * S              # corner gather+lerp (FMA = 2 flops)
        + 2 * S + 12                 # lam + residual elementwise chain
        + 2 * S                      # g_m
        + 2 * K * S + 2 * K          # Dbar + g_t
        + 2 * S * S + S              # H_mm (+ Pq scale)
        + 4 * S * K + 2 * K * S      # H_mt (dot + D*r reduction)
        + 2 * K * K + K              # H_tt
        + NP * (2 * S + 2))          # cross-pair reductions
    # Per-toy HBM: inputs (ids, weights, m, obs) + outputs (ll, g, H)
    hbm = dtype_bytes * (N + C * (2 + K + NP) + S + 1 + P + P * P)
    # On-chip reads: C corner rows for each accumulation target + the
    # working arrays
    vmem = dtype_bytes * N * S * (C * acc + 4 * acc + 2 * S + 2 * K)
    return dict(flops=flops, hbm_bytes=hbm, vmem_bytes=vmem)


def bb_vgh_cost(G, S, N, K, dtype_bytes=4):
    """Per-toy FLOPs / bytes of one fused Beeston-Barlow (ll, g, H) call.
    Adds to the plain binned cost: the count-row corner combine (one extra
    pseudo-source), ~200 flops/bin of closed-form per-bin root derivatives
    (ops/bb_vgh.py:bb_lam_parts), the 5-input chain-rule assembly, and ~19
    (v, w) Hessian outer-product contractions. Anchors as in
    :func:`binned_vgh_cost`."""
    C = 2 ** K
    NP = _pairs(K)
    acc = 1 + K + NP
    P = S + K
    flops = N * (
        2 * C * acc * (S + 1)        # pmf + bb-count corner combine
        + 2 * S + 2                  # U, T reductions
        + 200                        # bb_lam_parts closed forms per bin
        + 2 * 5 * P                  # dlam = sum_v gam_v * Gv
        + 2 * P * P                  # -q dlam dlam^T
        + 19 * (P + 2 * P * P) / 4   # om (v,w) contractions (sparse Gv rows:
                                     # ~1/4 of entries are nonzero)
        + 2 * K * S + NP * 8)        # T2 extras
    hbm = dtype_bytes * (N + C * (2 + K + NP) + S + 1 + P + P * P)
    vmem = dtype_bytes * N * (S + 1) * (C * acc + 6 * acc + 3 * S)
    return dict(flops=flops, hbm_bytes=hbm, vmem_bytes=vmem)


def bblite_vgh_cost(G, S, N, K, dtype_bytes=4):
    """Per-toy FLOPs / bytes of one fused Barlow-Beeston-lite (ll, g, H)
    call. Adds to the plain binned cost: the total-count-row corner combine
    (one extra pseudo-source), ~40 flops/bin of per-bin lite closed forms
    (ops/bb_lite.py:_per_bin_parts), and the (lam, M) two-input Hessian
    outer products. Anchors as in :func:`binned_vgh_cost`."""
    C = 2 ** K
    NP = _pairs(K)
    acc = 1 + K + NP
    P = S + K
    flops = N * (
        2 * C * acc * (S + 1)        # pmf + total-count corner combine
        + 2 * S                      # lam reduction
        + 40                         # per-bin lite closed forms
        + 2 * K * S                  # Dbar
        + 2 * P + 2 * K              # g assembly
        + 2 * P * P + 4 * P * K + 2 * K * K + 3 * P  # H outer products
        + 2 * K * S + NP * (2 * S + 4))              # second-order extras
    hbm = dtype_bytes * (N + C * (2 + K + NP) + S + 1 + P + P * P)
    vmem = dtype_bytes * N * (S + 1) * (C * acc + 4 * acc + 2 * S + 2 * K)
    return dict(flops=flops, hbm_bytes=hbm, vmem_bytes=vmem)


def unbinned_vgh_cost(G, S, E, K, dtype_bytes=4):
    """Per-toy FLOPs / bytes of one fused unbinned (ll, g, H) call.
    Structurally the binned kernel over the event axis, except that the
    per-toy anchor tensor (G, S, E) itself streams from device memory every
    call (it is per-toy data), so it is in the per-toy bytes already."""
    c = binned_vgh_cost(G, S, E, K, dtype_bytes)
    c['hbm_bytes'] += dtype_bytes * (G * S * E + 2 * E)  # ps_toy + mask/invref
    return c


def tree_flops(K):
    """Float32 operations of the corner tree (``csrc/bt_ranges.cuh``
    ``corner_tree``) on one row of a cell's 2^K corners, to its value, its
    K differences and its K(K-1)/2 cross differences: the step on axis D
    halves 2^D pairs of each array it still holds (the value, the
    differences along the axes after D and their cross differences) by a
    subtraction and an FMA, 3 flops a pair. 93 at K = 4, where the
    corner-weight tables take 2^K (1 + K + K(K-1)/2) FMAs, 352 flops."""
    pairs = 0
    for D in range(K):
        after = K - 1 - D
        pairs += 2 ** D * (1 + after + after * (after - 1) // 2)
    return 3 * pairs


def _tree_cost(cost, N, K, rows):
    """A reference cost model's per-toy cost with its corner combine (the
    weight tables, 2^K (1 + K + K(K-1)/2) FMAs a row) counted as the corner
    tree does it (:func:`tree_flops`), ``rows`` rows a bin over N bins."""
    C = 2 ** K
    tables = 2 * C * (1 + K + _pairs(K))
    return dict(cost, flops=cost['flops'] - N * rows * (tables
                                                        - tree_flops(K)))


def op_cost(fn, *args):
    """(flops, bytes) of ``fn(*args)`` on torch tensors: flops as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (matrix
    products, convolutions, attention), bytes the tensor inputs and outputs
    counted once. Returns dict(flops, hbm_bytes), or None where the counter
    counts nothing."""
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    flops = counter.get_total_flops()
    if not flops:
        return None
    nbytes = sum(x.numel() * x.element_size()
                 for x in tree_leaves((args, out)) if torch.is_tensor(x))
    return dict(flops=float(flops), hbm_bytes=float(nbytes))


# -- the least time the card could take for one kernel call ------------------

def work(kind, S, K, lead, row_floats, data_bytes, items, mc_rows=False):
    """(bytes, float32 operations) that one kernel call must move and do.

    Bytes: each input read once and each output written once: the
    ``row_floats`` floats of the distinct corner rows the call's toys touch,
    the ``data_bytes`` of per-toy data (binned: the observed counts;
    unbinned: the event mask and the valid events' inv_ref), the per-call
    tables and the outputs. Operations: per bin or event (``items``, summed
    over the call's toys and candidates; unbinned, the valid events only,
    as the others add nothing) the corner combination (2 flops per FMA;
    vgh: by the corner tree, :func:`tree_flops`, as the four vgh kernels
    do it), the rate sum and the g / H accumulation;
    the logarithm, division and Beeston-Barlow root are not counted, so
    this is a lower bound.

    :param kind: 'vgh' or 'value'; lead: (B,) or (B, A).
    :param mc_rows: each corner also combines an MC-count row (bb, bb-lite).
    """
    C = 2 ** K
    NP = K * (K - 1) // 2
    P = S + K
    NH = P * (P + 1) // 2
    R = S + (1 if mc_rows else 0)          # rows combined per corner
    B = lead[0]
    calls = int(np.prod(lead))
    if kind == 'vgh':
        # the tree on each row; the pmf rows m-weighted into lambda, Dbar
        # and Xbar; g, H's outer product, D r and Xbar r
        per = R * tree_flops(K) + 2 * S * (1 + K + NP)
        per += 2 * P + 2 * NH + P + 2 * S * K + 2 * NP
        tables = calls * (C * (1 + K + NP) + S) * 4
        out = B * (1 + P + P * P) * 4
    else:
        per = C * R * 2 + 2 * S
        tables = calls * (2 * C + S) * 4
        out = calls * 4
    return row_floats * 4 + data_bytes + tables + out, float(per) * items


def bound(bytes_, flops, chip='h100-sxm'):
    """(ms, 'bytes' or 'operations'): the larger of bytes over the memory
    rate and float32 operations over the CUDA cores' rate."""
    peaks = PEAKS[chip]
    t_mem = bytes_ / peaks['hbm_gbps'] * 1e3
    t_ops = flops / peaks['fp32'] * 1e3
    return (t_mem, 'bytes') if t_mem >= t_ops else (t_ops, 'operations')


def distinct_rows(ids):
    """Distinct anchor ids a binned call reads (one anchor tensor shared by
    every toy)."""
    return int(ids.unique().numel())


# -- timers -----------------------------------------------------------------

def card_line():
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _require_cuda(what):
    if not torch.cuda.is_available():
        raise RuntimeError("%s measures on a CUDA device and none is "
                           "available (a CPU timing is no device metric)"
                           % what)


def _event_s(fn, warmup=2):
    """Median seconds of fn() over :data:`RUNS` calls, CUDA events around
    each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return float(np.median(times))


def launch_elapsed_s(launch, n_inner=N_INNER):
    """Seconds per launch of a kernel alone: ``n_inner`` calls of
    ``launch()`` (a launch on prepared tables and outputs, see the
    ``*_launcher`` functions of the ops modules) captured once in a CUDA
    graph, whose replay runs them back to back with no host work between
    them; the median over :data:`RUNS` replays of the replay's CUDA-event
    window over ``n_inner``. (Python launches between two events would time
    the host's launch rate for a kernel under ~30 us.) The capture adds
    ``n_inner`` to the wrapper's launch count; the replays add nothing.

    ``launch`` may be a list of launches: the graph then cycles over them
    in order (launch ``i`` is ``launch[i % len(launch)]``). One launch per
    copy of the inputs (:func:`cold_launches`) times the kernel on inputs
    that are out of the L2 cache; one launch per recorded call times a
    sequence of calls (``n_inner = len(launch)``)."""
    _require_cuda('launch_elapsed_s')
    launches = list(launch) if isinstance(launch, (list, tuple)) else [launch]
    for fn in launches:         # loads the kernels before the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inner):
            launches[i % len(launches)]()
    return _event_s(graph.replay, warmup=1) / n_inner


def l2_copies(nbytes):
    """Copies of a kernel's inputs (``nbytes`` each) that a cycle over them
    needs so that each launch finds its inputs evicted from the L2 cache:
    the other copies together move at least twice the cache. Inputs of
    that size or more evict themselves: one copy."""
    if nbytes >= 2 * L2_BYTES:
        return 1
    return 1 + int(math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def cold_launches(launcher, args):
    """``[launch, ...]`` of ``launcher(*args)`` (a ``*_launcher`` of the ops
    modules), one per copy of ``args`` (its tensors cloned, the first copy
    ``args`` itself), :func:`l2_copies` copies in all: hand it to
    :func:`launch_elapsed_s` for the kernel's time on inputs out of L2."""
    nbytes = sum(x.numel() * x.element_size() for x in args
                 if torch.is_tensor(x))
    copies = [tuple(args)] + [
        tuple(x.clone() if torch.is_tensor(x) else x for x in args)
        for _ in range(l2_copies(nbytes) - 1)]
    return [launcher(*c)[0] for c in copies]


# -- the verdict ------------------------------------------------------------

def roofline_verdict(per_call, elapsed, batch, chip='h100-sxm',
                     compute_peak='fp32', call_bytes=0.0):
    """Turn (per-toy cost, measured seconds, batch size) into the roofline
    verdict: achieved rates, the time each roof alone would take, which bound
    binds, and the fraction of that binding roof achieved. ``call_bytes``
    are bytes the call moves once, whatever its batch (the anchor rows its
    toys touch, on a GPU)."""
    peaks = PEAKS[chip]
    flops = per_call['flops'] * batch
    hbm = per_call['hbm_bytes'] * batch + call_bytes
    t_comp = flops / peaks[compute_peak]
    t_hbm = hbm / peaks['hbm_gbps']
    binding = 'compute' if t_comp >= t_hbm else 'hbm'
    t_bound = max(t_comp, t_hbm)
    out = dict(
        batch=batch, elapsed_s=elapsed,
        gflops_achieved=flops / elapsed / 1e9,
        gbps_hbm_achieved=hbm / elapsed / 1e9,
        intensity_flops_per_hbm_byte=flops / max(hbm, 1.0),
        compute_roof=compute_peak,
        t_compute_s=t_comp, t_hbm_s=t_hbm, binding=binding,
        frac_of_binding_roof=t_bound / elapsed,
        frac_of_compute_roof=(flops / elapsed) / peaks[compute_peak],
        frac_of_hbm_roof=(hbm / elapsed) / peaks['hbm_gbps'])
    return out


# -- fit-kernel microbenchmarks --------------------------------------------

def _common_setup(G, S, N, K, B, seed=0, device='cuda'):
    """The reference's inputs (same generator, seed and draws), as float32
    tensors (int64 corner indices) on ``device``."""
    rng = np.random.default_rng(seed)
    anchor = rng.uniform(0.01, 1.0, (G, S, N))
    grid_per_axis = max(2, int(round(G ** (1 / K)))) if K else 1
    strides = tuple(int(grid_per_axis ** (K - 1 - d)) for d in range(K))
    max_idx = max(grid_per_axis - 2, 0)
    idx_b = rng.integers(0, max_idx + 1, (B, K))
    t_b = rng.uniform(0, 1, (B, K))
    m_b = rng.uniform(1, 10, (B, S))
    obs_b = rng.poisson(3.0, (B, N))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return (f32(anchor), strides, torch.as_tensor(idx_b, device=device),
            f32(t_b), f32(m_b), f32(obs_b))


def _measure(wrapper, launcher, args, cost, batch, chip, n_inner, label,
             call_bytes=0.0):
    """Verdict of one kernel: ``dispatch_s`` a whole wrapper call,
    ``elapsed_s`` the kernel alone (see :func:`launch_elapsed_s`) on one
    input that stays in L2 between launches, and ``elapsed_cold_s`` on
    inputs out of L2 (:func:`cold_launches`), with the shares of the roofs
    that the cold time reaches (``*_cold``)."""
    dispatch_s = _event_s(lambda: wrapper(*args))
    launch, _ = launcher(*args)
    n_inner = n_inner or N_INNER
    elapsed = launch_elapsed_s(launch, n_inner)
    cold = cold_launches(launcher, args)
    elapsed_cold = launch_elapsed_s(cold, max(n_inner, len(cold)))
    v = roofline_verdict(cost, elapsed, batch, chip, call_bytes=call_bytes)
    vc = roofline_verdict(cost, elapsed_cold, batch, chip,
                          call_bytes=call_bytes)
    v.update(dispatch_s=dispatch_s, n_inner=n_inner, kernel=label,
             elapsed_cold_s=elapsed_cold, copies=len(cold),
             **{k + '_cold': vc[k] for k in ('frac_of_binding_roof',
                                             'frac_of_compute_roof',
                                             'frac_of_hbm_roof')})
    return v


def _anchor_bytes(strides, idx, G, N, rows_per_anchor):
    """Bytes of the distinct anchor rows a binned call's toys touch."""
    ids = fused.corner_ids(strides, idx, G)
    return float(distinct_rows(ids) * rows_per_anchor * N * 4)


def measure_binned_kernel(G=81, S=6, N=3200, K=3, B=1024, chip='h100-sxm',
                          n_inner=None):
    """Microbenchmark the binned vgh kernel (``binned_vgh_fused``) at
    ensemble batch size and return its roofline verdict. The reference's
    ``dense=`` has no counterpart: the port has one kernel per contract."""
    _require_cuda('measure_binned_kernel')
    args = _common_setup(G, S, N, K, B)
    return _measure(fused.binned_vgh_fused, fused.binned_vgh_launcher, args,
                    _tree_cost(binned_vgh_cost(G, S, N, K), N, K, S), B,
                    chip, n_inner,
                    'binned_vgh_fused(G=%d,S=%d,N=%d,K=%d)' % (G, S, N, K),
                    _anchor_bytes(args[1], args[2], G, N, S))


def measure_bb_kernel(G=81, S=6, N=3200, K=3, B=256, bb_i=0, chip='h100-sxm',
                      n_inner=None):
    """As :func:`measure_binned_kernel`, for ``binned_bb_vgh_fused``."""
    _require_cuda('measure_bb_kernel')
    from ..ops import fused_bb
    anchor, strides, idx, t, m, obs = _common_setup(G, S, N, K, B)
    rng = np.random.default_rng(1)
    nme = torch.as_tensor(rng.uniform(1, 40, (G, N)), dtype=torch.float32,
                          device=anchor.device)
    args = (anchor, nme, strides, idx, t, m, obs, bb_i)
    return _measure(fused_bb.binned_bb_vgh_fused,
                    fused_bb.binned_bb_vgh_launcher, args,
                    _tree_cost(bb_vgh_cost(G, S, N, K), N, K, S + 1), B,
                    chip, n_inner,
                    'binned_bb_vgh_fused(G=%d,S=%d,N=%d,K=%d)' % (G, S, N, K),
                    _anchor_bytes(strides, idx, G, N, S + 1))


def measure_bblite_kernel(G=81, S=6, N=3200, K=3, B=256, chip='h100-sxm',
                          n_inner=None):
    """As :func:`measure_binned_kernel`, for ``binned_bblite_vgh_fused``."""
    _require_cuda('measure_bblite_kernel')
    from ..ops import fused_bb_lite
    anchor, strides, idx, t, m, obs = _common_setup(G, S, N, K, B)
    rng = np.random.default_rng(1)
    nme_tot = torch.as_tensor(rng.uniform(1, 240, (G, N)),
                              dtype=torch.float32, device=anchor.device)
    args = (anchor, nme_tot, strides, idx, t, m, obs)
    return _measure(fused_bb_lite.binned_bblite_vgh_fused,
                    fused_bb_lite.binned_bblite_vgh_launcher, args,
                    _tree_cost(bblite_vgh_cost(G, S, N, K), N, K, S + 1),
                    B, chip, n_inner,
                    'binned_bblite_vgh_fused(G=%d,S=%d,N=%d,K=%d)'
                    % (G, S, N, K),
                    _anchor_bytes(strides, idx, G, N, S + 1))


def row_events(ids, events):
    """Events of the distinct corner rows an unbinned call reads: each
    (lane, anchor id) pair is a row of that lane's own toy, of which only
    the lane's ``events`` (L,) valid events are needed."""
    ids = ids.reshape(ids.shape[0], -1)
    G = int(ids.max()) + 1
    lane = torch.arange(ids.shape[0], device=ids.device)
    pairs = (lane[:, None] * G + ids).unique()
    return int(events[pairs // G].sum())


def measure_unbinned_kernel(G=3, S=2, E=2304, K=1, B=256, chip='h100-sxm',
                            n_inner=None):
    """As :func:`measure_binned_kernel`, for ``unbinned_vgh_fused`` on
    per-toy densities (B, G, S, E) over a K-dimensional grid of G^(1/K)
    anchors an axis (its true strides, random lower corners, as the
    reference's ``measure_unbinned_jnp`` builds them), every event valid,
    uncentered (inv_ref ones, the rate term sum m).

    The reference's per-toy bytes stream all G anchor rows of a toy (its
    dense engine did); this kernel gathers each toy's corner rows, so the
    verdict counts the distinct (toy, corner row) pairs the call reads
    (``call_bytes``) in place of the G rows."""
    _require_cuda('measure_unbinned_kernel')
    from ..ops import fused_unbinned
    g = max(2, int(round(G ** (1 / K)))) if K else 1
    if K and g ** K != G:
        raise ValueError("G=%d is not a K=%d-dim grid" % (G, K))
    strides = tuple(g ** (K - 1 - d) for d in range(K))
    rng = np.random.default_rng(2)
    dev = torch.device('cuda')

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    ps = f32(rng.uniform(0.001, 0.4, (B, G, S, E)))
    t = f32(rng.uniform(0, 1, (B, K)))
    m = f32(rng.uniform(100, 2000, (B, S)))
    idx = torch.as_tensor(rng.integers(0, max(g - 1, 1), (B, K)), device=dev)
    mask = torch.ones((B, E), dtype=torch.bool, device=dev)
    lanes = torch.arange(B, device=dev)
    inv_ref = torch.ones((B, E), dtype=torch.float32, device=dev)
    args = (ps, strides, lanes, idx, t, m, mask, inv_ref,
            m.sum(-1).contiguous())
    cost = _tree_cost(unbinned_vgh_cost(G, S, E, K), E, K, S)
    cost['hbm_bytes'] -= 4 * G * S * E
    rows = row_events(fused.corner_ids(strides, idx, G),
                      torch.full((B,), E, device=dev))
    return _measure(fused_unbinned.unbinned_vgh_fused,
                    fused_unbinned.unbinned_vgh_launcher, args, cost, B, chip,
                    n_inner,
                    'unbinned_vgh_fused(G=%d,S=%d,E=%d,K=%d)' % (G, S, E, K),
                    4.0 * S * rows)


def measure_unbinned_jnp(G=81, S=6, E=2048, K=4, B=64, chip='h100-sxm',
                         n_inner=None):
    """The reference's probe of its dense unbinned engine: the port's
    :func:`~blueice_tpu_torch.ops.unbinned_dense.unbinned_vgh_dense` on
    every toy of a (B, G, S, E) batch, one stacked (J, G) x (G, S*E)
    product a toy over the whole per-toy tensor, then the closed forms. The
    grid has its true per-axis strides (G^(1/K) anchors an axis, random
    lower corners), and the verdict counts ``unbinned_vgh_cost``'s stream
    of the whole tensor, as the reference's does; the products run in
    float32 with TF32 off. Timed as the other probes: a CUDA graph of
    ``n_inner`` calls between two CUDA events (the tensor outgrows the L2
    cache, so the cold time takes one copy). Labelled by what it runs,
    ``unbinned_vgh_dense(...)``: the reference labels it
    ``unbinned_vgh_jnp``."""
    _require_cuda('measure_unbinned_jnp')
    from ..ops.unbinned_dense import unbinned_vgh_dense
    g = max(2, int(round(G ** (1 / K)))) if K else 1
    if K and g ** K != G:
        raise ValueError("G=%d is not a K=%d-dim grid" % (G, K))
    strides = tuple(g ** (K - 1 - d) for d in range(K))
    rng = np.random.default_rng(3)
    dev = torch.device('cuda')

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = (f32(rng.uniform(0.001, 0.4, (B, G, S, E))), strides,
            torch.as_tensor(rng.integers(0, max(g - 1, 1), (B, K)),
                            device=dev),
            f32(rng.uniform(0, 1, (B, K))), f32(rng.uniform(100, 2000, (B, S))),
            torch.ones((B, E), dtype=torch.bool, device=dev))

    def launcher(*a):
        return (lambda: unbinned_vgh_dense(*a)), None
    return _measure(unbinned_vgh_dense, launcher, args,
                    unbinned_vgh_cost(G, S, E, K), B, chip, n_inner,
                    'unbinned_vgh_dense(G=%d,S=%d,E=%d,K=%d)' % (G, S, E, K))


# -- the op-mix probe (kernel #17) -----------------------------------------

Mix = collections.namedtuple('Mix', 'id unroll charge n_aux check_eps')
#: kind -> its id in op_mix.cu, unroll, the flops the reference's cost
#: models charge per element-step, the aux arrays it reads, and the nudge
#: at which the kernel is held to the plain version on the check inputs
#: (``op_mix_inputs(check=True)``): there every term of the mix moves the
#: result well above the float32 check, and the chain stays in its domain
#: for three loop trips (the bb-lite chain leaves it at a nudge of 1e-2).
MIXES = {'fma': Mix(0, 16, 2, 0, 1.0), 'bb': Mix(1, 1, 200, 5, 1.0),
         'bblite': Mix(2, 4, 40, 2, 3e-3), 'poisson': Mix(3, 4, 16, 1, 1.0)}


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the op-mix kernel library; declare its C
    signatures. Raises without CUDA or without nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("the op-mix CUDA kernel needs a CUDA device")
    lib = ctypes.CDLL(fused.build_library(SOURCE))
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.bt_op_mix.argtypes = [i, i, i, f] + [p] * 8
    lib.bt_op_mix.restype = i
    lib.bt_op_mix_blocks_per_sm.argtypes = [i]
    lib.bt_op_mix_blocks_per_sm.restype = i
    lib.bt_op_mix_elements_per_thread.argtypes = []
    lib.bt_op_mix_elements_per_thread.restype = i
    return lib


def _mix_step(kind, x, aux, eps):
    """One step of mix ``kind`` on x (the reference's step functions,
    ``roofline.py:276-309``)."""
    if kind == 'fma':
        return 1.0001 * x + 0.0001
    if kind == 'bb':
        from ..ops.bb_vgh import bb_lam_parts
        lam, dlam, om = bb_lam_parts(x, *aux)
        return x + eps * (lam + sum(dlam) + sum(om[k] for k in sorted(om)))
    if kind == 'bblite':
        from ..ops.bb_lite import _per_bin_parts
        parts = _per_bin_parts(x, aux[0], aux[1])
        return x + eps * (parts[0] + sum(parts[1:]))
    lam, d = x, aux[0]
    pos = lam > 0
    lam_safe = torch.where(pos, lam, 1.0)
    r = torch.where(pos, d * torch.log(lam_safe) - lam, 0.0)
    inv = torch.where(pos, d / lam_safe, 0.0)
    q = inv / lam_safe
    return lam + eps * (r + inv + q)


def _check_mix(kind, x, aux):
    if kind not in MIXES:
        raise ValueError("unknown op mix %r (one of %s)"
                         % (kind, ', '.join(MIXES)))
    n_aux = MIXES[kind].n_aux
    if len(aux) != n_aux:
        raise ValueError("mix %r takes %d aux arrays, got %d"
                         % (kind, n_aux, len(aux)))
    for a in aux:
        if a.shape != x.shape or a.device != x.device or a.dtype != x.dtype:
            raise ValueError("aux arrays must be %s %s on %s like x, got %s "
                             "%s on %s" % (tuple(x.shape), x.dtype, x.device,
                                           tuple(a.shape), a.dtype, a.device))


def op_mix_plain(kind, x, aux, reps, unroll, eps):
    """Plain PyTorch version of :func:`op_mix`: ``reps * unroll`` steps of
    mix ``kind`` on each element of x, the step written with the port's
    own per-bin functions (``ops.bb_vgh.bb_lam_parts``,
    ``ops.bb_lite._per_bin_parts``) and the poisson chain of the
    reference. ``eps`` scales the mix's terms into x (unused by 'fma')."""
    _check_mix(kind, x, aux)
    for _ in range(reps * unroll):
        x = _mix_step(kind, x, aux, eps)
    return x


def op_mix_scale(kind, x, aux, reps, unroll, eps):
    """Per element, the largest over the plain chain's steps (in float64)
    of the sum of the magnitudes of the summands of the step's new value
    (|x| + |eps| * sum |terms|; for 'fma', 1.0001 |x| + 0.0001): the scale
    of the float32 rounding of :func:`op_mix`'s result."""
    x = x.double()
    aux = [a.double() for a in aux]
    scale = x.abs()
    for _ in range(reps * unroll):
        scale = torch.maximum(scale, _step_magnitude(kind, x, aux, eps))
        x = _mix_step(kind, x, aux, eps)
    return torch.maximum(scale, x.abs())


def _mix_terms(kind, x, aux):
    """The summands that a step of mix ``kind`` (not 'fma') scales by eps
    and adds to x, each with its sign."""
    if kind == 'bb':
        from ..ops.bb_vgh import bb_lam_parts
        lam, dlam, om = bb_lam_parts(x, *aux)
        return [lam, *dlam, *(om[k] for k in sorted(om))]
    if kind == 'bblite':
        from ..ops.bb_lite import _per_bin_parts
        return list(_per_bin_parts(x, aux[0], aux[1]))
    pos, d = x > 0, aux[0]
    lam_safe = torch.where(pos, x, 1.0)
    return [torch.where(pos, t, 0.0) for t in (
        d * torch.log(lam_safe), -x, d / lam_safe, d / lam_safe ** 2)]


def _step_magnitude(kind, x, aux, eps):
    if kind == 'fma':
        return 1.0001 * x.abs() + 0.0001
    terms = _mix_terms(kind, x, aux)
    return x.abs() + abs(eps) * sum(t.abs() for t in terms)


def op_mix_launcher(kind, x, aux, reps, eps):
    """Checks of :func:`op_mix` for CUDA tensors, done once: returns
    ``(launch, out)``, where each ``launch()`` runs the kernel once on x
    into ``out`` (and counts the launch)."""
    _check_mix(kind, x, aux)
    if x.device.type != 'cuda':
        raise ValueError("op_mix launches on CUDA tensors, got %s" % x.device)
    if x.dtype != torch.float32:
        raise TypeError("the op-mix kernel takes float32, got %s" % x.dtype)
    if not all(a.is_contiguous() for a in (x,) + tuple(aux)):
        raise ValueError("the op-mix kernel takes contiguous tensors")
    if not 0 <= int(reps) < 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError("reps and the element count must fit an int")
    lib = load_library()
    kid = MIXES[kind].id
    out = torch.empty_like(x)
    ptrs = [a.data_ptr() for a in aux] + [None] * (5 - len(aux))

    def launch():
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.bt_op_mix(kid, x.numel(), int(reps), float(eps),
                                 x.data_ptr(), *ptrs, out.data_ptr(), stream)
        fused._launch_check(code, 'op-mix')
        op_mix.launches += 1
    return launch, out


def op_mix(kind, x, aux, reps, eps):
    """``reps * unroll`` steps of mix ``kind`` (:data:`MIXES`) on every
    element of x, its aux arrays (the same shape) held alongside; the
    kernel of ``csrc/op_mix.cu`` for CUDA tensors, the plain version
    :func:`op_mix_plain` for CPU tensors."""
    _check_mix(kind, x, aux)
    if x.device.type == 'cpu':
        return op_mix_plain(kind, x, aux, reps, MIXES[kind].unroll, eps)
    launch, out = op_mix_launcher(kind, x, aux, reps, eps)
    launch()
    return out


op_mix.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {'op_mix': op_mix.launches}


def reset_launch_counts():
    op_mix.launches = 0


def op_mix_inputs(kind, n, device='cuda', check=False):
    """x and the aux arrays of mix ``kind``, tiled to n float32 elements:
    the reference's pools (same generator, seed 9, and draws), or with
    ``check`` the pools the kernel is checked on. These differ for 'bblite'
    alone: the reference's MC totals (10-240) dwarf its lam (0.5-2), so
    f_M, H_lM and H_MM are ~1e-4 of a step and lie under a float32 check;
    totals of 0.1-3 and lam of 1-4 make every part count."""
    rng = np.random.default_rng(9)
    pools = dict(
        bb=[rng.uniform(1, 40, BLOCK), rng.uniform(0.0, 5.0, BLOCK),
            rng.uniform(10, 100, BLOCK), rng.uniform(100, 1000, BLOCK),
            rng.poisson(3.0, BLOCK).astype(np.float32)],
        bblite=[rng.uniform(10, 240, BLOCK),
                rng.poisson(3.0, BLOCK).astype(np.float32)],
        poisson=[rng.poisson(3.0, BLOCK).astype(np.float32)],
        fma=[])
    raw = [rng.uniform(0.5, 2.0, BLOCK)] + pools[kind]
    if check and kind == 'bblite':
        raw[:2] = [rng.uniform(1.0, 4.0, BLOCK), rng.uniform(0.1, 3.0, BLOCK)]
    out = [torch.as_tensor(np.resize(v.ravel(), n), dtype=torch.float32,
                           device=device) for v in raw]
    return out[0], out[1:]


def op_mix_elements(kind):
    """Elements that fill every SM of the card at the kernel's occupancy:
    SMs x resident blocks x 256 threads x elements per thread."""
    _require_cuda('op_mix_elements')
    lib = load_library()
    blocks = lib.bt_op_mix_blocks_per_sm(MIXES[kind].id)
    if blocks <= 0:
        raise RuntimeError("op-mix occupancy query failed (%d)" % blocks)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * blocks * 256 * lib.bt_op_mix_elements_per_thread()


def measure_op_mix(kind, chip='h100-sxm', reps=None):
    """Achievable float32 rate of mix ``kind`` with memory out of play: the
    register-resident loop of ``csrc/op_mix.cu`` over enough elements to
    fill the card, at the nudge :data:`TIMING_EPS`, timed at ``reps`` and
    ``2 * reps`` loop trips (median of :data:`RUNS` CUDA-event runs each;
    the difference cancels the launch). ``reps`` defaults to the trip count
    that makes one launch last at least :data:`TARGET_S`. The rate counts
    the flops the reference charges (:data:`MIXES`); a kernel near its
    mix's rate is done: the gap to the nominal roof is the price of its
    math (logs, divisions, square roots, selects), not of its schedule.

    :return: dict(kind, gflops_achieved, frac_of_nominal_fp32, ...)
    """
    _require_cuda('measure_op_mix')
    if kind not in MIXES:
        raise ValueError("unknown op mix %r" % (kind,))
    lib = load_library()
    unroll, charge = MIXES[kind].unroll, MIXES[kind].charge
    n = op_mix_elements(kind)
    x, aux = op_mix_inputs(kind, n)
    count0 = op_mix.launches

    def timed(r):
        return _event_s(op_mix_launcher(kind, x, aux, r, TIMING_EPS)[0],
                        warmup=1)

    if reps is None:
        probe = 64
        reps = max(probe, math.ceil(probe * 1.2 * TARGET_S / timed(probe)))
    t1, t2 = timed(reps), timed(2 * reps)
    elapsed = t2 - t1
    if not elapsed > 0:
        raise RuntimeError("op mix %r: t(2r) %.6g s <= t(r) %.6g s"
                           % (kind, t2, t1))
    flops = charge * unroll * n * reps
    gflops = flops / elapsed / 1e9
    V = lib.bt_op_mix_elements_per_thread()
    return dict(kind=kind, gflops_achieved=gflops,
                frac_of_nominal_fp32=gflops * 1e9 / PEAKS[chip]['fp32'],
                reps=reps, unroll=unroll, grid=n // (256 * V), block=256,
                t_single_s=t1, t_double_s=t2, flops_per_elem=charge,
                elements=n, threads=n // V, V=V, eps=TIMING_EPS,
                launches=op_mix.launches - count0, card=card_line())


# -- records ----------------------------------------------------------------

def format_report(verdicts):
    """Human-readable roofline table. 'disp ms' is one whole wrapper call
    (its tables and small ops, then the launch); GFLOP/s, GB/s and %roof
    come from the kernel alone."""
    lines = ["%-44s %9s %9s %8s %8s %8s %s" % (
        'kernel', 'GFLOP/s', 'HBM GB/s', 'AI', '%roof', 'disp ms', 'binding')]
    for v in verdicts:
        lines.append("%-44s %9.1f %9.2f %8.1f %7.1f%% %8.1f %s" % (
            v['kernel'], v['gflops_achieved'], v['gbps_hbm_achieved'],
            v['intensity_flops_per_hbm_byte'],
            100 * v['frac_of_binding_roof'],
            1e3 * v.get('dispatch_s', float('nan')), v['binding']))
    return "\n".join(lines)


def roofline_record():
    """Roofline verdicts of the vgh kernels on the card, at the reference's
    shapes (``bench.py`` ``roofline_record``), with the card's name and
    power limit. At the XENON shape it measures both the kernel the
    port's study runs there and, as the reference did, the dense unbinned
    engine (:func:`measure_unbinned_jnp`)."""
    _require_cuda('roofline_record')
    verdicts = [
        measure_binned_kernel(),
        measure_bb_kernel(),
        measure_bblite_kernel(),
        measure_unbinned_kernel(),
        measure_unbinned_kernel(G=81, S=6, E=2048, K=4, B=64),
        measure_unbinned_jnp(),
    ]
    return dict(chip='h100-sxm', card=card_line(), kernels=verdicts)


def op_mix_record():
    """Measured float32 ceilings of the fit kernels' per-bin op mixes
    (``bench.py`` ``bench_mix``), with the card's name and power limit."""
    _require_cuda('op_mix_record')
    mixes = {k: measure_op_mix(k) for k in MIXES}
    return {
        "metric": "measured float32 op-mix ceilings (GFLOP/s: fma / bb / "
                  "bblite / poisson)",
        "value": mixes['fma']['gflops_achieved'],
        "unit": "GFLOP/s (fma mix)",
        "vs_baseline": mixes['fma']['gflops_achieved']
        / max(mixes['bb']['gflops_achieved'], 1e-9),
        "detail": mixes,
        "card": card_line(),
    }
