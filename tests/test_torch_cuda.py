"""The port's CUDA kernels (the binned, Beeston-Barlow, bb-lite and
unbinned contracts, and the op-mix probe) against their plain PyTorch
versions on the card.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. On a
GPU machine: ``python -m pytest tests/test_torch_cuda.py -m cuda``. This
file imports no jax, so it runs where JAX is not installed.

Tolerances (float32 on the card, different summation orders): ll relative
1e-5; g and H within 1e-4 of each toy's largest entry; op mixes within 1e-5
of each element's term scale (``roofline.op_mix_scale``).
"""

import numpy as np
import pytest
import torch

from blueice_tpu_torch.ops import fused, fused_bb, fused_bb_lite, fused_unbinned
from blueice_tpu_torch.utils import roofline

S, N, B, A = 3, 300, 16, 7
BB_I = 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device('cuda')


def _inputs(K, device, seed=0):
    rng = np.random.default_rng(seed + K)
    grid = (3,) * K
    G = int(np.prod(grid)) if K else 1

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    anchor = f32(rng.random((G, S, N)) + 0.01)
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    observed = f32(rng.poisson(30.0, (B, N)))
    vgh = (torch.as_tensor(rng.integers(0, 2, (B, K)), device=device),
           f32(rng.random((B, K))), f32(rng.random((B, S)) * 10 + 1))
    ll = (torch.as_tensor(rng.integers(0, 2, (B, A, K)), device=device),
          f32(rng.random((B, A, K))), f32(rng.random((B, A, S)) * 10 + 1))
    return anchor, strides, observed, vgh, ll


def _rel_to_toy_max(a, b):
    scale = b.abs().flatten(1).max(1).values.reshape(
        (-1,) + (1,) * (b.dim() - 1))
    return float(((a - b).abs() / scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
def test_vgh_kernel_matches_plain(cuda_device, K):
    anchor, strides, observed, (idx, t, m), _ = _inputs(K, cuda_device)
    args = (anchor, strides, idx, t, m, observed)
    fused.reset_launch_counts()
    out = fused.binned_vgh_fused(*args)
    ref = fused.binned_vgh_plain(*args)
    torch.cuda.synchronize()
    assert fused.launch_counts()['binned_vgh_fused'] == 1
    np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), rtol=1e-5)
    assert _rel_to_toy_max(out[1], ref[1]) < 1e-4
    assert _rel_to_toy_max(out[2], ref[2]) < 1e-4
    # fixed-order reductions: a rerun is bit-identical
    again = fused.binned_vgh_fused(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
def test_value_kernel_matches_plain(cuda_device, K):
    anchor, strides, observed, _, (idx, t, m) = _inputs(K, cuda_device)
    args = (anchor, strides, idx, t, m, observed)
    fused.reset_launch_counts()
    out = fused.binned_ll_fused_multi(*args)
    ref = fused.binned_ll_plain(*args)
    torch.cuda.synchronize()
    assert fused.launch_counts()['binned_ll_fused_multi'] == 1
    np.testing.assert_allclose(out.cpu(), ref.cpu(), rtol=1e-5)


#: The value kernel's cases: name -> (S, K, N, B, A, candidates). It loads
#: a grid cell's corner rows once for all of the toy's candidates in that
#: cell (equal corner-id tuples, clamped ones included), splits a toy's
#: bins over a cluster of up to 8 blocks and, with few toys, its candidates
#: over several blocks.
VALUE_CASES = {
    'shared_corners': (6, 4, 3100, 16, 12, 'shared'),
    'rate_only': (6, 4, 3100, 16, 20, 'rate_only'),
    'clamped_duplicates': (6, 4, 300, 16, 12, 'edge'),
    'union_all_rows_K4': (6, 4, 3100, 8, 16, 'all_cells'),
    'union_all_rows_K2': (3, 2, 300, 8, 4, 'all_cells'),
    'A1': (6, 4, 3100, 64, 1, 'random'),
    'A20': (6, 4, 3100, 64, 20, 'random'),
    'A33': (6, 4, 3100, 16, 33, 'random'),
    'B1_many_ranges': (6, 4, 3100, 1, 12, 'random'),
    'K0': (6, 0, 3100, 16, 12, 'random'),
    'S8_K4': (8, 4, 1000, 16, 12, 'random'),
    'N_odd': (6, 4, 301, 16, 12, 'random'),
}


def _value_case(S_, K, N_, B_, A_, kind, device, seed=0):
    rng = np.random.default_rng(seed)
    grid = (3,) * K
    G = int(np.prod(grid)) if K else 1
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    anchor = rng.random((G, S_, N_)) + 0.01
    observed = rng.poisson(30.0, (B_, N_))
    idx = rng.integers(0, 2, (B_, A_, K))
    t = rng.random((B_, A_, K))
    m = rng.random((B_, A_, S_)) * 10 + 1
    if kind in ('shared', 'rate_only'):
        idx[:] = idx[:, :1]
        if kind == 'rate_only':
            t[:] = t[:, :1]
    elif kind == 'edge':
        # lower corners on the grid's last cell: corner_ids clamps the
        # corners past the end onto the last row, so a candidate names it
        # several times
        idx[:, ::2] = 2
        idx[:, 1::2, 0] = 2
    elif kind == 'all_cells':
        # every cell of the grid: the toy's union is all G rows
        idx[:] = np.array(list(np.ndindex((2,) * K)))[None]

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return (f32(anchor), strides, torch.as_tensor(idx, device=device),
            f32(t), f32(m), f32(observed))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(VALUE_CASES))
def test_value_kernel_cases(cuda_device, case):
    S_, K, N_, B_, A_, kind = VALUE_CASES[case]
    args = _value_case(S_, K, N_, B_, A_, kind, cuda_device)
    anchor, strides, idx = args[:3]
    ids = fused.corner_ids(strides, idx, anchor.shape[0])
    if kind == 'edge':
        srt = ids.sort(-1).values
        assert bool((srt[..., 1:] == srt[..., :-1]).any())
    if kind == 'all_cells':
        for toy in ids:
            assert toy.unique().numel() == anchor.shape[0]
    fused.reset_launch_counts()
    out = fused.binned_ll_fused_multi(*args)
    ref = fused.binned_ll_plain(*args)
    torch.cuda.synchronize()
    assert fused.launch_counts()['binned_ll_fused_multi'] == 1
    assert out.shape == (B_, A_)
    np.testing.assert_allclose(out.cpu(), ref.cpu(), rtol=1e-5)
    # fixed-order sums, no float atomics: a rerun is bit-identical
    again = fused.binned_ll_fused_multi(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_kernels_refuse_float64_and_out_of_range(cuda_device):
    anchor, strides, observed, (idx, t, m), _ = _inputs(2, cuda_device)
    with pytest.raises(TypeError):
        fused.binned_vgh_fused(anchor.double(), strides, idx, t.double(),
                               m.double(), observed.double())
    big = torch.zeros((9, 9, N), device=cuda_device)
    with pytest.raises(ValueError):
        fused.binned_vgh_fused(big, strides, idx, t,
                               torch.ones((B, 9), device=cuda_device),
                               observed)


def _count_rows(K, device, seed=0):
    """MC-count anchor rows (G, N) with an empty-MC bin, and pmf anchors
    with a U == 0 bin and an inert bin for source BB_I."""
    rng = np.random.default_rng(100 + seed + K)
    anchor, strides, observed, vgh, ll = _inputs(K, device, seed)
    G = anchor.shape[0]
    nme = rng.uniform(0.5, 40.0, (G, N))
    nme[:, 5] = 0.0
    anchor[:, [s for s in range(S) if s != BB_I], 7] = 0.0
    anchor[:, BB_I, 9] = 0.0
    nme = torch.as_tensor(nme, dtype=torch.float32, device=device)
    return anchor, nme, strides, observed, vgh, ll


BB_MODES = {
    'bb': (fused_bb, fused_bb.binned_bb_vgh_fused,
           fused_bb.binned_bb_vgh_plain, fused_bb.binned_bb_ll_fused_multi,
           fused_bb.binned_bb_ll_plain, (BB_I,)),
    'bblite': (fused_bb_lite, fused_bb_lite.binned_bblite_vgh_fused,
               fused_bb_lite.binned_bblite_vgh_plain,
               fused_bb_lite.binned_bblite_ll_fused_multi,
               fused_bb_lite.binned_bblite_ll_plain, ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("mode", sorted(BB_MODES))
def test_bb_vgh_kernels_match_plain(cuda_device, mode, K):
    module, kernel, plain, _, _, extra = BB_MODES[mode]
    anchor, nme, strides, observed, (idx, t, m), _ = _count_rows(
        K, cuda_device)
    args = (anchor, nme, strides, idx, t, m, observed) + extra
    module.reset_launch_counts()
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert module.launch_counts()['binned_%s_vgh_fused' % mode] == 1
    np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), rtol=1e-5)
    assert _rel_to_toy_max(out[1], ref[1]) < 1e-4
    assert _rel_to_toy_max(out[2], ref[2]) < 1e-4
    again = kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("mode", sorted(BB_MODES))
def test_bb_value_kernels_match_plain(cuda_device, mode, K):
    module, _, _, kernel, plain, extra = BB_MODES[mode]
    anchor, nme, strides, observed, _, (idx, t, m) = _count_rows(
        K, cuda_device)
    args = (anchor, nme, strides, idx, t, m, observed) + extra
    module.reset_launch_counts()
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert module.launch_counts()['binned_%s_ll_fused_multi' % mode] == 1
    np.testing.assert_allclose(out.cpu(), ref.cpu(), rtol=1e-5)
    assert torch.equal(out, kernel(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(BB_MODES))
def test_bb_kernels_refuse_bad_inputs(cuda_device, mode):
    _, kernel, _, value, _, extra = BB_MODES[mode]
    anchor, nme, strides, observed, (idx, t, m), (ci, ct, cm) = _count_rows(
        2, cuda_device)
    with pytest.raises(TypeError):
        kernel(anchor.double(), nme.double(), strides, idx, t.double(),
               m.double(), observed.double(), *extra)
    with pytest.raises(ValueError, match='nme'):
        kernel(anchor, nme[:, :-1], strides, idx, t, m, observed, *extra)
    with pytest.raises(ValueError, match='contiguous'):
        value(anchor, nme.t().contiguous().t(), strides, ci, ct, cm,
              observed, *extra)
    if mode == 'bb':
        with pytest.raises(ValueError, match='bb_i'):
            kernel(anchor, nme, strides, idx, t, m, observed, S)


# Unbinned: name -> (anchor grid, S); the block shape of the Gaussian model
# (G = 3) and a gather shape (G = 25), plus K = 0
UNBINNED = {'block': ((3,), 2), 'gather': ((5, 5), 3), 'constant': ((), 2)}
UB, UE, UA = 7, 700, 5
U_LANES = [4, 0, 6, 2]


def _unbinned_inputs(case, outlier, device, seed=0):
    """(vgh args, value args) of the unbinned wrappers: masked tails, events
    of zero and of negative summed density (valid only with an outlier
    floor), centered, on a lane subset in a non-trivial order."""
    grid, S_ = UNBINNED[case]
    K = len(grid)
    G = int(np.prod(grid)) if K else 1
    rng = np.random.default_rng(seed + 3 * K + S_)
    ps = rng.uniform(0.001, 0.4, (UB, G, S_, UE))
    mask = np.arange(UE)[None, :] < rng.integers(UE // 2, UE - 10, UB)[:, None]
    bad = [0, 1] if outlier else [UE - 2, UE - 1]
    ps[:, :, :, bad[0]] = 0.0
    ps[:, :, 0, bad[1]] = -50.0
    inv_ref = np.where(mask, rng.uniform(0.5, 2.0, (UB, UE)), 1.0)
    ref_msum = rng.uniform(500, 3000, UB)
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    L = len(U_LANES)
    hi = max(grid) - 1 if K else 1

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    lanes = torch.as_tensor(U_LANES, dtype=torch.int64, device=device)
    common = (f32(ps), strides, lanes)
    tail = (torch.as_tensor(mask, device=device), f32(inv_ref))
    m = rng.uniform(100, 2000, (L, S_))
    vgh = common + (torch.as_tensor(rng.integers(0, hi, (L, K)),
                                    device=device),
                    f32(rng.uniform(0, 1, (L, K))), f32(m)) + tail + (
        f32(m.sum(-1) - ref_msum[U_LANES]), outlier)
    mc = rng.uniform(100, 2000, (L, UA, S_))
    ll = common + (torch.as_tensor(rng.integers(0, hi, (L, UA, K)),
                                   device=device),
                   f32(rng.uniform(0, 1, (L, UA, K))), f32(mc)) + tail + (
        f32(mc.sum(-1) - ref_msum[U_LANES][:, None]), outlier)
    return vgh, ll


@pytest.mark.cuda
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("case", sorted(UNBINNED))
def test_unbinned_vgh_kernel_matches_plain(cuda_device, case, outlier):
    args, _ = _unbinned_inputs(case, outlier, cuda_device)
    fused_unbinned.reset_launch_counts()
    out = fused_unbinned.unbinned_vgh_fused(*args)
    ref = fused_unbinned.unbinned_vgh_plain(*args)
    torch.cuda.synchronize()
    assert fused_unbinned.launch_counts()['unbinned_vgh_fused'] == 1
    assert torch.isfinite(out[0]).all()
    np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), rtol=1e-5)
    assert _rel_to_toy_max(out[1], ref[1]) < 1e-4
    assert _rel_to_toy_max(out[2], ref[2]) < 1e-4
    again = fused_unbinned.unbinned_vgh_fused(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("case", sorted(UNBINNED))
def test_unbinned_value_kernel_matches_plain(cuda_device, case, outlier):
    _, args = _unbinned_inputs(case, outlier, cuda_device, seed=1)
    fused_unbinned.reset_launch_counts()
    out = fused_unbinned.unbinned_ll_fused_multi(*args)
    ref = fused_unbinned.unbinned_ll_plain(*args)
    torch.cuda.synchronize()
    assert fused_unbinned.launch_counts()['unbinned_ll_fused_multi'] == 1
    assert out.shape == (len(U_LANES), UA) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.cpu(), ref.cpu(), rtol=1e-5)
    assert torch.equal(out, fused_unbinned.unbinned_ll_fused_multi(*args))


@pytest.mark.cuda
def test_unbinned_kernels_refuse_bad_inputs(cuda_device):
    vgh, ll = _unbinned_inputs('gather', 1e-12, cuda_device)
    as64 = [a.double() if torch.is_tensor(a) and a.is_floating_point() else a
            for a in vgh]
    with pytest.raises(TypeError):
        fused_unbinned.unbinned_vgh_fused(*as64)
    bad = list(vgh)
    bad[7] = vgh[7].t().contiguous().t()               # inv_ref, strided
    with pytest.raises(ValueError, match='contiguous'):
        fused_unbinned.unbinned_vgh_fused(*bad)
    bad = list(ll)
    bad[0] = ll[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match='contiguous'):
        fused_unbinned.unbinned_ll_fused_multi(*bad)


# The op-mix probe: a ragged element count (three full blocks and a partial
# one) checks the masked edge
MIX_N = 256 * 4 * 3 + 17


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("kind", sorted(roofline.MIXES))
def test_op_mix_kernel_matches_plain(cuda_device, kind, reps):
    mix = roofline.MIXES[kind]
    x, aux = roofline.op_mix_inputs(kind, MIX_N, device=cuda_device,
                                    check=True)
    roofline.reset_launch_counts()
    out = roofline.op_mix(kind, x, aux, reps, mix.check_eps)
    ref = roofline.op_mix_plain(kind, x, aux, reps, mix.unroll, mix.check_eps)
    torch.cuda.synchronize()
    assert roofline.launch_counts()['op_mix'] == 1
    assert torch.isfinite(out).all()
    scale = roofline.op_mix_scale(kind, x, aux, reps, mix.unroll,
                                  mix.check_eps)
    assert float(((out.double() - ref.double()).abs() / scale).max()) <= 1e-5
    # the timing nudge leaves the values where they were
    if kind != 'fma':
        assert torch.equal(roofline.op_mix(kind, x, aux, reps, 1e-30), x)


@pytest.mark.cuda
def test_op_mix_refuses_bad_inputs(cuda_device):
    x, aux = roofline.op_mix_inputs('bblite', MIX_N, device=cuda_device)
    with pytest.raises(TypeError):
        roofline.op_mix('bblite', x.double(), [a.double() for a in aux], 1,
                        1.0)
    strided = torch.stack([x, x], dim=1)[:, 0]
    with pytest.raises(ValueError, match='contiguous'):
        roofline.op_mix('bblite', strided, aux, 1, 1.0)
    with pytest.raises(ValueError, match='aux'):
        roofline.op_mix('bblite', x.cpu(), aux, 1, 1.0)
    with pytest.raises(ValueError, match='unknown op mix'):
        roofline.op_mix('exp', x, aux, 1, 1.0)


@pytest.mark.cuda
def test_measure_binned_kernel_times_the_kernel_alone(cuda_device):
    v = roofline.measure_binned_kernel(G=4, S=2, N=128, K=2, B=8)
    assert 0 < v['elapsed_s'] < v['dispatch_s']
    assert v['binding'] in ('compute', 'hbm')
    assert v['kernel'] == 'binned_vgh_fused(G=4,S=2,N=128,K=2)'
    assert roofline.format_report([v]).count('\n') == 1


@pytest.mark.cuda
def test_measure_unbinned_kernel_counts_the_rows_it_reads(cuda_device):
    # a 3^4 grid: each toy reads its 16 corner rows, not all 81
    v = roofline.measure_unbinned_kernel(G=81, S=6, E=256, K=4, B=8)
    assert 0 < v['elapsed_s'] < v['dispatch_s']
    cost = roofline.unbinned_vgh_cost(81, 6, 256, 4)
    per_toy = cost['hbm_bytes'] - 4 * 81 * 6 * 256 + 4 * 16 * 6 * 256
    assert v['gbps_hbm_achieved'] == pytest.approx(
        8 * per_toy / v['elapsed_s'] / 1e9)
