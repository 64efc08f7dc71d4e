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


#: The value kernels' cases: name -> (S, K, N, B, A, candidates[, bb
#: source]). The three binned value kernels (binned, bb, bb-lite) load a
#: grid cell's corner rows once for all of the toy's candidates in that
#: cell (equal corner-id tuples, clamped ones included), split a toy's bins
#: over a cluster of up to 8 blocks and, with few toys or more than 64
#: candidates, its candidates over several blocks.
VALUE_CASES = {
    'shared_corners': (6, 4, 3100, 16, 12, 'shared'),
    'rate_only': (6, 4, 3100, 16, 20, 'rate_only'),
    'clamped_duplicates': (6, 4, 300, 16, 12, 'edge'),
    'union_all_rows_K4': (6, 4, 3100, 8, 16, 'all_cells'),
    'union_all_rows_K2': (3, 2, 300, 8, 4, 'all_cells'),
    'A1': (6, 4, 3100, 64, 1, 'random'),
    'A20': (6, 4, 3100, 64, 20, 'random'),
    'A33': (6, 4, 3100, 16, 33, 'random'),
    'A65_two_groups': (6, 4, 3100, 8, 65, 'random'),
    'B1_many_ranges': (6, 4, 3100, 1, 12, 'random'),
    'K0': (6, 0, 3100, 16, 12, 'random'),
    'S8_K4': (8, 4, 1000, 16, 12, 'random'),
    'N_odd': (6, 4, 301, 16, 12, 'random'),
}
#: Beeston-Barlow only: the finite source first and last (a runtime index)
BB_VALUE_CASES = {
    'bb_first_source': (6, 4, 3100, 16, 12, 'shared', 0),
    'bb_last_source': (6, 4, 3100, 16, 12, 'shared', 5),
}
VALUE_MODES = ('binned', 'bb', 'bblite')


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
    nme = rng.uniform(0.5, 40.0, (G, N_))
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
            f32(t), f32(m), f32(observed), f32(nme))


def _value_ops(mode, nme, bb_i):
    """(module, wrapper name, kernel, plain) of a binned value contract,
    each called as f(anchor, strides, idx, t, m, observed)."""
    if mode == 'binned':
        return (fused, 'binned_ll_fused_multi', fused.binned_ll_fused_multi,
                fused.binned_ll_plain)
    module = fused_bb if mode == 'bb' else fused_bb_lite
    name = 'binned_%s_ll_fused_multi' % mode
    extra = (bb_i,) if mode == 'bb' else ()

    def bind(fn):
        return lambda anchor, *rest: fn(anchor, nme, *rest, *extra)
    return (module, name, bind(getattr(module, name)),
            bind(getattr(module, 'binned_%s_ll_plain' % mode)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,case", [
    (mode, case) for mode in VALUE_MODES for case in sorted(VALUE_CASES)]
    + [('bb', case) for case in sorted(BB_VALUE_CASES)])
def test_value_kernel_cases(cuda_device, mode, case):
    S_, K, N_, B_, A_, kind, *bb = (VALUE_CASES.get(case)
                                    or BB_VALUE_CASES[case])
    anchor, strides, idx, t, m, observed, nme = _value_case(
        S_, K, N_, B_, A_, kind, cuda_device)
    args = (anchor, strides, idx, t, m, observed)
    module, name, kernel, plain = _value_ops(mode, nme,
                                             bb[0] if bb else BB_I)
    ids = fused.corner_ids(strides, idx, anchor.shape[0])
    if kind == 'edge':
        srt = ids.sort(-1).values
        assert bool((srt[..., 1:] == srt[..., :-1]).any())
    if kind == 'all_cells':
        for toy in ids:
            assert toy.unique().numel() == anchor.shape[0]
    module.reset_launch_counts()
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert module.launch_counts()[name] == 1
    assert out.shape == (B_, A_)
    np.testing.assert_allclose(out.cpu(), ref.cpu(), rtol=1e-5)
    # fixed-order sums, no float atomics: a rerun is bit-identical
    again = kernel(*args)
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


#: The binned vgh kernels' cases beyond K = 0..4 (S = 3, N = 300, B = 16),
#: for the three contracts (binned, Beeston-Barlow, bb-lite): name -> (S,
#: K, N, B, bb source). The kernels split a toy's bins over a cluster of up
#: to 8 blocks, as many as the batch needs to fill the card: one toy gets 7
#: ranges (B = 1, 3), a batch of more than five waves (B = 300, 5 ranges a
#: toy), fewer bins than a range's width (N = 37), the XENON shape; and
#: they combine the corner rows by lerp steps at lerp weights recovered from
#: the corner weights, which must keep the plain version's exact zeros of a
#: fit at an anchor (t = 0 or 1) and its precision next to one (t within
#: 1e-5 of 1 on every axis, where the weight tables' sum keeps a small
#: corner value's digits and a lerp from the far corner would not).
BB_VGH_CASES = {
    'B1': (6, 4, 3100, 1, 1),
    'B3': (6, 4, 3100, 3, 1),
    'B300': (6, 4, 3100, 300, 1),
    'N37': (6, 4, 37, 16, 1),
    'N3100': (6, 4, 3100, 16, 1),
    't_at_anchors': (6, 4, 300, 16, 1),
    't_near_one': (6, 4, 300, 16, 1),
}
VGH_MODES = ('binned', 'bb', 'bblite')
#: Beeston-Barlow only: the finite source first and last (a runtime index)
BB_ONLY_VGH_CASES = {
    'bb_first_source': (6, 4, 3100, 16, 0),
    'bb_last_source': (6, 4, 3100, 16, 5),
}


def _bb_vgh_case(case, mode, device, seed=0):
    """(args, module, kernel, plain) of a binned vgh case of contract
    ``mode`` (``VGH_MODES``): K = 0..4 (case '0'..'4') on ``_count_rows``'
    inputs, else a ``BB_VGH_CASES`` or ``BB_ONLY_VGH_CASES`` shape with, as
    there, an empty-MC bin, a bin where the other sources vanish (U == 0)
    and one where the finite source does. The binned contract takes no
    MC-count rows: its args leave them out."""
    if mode == 'binned':
        module, kernel, plain, extra = (fused, fused.binned_vgh_fused,
                                        fused.binned_vgh_plain, ())
    else:
        module, kernel, plain, _, _, extra = BB_MODES[mode]

    def contract(args):
        return (args[:1] + args[2:] if mode == 'binned' else args + extra,
                module, kernel, plain)
    if case.isdigit():
        anchor, nme, strides, observed, (idx, t, m), _ = _count_rows(
            int(case), device, seed)
        return contract((anchor, nme, strides, idx, t, m, observed))
    S_, K, N_, B_, bb_i = BB_VGH_CASES.get(case) or BB_ONLY_VGH_CASES[case]
    rng = np.random.default_rng(200 + seed)
    grid = (3,) * K
    G = int(np.prod(grid))
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    anchor = rng.random((G, S_, N_)) + 0.01
    nme = rng.uniform(0.5, 40.0, (G, N_))
    nme[:, 5] = 0.0
    anchor[:, [s for s in range(S_) if s != bb_i], 7] = 0.0
    anchor[:, bb_i, 9] = 0.0
    observed = rng.poisson(30.0, (B_, N_))
    idx = rng.integers(0, 2, (B_, K))
    t = rng.random((B_, K))
    m = rng.random((B_, S_)) * 10 + 1
    if case == 't_at_anchors':
        # fits at an anchor along axes 0 and 2 (t exactly 0 or 1), and
        # rows that vanish on the anchors with an odd index along axis 0:
        # at t = 1 (lower corner 0) or 0 (lower corner 1) the plain
        # version's MC count, other-source sum U or bb pmf is zero exactly
        t[:, [0, 2]] = rng.integers(0, 2, (B_, 2))
        odd = np.array([(g // strides[0]) % 2 == 1 for g in range(G)])
        nme[np.ix_(odd, np.arange(11, 21))] = 0.0
        anchor[np.ix_(odd, [s for s in range(S_) if s != bb_i],
                      np.arange(21, 31))] = 0.0
        anchor[np.ix_(odd, [bb_i], np.arange(31, 41))] = 0.0
    if case == 't_near_one':
        # within 1e-5 of 1 on every axis, and every source's rows 1e-4 of
        # their size on the anchors with an odd index along axis 0 (bins
        # 41-60): where the lower corner along axis 0 is even, lambda is
        # ~1e-4 of its size there and dominates the toy's H, so its few
        # digits must survive the combine
        t[:] = 1.0 - rng.uniform(0.0, 1e-5, (B_, K))
        odd = np.array([(g // strides[0]) % 2 == 1 for g in range(G)])
        anchor[np.ix_(odd, np.arange(S_), np.arange(41, 61))] *= 1e-4

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    args = (f32(anchor), f32(nme), strides, torch.as_tensor(idx,
                                                            device=device),
            f32(t), f32(m), f32(observed))
    if mode == 'bb':
        return args + (bb_i,), module, kernel, plain
    return contract(args)


@pytest.mark.cuda
@pytest.mark.parametrize("K", ['0', '1', '2', '3', '4']
                         + sorted(BB_VGH_CASES))
@pytest.mark.parametrize("mode", VGH_MODES)
def test_bb_vgh_kernels_match_plain(cuda_device, mode, K):
    args, module, kernel, plain = _bb_vgh_case(K, mode, cuda_device)
    module.reset_launch_counts()
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert module.launch_counts()[kernel.__name__] == 1
    np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), rtol=1e-5)
    assert _rel_to_toy_max(out[1], ref[1]) < 1e-4
    assert _rel_to_toy_max(out[2], ref[2]) < 1e-4
    # fixed-order sums over the cluster, no float atomics: bit-identical
    again = kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BB_ONLY_VGH_CASES))
def test_bb_vgh_kernel_source_cases(cuda_device, case):
    """The finite source first and last (bb's runtime index picks Pb, Dpb
    and Xp by a one-hot chain)."""
    args, module, kernel, plain = _bb_vgh_case(case, 'bb', cuda_device)
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out[0].cpu(), ref[0].cpu(), rtol=1e-5)
    assert _rel_to_toy_max(out[1], ref[1]) < 1e-4
    assert _rel_to_toy_max(out[2], ref[2]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", VGH_MODES)
def test_bb_vgh_kernels_alone_and_in_a_batch(cuda_device, mode):
    """One toy computed alone (all of a cluster's ranges on its bins) and
    inside a batch of 300 (two ranges a toy) agree to float32 tolerance:
    the range count changes the summation order, not the result."""
    args, _, kernel, _ = _bb_vgh_case('B300', mode, cuda_device)
    toy_args = range(2 if mode == 'binned' else 3, len(args))  # idx .. obs
    batch = kernel(*args)
    for toy in (0, 137, 299):
        one = kernel(*(a[toy:toy + 1] if i in toy_args and torch.is_tensor(a)
                       else a for i, a in enumerate(args)))
        torch.cuda.synchronize()
        np.testing.assert_allclose(one[0].cpu(), batch[0][toy:toy + 1].cpu(),
                                   rtol=1e-5)
        assert _rel_to_toy_max(one[1], batch[1][toy:toy + 1]) < 1e-4
        assert _rel_to_toy_max(one[2], batch[2][toy:toy + 1]) < 1e-4


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


#: The unbinned value kernel's cases, at the two widths the paths run
#: (``ULL_WIDTHS``: the Gaussian model's S = 2 sources on a 3-anchor axis,
#: and XENON's S = 6 on a 3^4 grid): name -> (B, L, A, E, candidates,
#: lanes). The kernel runs one block per (lane, event range[, candidate
#: group]), a lane's ranges one cluster, the candidates of one grid cell
#: sharing each load of its corner rows: one lane (3 ranges at E = 700),
#: one lane of 16,384 events (8 ranges, the most a cluster takes: 512
#: warps' worth of events in 8 ranges is 8 trips of a 256-thread block,
#: in 7 ranges 10, and 8 x 12 blocks fit the card in one round, so
#: ranges_for_bins takes 8), L x A below
#: one wave of the card and above it, A = 65 (more than a block's 64
#: candidates: two groups), all of a lane's candidates in one cell and each
#: in its own, lanes permuted and repeated, a lane whose events are all
#: masked, and E = 37 (fewer events than a block's threads).
ULL_WIDTHS = {'S2K1': ((3,), 2), 'S6K4': ((3, 3, 3, 3), 6)}
ULL_CASES = {
    'one_lane': (3, 1, 12, 700, 'random', [1]),
    'eight_ranges': (2, 1, 12, 16384, 'random', [1]),
    'below_one_wave': (6, 4, 12, 700, 'random', [4, 0, 5, 2]),
    'above_one_wave': (130, 128, 12, 300, 'random', None),
    'A65_two_groups': (6, 3, 65, 300, 'random', [2, 5, 0]),
    'one_cell': (6, 4, 12, 700, 'one_cell', [3, 1, 4, 0]),
    'own_cells': (6, 4, 12, 700, 'own_cells', [3, 1, 4, 0]),
    'lanes_permuted_repeated': (5, 6, 12, 700, 'random', [3, 0, 3, 4, 0, 1]),
    'all_masked_lane': (6, 4, 12, 700, 'all_masked', [2, 0, 5, 1]),
    'E37': (6, 4, 12, 37, 'random', [4, 0, 5, 2]),
}


def _event_sets(rng, G, S_, B_, E_, outlier, all_masked=None):
    """(ps, mask, inv_ref, ref_msum) of B toys' event sets: masked tails (a
    prefix of each toy's events valid, as the study's sampler makes them;
    toy ``all_masked`` has none), events of zero and of negative summed
    density (valid only with an outlier floor, else in the masked tail)."""
    ps = rng.uniform(0.001, 0.4, (B_, G, S_, E_))
    n_valid = rng.integers(E_ // 2, E_ - 2, B_)
    if all_masked is not None:
        n_valid[all_masked] = 0
    mask = np.arange(E_)[None, :] < n_valid[:, None]
    bad = [0, 1] if outlier else [E_ - 2, E_ - 1]
    ps[:, :, :, bad[0]] = 0.0
    ps[:, :, 0, bad[1]] = -50.0
    inv_ref = np.where(mask, rng.uniform(0.5, 2.0, (B_, E_)), 1.0)
    ref_msum = rng.uniform(500, 3000, B_)
    return ps, mask, inv_ref, ref_msum


def _ull_case(width, case, outlier, device, seed=0):
    """The unbinned value wrapper's args of a ``ULL_CASES`` case
    (``_event_sets``), centered."""
    grid, S_ = ULL_WIDTHS[width]
    B_, L, A_, E_, kind, lanes = ULL_CASES[case]
    K = len(grid)
    G = int(np.prod(grid))
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    rng = np.random.default_rng(seed + S_)
    ps, mask, inv_ref, ref_msum = _event_sets(
        rng, G, S_, B_, E_, outlier,
        lanes[1] if kind == 'all_masked' else None)
    lanes = np.arange(L) if lanes is None else np.asarray(lanes)
    cells = np.array(list(np.ndindex((2,) * K)))       # lower corners
    idx = cells[rng.integers(0, len(cells), (L, A_))]
    if kind == 'one_cell':
        idx[:] = idx[:, :1]
    elif kind == 'own_cells':
        idx = np.stack([cells[rng.permutation(len(cells))] for _ in
                        range(L)])[:, :min(A_, len(cells))]
    A_ = idx.shape[1]
    t = rng.uniform(0, 1, (L, A_, K))
    m = rng.uniform(100, 2000, (L, A_, S_))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return (f32(ps), strides,
            torch.as_tensor(lanes, dtype=torch.int64, device=device),
            torch.as_tensor(idx, device=device), f32(t), f32(m),
            torch.as_tensor(mask, device=device), f32(inv_ref),
            f32(m.sum(-1) - ref_msum[lanes][:, None]), outlier)


def _ull_term_scale(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                    outlier):
    """Per (lane, candidate) sum of the magnitudes of the centered ll's
    terms, sum_e |log(lam_e inv_ref_e)| + |moff|, in float64: the scale of
    its float32 rounding (a centered ll is a small difference of such
    terms)."""
    from blueice_tpu_torch.ops.binned_vgh import corner_weight_tables
    ids = fused.corner_ids(strides, idx, ps.shape[1])           # (L, A, C)
    w = corner_weight_tables(t.double())[0]
    P = sum(w[..., c, None, None] * ps[lanes[:, None], ids[..., c]].double()
            for c in range(ids.shape[-1]))                      # (L, A, S, E)
    lam = torch.einsum('las,lase->lae', m.double(), P)
    if outlier:
        lam = torch.where(lam > 0, lam, torch.full_like(lam, outlier))
    terms = torch.log(lam * inv_ref[lanes][:, None].double()).abs()
    terms = torch.where(mask[lanes][:, None], terms, torch.zeros_like(terms))
    return terms.sum(-1) + moff.double().abs()


@pytest.mark.cuda
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("case", sorted(ULL_CASES))
@pytest.mark.parametrize("width", sorted(ULL_WIDTHS))
def test_ull_kernel_cases(cuda_device, width, case, outlier):
    """The unbinned value kernel against its plain version, within 1e-5 of
    the magnitudes of each ll's terms, finite, and bit-identical on a
    rerun (fixed-order sums, no float atomics)."""
    args = _ull_case(width, case, outlier, cuda_device)
    L, A_ = args[3].shape[:2]
    ids = fused.corner_ids(args[1], args[3], args[0].shape[1]).tolist()
    cells = {len(set(map(tuple, lane))) for lane in ids}   # cells a lane
    if case == 'one_cell':
        assert cells == {1}
    if case == 'own_cells':
        assert cells == {A_}
    fused_unbinned.reset_launch_counts()
    out = fused_unbinned.unbinned_ll_fused_multi(*args)
    ref = fused_unbinned.unbinned_ll_plain(*args)
    torch.cuda.synchronize()
    assert fused_unbinned.launch_counts()['unbinned_ll_fused_multi'] == 1
    assert out.shape == (L, A_) and torch.isfinite(out).all()
    err = (out.double() - ref.double()).abs() / _ull_term_scale(*args)
    assert float(err.max()) <= 1e-5
    if case == 'all_masked_lane':
        assert torch.equal(out[1], -args[8][1])
    if case == 'lanes_permuted_repeated':
        # a toy's events give one lane's ll whatever the lane's place
        same = fused_unbinned.unbinned_ll_fused_multi(
            args[0], args[1], args[2][[0]], args[3][[2]], args[4][[2]],
            args[5][[2]], *args[6:8], args[8][[2]], outlier)
        assert float(((same - out[[2]]).abs() / _ull_term_scale(
            args[0], args[1], args[2][[0]], args[3][[2]], args[4][[2]],
            args[5][[2]], *args[6:8], args[8][[2]], outlier)).max()) <= 1e-5
    again = fused_unbinned.unbinned_ll_fused_multi(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


#: The unbinned vgh kernel's cases, at ``ULL_WIDTHS``: name -> (B, L, E,
#: lerp weights, lanes). The kernel runs one 128-thread block per (lane,
#: event range), a lane's ranges one cluster: one lane (6 ranges at E =
#: 700), one lane of 16,384 events (8 ranges, the most a cluster takes),
#: L below one wave of the card and above it at both widths (1,100 lanes
#: over 300 toys, where a lane alone must agree with the same lane in the
#: batch), lanes permuted and
#: repeated, a lane whose events are all masked, E = 37 (fewer events than
#: a block's threads); and it combines the corner rows by lerp steps over
#: the reflected cell, which must keep the plain version's precision next
#: to an anchor (t within 1e-5 of 1 on every axis, rows at 1e-4 of their
#: size on the anchors with an odd index along axis 0 at events 41-60) and
#: its corners exactly at one (t exactly 0 or 1 on the even axes).
UVGH_CASES = {
    'one_lane': (3, 1, 700, 'random', [1]),
    'eight_ranges': (2, 1, 16384, 'random', [1]),
    'below_one_wave': (6, 4, 700, 'random', [4, 0, 5, 2]),
    'above_one_wave': (300, 1100, 300, 'random', None),
    'lanes_permuted_repeated': (5, 6, 700, 'random', [3, 0, 3, 4, 0, 1]),
    'all_masked_lane': (6, 4, 700, 'random', [2, 0, 5, 1]),
    'E37': (6, 4, 37, 'random', [4, 0, 5, 2]),
    't_near_one': (6, 4, 700, 'near_one', [4, 0, 5, 2]),
    't_at_anchors': (6, 4, 700, 'at_anchors', [4, 0, 5, 2]),
}


def _uvgh_case(width, case, outlier, device, seed=0):
    """The unbinned vgh wrapper's args of a ``UVGH_CASES`` case
    (``_event_sets``), centered."""
    grid, S_ = ULL_WIDTHS[width]
    B_, L, E_, kind, lanes = UVGH_CASES[case]
    K = len(grid)
    G = int(np.prod(grid))
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    rng = np.random.default_rng(300 + seed + S_)
    ps, mask, inv_ref, ref_msum = _event_sets(
        rng, G, S_, B_, E_, outlier,
        lanes[1] if case == 'all_masked_lane' else None)
    lanes = np.arange(L) % B_ if lanes is None else np.asarray(lanes)
    cells = np.array(list(np.ndindex((2,) * K)))       # lower corners
    idx = cells[rng.integers(0, len(cells), L)]
    t = rng.uniform(0, 1, (L, K))
    if kind == 'near_one':
        t[:] = 1.0 - rng.uniform(0.0, 1e-5, (L, K))
        odd = np.array([(g // strides[0]) % 2 == 1 for g in range(G)])
        ps[:, odd, :, 41:61] *= 1e-4
    elif kind == 'at_anchors':
        t[:, ::2] = rng.integers(0, 2, (L, (K + 1) // 2))
    m = rng.uniform(100, 2000, (L, S_))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return (f32(ps), strides,
            torch.as_tensor(lanes, dtype=torch.int64, device=device),
            torch.as_tensor(idx, device=device), f32(t), f32(m),
            torch.as_tensor(mask, device=device), f32(inv_ref),
            f32(m.sum(-1) - ref_msum[lanes]), outlier)


def _uvgh_errors(out, ref, args, rows=None):
    """(ll, g, H) errors of a vgh call's outputs against ``ref``: the ll
    relative to the magnitudes of its terms (``_ull_term_scale``), g and H
    to each lane's largest entry, over the lanes ``rows`` (default all)."""
    ps, strides, lanes, idx, t, m, mask, inv_ref, moff, outlier = args
    scale = _ull_term_scale(ps, strides, lanes, idx[:, None], t[:, None],
                            m[:, None], mask, inv_ref, moff[:, None],
                            outlier)[:, 0]
    rows = slice(None) if rows is None else rows
    return (float(((out[0].double() - ref[0].double()).abs()
                   / scale)[rows].max()),
            _rel_to_toy_max(out[1][rows], ref[1][rows]),
            _rel_to_toy_max(out[2][rows], ref[2][rows]))


@pytest.mark.cuda
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("case", sorted(UVGH_CASES))
@pytest.mark.parametrize("width", sorted(ULL_WIDTHS))
def test_uvgh_kernel_cases(cuda_device, width, case, outlier):
    """The unbinned vgh kernel against its plain version: ll within 1e-5
    of the magnitudes of its terms, g and H within 1e-4 of each lane's
    largest entry, finite, and bit-identical on a rerun (fixed-order sums,
    no float atomics)."""
    args = _uvgh_case(width, case, outlier, cuda_device)
    L, P = args[3].shape[0], args[0].shape[2] + len(args[1])
    fused_unbinned.reset_launch_counts()
    out = fused_unbinned.unbinned_vgh_fused(*args)
    ref = fused_unbinned.unbinned_vgh_plain(*args)
    torch.cuda.synchronize()
    assert fused_unbinned.launch_counts()['unbinned_vgh_fused'] == 1
    assert out[0].shape == (L,) and out[1].shape == (L, P)
    assert out[2].shape == (L, P, P)
    assert all(torch.isfinite(x).all() for x in out)
    rows = None
    if case == 'all_masked_lane':
        # no valid event: ll = -moff, g = -1 on the rates, 0 on t, H = 0
        S_ = args[0].shape[2]
        assert torch.equal(out[0][1], -args[8][1])
        assert torch.equal(out[1][1, :S_], -torch.ones_like(out[1][1, :S_]))
        assert torch.equal(out[1][1, S_:], torch.zeros_like(out[1][1, S_:]))
        assert torch.equal(out[2][1], torch.zeros_like(out[2][1]))
        rows = [0, 2, 3]
    ll_err, g_err, h_err = _uvgh_errors(out, ref, args, rows)
    assert ll_err <= 1e-5 and g_err <= 1e-4 and h_err <= 1e-4
    if case in ('above_one_wave', 'lanes_permuted_repeated'):
        # a lane alone (all of a cluster's ranges on its events) gives its
        # ll, g and H inside the batch to float32 tolerance
        for lane in (0, 2, 137, 1099)[:4 if L == 1100 else 2]:
            one_args = tuple(a[[lane]] if i in (2, 3, 4, 5, 8) else a
                             for i, a in enumerate(args))
            one = fused_unbinned.unbinned_vgh_fused(*one_args)
            part = tuple(x[[lane]] for x in out)
            ll_err, g_err, h_err = _uvgh_errors(one, part, one_args)
            assert ll_err <= 1e-5 and g_err <= 1e-4 and h_err <= 1e-4
    again = fused_unbinned.unbinned_vgh_fused(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))


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


#: A profile map's calls (``BinnedToyStudy.profile_map``,
#: ``UnbinnedToyStudy.profile_map``): two lanes a grid point (a warm and a
#: cold start), 33 points, all on ONE dataset: the binned contracts'
#: observed rows are one toy's, the unbinned lanes all read toy 0. At the
#: XENON width (S = 6 on a 3^4 grid; 3,100 bins, or 300 events a toy).
MAP_LANES = 66
MAP_CONTRACTS = [(mode, contract) for mode in VGH_MODES + ('unbinned',)
                 for contract in ('vgh', 'value')]


def _one_dataset(observed):
    return observed[:1].expand(MAP_LANES, -1).contiguous()


def _map_call(mode, contract, device):
    """(args, module, wrapper name, kernel, plain) of a map call."""
    L = slice(0, MAP_LANES)
    if mode == 'unbinned':
        if contract == 'vgh':
            args = _uvgh_case('S6K4', 'above_one_wave', 0.0, device)
            name = 'unbinned_vgh_fused'
        else:
            args = _ull_case('S6K4', 'above_one_wave', 0.0, device)
            name = 'unbinned_ll_fused_multi'
        args = (args[0], args[1],
                torch.zeros(MAP_LANES, dtype=torch.int64, device=device),
                args[3][L], args[4][L], args[5][L], args[6], args[7],
                args[8][L], args[9])
        return (args, fused_unbinned, name, getattr(fused_unbinned, name),
                getattr(fused_unbinned, name.replace('_fused_multi', '_plain')
                        .replace('_fused', '_plain')))
    if contract == 'value':
        anchor, strides, idx, t, m, observed, nme = _value_case(
            6, 4, 3100, MAP_LANES, 12, 'random', device)
        module, name, kernel, plain = _value_ops(mode, nme, BB_I)
        return ((anchor, strides, idx, t, m, _one_dataset(observed)),
                module, name, kernel, plain)
    args, module, kernel, plain = _bb_vgh_case('B300', mode, device)
    at = 1 if mode == 'binned' else 2                 # strides' position
    args = (args[:at + 1] + tuple(a[L] for a in args[at + 1:at + 4])
            + (_one_dataset(args[at + 4]),) + args[at + 5:])
    return args, module, kernel.__name__, kernel, plain


@pytest.mark.cuda
@pytest.mark.parametrize("mode,contract", MAP_CONTRACTS)
def test_map_calls_match_plain(cuda_device, mode, contract):
    """Every fused contract on a profile map's call (66 lanes on one
    dataset) against its plain version, at phase 1's tolerances: the ll
    relative (unbinned: to the magnitudes of its terms), g and H within
    1e-4 of each lane's largest entry; finite, and bit-identical on a
    rerun."""
    args, module, name, kernel, plain = _map_call(mode, contract,
                                                  cuda_device)
    module.reset_launch_counts()
    out = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert module.launch_counts()[name] == 1
    outs = out if contract == 'vgh' else (out,)
    assert all(torch.isfinite(x).all() for x in outs)
    assert outs[0].shape[0] == MAP_LANES
    if mode == 'unbinned' and contract == 'vgh':
        assert max(_uvgh_errors(out, ref, args)) <= 1e-4
        assert _uvgh_errors(out, ref, args)[0] <= 1e-5
    elif mode == 'unbinned':
        err = (out.double() - ref.double()).abs() / _ull_term_scale(*args)
        assert float(err.max()) <= 1e-5
    else:
        np.testing.assert_allclose(outs[0].cpu(), (ref[0] if contract == 'vgh'
                                                   else ref).cpu(), rtol=1e-5)
        if contract == 'vgh':
            assert _rel_to_toy_max(out[1], ref[1]) < 1e-4
            assert _rel_to_toy_max(out[2], ref[2]) < 1e-4
    again = kernel(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        outs, again if contract == 'vgh' else (again,)))


# -- compositions and log morphing on the card --------------------------------

#: a small XENON-like binned model's width (the full one is chip_smoke's)
SMALL = dict(n_cs1_bins=10, n_cs2_bins=8)


def _combined_sum():
    """Two science runs of the XENON-like model and a correlated
    calibration constraint, as chip_smoke's ``combined`` path at a small
    width."""
    from blueice_tpu_torch import composition
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.utils import set_progress
    set_progress(False)
    runs = [xenon_like.build_likelihood('binned', livetime_days=days,
                                        **SMALL) for days in (32.1, 246.7)]
    return composition.LogLikelihoodSum(runs + [
        composition.correlated_gaussian_constraint(
            ['band_shift', 'band_width_scale'], [0.0, 1.0],
            [[0.09, 0.012], [0.012, 0.0064]])])


@pytest.mark.cuda
def test_sum_engine_kernels_match_plain(cuda_device):
    """The Sum engine's (value, g, H) and its values at candidates with its
    binned children on ``vgh_kernel`` / ``ll_kernel`` against the plain
    Sum engine on the card: the value relative 1e-5, g and H within 1e-4
    of each toy's largest entry; each child's kernels launch."""
    from blueice_tpu_torch.compile import build_logl
    from blueice_tpu_torch.parallel import fitter
    compiled = build_logl(_combined_sum(), device=cuda_device)
    assert compiled.dtype == torch.float32
    names, fixed, transform, x0 = fitter._floating_setup(compiled, {})
    rng = np.random.default_rng(0)
    n = len(names)
    u = torch.as_tensor(transform.to_u_np(x0)[None]
                        + rng.normal(0, 0.2, (B, n)),
                        dtype=torch.float32, device=cuda_device)
    cands = u[:, None, :] + torch.as_tensor(
        rng.normal(0, 0.05, (B, A, n)), dtype=torch.float32,
        device=cuda_device)
    data = tuple(torch.as_tensor(
        rng.poisson(e.cpu().numpy(), (B,) + tuple(e.shape)).reshape(B, -1),
        dtype=torch.float32, device=cuda_device)
        for e in compiled.expected_counts(compiled.defaults))
    fv = torch.zeros((B, 0), dtype=torch.float32, device=cuda_device)
    outs = {}
    for engine in ('auto', 'analytic'):
        value_many, vgh = fitter._make_sum_analytic_parts(
            compiled, names, fixed, transform, engine)
        fused.reset_launch_counts()
        outs[engine] = (vgh(u, data, fv), value_many(cands, data, fv))
        torch.cuda.synchronize()
        assert fused.launch_counts() == (
            {'binned_vgh_fused': 2, 'binned_ll_fused_multi': 2}
            if engine == 'auto' else
            {'binned_vgh_fused': 0, 'binned_ll_fused_multi': 0})
    (val, g, H), many = outs['auto']
    (rval, rg, rH), rmany = outs['analytic']
    np.testing.assert_allclose(val.cpu(), rval.cpu(), rtol=1e-5)
    np.testing.assert_allclose(many.cpu(), rmany.cpu(), rtol=1e-5)
    assert _rel_to_toy_max(g, rg) < 1e-4
    assert _rel_to_toy_max(H, rH) < 1e-4


@pytest.mark.cuda
def test_log_morphed_fitter_launches_no_kernel(cuda_device):
    """A log-morphed model's fits on the card run the closed forms: no
    kernel launches, since the kernels bake in the linear lerp."""
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.likelihood import BinnedLogLikelihood
    from blueice_tpu_torch.parallel import BinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    set_progress(False)
    lf = BinnedLogLikelihood(xenon_like.build_config(**SMALL),
                             likelihood_config={
                                 'template_interpolation': 'log'})
    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=xenon_like.NormalPrior(1, 0.05))
    lf.add_shape_parameter('band_shift', (-1.0, 0.0, 1.0))
    lf.prepare()
    study = BinnedToyStudy(lf, max_iter=40, tol=3e-4)
    assert study.compiled.device.type == 'cuda' and study.compiled.log_morph
    for module in (fused, fused_bb, fused_bb_lite, fused_unbinned):
        module.reset_launch_counts()
    t, free, cond = study.profile_ts(0, 8, 'wimp_rate_multiplier', 1.0)
    torch.cuda.synchronize()
    assert np.isfinite(free.max_ll).all() and (t >= 0).all()
    for module in (fused, fused_bb, fused_bb_lite, fused_unbinned):
        assert not any(module.launch_counts().values())


# -- the inference slice on the card -------------------------------------------

def _bound_likelihood(kind):
    """A small XENON-like binned or unbinned model with one dataset bound,
    drawn from a seeded generator."""
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.utils import set_progress
    set_progress(False)
    extra = dict(livetime_days=3.0) if kind == 'unbinned' else {}
    lf = xenon_like.build_likelihood(kind, **SMALL, **extra)
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(0)))
    return lf


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['binned', 'unbinned'])
def test_walker_values_match_plain(cuda_device, kind):
    """The MCMC walkers' log_prob through the value kernel (#2, or #16 for
    the unbinned model) at one dataset and A = 20 candidates, one walker
    out of the shape bounds: one launch, the values relative 1e-5 of the
    plain version's on the card, -inf at the same place."""
    from blueice_tpu_torch.compile import cached_logl
    from blueice_tpu_torch.parallel import mcmc
    compiled = cached_logl(_bound_likelihood(kind))
    log_prob, names, guess = mcmc.make_device_log_prob(compiled)
    plain = mcmc.make_device_log_prob(compiled, engine='analytic')[0]
    rng = np.random.default_rng(1)
    x = guess * rng.uniform(0.9, 1.1, (20, len(names)))
    x[3, names.index('band_shift')] = 1.5
    x = torch.as_tensor(x, dtype=torch.float32, device=cuda_device)
    module = fused if kind == 'binned' else fused_unbinned
    name = ('binned_ll_fused_multi' if kind == 'binned'
            else 'unbinned_ll_fused_multi')
    module.reset_launch_counts()
    out = log_prob(x)
    torch.cuda.synchronize()
    assert module.launch_counts()[name] == 1
    ref = plain(x)
    assert torch.isneginf(out[3]) and torch.isneginf(ref[3])
    keep = torch.arange(20, device=cuda_device) != 3
    assert bool(torch.isfinite(out[keep]).all())
    np.testing.assert_allclose(out[keep].cpu(), ref[keep].cpu(), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['binned', 'unbinned'])
def test_fit_single_on_the_card(cuda_device, kind):
    """bestfit_jax on the card (float32, the kernels) against the same fit
    on the CPU in float64: the maximum within 1e-2, the values within a
    tenth of their errors, the errors within 5%."""
    lf = _bound_likelihood(kind)
    module = fused if kind == 'binned' else fused_unbinned
    module.reset_launch_counts()
    card, ll = lf.bestfit_jax()
    torch.cuda.synchronize()
    assert all(v > 0 for v in module.launch_counts().values())
    cpu, ll64 = lf.bestfit_jax(device='cpu')
    assert abs(ll - ll64) < 1e-2
    for k in cpu:
        if not k.endswith('_error'):
            assert abs(card[k] - cpu[k]) <= 0.1 * cpu[k + '_error'], k
        else:
            assert abs(card[k] / cpu[k] - 1) < 0.05, k


@pytest.mark.cuda
def test_template_batch_kernel_on_the_card(cuda_device):
    """The device template build (float64) on the card against the CPU's."""
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.models import jax_source
    space = xenon_like.build_config(**SMALL)['analysis_space']
    density = xenon_like.blob_density(*xenon_like.SOURCES[0][2:])
    names = ['band_shift', 'band_width_scale', 'cs1_tilt', 'efficiency']
    params = np.random.default_rng(2).uniform(-1, 1, (81, 4)) * [1, 0.2, 1,
                                                                 0.3]
    params += [0.0, 1.0, 0.0, 1.0]
    card = jax_source._batch_kernel(density, space, names, 'cuda')(params)
    cpu = jax_source._batch_kernel(density, space, names, 'cpu')(params)
    assert card.shape == (81, 10, 8)
    np.testing.assert_allclose(card, cpu, rtol=1e-12, atol=1e-15)


# -- the autodiff engine and source-wise morphing on the card ---------------------

def _counted_launches():
    return {name: n for module in (fused, fused_bb, fused_bb_lite,
                                   fused_unbinned)
            for name, n in module.launch_counts().items()}


def _reset_launches():
    for module in (fused, fused_bb, fused_bb_lite, fused_unbinned):
        module.reset_launch_counts()


def _errors(compiled, names, x, data, runtime=()):
    """(toys, n) parabolic errors at the fits ``x``: the inverse of the
    float32 Hessian of the plain closed form there (a runtime-fixed
    parameter at 1.0)."""
    from blueice_tpu_torch.parallel.fitter import x_space_ops
    vgh = x_space_ops(compiled, names, runtime_fixed=list(runtime),
                      engine='analytic')[1]
    x = torch.as_tensor(x, dtype=compiled.dtype, device=compiled.device)
    fv = torch.ones((x.shape[0], len(runtime)), dtype=compiled.dtype,
                    device=compiled.device)
    cov = torch.linalg.pinv(vgh(x, data, fv)[2].double())
    return torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                                  min=0)).cpu().numpy()


def _same_optima(x, ll, x_ref, ll_ref, err, t=None, t_ref=None):
    """The gate of chip_smoke.py's source-wise paths: at least 95% of the
    toys agree in x (within a tenth of the reference fit's parabolic
    error ``err``, float32's bound), on those |d max_ll| <= 0.05 (and
    median |d t| <= 0.01), and on every toy |d max_ll| < 0.2."""
    agree = np.all(np.abs(x - x_ref) <= 0.1 * err, axis=1)
    assert agree.mean() >= 0.95, agree
    d_ll = np.abs(ll - ll_ref)
    assert d_ll[agree].max() <= 0.05 and d_ll.max() < 0.2
    if t is not None:
        assert np.median(np.abs(t - t_ref)[agree]) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['binned', 'unbinned'])
def test_ad_engine_matches_fused(cuda_device, kind):
    """A small XENON-shaped batch fitted by the autodiff engine (no kernel
    launched) and by the fused engine (its kernels) on the card, the same
    toys, float32: the source-wise paths' gate."""
    from blueice_tpu_torch.parallel import (BinnedToyStudy, UnbinnedToyStudy,
                                            make_toy_fitter)
    lf = _bound_likelihood(kind)
    cls = BinnedToyStudy if kind == 'binned' else UnbinnedToyStudy
    study = cls(lf, max_iter=60)
    toys = study.simulate(1, 32)
    data = (study._counts(toys).reshape(32, -1) if kind == 'binned'
            else study._fit_data(toys))
    out = {}
    for engine in ('ad', 'fused'):
        fit, names = make_toy_fitter(study.compiled, max_iter=240,
                                     engine=engine)
        _reset_launches()
        x, ll, _ = fit(data)
        torch.cuda.synchronize()
        launched = sum(_counted_launches().values())
        assert (launched == 0) == (engine == 'ad'), launched
        out[engine] = (x.double().cpu().numpy(), ll.double().cpu().numpy())
    err = _errors(study.compiled, names, out['fused'][0], data)
    _same_optima(*out['ad'], *out['fused'], err)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['binned', 'unbinned'])
def test_source_wise_study_matches_global(cuda_device, kind):
    """The source-wise XENON model's profile study (the autodiff engine, no
    kernel launched) against the global model's (the kernels) on the same
    toys on the card."""
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.parallel import BinnedToyStudy, UnbinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    set_progress(False)
    target = 'wimp_rate_multiplier'
    extra = dict(livetime_days=3.0) if kind == 'unbinned' else {}
    cls = BinnedToyStudy if kind == 'binned' else UnbinnedToyStudy
    glob, sw = (cls(xenon_like.build_likelihood(
        kind, source_wise_interpolation=s, **SMALL, **extra))
        for s in (False, True))
    toys = glob.simulate(2, 32)
    _reset_launches()
    t, free, cond = sw._run_profile(toys, target, 1.0, None)
    torch.cuda.synchronize()
    assert not any(_counted_launches().values())
    tg, fg, cg = glob._run_profile(toys, target, 1.0, None)
    data = (glob._counts(toys).reshape(32, -1) if kind == 'binned'
            else glob._fit_data(toys))
    _same_optima(free.x, free.max_ll, fg.x, fg.max_ll,
                 _errors(glob.compiled, fg.names, fg.x, data), t, tg)
    _same_optima(cond.x, cond.max_ll, cg.x, cg.max_ll,
                 _errors(glob.compiled, cg.names, cg.x, data, [target]))


@pytest.mark.cuda
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("case", sorted(UNBINNED))
def test_dense_ops_match_plain(cuda_device, case, outlier):
    """The dense unbinned engine's ops (``torch.bmm`` over ``ps[lanes]``,
    no kernel of their own) against the plain closed forms on the card,
    float32: ll relative 1e-5, g and H within 1e-4 of each toy's largest
    entry; no kernel launched."""
    from blueice_tpu_torch.ops import unbinned_dense
    vgh_args, ll_args = _unbinned_inputs(case, outlier, cuda_device)
    _reset_launches()
    for args, dense, plain in (
            (vgh_args, unbinned_dense.unbinned_vgh_dense,
             fused_unbinned.unbinned_vgh_plain),
            (ll_args, unbinned_dense.unbinned_ll_dense_many,
             fused_unbinned.unbinned_ll_plain)):
        ps, strides, lanes, idx, t, m, mask, inv_ref, moff, outl = args
        ref_msum = m.sum(-1) - moff
        out = dense(ps, strides, idx, t, m, mask, outl, inv_ref, ref_msum,
                    lanes=lanes)
        want = plain(ps, strides, lanes, idx, t, m, mask, inv_ref,
                     (m.sum(-1) - ref_msum).contiguous(), outl)
        torch.cuda.synchronize()
        if isinstance(out, tuple):
            assert out[0].device.type == 'cuda'
            np.testing.assert_allclose(out[0].cpu(), want[0].cpu(),
                                       rtol=1e-5)
            assert _rel_to_toy_max(out[1], want[1]) < 1e-4
            assert _rel_to_toy_max(out[2], want[2]) < 1e-4
        else:
            assert out.shape == (len(U_LANES), UA)
            np.testing.assert_allclose(out.cpu(), want.cpu(), rtol=1e-5)
    assert not any(_counted_launches().values())


@pytest.mark.cuda
def test_one_rank_mesh_on_the_card(cuda_device):
    """A one-process mesh on the card is no mesh, bit for bit, and the
    study's kernels launch under it."""
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.parallel import BinnedToyStudy, make_mesh
    from blueice_tpu_torch.utils import set_progress
    set_progress(False)
    study = BinnedToyStudy(xenon_like.build_likelihood('binned', **SMALL))
    target = 'wimp_rate_multiplier'
    t, free, cond = study.profile_ts(0, 32, target, 1.0)
    _reset_launches()
    t2, free2, cond2 = study.profile_ts(0, 32, target, 1.0, mesh=make_mesh())
    torch.cuda.synchronize()
    assert _counted_launches()['binned_vgh_fused'] > 0
    for a, b in ((t, t2), (free.x, free2.x), (free.max_ll, free2.max_ll),
                 (cond.max_ll, cond2.max_ll)):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card(cuda_device):
    """Two ranks spawned on the one card (gloo) profile 16 xenon toys at
    full width: both hold the same arrays, they drew the single process's
    toys, each launched the binned kernels and the parameter graph's and
    no other, and their fits agree with one process's (max |d max_ll| <=
    0.05, median |d t| <= 0.01)."""
    from blueice_tpu_torch import dryrun
    from blueice_tpu_torch.ops import param_graph
    from blueice_tpu_torch.parallel import BinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    set_progress(False)
    for module in (fused, fused_bb, fused_bb_lite, fused_unbinned,
                   param_graph):
        module.load_library()           # built before the ranks start
    kw = dict(max_iter=96, tol=3e-4)
    results = dryrun.run_ranks(2, dict(runs=[dict(
        model='xenon', seed=0, n_toys=16)], study=kw), 'cuda', timeout=600)
    dryrun.same_on_every_rank(results)
    own = ('binned_vgh_fused', 'binned_ll_fused_multi', 'graph_fwd',
           'graph_chain')
    for res in results:
        launches = res['runs'][0]['launches']
        assert all(launches[name] > 0 for name in own)
        assert sum(launches.values()) == sum(launches[name] for name in own)
    study = BinnedToyStudy(dryrun.flagship_likelihood('xenon'), **kw)
    run = results[0]['runs'][0]
    assert run['digest'] == dryrun.ensemble_digest(study.simulate(0, 16))
    t, free, cond = study.profile_ts(0, 16, 'wimp_rate_multiplier', 1.0)
    d_ll = np.maximum(np.abs(np.asarray(run['free_ll']) - free.max_ll),
                      np.abs(np.asarray(run['cond_ll']) - cond.max_ll))
    assert d_ll.max() <= 0.05
    assert np.median(np.abs(np.asarray(run['t']) - t)) <= 0.01
