"""The port's CUDA kernels (the binned, Beeston-Barlow and bb-lite
contracts) against their plain PyTorch versions on the card.

These need an NVIDIA GPU (a CUDA kernel has no CPU mode): they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. On a
GPU machine: ``python -m pytest tests/test_torch_cuda.py -m cuda``. This
file imports no jax, so it runs where JAX is not installed.

Tolerances (float32 on the card, different summation orders): ll relative
1e-5; g and H within 1e-4 of each toy's largest entry.
"""

import numpy as np
import pytest
import torch

from blueice_tpu_torch.ops import fused, fused_bb, fused_bb_lite

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
