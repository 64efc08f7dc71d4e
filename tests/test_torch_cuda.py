"""The port's CUDA kernels against their plain PyTorch versions on the card.

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

from blueice_tpu_torch.ops import fused

S, N, B, A = 3, 300, 16, 7


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
