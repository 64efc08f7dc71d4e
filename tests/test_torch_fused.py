"""The port's fused-kernel wrappers (their plain versions on the CPU) against
the JAX package's Pallas kernels in interpret mode, both flavors, vmapped
over toys: same numpy-made inputs, float64.

Tolerances follow tests/test_fused_kernel.py: ll rtol 1e-10, g rtol 1e-9,
H rtol 1e-8 / atol 1e-12 (accumulation order differs between the closed
form and the kernels). The CUDA kernels themselves are checked against the
same plain versions on the card (tests/test_torch_cuda.py, and
chip_smoke.py at the XENON shape).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.ops import fused as jfused
from blueice_tpu_torch.ops import fused

S, N, B, A = 3, 100, 4, 5


def _setup(K, seed=0):
    rng = np.random.default_rng(seed + K)
    grid = (3,) * K
    G = int(np.prod(grid)) if K else 1
    anchor = rng.random((G, S, N)) + 0.01
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    observed = rng.poisson(3.0, (B, N)).astype(float)
    m = rng.random((B, S)) * 10 + 1
    t = rng.random((B, K))
    idx = rng.integers(0, 2, (B, K))
    cand = dict(idx=rng.integers(0, 2, (B, A, K)), t=rng.random((B, A, K)),
                m=rng.random((B, A, S)) * 10 + 1)
    return anchor, strides, idx, t, m, observed, cand


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _jax_vgh(anchor, strides, idx, t, m, observed, dense):
    K = len(strides)
    anchor_p = jnp.asarray(jfused.pad_bins(anchor))
    obs_p = jnp.asarray(jfused.pad_bins(observed))

    def one(i, tv, mv, obs):
        return jfused.binned_vgh_fused(anchor_p, strides,
                                       [i[d] for d in range(K)], tv, mv, obs,
                                       interpret=True, dense=dense)
    return jax.vmap(one)(jnp.asarray(idx, jnp.int32), jnp.asarray(t),
                         jnp.asarray(m), obs_p)


def _jax_ll_multi(anchor, strides, cand, observed, dense):
    anchor_p = jnp.asarray(jfused.pad_bins(anchor))
    obs_p = jnp.asarray(jfused.pad_bins(observed))

    def one(i, tv, mv, obs):
        return jfused.binned_ll_fused_multi(anchor_p, strides, i, tv, mv, obs,
                                            interpret=True, dense=dense)
    return jax.vmap(one)(jnp.asarray(cand['idx'], jnp.int32),
                         jnp.asarray(cand['t']), jnp.asarray(cand['m']),
                         obs_p)


def _assert_vgh_close(port, ref):
    ll_p, g_p, H_p = (x.numpy() for x in port)
    ll_r, g_r, H_r = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(ll_p, ll_r, rtol=1e-10)
    np.testing.assert_allclose(g_p, g_r, rtol=1e-9)
    np.testing.assert_allclose(H_p, H_r, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
def test_vgh_matches_pallas(K, dense):
    anchor, strides, idx, t, m, observed, _ = _setup(K)
    port = fused.binned_vgh_fused(_t(anchor), strides, _t(idx, torch.int64),
                                  _t(t), _t(m), _t(observed))
    ref = _jax_vgh(anchor, strides, idx, t, m, observed, dense)
    assert port[0].shape == (B,) and port[2].shape == (B, S + K, S + K)
    _assert_vgh_close(port, ref)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
def test_ll_multi_matches_pallas(K, dense):
    anchor, strides, _, _, _, observed, cand = _setup(K)
    port = fused.binned_ll_fused_multi(
        _t(anchor), strides, _t(cand['idx'], torch.int64), _t(cand['t']),
        _t(cand['m']), _t(observed))
    ref = _jax_ll_multi(anchor, strides, cand, observed, dense)
    assert port.shape == (B, A)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-10)


def test_negative_expectation_penalty_matches_pallas():
    """The negative-expectation penalty rides along in value and
    derivatives (tests/test_fused_kernel.py's regression case)."""
    anchor = np.zeros((1, 2, 3))
    anchor[0, 0] = [1.0, 0.5, 2.0]
    anchor[0, 1] = [0.0, -1.0, 0.5]
    observed = np.array([[0.0, 0.0, 3.0]])
    m = np.array([[1.0, 0.8]])
    empty = np.zeros((1, 0))
    port = fused.binned_vgh_fused(_t(anchor), (), _t(empty, torch.int64),
                                  _t(empty), _t(m), _t(observed))
    assert float(port[0][0]) < -1e4          # the penalty engaged
    for dense in (False, True):
        _assert_vgh_close(port, _jax_vgh(anchor, (), empty.astype(int),
                                         empty, m, observed, dense))
    cand = dict(idx=np.zeros((1, 3, 0), int), t=np.zeros((1, 3, 0)),
                m=np.array([[[1.0, 0.8], [1.0, 0.2], [2.0, 1.5]]]))
    lls = fused.binned_ll_fused_multi(
        _t(anchor), (), _t(cand['idx'], torch.int64), _t(cand['t']),
        _t(cand['m']), _t(observed))
    np.testing.assert_allclose(
        lls.numpy(), np.asarray(_jax_ll_multi(anchor, (), cand, observed,
                                              False)), rtol=1e-10)


def test_plain_path_is_taken_for_cpu_tensors():
    """On CPU tensors the wrappers return exactly their plain versions and
    launch nothing."""
    K = 2
    anchor, strides, idx, t, m, observed, cand = _setup(K)
    fused.reset_launch_counts()
    args = (_t(anchor), strides, _t(idx, torch.int64), _t(t), _t(m),
            _t(observed))
    for a, b in zip(fused.binned_vgh_fused(*args),
                    fused.binned_vgh_plain(*args)):
        assert torch.equal(a, b)
    cargs = (_t(anchor), strides, _t(cand['idx'], torch.int64),
             _t(cand['t']), _t(cand['m']), _t(observed))
    assert torch.equal(fused.binned_ll_fused_multi(*cargs),
                       fused.binned_ll_plain(*cargs))
    assert fused.launch_counts() == {'binned_vgh_fused': 0,
                                     'binned_ll_fused_multi': 0}


def test_wrappers_reject_bad_shapes():
    anchor, strides, idx, t, m, observed, _ = _setup(2)
    with pytest.raises(ValueError):
        fused.binned_vgh_fused(_t(anchor), strides, _t(idx, torch.int64),
                               _t(t), _t(m[:, :2]), _t(observed))
    with pytest.raises(ValueError):
        fused.binned_vgh_fused(_t(anchor), strides, _t(idx, torch.int64),
                               _t(t, torch.float32), _t(m), _t(observed))
