"""The port's torch ops against their JAX twins on the same numpy-made
inputs, float64, rtol 1e-12 (same closed forms; only the accumulation order
may differ). The port's ops are batched over leading dimensions; the JAX
twins are vmapped to match."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.ops import binned_vgh as jvgh
from blueice_tpu.ops import interp as jinterp
from blueice_tpu.ops import poisson as jpoisson
from blueice_tpu_torch.ops import binned_vgh as tvgh
from blueice_tpu_torch.ops import interp as tinterp
from blueice_tpu_torch.ops import poisson as tpoisson

RTOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(port, ref, atol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=atol)


@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
def test_corner_weight_tables(K):
    t = np.random.default_rng(K).random((5, K))
    port = tvgh.corner_weight_tables(_t(t))
    ref = jax.vmap(jvgh.corner_weight_tables)(jnp.asarray(t))
    for a, b in zip(port, ref):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, atol=1e-15)


def _corner_setup(K, S=3, N=40, B=4, seed=0):
    rng = np.random.default_rng(seed + K)
    corners = rng.random((B, 2 ** K, S, N)) + 0.01
    m = rng.random((B, S)) * 10 + 1
    t = rng.random((B, K))
    observed = rng.poisson(3.0, (B, N)).astype(float)
    observed[:, :3] = 0.0                  # empty bins keep r = -1
    return corners, m, t, observed


@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
def test_binned_vgh(K):
    corners, m, t, observed = _corner_setup(K)
    port = tvgh.binned_vgh(_t(corners), _t(m), _t(t), _t(observed))
    ref = jax.vmap(jvgh.binned_vgh)(*(jnp.asarray(x) for x in
                                      (corners, m, t, observed)))
    for a, b in zip(port, ref):
        _close(a, b, atol=1e-12 * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("K", [0, 2, 4])
def test_binned_ll(K):
    corners, m, t, observed = _corner_setup(K)
    port = tvgh.binned_ll(_t(corners), _t(m), _t(t), _t(observed))
    ref = jax.vmap(jvgh.binned_ll)(*(jnp.asarray(x) for x in
                                     (corners, m, t, observed)))
    _close(port, ref)


def test_gather_corners():
    rng = np.random.default_rng(3)
    tensor = rng.random((3, 4, 2, 5))
    idx = np.array([[1, 2], [0, 0], [2, 3], [-1, 1]])
    port = tvgh.gather_corners(_t(tensor), _t(idx), 2)
    for i, row in enumerate(idx):
        ref = jvgh.gather_corners(jnp.asarray(tensor),
                                  [jnp.asarray(v) for v in row], 2)
        np.testing.assert_array_equal(port[i].numpy(), np.asarray(ref))


@pytest.mark.parametrize("zs", [(0.3, 1.5), (-1.0, 2.0), (1.0, 0.25),
                                (0.999, 1.0)])
def test_morph_templates(zs):
    rng = np.random.default_rng(4)
    arrays = [np.array([-1.0, 0.0, 1.0]), np.array([0.0, 0.5, 1.5, 2.0])]
    tensor = rng.random((3, 4, 2, 7))
    port = tinterp.morph_templates(_t(tensor), [_t(a) for a in arrays],
                                   _t(zs))
    ref = jinterp.morph_templates(jnp.asarray(tensor), arrays,
                                  jnp.asarray(zs))
    _close(port, ref)
    # and the host twin the morphers use
    np.testing.assert_allclose(
        tinterp.morph_templates_np(tensor, arrays, zs),
        jinterp.morph_templates_np(tensor, arrays, zs), rtol=RTOL)


def test_binned_poisson_logl():
    rng = np.random.default_rng(5)
    mus = rng.random(3) * 100
    pmfs = rng.random((3, 6, 5))
    observed = rng.poisson(20.0, (6, 5)).astype(float)
    observed[1, 1] = 0.0
    # A zero-expectation bin, left empty: with counts in it, the JAX twin's
    # floor max(lambda, tiny) / k is a denormal that XLA's CPU flushes to
    # zero (-inf), where torch keeps the floor's finite k*log(tiny/k)
    pmfs[:, 1, 1] = 0.0
    for include_constant in (True, False):
        port = tpoisson.binned_poisson_logl(_t(mus), _t(pmfs), _t(observed),
                                            include_constant)
        ref = jpoisson.binned_poisson_logl(mus, pmfs, observed,
                                           include_constant)
        _close(port, ref)
    # negative expectations (in bins left empty, as above) take the
    # linear penalty
    mus_neg = mus.copy()
    mus_neg[2] = -50.0
    negative = np.tensordot(mus_neg, pmfs, axes=(0, 0)) < 0
    assert negative.any()
    observed[negative] = 0.0
    _close(tpoisson.binned_poisson_logl(_t(mus_neg), _t(pmfs), _t(observed)),
           jpoisson.binned_poisson_logl(mus_neg, pmfs, observed))


def test_binned_poisson_logl_constant_batched():
    observed = np.random.default_rng(6).poisson(4.0, (3, 6, 5)).astype(float)
    port = tpoisson.binned_poisson_logl_constant(_t(observed), batch_dims=1)
    ref = [jpoisson.binned_poisson_logl_constant(o) for o in observed]
    _close(port, np.array(ref))
    _close(tpoisson.binned_poisson_logl_constant(_t(observed[0])), ref[0])
