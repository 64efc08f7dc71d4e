"""The port on the reduced XENON1T-style likelihood (12x10 bins, the same 6
sources and 3^4 = 81 anchors as tests/test_xenon_example.py) against the JAX
package, float64 on the CPU: host template builds, the compiled likelihood
and the fit engine's chained value/gradient/Hessian. The whole profile toy
study is compared in test_torch_xenon_study.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.compile import build_logl as jax_build_logl
from blueice_tpu.examples.xenon_like import build_likelihood as jax_build
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.compile import build_logl
from blueice_tpu_torch.convert import (build_logl_from_state,
                                       state_from_reference)
from blueice_tpu_torch.examples.xenon_like import build_likelihood
from blueice_tpu_torch.parallel import fitter as tfitter
from blueice_tpu_torch.utils import set_progress

SIZE = dict(n_cs1_bins=12, n_cs2_bins=10, livetime_days=30.0)
TARGET = 'wimp_rate_multiplier'


@pytest.fixture(scope='module')
def lfs():
    set_progress(False)
    jax_set_progress(False)
    return jax_build('binned', **SIZE), build_likelihood('binned', **SIZE)


@pytest.fixture(scope='module')
def compiled(lfs):
    jlf, tlf = lfs
    return jax_build_logl(jlf), build_logl(tlf, device='cpu')


@pytest.fixture(scope='module')
def counts(compiled):
    """8 toy count tensors, Poisson draws at the default parameters."""
    expected = compiled[1].expected_counts(compiled[1].defaults).numpy()
    return np.random.default_rng(0).poisson(
        expected, size=(8,) + expected.shape).astype(float)


def test_host_builds_match(lfs):
    jlf, tlf = lfs
    assert len(tlf.anchor_models) == 3 ** 4
    for name in ('mus', 'ps'):
        a, b = jlf._builds[name][2], tlf._builds[name][2]
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)


POINTS = [dict(),
          dict(wimp_rate_multiplier=2.0, band_shift=0.3),
          dict(efficiency=0.85, cs1_tilt=-0.5, band_width_scale=1.1),
          dict(er_rate_multiplier=0.95, nr_rate_multiplier=1.2,
               band_shift=-1.0),
          dict(efficiency=1.3, band_width_scale=0.8, cs1_tilt=0.999)]


@pytest.mark.parametrize("point", POINTS)
def test_logl_matches(lfs, compiled, counts, point):
    jlf, _ = lfs
    jc, tc = compiled
    from_state = build_logl_from_state(state_from_reference(jlf),
                                       device='cpu')
    data = counts[0]
    ref = float(jc.logl_with_data(jc.params_from_kwargs(**point),
                                  jnp.asarray(data)))
    for c in (tc, from_state):
        port = float(c.logl_with_data(c.params_from_kwargs(**point),
                                      torch.as_tensor(data)))
        np.testing.assert_allclose(port, ref, rtol=1e-10)


@pytest.mark.parametrize("conditional", [False, True])
def test_chained_vgh_matches(compiled, counts, conditional):
    """The fit objective's value, gradient and Hessian in the optimizer's u
    space — the closed-form (m, t) engine chained through transforms, rate
    morphing, efficiency and priors — against the JAX engine's, at the start
    point (every shape parameter exactly on an anchor) and at random u."""
    jc, tc = compiled
    runtime = [TARGET] if conditional else []
    fixed = {TARGET: 1.0} if conditional else {}
    jnames, jfixed, jtr, x0 = jfitter._floating_setup(jc, dict(fixed))
    tnames, tfixed, ttr, _ = tfitter._floating_setup(tc, dict(fixed))
    assert jnames == tnames
    _, jvgh, _ = jfitter._make_analytic_parts(
        jc, jnames, jfixed, jtr, runtime_fixed=runtime)
    jvgh = jax.jit(jvgh)
    _, tvgh = tfitter._make_analytic_parts(
        tc, tnames, tfixed, ttr, use_fused=True, runtime_fixed=runtime)
    rng = np.random.default_rng(1)
    u0 = jtr.to_u_np(x0)
    us = np.stack([u0] + [u0 + 0.3 * rng.standard_normal(u0.shape)
                          for _ in range(3)])
    fv = np.array([1.3] if conditional else [])
    data = counts[:len(us)].reshape(len(us), -1)
    val, g, H = tvgh(torch.as_tensor(us), torch.as_tensor(data),
                     torch.as_tensor(fv).expand(len(us), -1))
    for i, u in enumerate(us):
        rv, rg, rH = (np.asarray(x) for x in jvgh(
            jnp.asarray(u), jnp.asarray(data[i]), tuple(jnp.asarray(fv))))
        np.testing.assert_allclose(float(val[i]), rv, rtol=1e-10)
        np.testing.assert_allclose(g[i].numpy(), rg, rtol=1e-9,
                                   atol=1e-10 * np.abs(rg).max())
        np.testing.assert_allclose(H[i].numpy(), rH, rtol=1e-8,
                                   atol=1e-10 * np.abs(rH).max())


@pytest.mark.parametrize("point", POINTS[:3])
def test_host_simulation_and_likelihood_match(lfs, point):
    """The numpy host layer: the same seed draws the same toy events in both
    packages, and the host likelihood of those events agrees."""
    jlf, tlf = lfs
    d_j = jlf.base_model.simulate(rng=np.random.default_rng(7))
    d_t = tlf.base_model.simulate(rng=np.random.default_rng(7))
    np.testing.assert_array_equal(d_t, d_j)
    jlf.set_data(d_j)
    tlf.set_data(d_t)
    np.testing.assert_array_equal(tlf.data_events_per_bin.values,
                                  jlf.data_events_per_bin.values)
    np.testing.assert_allclose(tlf(**point), jlf(**point), rtol=1e-12)
    assert tlf(band_shift=5.0) == -float('inf')
    # the compiled likelihood on the bound data is the host likelihood
    compiled = tlf.make_logl(device='cpu')
    np.testing.assert_allclose(float(compiled(**point)), tlf(**point),
                               rtol=1e-10)
    assert float(compiled(band_shift=5.0)) == -float('inf')
