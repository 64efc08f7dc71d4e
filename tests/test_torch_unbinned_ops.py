"""The port's extended unbinned likelihood ops against the JAX package,
float64 on the CPU, on the same numpy-made inputs: ``extended_logl`` and its
host twin, the batched closed forms ``unbinned_vgh`` / ``unbinned_ll`` /
``reference_center`` (with masks, outlier floors and events whose density
is not positive), the centering identities, and the host
``UnbinnedLogLikelihood`` after ``set_data``.

Tolerances: values rtol 1e-12 where both sides sum the same terms (host
value 1e-12, closed forms 1e-10); gradients 1e-9 and Hessians 1e-8, as
tests/test_torch_fused.py (the summation orders differ)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.examples.xenon_like import build_likelihood as jax_build
from blueice_tpu.likelihood import \
    extended_loglikelihood as jax_extended_host
from blueice_tpu.ops import poisson as jpoisson
from blueice_tpu.ops import unbinned_vgh as jvgh
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.examples.xenon_like import build_likelihood
from blueice_tpu_torch.likelihood import extended_loglikelihood
from blueice_tpu_torch.ops import poisson, unbinned_vgh as tvgh
from blueice_tpu_torch.utils import set_progress

from test_torch_profile_grid_map import fresh_template_caches  # noqa: F401,E402

S, E, B = 3, 150, 4
SIZE = dict(n_cs1_bins=8, n_cs2_bins=6, livetime_days=1.0)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _events(seed=0, E=E, negative=True):
    """Densities (S, E) with masked tail events and, with ``negative``,
    events whose summed density is 0 or negative (a source below zero)."""
    rng = np.random.default_rng(seed)
    ps = rng.uniform(0.01, 1.0, (S, E))
    mus = rng.uniform(5.0, 50.0, S)
    mask = np.arange(E) < E - 17
    if negative:
        ps[:, 3] = 0.0
        ps[0, 7] = -10.0
    return mus, ps, mask


@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("masked", [False, True])
def test_extended_logl_matches(outlier, masked):
    mus, ps, mask = _events(negative=outlier != 0)
    m = mask if masked else None
    ref = float(jpoisson.extended_logl(jnp.asarray(mus), jnp.asarray(ps),
                                       outlier, None if m is None
                                       else jnp.asarray(m)))
    port = float(poisson.extended_logl(_t(mus), _t(ps), outlier,
                                       None if m is None else _t(m, torch.bool)))
    np.testing.assert_allclose(port, ref, rtol=1e-12)
    np.testing.assert_allclose(
        poisson.extended_logl_np(mus, ps, outlier, m), ref, rtol=1e-12)
    if not masked:
        np.testing.assert_allclose(
            extended_loglikelihood(mus, ps, outlier),
            jax_extended_host(mus, ps, outlier), rtol=1e-12)


def _corner_problem(K, seed=0, outlier_events=True):
    """(corners (B, 2^K, S, E), m (B, S), t (B, K), mask (B, E)) with masked
    tails of different lengths and, per toy, an event of zero and one of
    negative summed density."""
    rng = np.random.default_rng(seed + 10 * K)
    C = 2 ** K
    corners = rng.uniform(0.01, 1.0, (B, C, S, E))
    if outlier_events:
        corners[:, :, :, 2] = 0.0
        corners[:, :, 0, 5] = -40.0
    m = rng.uniform(5.0, 50.0, (B, S))
    t = rng.uniform(0, 1, (B, K))
    n_valid = rng.integers(E // 2, E, B)
    mask = np.arange(E)[None, :] < n_valid[:, None]
    return corners, m, t, mask


def _jax_vmap(fn, *args, **kwargs):
    return jax.vmap(lambda *a: fn(*a, **kwargs))(*(jnp.asarray(a)
                                                    for a in args))


@pytest.mark.parametrize("K", [0, 1, 2])
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
def test_vgh_and_ll_match(K, outlier):
    corners, m, t, mask = _corner_problem(K, outlier_events=outlier != 0)
    args = (_t(corners), _t(m), _t(t), _t(mask, torch.bool))
    ll, g, H = tvgh.unbinned_vgh(*args, outlier_likelihood=outlier)
    rll, rg, rH = _jax_vmap(jvgh.unbinned_vgh, corners, m, t, mask,
                            outlier_likelihood=outlier)
    np.testing.assert_allclose(ll.numpy(), np.asarray(rll), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(H.numpy(), np.asarray(rH), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(
        tvgh.unbinned_ll(*args, outlier_likelihood=outlier).numpy(),
        np.asarray(_jax_vmap(jvgh.unbinned_ll, corners, m, t, mask,
                             outlier_likelihood=outlier)), rtol=1e-10)


@pytest.mark.parametrize("K", [0, 2])
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
def test_reference_center_matches(K, outlier):
    """inv_ref is 1 at masked events and where the reference density is not
    positive; the centered values and ref_ll match JAX."""
    corners, m, t, mask = _corner_problem(K, seed=1,
                                          outlier_events=outlier != 0)
    args = (_t(corners), _t(m), _t(t), _t(mask, torch.bool))
    inv_ref, ref_msum, ref_ll = tvgh.reference_center(*args, outlier)
    rinv, rmsum, rll = _jax_vmap(jvgh.reference_center, corners, m, t, mask,
                                 outlier_likelihood=outlier)
    assert ref_ll.dtype == torch.float64
    np.testing.assert_allclose(inv_ref.numpy(), np.asarray(rinv), rtol=1e-14)
    np.testing.assert_allclose(ref_msum.numpy(), np.asarray(rmsum),
                               rtol=1e-14)
    np.testing.assert_allclose(ref_ll.numpy(), np.asarray(rll), rtol=1e-12)
    assert (inv_ref.numpy()[~mask] == 1).all()
    m2 = m * 1.02
    port = tvgh.unbinned_vgh(args[0], _t(m2), args[2], args[3], outlier,
                             inv_ref=inv_ref, ref_msum=ref_msum)
    ref = jax.vmap(lambda c, mm, tt, mk, ir, rs: jvgh.unbinned_vgh(
        c, mm, tt, mk, outlier, inv_ref=ir, ref_msum=rs))(
            *(jnp.asarray(a) for a in (corners, m2, t, mask)), rinv, rmsum)
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-9, atol=1e-12)


def test_centering_properties():
    """centered + ref_ll = plain at any point; g and H do not depend on the
    center (tests/test_unbinned_centering.py's identities, batched)."""
    corners, m, t, mask = _corner_problem(1, seed=2, outlier_events=False)
    c, mm, tt, mk = _t(corners), _t(m), _t(t), _t(mask, torch.bool)
    inv_ref, ref_msum, ref_ll = tvgh.reference_center(c, mm, tt, mk)
    assert np.abs(tvgh.unbinned_ll(c, mm, tt, mk, inv_ref=inv_ref,
                                   ref_msum=ref_msum).numpy()).max() < 1e-9
    m2, t2 = mm * 1.01, torch.clamp(tt + 0.05, max=1.0)
    plain = tvgh.unbinned_vgh(c, m2, t2, mk)
    centered = tvgh.unbinned_vgh(c, m2, t2, mk, inv_ref=inv_ref,
                                 ref_msum=ref_msum)
    np.testing.assert_allclose((centered[0] + ref_ll).numpy(),
                               plain[0].numpy(), rtol=1e-12)
    for a, b in zip(plain[1:], centered[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


@pytest.fixture(scope='module')
def lfs():
    set_progress(False)
    jax_set_progress(False)
    return jax_build('unbinned', **SIZE), build_likelihood('unbinned', **SIZE)


POINTS = [dict(),
          dict(wimp_rate_multiplier=2.0, band_shift=0.3),
          dict(efficiency=0.85, cs1_tilt=-0.5, band_width_scale=1.1)]


def test_host_unbinned_likelihood_matches(lfs):
    """The same seed draws the same events in both packages; after
    set_data the per-event anchor tensors and the host likelihood agree,
    at anchor-interpolated points and (compute_pdf) at exact models."""
    jlf, tlf = lfs
    d = tlf.base_model.simulate(rng=np.random.default_rng(3))
    np.testing.assert_array_equal(
        d, jlf.base_model.simulate(rng=np.random.default_rng(3)))
    jlf.set_data(d)
    tlf.set_data(d)
    assert tlf._builds['ps'][2].shape == (3, 3, 3, 3, 6, len(d))
    np.testing.assert_allclose(tlf._builds['ps'][2], jlf._builds['ps'][2],
                               rtol=1e-13, atol=0)
    for point in POINTS:
        np.testing.assert_allclose(tlf(**point), jlf(**point), rtol=1e-12)
    point = dict(band_shift=0.3, cs1_tilt=-0.2)
    np.testing.assert_allclose(tlf(compute_pdf=True, **point),
                               jlf(compute_pdf=True, **point), rtol=1e-12)
    assert tlf(band_shift=5.0) == -float('inf')
    compiled = tlf.make_logl(device='cpu')
    for point in POINTS:
        np.testing.assert_allclose(float(compiled(**point)), tlf(**point),
                                   rtol=1e-10)


def _gauss_lf(helpers, cls, seed):
    """bench.py's Gaussian unbinned model at a smaller MC sample: two MC
    sources (s1 at mu = 3), the shape parameter mu on 3 anchors."""
    np.random.seed(seed)
    conf = helpers.conf_for_test(
        n_sources=2, mc=True, analysis_space=[['x', np.linspace(-10, 10, 101)]],
        n_events_for_pdf=int(2e4))
    conf['sources'][1]['mu'] = 3.0
    lf = cls(conf)
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    lf.prepare()
    return lf


def test_gaussian_scenario_matches():
    """The port's test_helpers build the same Gaussian scenario as the JAX
    package's: the same MC templates from the same global seed, and the
    same host likelihood of the same events; the analytic GaussianSource
    has the closed-form pdf."""
    from blueice_tpu import test_helpers as jhelpers
    from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
    from blueice_tpu_torch import test_helpers
    from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
    set_progress(False)
    jax_set_progress(False)
    jlf = _gauss_lf(jhelpers, JaxUnbinned, 4)
    tlf = _gauss_lf(test_helpers, UnbinnedLogLikelihood, 4)
    np.testing.assert_allclose(tlf._builds['mus'][2], jlf._builds['mus'][2],
                               rtol=1e-13)
    d = np.zeros(300, dtype=[('x', float), ('source', int)])
    d['x'] = np.random.default_rng(0).normal(1.0, 2.0, 300)
    jlf.set_data(d)
    tlf.set_data(d)
    np.testing.assert_allclose(tlf._builds['ps'][2], jlf._builds['ps'][2],
                               rtol=1e-13)
    for point in (dict(), dict(s0_rate_multiplier=1.3, mu=0.4)):
        np.testing.assert_allclose(tlf(**point), jlf(**point), rtol=1e-12)
    lf = UnbinnedLogLikelihood(test_helpers.conf_for_test(n_sources=1))
    lf.prepare()
    lf.set_data(d)
    x = d['x']
    pdf = np.exp(-0.5 * x ** 2) / np.sqrt(2 * np.pi)
    np.testing.assert_allclose(lf.ps[0], pdf, rtol=1e-14)
