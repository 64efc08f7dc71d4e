"""Geometric (log) template morphing in the port against the JAX package,
float64 on the CPU: the LogMorpher's host and torch evaluations, the closed
forms ``binned_vgh_log`` / ``binned_ll_log`` on numpy-made corners, the
compiled log-morphed likelihood, and the fits of a small XENON-like model's
toys on the same numpy-made counts.

Tolerances: the morpher rtol 1e-12; the closed forms' ll rtol 1e-10, g and
H within 1e-9 of each lane's largest entry; the compiled logl rtol 1e-10;
the fits max_ll rtol 1e-8, x atol 2e-3 (as
``test_torch_small_models.py``)."""

import tempfile
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.morphers import GridInterpolator as JaxGrid
from blueice_tpu.morphers import LogMorpher as JaxLogMorpher
from blueice_tpu.ops import binned_vgh as jops
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.priors import NormalPrior as JaxNormal
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.compile import build_logl
from blueice_tpu_torch.convert import state_from_reference
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.likelihood import (BinnedLogLikelihood,
                                          UnbinnedLogLikelihood)
from blueice_tpu_torch.morphers import GridInterpolator, LogMorpher
from blueice_tpu_torch.ops import binned_vgh as tops
from blueice_tpu_torch.parallel import BinnedToyStudy, make_toy_fitter
from blueice_tpu_torch.parallel import fitter as tfitter
from blueice_tpu_torch.priors import NormalPrior
from blueice_tpu_torch.utils import set_progress

TARGET = 'wimp_rate_multiplier'
JAX = SimpleNamespace(Binned=JaxBinned, Source=jxenon.GaussianBlobSource,
                      Normal=JaxNormal)
PORT = SimpleNamespace(Binned=BinnedLogLikelihood,
                       Source=txenon.GaussianBlobSource, Normal=NormalPrior)


def blob_likelihood(pkg, interp='linear', livetime=30.0, K=1,
                    register_wimp=True, likelihood_config=None):
    """A small XENON-like binned model (ER and WIMP blobs over 8 x 6 bins)
    of either package: ``K`` shape parameters (band_shift, then
    band_width_scale) on 3 anchors each, the ER rate constrained."""
    set_progress(False)
    jax_set_progress(False)
    sources = []
    for name, rate, mean, sigma, corr, resp in (jxenon.SOURCES[0],
                                               jxenon.SOURCES[5]):
        sources.append(dict(name=name, events_per_day=rate / 20,
                            blob_mean=mean, blob_sigma=sigma, blob_corr=corr,
                            band_shift_response=resp[0],
                            width_response=resp[1], tilt_response=resp[2]))
    config = dict(analysis_space=[['cs1', np.linspace(0, 100, 9)],
                                  ['log10_cs2', np.linspace(1.0, 4.0, 7)]],
                  default_source_class=pkg.Source, livetime_days=livetime,
                  band_shift=0.0, band_width_scale=1.0, cs1_tilt=0.0,
                  sources=sources,
                  cache_dir=tempfile.mkdtemp(prefix='log_morph_cache_'))
    lf = pkg.Binned(config, likelihood_config=dict(
        likelihood_config or {}, template_interpolation=interp))
    if register_wimp:
        lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=pkg.Normal(1, 0.05))
    if K >= 1:
        lf.add_shape_parameter('band_shift', (-1.0, 0.0, 1.0),
                               log_prior=pkg.Normal(0, 0.5))
    if K >= 2:
        lf.add_shape_parameter('band_width_scale', (0.8, 1.0, 1.2),
                               log_prior=pkg.Normal(1, 0.1))
    lf.prepare()
    return lf


def _rel_to_lane_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).reshape(b.shape[0], -1).max(1)
    return float((np.abs(a - b).reshape(b.shape[0], -1).max(1)
                  / scale).max())


@pytest.mark.parametrize("K", [1, 2])
def test_log_morpher_host_and_torch_match(K):
    rng = np.random.default_rng(K)
    shape_parameters = {
        'a%d' % d: ({z: z for z in (-1.0, 0.0, 1.5)}, None, 0.0)
        for d in range(K)}
    tensor = rng.random((3,) * K + (2, 4, 5)) * 2.0
    tensor[(0,) * K + (0, 0, 0)] = 0.0          # a floored bin
    jm = JaxLogMorpher(JaxGrid({}, shape_parameters), n_template_axes=2)
    tm = LogMorpher(GridInterpolator({}, shape_parameters),
                    n_template_axes=2)
    jlog = jm.build_tensor(lambda m: m, [2, 4, 5],
                           {z: tensor[tuple(np.searchsorted(
                               [-1.0, 0.0, 1.5], z))]
                            for z in jm.get_anchor_points()})
    tlog = tm.build_tensor(lambda m: m, [2, 4, 5],
                           {z: tensor[tuple(np.searchsorted(
                               [-1.0, 0.0, 1.5], z))]
                            for z in tm.get_anchor_points()})
    np.testing.assert_array_equal(tlog, jlog)
    for zs in (np.full(K, 0.3), np.linspace(-0.9, 1.4, K), np.zeros(K)):
        ref = jm.host_eval(jlog, zs)
        np.testing.assert_allclose(tm.host_eval(tlog, zs), ref, rtol=1e-12)
        out = tm.eval(torch.as_tensor(tlog), torch.as_tensor(zs))
        np.testing.assert_allclose(out.numpy(),
                                   np.asarray(jm.jax_eval(jlog, zs)),
                                   rtol=1e-12)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("K", [0, 1, 2, 3])
def test_binned_vgh_log_matches(K):
    """The closed forms on numpy-made corners, a batch of lanes against the
    JAX package's vmapped over the lanes."""
    rng = np.random.default_rng(10 + K)
    B, C, S, N = 5, 2 ** K, 3, 17
    log_corners = np.log(rng.random((B, C, S, N)) + 1e-3)
    masses = np.exp(log_corners).sum(-1) * rng.uniform(0.9, 1.1, (B, C, S))
    m = rng.random((B, S)) * 20 + 1
    t = rng.random((B, K))
    k = rng.poisson(4.0, (B, N)).astype(float)
    args = [torch.as_tensor(a) for a in (log_corners, masses, m, t, k)]
    ll, g, H = tops.binned_vgh_log(*args)
    value = tops.binned_ll_log(*args)
    jargs = [jnp.asarray(a) for a in (log_corners, masses, m, t, k)]
    ref_ll, ref_g, ref_H = jax.vmap(jops.binned_vgh_log)(*jargs)
    ref_value = jax.vmap(jops.binned_ll_log)(*jargs)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ref_ll), rtol=1e-10)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_value),
                               rtol=1e-10)
    assert _rel_to_lane_max(g, ref_g) < 1e-9
    assert _rel_to_lane_max(H, ref_H) < 1e-9


def test_log_morphed_likelihood_matches():
    """The compiled log-morphed likelihood (its own build and the bridge
    of the JAX one) against the JAX package's: logl and the morphed pmfs,
    at the defaults and between anchors."""
    jlf = blob_likelihood(JAX, 'log', K=2)
    tlf = blob_likelihood(PORT, 'log', K=2)
    assert type(tlf._builds['ps'][1]).__name__ == 'LogMorpher'
    np.testing.assert_array_equal(tlf._builds['ps'][2], jlf._builds['ps'][2])
    own = build_logl(tlf, device='cpu')
    counts = np.random.default_rng(3).poisson(
        own.expected_counts(own.defaults).numpy())
    from blueice_tpu.compile import build_logl as jbuild
    jc = jbuild(jlf)
    state = state_from_reference(jlf)
    assert state['log_morph']
    np.testing.assert_allclose(
        state['masses'], np.exp(jlf._builds['ps'][2]).sum(axis=(-2, -1)),
        rtol=1e-15)
    for tc in (own, build_logl(jlf, device='cpu')):
        assert tc.log_morph
        for point in ({}, dict(band_shift=0.37, band_width_scale=1.13,
                               wimp_rate_multiplier=2.0),
                      dict(band_shift=-0.81, band_width_scale=0.86)):
            p = tc.params_from_kwargs(**point)
            ref = float(jc.logl_with_data(jc.params_from_kwargs(**point),
                                          jnp.asarray(counts, dtype=float)))
            out = float(tc.logl_with_data(p, torch.as_tensor(
                counts, dtype=torch.float64)))
            np.testing.assert_allclose(out, ref, rtol=1e-10)
            np.testing.assert_allclose(
                tc.densities(p).numpy(),
                np.asarray(jc.densities(jc.params_from_kwargs(**point))),
                rtol=1e-10)


def test_log_fits_match():
    """The fits of a toy ensemble of the log-morphed model on the same
    numpy counts: the port's closed-form log engine against the JAX
    package's (a whole profile of a Sum with a log-morphed child:
    ``test_torch_composition.py``)."""
    jlf = blob_likelihood(JAX, 'log', K=1)
    tlf = blob_likelihood(PORT, 'log', K=1)
    jstudy = JaxStudy(jlf, max_iter=40, engine='analytic')
    tstudy = BinnedToyStudy(tlf, device='cpu', max_iter=40)
    expected = tstudy.expected_counts().numpy()
    np.testing.assert_allclose(expected, np.asarray(jstudy.expected_counts()),
                               rtol=1e-12)
    counts = np.random.default_rng(5).poisson(
        expected, size=(8,) + expected.shape).astype(float)
    ref = jstudy.fit_toys(jnp.asarray(counts))
    port = tstudy.fit_toys(counts)
    assert port.names == ref.names
    np.testing.assert_allclose(port.max_ll, ref.max_ll, rtol=1e-8)
    np.testing.assert_allclose(port.x, ref.x, rtol=2e-3, atol=2e-3)


def test_log_morphing_options_are_checked():
    """The validation of the JAX package: an unknown interpolation is a
    ValueError, log morphing of an unbinned likelihood NotImplementedError
    (as there); a log-morphed model never takes the kernels ('auto' is
    the closed form, 'fused' raises), and with a Beeston-Barlow mode it is
    the autodiff engine's: its fits of numpy-made toys are the JAX
    package's (max_ll 1e-6, x 2e-3)."""
    config = txenon.build_config(n_cs1_bins=4, n_cs2_bins=3)
    for cls, jcls in ((BinnedLogLikelihood, JaxBinned),
                      (UnbinnedLogLikelihood, JaxUnbinned)):
        for pkg_cls in (cls, jcls):
            with pytest.raises(ValueError, match='template_interpolation'):
                pkg_cls(dict(config), likelihood_config=dict(
                    template_interpolation='cubic'))
    for pkg_cls in (UnbinnedLogLikelihood, JaxUnbinned):
        with pytest.raises(NotImplementedError, match='binned'):
            pkg_cls(dict(config), likelihood_config=dict(
                template_interpolation='log'))
    compiled = build_logl(blob_likelihood(PORT, 'log'), device='cpu')
    assert not tfitter._fused_eligible(compiled)
    with pytest.raises(ValueError, match='linear template morphing'):
        make_toy_fitter(compiled, engine='fused')
    from blueice_tpu.compile import build_logl as jbuild
    from blueice_tpu.parallel import fitter as jfitter
    jbb = blob_likelihood(JAX, 'log', likelihood_config=dict(
        model_statistical_uncertainty_handling='bb_lite'))
    bb = build_logl(jbb, device='cpu')
    assert tfitter._engine_family(bb) == 'ad'
    counts = np.random.default_rng(5).poisson(
        bb.expected_counts(bb.defaults).numpy(), (3, 8, 6)).astype(float)
    x, ll, _ = make_toy_fitter(bb)[0](counts)
    jfit = jfitter.make_toy_fitter(jbuild(jbb))[0]
    jx, jll, _ = jax.vmap(lambda d: jfit(d))(jnp.asarray(counts))
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-3,
                               atol=2e-3)
