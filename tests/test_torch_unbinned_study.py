"""The port's unbinned profile toy study against the JAX package's, float64
on the CPU.

(a) A small unbinned model (two blob sources on an 8 x 6 grid, one shape
    parameter on 3 anchors): the same numpy-made event sets are scored by
    JAX's ``UnbinnedToyStudy._score_sampled`` and the port's scorer, and
    fitted by JAX's closed-form fitter and the port's (engine 'fused': the
    kernels' plain versions here), free and conditional: max_ll rtol 1e-8,
    x rtol/atol 2e-3, t atol 1e-4, as the binned study tests.
(b) The port's sampler, by statistics: event-count mean and variance, a
    chi-square of the drawn bins against ``expected_weights``, zero-weight
    and negative-net bins never drawn, positions inside their bins, and
    the truncation warning.
(c) The XENON1T-style unbinned likelihood: the port's study holds the same
    pdf tensor, rates and expected weights as JAX's, and a likelihood read
    from the JAX package through ``convert.state_from_reference`` (data-free
    and data-bound) compiles to the same values.
(d) Without CUDA the study's default device raises; ``device='cpu'`` runs.
"""

import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.compile import build_logl as jax_build_logl
from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.parallel import UnbinnedToyStudy as JaxStudy
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.priors import NormalPrior as JaxNormal
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.convert import (build_logl_from_state,
                                       state_from_reference)
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
from blueice_tpu_torch.parallel import UnbinnedToyStudy
from blueice_tpu_torch.priors import NormalPrior
from blueice_tpu_torch.utils import set_progress

TARGET = 'wimp_rate_multiplier'
N_TOYS = 6


def _config(source_class, scale=20.0):
    space = [['cs1', np.linspace(0, 100, 9)],
             ['log10_cs2', np.linspace(1.0, 4.0, 7)]]
    sources = []
    for name, rate, mean, sigma, corr, resp in (jxenon.SOURCES[0],
                                               jxenon.SOURCES[5]):
        sources.append(dict(name=name, events_per_day=rate / scale,
                            blob_mean=mean, blob_sigma=sigma, blob_corr=corr,
                            band_shift_response=resp[0],
                            width_response=resp[1], tilt_response=resp[2]))
    return dict(analysis_space=space, default_source_class=source_class,
                livetime_days=30.0, band_shift=0.0, band_width_scale=1.0,
                cs1_tilt=0.0, sources=sources,
                cache_dir=tempfile.mkdtemp(prefix='small_unbinned_cache_'))


def _likelihood(cls, source_class, prior, scale=20.0):
    lf = cls(_config(source_class, scale))
    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=prior(1, 0.05))
    lf.add_shape_parameter('band_shift', (-1.0, 0.0, 1.0),
                           log_prior=prior(0, 0.5))
    lf.prepare()
    return lf


def _numpy_events(weights, n_max, n_toys, edges, seed):
    """Event sets drawn with numpy: (coords, mask, bins) as the port's
    sampler returns them."""
    rng = np.random.default_rng(seed)
    w = np.clip(weights.sum(0), 0, None)
    p = w.ravel() / w.sum()
    n = np.minimum(rng.poisson(w.sum(), n_toys), n_max)
    flat = rng.choice(p.size, size=(n_toys, n_max), p=p)
    bins = np.stack(np.unravel_index(flat, w.shape), axis=-1)
    u = rng.random(bins.shape)
    coords = np.stack([e[bins[..., d]] + u[..., d] * np.diff(e)[bins[..., d]]
                       for d, e in enumerate(edges)], axis=-1)
    return coords, np.arange(n_max)[None, :] < n[:, None], bins


@pytest.fixture(scope='module')
def small():
    set_progress(False)
    jax_set_progress(False)
    jlf = _likelihood(JaxUnbinned, jxenon.GaussianBlobSource, JaxNormal)
    tlf = _likelihood(UnbinnedLogLikelihood, txenon.GaussianBlobSource,
                      NormalPrior)
    jstudy = JaxStudy(jlf, max_iter=40, engine='analytic', two_stage=False)
    tstudy = UnbinnedToyStudy(tlf, device='cpu', max_iter=40,
                              engine='fused', two_stage=False)
    weights = tstudy.expected_weights().numpy()
    events = _numpy_events(weights, tstudy.n_max, N_TOYS, tstudy.edges, 0)
    return jstudy, tstudy, events


def test_scoring_matches(small):
    jstudy, tstudy, (coords, mask, bins) = small
    assert jstudy.n_max == tstudy.n_max
    ps = tstudy.score_events(coords, bins)
    ref = jax.vmap(lambda c, b: jstudy._score_sampled(
        c, tuple(b[:, d] for d in range(b.shape[1]))))(
            jnp.asarray(coords), jnp.asarray(bins))
    ref = np.asarray(ref).reshape(ps.shape)
    assert ps.shape == (N_TOYS, 3, 2, tstudy.n_max)
    np.testing.assert_allclose(ps.numpy(), ref, rtol=1e-12, atol=0)


def test_profile_study_matches(small):
    """Free and conditional fits of the same event sets: the JAX fitter
    vmapped over (ps, mask) against the port's batched study."""
    jstudy, tstudy, events = small
    coords, mask, bins = events
    tt, tfree, tcond = tstudy._run_profile(events, TARGET, 1.0, None)

    ps = jnp.asarray(tstudy.score_events(coords, bins).numpy())
    ps = ps.reshape(ps.shape[0], -1, ps.shape[-1])
    mask_j = jnp.asarray(mask)
    fit_free, names_free = jfitter.make_toy_fitter(
        jstudy.compiled, max_iter=40, engine='analytic')
    fit_cond, names_cond = jfitter.make_toy_fitter(
        jstudy.compiled, runtime_fixed=[TARGET], max_iter=40,
        engine='analytic')
    xf, llf, itf = jax.jit(jax.vmap(fit_free))(ps, mask_j)
    warm = jnp.asarray([names_free.index(n) for n in names_cond])
    xc, llc, itc = jax.jit(jax.vmap(
        lambda p, mk, x0: fit_cond(p, mk, (jnp.asarray(1.0),), x0)))(
            ps, mask_j, xf[:, warm])
    assert tfree.names == names_free and tcond.names == names_cond
    for port, (x, ll) in ((tfree, (xf, llf)), (tcond, (xc, llc))):
        np.testing.assert_allclose(port.max_ll, np.asarray(ll), rtol=1e-8)
        np.testing.assert_allclose(port.x, np.asarray(x), rtol=2e-3,
                                   atol=2e-3)
    jt = np.maximum(2.0 * (np.asarray(llf) - np.asarray(llc)), 0.0)
    np.testing.assert_allclose(tt, jt, atol=1e-4)
    assert (tt >= 0).all()
    # the absolute optimum is the host likelihood's value at that point
    tlf = tstudy.lf
    n0 = int(mask[0].sum())
    tlf.set_data(dict(cs1=coords[0, :n0, 0], log10_cs2=coords[0, :n0, 1]))
    point = dict(zip(tfree.names, tfree.x[0]))
    np.testing.assert_allclose(tlf(**point), tfree.max_ll[0], rtol=1e-10)


def test_sampler_statistics():
    """Event counts are Poisson(total) (mean and variance), bins are drawn
    in proportion to the expected weights (chi-square), positions lie in
    their bins, and a toy never holds more than n_max events."""
    set_progress(False)
    lf = _likelihood(UnbinnedLogLikelihood, txenon.GaussianBlobSource,
                     NormalPrior, scale=200.0)
    study = UnbinnedToyStudy(lf, device='cpu')
    weights = study.expected_weights()
    total = float(weights.sum())
    coords, mask, bins = study.simulate(0, 3000)
    n = mask.sum(1).double()
    assert abs(float(n.mean()) - total) < 4 * np.sqrt(total / 3000)
    assert abs(float(n.var()) / total - 1) < 0.1
    assert (mask[:, :-1] >= mask[:, 1:]).all()          # valid events first
    flat = (bins[..., 0] * 6 + bins[..., 1])[mask]
    observed = np.bincount(flat.numpy(), minlength=48)
    expected = weights.sum(0).reshape(-1).numpy() / total * flat.numel()
    keep = expected > 5
    chi2 = float((((observed - expected) ** 2 / expected)[keep]).sum())
    assert chi2 < keep.sum() + 5 * np.sqrt(2 * keep.sum())
    edges = study.edges
    for d in range(2):
        b = bins[..., d].numpy()
        x = coords[..., d].numpy()
        assert ((edges[d][b] <= x) & (x <= edges[d][b + 1])).all()
    assert study.simulate(1, 4)[0].equal(study.simulate(1, 4)[0])


def test_sampler_clamps_and_skips_empty_bins():
    """A zero-weight bin is never drawn; a bin whose net weight is negative
    (an allow_negative source below zero) counts as empty, and the event
    count draws from the clamped total."""
    set_progress(False)
    lf = _likelihood(UnbinnedLogLikelihood, txenon.GaussianBlobSource,
                     NormalPrior, scale=200.0)
    study = UnbinnedToyStudy(lf, device='cpu', n_max=400)
    w = torch.full((2, 8, 6), 1.0, dtype=torch.float64)
    w[:, 2, 3] = 0.0
    w[0, 5, 1], w[1, 5, 1] = -4.0, 1.0                  # net -3
    gen = torch.Generator().manual_seed(0)
    coords, mask, bins = study._sample(gen, w, 2000)
    drawn = bins[mask]
    assert not ((drawn[:, 0] == 2) & (drawn[:, 1] == 3)).any()
    assert not ((drawn[:, 0] == 5) & (drawn[:, 1] == 1)).any()
    clamped_total = 2.0 * (48 - 2)
    assert abs(float(mask.sum(1).double().mean()) - clamped_total) < 1.0


def test_truncation_warning():
    set_progress(False)
    lf = _likelihood(UnbinnedLogLikelihood, txenon.GaussianBlobSource,
                     NormalPrior, scale=200.0)
    study = UnbinnedToyStudy(lf, device='cpu')
    with pytest.warns(UserWarning, match='n_max'):
        study.expected_weights(er_rate_multiplier=3.0)
    coords, mask, bins = study.simulate(0, 20, truth=dict(
        er_rate_multiplier=3.0))
    assert mask.shape == (20, study.n_max) and mask.all()


SIZE = dict(n_cs1_bins=12, n_cs2_bins=10, livetime_days=3.0)


@pytest.fixture(scope='module')
def xenon():
    set_progress(False)
    jax_set_progress(False)
    return (jxenon.build_likelihood('unbinned', **SIZE),
            txenon.build_likelihood('unbinned', **SIZE))


def test_xenon_study_matches_jax(xenon):
    jlf, tlf = xenon
    jstudy = JaxStudy(jlf)
    tstudy = UnbinnedToyStudy(tlf, device='cpu')
    assert tstudy.n_max == jstudy.n_max
    np.testing.assert_allclose(tstudy._build_pdf_tensor(),
                               jstudy._build_pdf_tensor(), rtol=1e-13,
                               atol=0)
    for truth in (dict(), dict(wimp_rate_multiplier=2.0, band_shift=0.3,
                               efficiency=0.9)):
        np.testing.assert_allclose(
            tstudy.expected_weights(**truth).numpy(),
            np.asarray(jstudy.expected_weights(**truth)), rtol=1e-12,
            atol=1e-15)


def test_state_from_jax_compiles(xenon):
    """Data-free and data-bound JAX unbinned likelihoods read through
    convert.state_from_reference: rates, and the value of the bound
    events."""
    jlf, _ = xenon
    state = state_from_reference(jlf)
    assert state['kind'] == 'unbinned' and state['ps'] is None
    assert state['outlier_likelihood'] == 1e-12
    compiled = build_logl_from_state(state, device='cpu')
    jc = jax_build_logl(jlf)
    point = dict(wimp_rate_multiplier=1.5, band_shift=-0.4,
                 efficiency=1.1, er_rate_multiplier=0.97)
    np.testing.assert_allclose(
        compiled.rates(compiled.params_from_kwargs(**point)).numpy(),
        np.asarray(jc.rates(jc.params_from_kwargs(**point))), rtol=1e-13)
    assert compiled.ps_tensor is None and not compiled.is_binned

    d = jlf.base_model.simulate(rng=np.random.default_rng(5))
    jlf.set_data(d)
    bound = build_logl_from_state(state_from_reference(jlf), device='cpu')
    assert bound.ps_tensor.shape == (3, 3, 3, 3, 6, len(d))
    jc = jax_build_logl(jlf)
    for p in (dict(), point):
        np.testing.assert_allclose(float(bound(**p)),
                                   float(jc.logl(jc.params_from_kwargs(**p))),
                                   rtol=1e-10)
        np.testing.assert_allclose(float(bound(**p)), jlf(**p), rtol=1e-10)


def test_default_device_is_the_card(xenon, small):
    _, tlf = xenon
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UnbinnedToyStudy(tlf)
    study = UnbinnedToyStudy(small[1].lf, device='cpu', max_iter=30)
    t, free, cond = study.profile_ts(1, 3, TARGET, 1.0)
    assert t.shape == (3,) and np.isfinite(free.max_ll).all()
    assert study.compiled.dtype == torch.float64
    with pytest.raises(TypeError, match='Unbinned'):
        UnbinnedToyStudy(txenon.build_likelihood('binned', **SIZE),
                         device='cpu')
    # the grid, scan and map surface: called without its arguments it
    # raises as the reference's does; no observed_counts (the statistics
    # tell a binned study from an unbinned one by it)
    for name in ('profile_ts_grid', 'profile_ts_scan', 'profile_map'):
        with pytest.raises(TypeError, match='missing'):
            getattr(study, name)()
    assert not hasattr(study, 'observed_counts')
    # mesh= is ported (a ToyMesh); anything else is refused
    with pytest.raises(TypeError, match='ToyMesh'):
        study.simulate(0, 2, mesh=object())
