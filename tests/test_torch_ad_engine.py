"""The port's autodiff fit engine (``make_toy_fitter(engine='ad')``, and
``engine='auto'`` where no closed form fits) against the JAX package's,
float64 on the CPU, on identical numpy inputs.

* Each family only the autodiff engine fits: a ``LogLikelihoodReParam``;
  a ``LogLikelihoodSum`` with an unbinned child, and one with a nested
  Sum; log template morphing with a Beeston-Barlow mode; a dataset-free
  ancillary term alone; source-wise morphing. The single-dataset fit
  (``fit_single``) against the JAX package's, and a toy batch against
  the JAX fit vmapped over the same toys.
* The autodiff engine against the port's own closed forms on a binned, an
  unbinned and a Sum model (the same toys).
* ``torch.func``'s ``vmap(hessian)`` through every compiled class against
  ``jax.hessian`` of the JAX compile of the same likelihood.
* The device MCMC log-probability of the new families against
  ``compiled.logl``.

Tolerances: max_ll 1e-6 absolute, x 2e-3 (as ``assert_same_fits``); the
parabolic errors rtol 1e-3; g and H within 1e-7 of each lane's largest
entry; log-probabilities rtol 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu import composition as jcomp
from blueice_tpu.compile import cached_logl as jcached
from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.priors import NormalPrior as JaxNormal
from blueice_tpu_torch import composition as tcomp
from blueice_tpu_torch.compile import build_logl, cached_logl
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.likelihood import (BinnedLogLikelihood,
                                          UnbinnedLogLikelihood)
from blueice_tpu_torch.parallel import fitter as tfitter
from blueice_tpu_torch.parallel import mcmc
from blueice_tpu_torch.priors import NormalPrior

from test_torch_log_morphing import JAX, PORT, blob_likelihood
from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)

MEAN, COV = [0.0, 1.0], [[0.09, 0.012], [0.012, 0.0064]]
CONSTRAINED = ['band_shift', 'er_rate_multiplier']
SMALL = dict(n_cs1_bins=4, n_cs2_bins=3, livetime_days=1.0)


def xenon_lf(pkg, kind='unbinned', source_wise=False, **size):
    """The XENON-style model of either package (``pkg`` 'jax' or 'port'),
    registered as ``xenon_like.build_likelihood`` registers it; the JAX
    package's takes ``source_wise_interpolation`` through its config."""
    xenon = jxenon if pkg == 'jax' else txenon
    cls = {('jax', 'binned'): JaxBinned, ('jax', 'unbinned'): JaxUnbinned,
           ('port', 'binned'): BinnedLogLikelihood,
           ('port', 'unbinned'): UnbinnedLogLikelihood}[pkg, kind]
    prior = JaxNormal if pkg == 'jax' else NormalPrior
    config = xenon.build_config(**dict(SMALL, **size))
    if source_wise:
        config['source_wise_interpolation'] = True
    lf = cls(config)
    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=prior(1, 0.05))
    lf.add_rate_parameter('nr', log_prior=prior(1, 0.2))
    lf.add_rate_parameter('wall', log_prior=prior(1, 0.3))
    zs = (-1.0, 0.0, 1.0)
    lf.add_shape_parameter('band_shift', zs, log_prior=prior(0, 0.5))
    lf.add_shape_parameter('band_width_scale', (0.8, 1.0, 1.2),
                           log_prior=prior(1, 0.1))
    lf.add_shape_parameter('cs1_tilt', zs, log_prior=prior(0, 0.5))
    lf.add_shape_parameter('efficiency', (0.7, 1.0, 1.3),
                           log_prior=prior(1, 0.1))
    lf.prepare()
    return lf


def with_data(lf, seed):
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(seed)))
    return lf


def reparam(pkg, comp, seed=3):
    lf = with_data(blob_likelihood(pkg, 'linear'), seed)
    lf.pdf_base_config['coupling'] = 1.0
    return comp.LogLikelihoodReParam(lf, {
        'wimp_rate_multiplier': {'params': ['coupling'],
                                 'func': lambda c: c ** 2},
        'coupling': (np.linspace(0.0, 3.0, 4), None, None)})


def jax_model(family):
    """The JAX package's likelihood of a family, its data bound."""
    if family == 'reparam':
        return reparam(JAX, jcomp)
    if family == 'sum_unbinned':
        return jcomp.LogLikelihoodSum([
            with_data(blob_likelihood(JAX, 'linear'), 4),
            with_data(xenon_lf('jax'), 5),
            jcomp.correlated_gaussian_constraint(CONSTRAINED, MEAN, COV)])
    if family == 'sum_nested':
        inner = jcomp.LogLikelihoodSum([
            with_data(blob_likelihood(JAX, 'linear', livetime=20.0), 6),
            jcomp.correlated_gaussian_constraint(CONSTRAINED, MEAN, COV)])
        return jcomp.LogLikelihoodSum([
            inner, with_data(blob_likelihood(JAX, 'linear', K=2), 7)])
    if family == 'log_bb':
        return with_data(blob_likelihood(JAX, 'log', likelihood_config=dict(
            model_statistical_uncertainty_handling='bb_lite')), 8)
    if family == 'ancillary':
        return jcomp.correlated_gaussian_constraint(CONSTRAINED, MEAN, COV)
    assert family == 'source_wise'
    return with_data(xenon_lf('jax', source_wise=True), 9)


FAMILIES = ['reparam', 'sum_unbinned', 'sum_nested', 'log_bb', 'ancillary',
            'source_wise']


@pytest.fixture(scope='module')
def models():
    cache = {}

    def get(family):
        if family not in cache:
            jm = jax_model(family)
            cache[family] = (jm, jcached(jm), build_logl(jm, device='cpu'))
        return cache[family]
    return get


def assert_same_single_fit(port, ref):
    (tp, tll), (jp, jll) = port, ref
    assert list(tp) == list(jp)
    np.testing.assert_allclose(tll, jll, rtol=0, atol=1e-6)
    values = [k for k in jp if not k.endswith('_error')]
    np.testing.assert_allclose([tp[k] for k in values],
                               [jp[k] for k in values], rtol=2e-3, atol=2e-3)
    errors = [k for k in jp if k.endswith('_error')]
    np.testing.assert_allclose([tp[k] for k in errors],
                               [jp[k] for k in errors], rtol=1e-3)


def without_snaps(compiled):
    """``compiled`` fitted as the JAX package fits it: a source-wise build
    and a ReParam's wrapped likelihood without the port's snap candidates
    at their shape anchors (the JAX package snaps only on a global grid).
    Returns ``compiled``."""
    getattr(compiled, 'child', compiled).shape_anchor_arrays = []
    return compiled


SNAPPED = ('reparam', 'source_wise')


@pytest.mark.parametrize('family', FAMILIES)
def test_single_fit_matches_jax(models, family):
    """``fit_single`` on each family (engine 'auto': the autodiff engine)
    against the JAX package's on the same templates and data. Where the
    port snaps and the JAX package does not (``SNAPPED``), the port's fit
    without the snaps is the JAX package's, and with them no lower."""
    jm, jc, tc = models(family)
    assert tfitter._engine_family(tc) == 'ad'
    ref = jfitter.fit_single(jc)
    if family in SNAPPED:
        assert_same_single_fit(tfitter.fit_single(without_snaps(
            build_logl(jm, device='cpu'))), ref)
        assert tfitter.fit_single(tc)[1] >= ref[1] - 1e-6
    else:
        assert_same_single_fit(tfitter.fit_single(tc), ref)


def test_port_classes_fit_as_jax(models):
    """The port's own ReParam and Sum classes (not a bridged JAX state)
    through ``bestfit_jax``: the same fits (the ReParam without its
    snaps, see ``without_snaps``)."""
    trp = reparam(PORT, tcomp)
    without_snaps(cached_logl(trp, device='cpu'))
    assert_same_single_fit(trp.bestfit_jax(device='cpu'),
                           models('reparam')[0].bestfit_jax())
    tsum = tcomp.LogLikelihoodSum([
        with_data(blob_likelihood(PORT, 'linear'), 4),
        with_data(xenon_lf('port'), 5),
        tcomp.correlated_gaussian_constraint(CONSTRAINED, MEAN, COV)])
    assert_same_single_fit(tsum.bestfit_jax(device='cpu'),
                           models('sum_unbinned')[0].bestfit_jax())


def _binned_toys(tc, n, seed):
    counts = tc.expected_counts(tc.defaults)
    rng = np.random.default_rng(seed)
    return tfitter.tree_map(
        lambda e: rng.poisson(e.numpy(), (n,) + tuple(e.shape)).astype(float),
        counts)


@pytest.mark.parametrize('family', ['reparam', 'log_bb'])
def test_toy_batch_matches_jax(models, family):
    """A batch of numpy-made toys, free and with the target fixed at run
    time: the port's batched AD fit against the JAX AD fit vmapped."""
    jm, jc, _ = models(family)
    tc = without_snaps(build_logl(jm, device='cpu'))
    counts = _binned_toys(tc, 3, 11)
    target = 'coupling' if family == 'reparam' else 'wimp_rate_multiplier'
    for runtime in ((), (target,)):
        fixed_values = [1.2] if runtime else None
        fit, names = tfitter.make_toy_fitter(tc, engine='ad',
                                             runtime_fixed=runtime)
        jfit, jnames = jfitter.make_toy_fitter(jc, engine='ad',
                                               runtime_fixed=runtime)
        assert names == jnames
        x, ll, _ = fit(counts, fixed_values)
        jx, jll, _ = jax.vmap(lambda d: jfit(
            d, None, tuple(jnp.asarray(v) for v in (fixed_values or ()))))(
                jnp.asarray(counts))
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-3,
                                   atol=2e-3)


def _closed_form_case(kind):
    """(compiled, data) of a model a closed form fits, with 3 toys."""
    if kind == 'binned':
        tc = build_logl(xenon_lf('port', 'binned'), device='cpu')
        return tc, _binned_toys(tc, 3, 12)
    if kind == 'sum':
        tsum = tcomp.LogLikelihoodSum([
            blob_likelihood(PORT, 'linear'),
            blob_likelihood(PORT, 'linear', livetime=60.0, K=2),
            tcomp.correlated_gaussian_constraint(CONSTRAINED, MEAN, COV)])
        tc = build_logl(tsum, device='cpu')
        return tc, _binned_toys(tc, 3, 13)
    from blueice_tpu_torch.parallel import UnbinnedToyStudy
    study = UnbinnedToyStudy(xenon_lf('port'), device='cpu')
    return study.compiled, study._fit_data(study.simulate(14, 3))


@pytest.mark.parametrize('kind', ['binned', 'unbinned', 'sum'])
def test_ad_engine_matches_closed_forms(kind):
    """The autodiff engine and the closed form fit the same toys to the
    same optima, free and conditional."""
    tc, data = _closed_form_case(kind)
    for runtime in ((), ('wimp_rate_multiplier',)):
        fixed_values = [0.6] if runtime else None
        out = {}
        for engine in ('ad', 'analytic'):
            fit, names = tfitter.make_toy_fitter(tc, engine=engine,
                                                 runtime_fixed=runtime)
            out[engine] = fit(data, fixed_values)
        (xa, lla, _), (xc, llc, _) = out['ad'], out['analytic']
        np.testing.assert_allclose(lla.numpy(), llc.numpy(), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(xa.numpy(), xc.numpy(), rtol=2e-3,
                                   atol=2e-3)


HESSIAN_CASES = ['binned', 'bb_single', 'bb_lite', 'log', 'unbinned',
                 'unbinned_source_wise', 'sum', 'reparam', 'ancillary']


def _hessian_model(case):
    if case == 'binned':
        return with_data(blob_likelihood(JAX, 'linear', K=2), 15)
    if case in ('bb_single', 'bb_lite'):
        config = dict(model_statistical_uncertainty_handling=case)
        if case == 'bb_single':
            config['bb_single_source'] = 'er'
        return with_data(blob_likelihood(JAX, 'linear', K=2,
                                         likelihood_config=config), 16)
    if case == 'log':
        return with_data(blob_likelihood(JAX, 'log', K=2), 17)
    if case == 'unbinned':
        return with_data(xenon_lf('jax'), 18)
    if case == 'unbinned_source_wise':
        return with_data(xenon_lf('jax', source_wise=True), 18)
    return jax_model({'sum': 'sum_unbinned'}.get(case, case))


@pytest.mark.parametrize('case', HESSIAN_CASES)
def test_vmap_hessian_through_every_compiled_class(case):
    """g and H of the negated logl in x, by ``torch.func`` (the engine's
    vgh, vmapped over two points) against ``jax.hessian`` of the JAX
    compile at the same points."""
    jm = _hessian_model(case)
    jc, tc = jcached(jm), build_logl(jm, device='cpu')
    names = [n for n in tc.param_names if n in tc.registered]
    rng = np.random.default_rng(19)
    lo = np.array([max(tc.bounds[n][0], -0.9) for n in names])
    x0 = np.array([float(tc.defaults[n]) for n in names])
    xs = np.stack([x0, x0 + rng.uniform(0.02, 0.1, x0.shape)])
    xs = np.maximum(xs, lo + 0.05)

    def neg(xv):
        p = dict(jc.defaults)
        p.update({n: xv[i] for i, n in enumerate(names)})
        return -jc.logl(p)
    jg = np.asarray(jax.vmap(jax.grad(neg))(jnp.asarray(xs)))
    jH = np.asarray(jax.vmap(jax.hessian(neg))(jnp.asarray(xs)))
    # two lanes on the bound dataset (toy 0)
    data = tfitter._ad_lanes(tc, tfitter.observed_data(tc),
                             torch.zeros(2, dtype=torch.int64))
    _, g, H = tfitter._make_ad_parts(
        tc, names, {}, tfitter.make_transform([(None, None)] * len(names))
    )[1](torch.as_tensor(xs), data, torch.zeros((2, 0), dtype=torch.float64))
    for port, ref in ((g.numpy(), jg), (H.numpy(), jH)):
        assert np.isfinite(port).all()
        scale = np.maximum(np.abs(ref).reshape(2, -1).max(1), 1e-12)
        err = np.abs(port - ref).reshape(2, -1).max(1) / scale
        assert err.max() < 1e-7, err


@pytest.mark.parametrize('family', ['reparam', 'sum_unbinned',
                                    'source_wise'])
def test_device_log_prob_matches_compiled_logl(models, family):
    """The device MCMC's log-probability of the autodiff families: one
    vmapped value call scores the walkers, equal to ``compiled.logl``."""
    jm, jc, _ = models(family)
    tc = cached_logl(jm, device='cpu')
    lp, names, guess = mcmc.make_device_log_prob(tc)
    rng = np.random.default_rng(20)
    walkers = guess * rng.uniform(0.95, 1.05, (6, len(guess)))
    ref = []
    for w in walkers:
        p = dict(tc.defaults)
        p.update(dict(zip(names, torch.as_tensor(w))))
        ref.append(float(tc.logl(p)))
    np.testing.assert_allclose(lp(torch.as_tensor(walkers)).numpy(), ref,
                               rtol=1e-10)
    chain = mcmc.bestfit_emcee_device(jm, n_walkers=8, n_steps=4,
                                      n_burn_in=0, device='cpu')
    assert np.isfinite(chain[1])
