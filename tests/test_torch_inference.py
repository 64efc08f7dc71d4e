"""The inference slice of the port against the JAX package, float64 on the
CPU, on identical numpy inputs.

* The host functions of ``inference.py`` on the host numpy likelihoods:
  ``make_objective``, ``bestfit_scipy``, ``best_anchor``,
  ``one_parameter_interval`` (upper, lower, central; Wilks and a
  ``t_ppf``) and ``bestfit_emcee`` on its built-in sampler, on
  ``conf_for_test`` likelihoods and on the XENON example at 14 x 11 bins.
* The compiled fits: ``bestfit_jax`` / ``fit_single`` on a binned, a
  Gaussian unbinned, the small XENON and a two-child Sum likelihood,
  conditional fits, the all-fixed case, the cache of ``cached_logl``, and
  ``make_batch_fitter`` on 8 toys.
* The methods grafted onto the four likelihood classes.

Tolerances: host fit values and maxima rtol 1e-8; interval limits rtol
1e-6; the built-in sampler's samples 1e-12 (the same numpy arithmetic on
the same ``default_rng``); ``bestfit_jax`` max_ll abs 1e-6, x atol 2e-3
(as ``test_torch_small_models.py``), errors rtol 1e-3.
"""

import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from blueice_tpu import composition as jcomp
from blueice_tpu import inference as jinf
from blueice_tpu import likelihood as jlik
from blueice_tpu.compile import cached_logl as jcached
from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.test_helpers import conf_for_test as jconf
from blueice_tpu.test_helpers import make_data
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch import composition as tcomp
from blueice_tpu_torch import inference as tinf
from blueice_tpu_torch import likelihood as tlik
from blueice_tpu_torch.compile import cached_logl
from blueice_tpu_torch.exceptions import InvalidParameterSpecification
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.parallel import fitter as tfitter
from blueice_tpu_torch.test_helpers import conf_for_test as tconf
from blueice_tpu_torch.utils import set_progress

from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)

JAX = SimpleNamespace(lik=jlik, conf=jconf, xenon=jxenon)
PORT = SimpleNamespace(lik=tlik, conf=tconf, xenon=txenon)
SMALL_XENON = dict(n_cs1_bins=14, n_cs2_bins=11)


def _gauss(pkg, kind, events):
    """conf_for_test models: 'rate' (s0), 'shape' (some_multiplier),
    'rate_shape', 'strlen' (a non-numeric shape parameter) and 'two' (two
    sources, rate s0), unbinned with analytic Gaussian sources, the given
    events bound."""
    conf = pkg.conf(n_sources=2 if kind == 'two' else 1)
    lf = pkg.lik.UnbinnedLogLikelihood(conf)
    if kind in ('rate', 'rate_shape', 'two'):
        lf.add_rate_parameter('s0')
    if kind in ('shape', 'rate_shape'):
        lf.add_shape_parameter('some_multiplier', (0.5, 1, 1.5, 2))
    if kind == 'strlen':
        lf.add_shape_parameter('strlen_multiplier', {1: 'x', 2: 'hi', 3: 'wha'},
                               base_value=1)
    lf.prepare()
    lf.set_data(events)
    return lf


def _gauss_pair(kind, seed=11):
    set_progress(False)
    jax_set_progress(False)
    conf = jconf(n_sources=2 if kind == 'two' else 1)
    probe = jlik.UnbinnedLogLikelihood(conf)
    events = probe.base_model.simulate(rng=np.random.default_rng(seed))
    jlf = _gauss(JAX, kind, events)
    tlf = _gauss(PORT, kind, events)
    return jlf, tlf


def _xenon(pkg, seed=1, **kwargs):
    set_progress(False)
    jax_set_progress(False)
    d = tempfile.mkdtemp(prefix='xenon_inference_')
    extra = dict(template_device='cpu') if pkg is PORT else {}
    lf = pkg.xenon.build_likelihood('binned', jax_templates=True,
                                    cache_dir=d + '/c', task_dir=d + '/t',
                                    **SMALL_XENON, **extra, **kwargs)
    return lf


@pytest.fixture(scope='module')
def xenon_pair():
    jlf, tlf = _xenon(JAX), _xenon(PORT)
    events = jlf.base_model.simulate(rng=np.random.default_rng(1))
    jlf.set_data(events)
    tlf.set_data(events)
    return jlf, tlf


def _assert_same_fit(port, ref, rtol=1e-8):
    (tp, tll), (jp, jll) = port, ref
    assert list(tp) == list(jp)
    np.testing.assert_allclose([tp[k] for k in tp], [jp[k] for k in tp],
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(tll, jll, rtol=rtol)


# -- host functions ------------------------------------------------------------

@pytest.mark.parametrize('kind', ['rate', 'shape', 'rate_shape', 'strlen'])
def test_bestfit_scipy_matches(kind):
    jlf, tlf = _gauss_pair(kind)
    _assert_same_fit(tinf.bestfit_scipy(tlf), jinf.bestfit_scipy(jlf))
    _assert_same_fit(tlf.bestfit_scipy(rates_in_log_space=True),
                     jlf.bestfit_scipy(rates_in_log_space=True))
    if kind != 'strlen':
        # nothing to fit: the likelihood at the fixed point
        fixed = {'rate': dict(s0_rate_multiplier=1.2),
                 'shape': dict(some_multiplier=1.2),
                 'rate_shape': dict(s0_rate_multiplier=1.2,
                                    some_multiplier=1.2)}[kind]
        res, ll = tlf.bestfit_scipy(**fixed)
        assert res == {} and ll == tlf(**fixed)
        np.testing.assert_allclose(ll, jlf.bestfit_scipy(**fixed)[1],
                                   rtol=1e-12)


def test_bestfit_scipy_matches_on_xenon(xenon_pair):
    jlf, tlf = xenon_pair
    _assert_same_fit(tlf.bestfit_scipy(), jlf.bestfit_scipy())


def test_make_objective_matches():
    jlf, tlf = _gauss_pair('rate_shape')
    for kwargs in ({}, dict(guess={'s0_rate_multiplier': 2.0}),
                   dict(some_multiplier=1.5),
                   dict(minus=False, rates_in_log_space=True)):
        tf, tn, tg, tb = tlf.make_objective(**kwargs)
        jf, jn, jg, jb = jlf.make_objective(**kwargs)
        assert tn == jn and tb == jb
        np.testing.assert_array_equal(tg, jg)
        for x in (tg, 1.1 * tg + 0.05):
            np.testing.assert_allclose(tf(x), jf(x), rtol=1e-12)


def test_make_objective_bounds_and_guesses():
    """An allow_negative source's rate opens to (-inf, inf) in both
    packages; a parameter without a numeric guess raises."""
    bounds = []
    for pkg in (JAX, PORT):
        conf = pkg.conf()
        conf['sources'][0]['allow_negative'] = True
        lf = pkg.lik.UnbinnedLogLikelihood(conf)
        lf.add_rate_parameter('s0')
        lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(0)))
        _, names, _, b = lf.make_objective()
        bounds.append(b[names.index('s0_rate_multiplier')])
    assert bounds[0] == bounds[1] == (-float('inf'), float('inf'))
    anc = tcomp.LogAncillaryLikelihood(lambda p: -p['a'] ** 2, ['a'])
    with pytest.raises(InvalidParameterSpecification, match="guess"):
        anc.make_objective()


def test_best_anchor_matches():
    jlf, tlf = _gauss_pair('shape')
    assert tinf.best_anchor(tlf) == jinf.best_anchor(jlf)
    assert tlf.best_anchor()['some_multiplier'] in (0.5, 1, 1.5, 2)


def _t_ppf(hypothesis, quantile):
    """A Neyman-style critical value that varies with the hypothesis."""
    from scipy import stats
    return stats.chi2(1).ppf(2 * quantile - 1) * (1 + 0.05 * hypothesis) \
        if quantile > 0.5 else stats.chi2(1).ppf(1 - 2 * quantile)


@pytest.mark.parametrize('t_ppf', [None, _t_ppf], ids=['wilks', 't_ppf'])
def test_one_parameter_interval_matches(t_ppf):
    jlf, tlf = _gauss_pair('two')
    target = 's0_rate_multiplier'
    for kind, bound in (('upper', 40), ('lower', 0.1),
                        ('central', (0.1, 20))):
        port = tlf.one_parameter_interval(target, bound, kind=kind,
                                          t_ppf=t_ppf)
        ref = jinf.one_parameter_interval(jlf, target, bound, kind=kind,
                                          t_ppf=t_ppf)
        np.testing.assert_allclose(port, ref, rtol=1e-6)
    lo, hi = tlf.one_parameter_interval(target, (0.1, 20), kind='central')
    assert lo < 1.0 < hi


#: the XENON intervals' shape nuisances, fixed at their base values: the
#: four rates float (a scipy fit of all eight takes seconds)
XENON_SHAPES = dict(band_shift=0.0, band_width_scale=1.0, cs1_tilt=0.0,
                    efficiency=1.0)


def test_one_parameter_interval_matches_on_xenon(xenon_pair):
    jlf, tlf = xenon_pair
    port = tinf.one_parameter_interval(tlf, 'wimp_rate_multiplier', 5.0,
                                       **XENON_SHAPES)
    ref = jinf.one_parameter_interval(jlf, 'wimp_rate_multiplier', 5.0,
                                      **XENON_SHAPES)
    np.testing.assert_allclose(port, ref, rtol=1e-6)


def test_bestfit_emcee_builtin_sampler_matches():
    """The built-in stretch-move sampler: the same numpy arithmetic on the
    same default_rng, so the same chain; errors and the fixed-value LL."""
    jlf, tlf = _gauss_pair('rate_shape')
    opts = dict(n_walkers=10, n_steps=40, n_burn_in=20, seed=42)
    tfit, tll, ts = tlf.bestfit_emcee(return_samples=True, **opts)
    jfit, jll, js = jinf.bestfit_emcee(jlf, return_samples=True, **opts)
    np.testing.assert_allclose(ts, js, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tll, jll, rtol=1e-12)
    assert list(tfit) == list(jfit)
    _, _, errs = tlf.bestfit_emcee(return_errors=True, some_multiplier=1.0,
                                   **opts)
    assert list(errs) == ['s0_rate_multiplier'] and errs[
        's0_rate_multiplier'] > 0

    anc = tcomp.LogAncillaryLikelihood(
        lambda p: -((p['a'] - 3.0) ** 2 + (p['b'] - 5.0) ** 2),
        ['a', 'b'], config={'a': 1.0, 'b': 1.0})
    fit, ll = anc.bestfit_emcee(b=4.0, seed=0, n_steps=300, n_burn_in=150)
    assert set(fit) == {'a'} and abs(fit['a'] - 3.0) < 0.5
    assert np.isclose(ll, anc(a=fit['a'], b=4.0), atol=1e-9)


def test_bestfit_minuit_says_what_it_needs():
    jlf, tlf = _gauss_pair('rate')
    try:
        import iminuit  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError) as port:
            tlf.bestfit_minuit()
        with pytest.raises(ImportError) as ref:
            jlf.bestfit_minuit()
        assert str(port.value) == str(ref.value)
    else:
        _assert_same_fit(tlf.bestfit_minuit(), jlf.bestfit_minuit(),
                         rtol=1e-6)


# -- compiled fits -------------------------------------------------------------

def _assert_same_jax_fit(port, ref):
    (tp, tll), (jp, jll) = port, ref
    assert sorted(tp) == sorted(jp)
    np.testing.assert_allclose(tll, jll, rtol=0, atol=1e-6)
    values = [k for k in jp if not k.endswith('_error')]
    np.testing.assert_allclose([tp[k] for k in values],
                               [jp[k] for k in values], rtol=0, atol=2e-3)
    errors = [k for k in jp if k.endswith('_error')]
    np.testing.assert_allclose([tp[k] for k in errors],
                               [jp[k] for k in errors], rtol=1e-3)


def _binned_pair():
    out = []
    for pkg in (JAX, PORT):
        np.random.seed(0)
        # every bin observed: the JAX package's autodiff Hessian is NaN
        # where a bin counts 0
        lf = pkg.lik.BinnedLogLikelihood(pkg.conf(
            n_sources=2, mc=True, n_events_for_pdf=int(2e5),
            analysis_space=[['x', np.linspace(-3, 3, 13)]]))
        lf.add_rate_parameter('s0')
        lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
        lf.prepare()
        out.append(lf)
    events = out[0].base_model.simulate(rng=np.random.default_rng(3))
    for lf in out:
        lf.set_data(events)
    return out


def _unbinned_pair():
    out = []
    for pkg in (JAX, PORT):
        conf = pkg.conf(n_sources=2)
        conf['sources'][1]['mu'] = 3.0
        lf = pkg.lik.UnbinnedLogLikelihood(conf)
        lf.add_rate_parameter('s0')
        lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
        lf.prepare()
        out.append(lf)
    events = out[0].base_model.simulate(rng=np.random.default_rng(5))
    for lf in out:
        lf.set_data(events)
    return out


def _sum_pair():
    """Two binned blob likelihoods (30 and 60 days) sharing their
    parameters, each with its own dataset."""
    from test_torch_log_morphing import JAX as JL, PORT as PL, blob_likelihood
    jc = [blob_likelihood(JL, livetime=days) for days in (30.0, 60.0)]
    tc = [blob_likelihood(PL, livetime=days) for days in (30.0, 60.0)]
    for i, (j, t) in enumerate(zip(jc, tc)):
        events = j.base_model.simulate(rng=np.random.default_rng(20 + i))
        j.set_data(events)
        t.set_data(events)
    return jcomp.LogLikelihoodSum(jc), tcomp.LogLikelihoodSum(tc)


@pytest.mark.parametrize('model', ['binned', 'unbinned', 'sum'])
def test_bestfit_jax_matches(model):
    jlf, tlf = {'binned': _binned_pair, 'unbinned': _unbinned_pair,
                'sum': _sum_pair}[model]()
    _assert_same_jax_fit(tinf.bestfit_jax(tlf, device='cpu'),
                         jinf.bestfit_jax(jlf))
    if model == 'binned':
        # conditional fits through kwargs: one fitter for every value
        for v in (0.5, 2.0):
            _assert_same_jax_fit(tlf.bestfit_jax(device='cpu',
                                                 s0_rate_multiplier=v),
                                 jlf.bestfit_jax(s0_rate_multiplier=v))
        compiled = cached_logl(tlf, device='cpu')
        assert len(compiled._fit_single_cache) == 2
        # every parameter fixed: the likelihood at that point
        res, ll = tlf.bestfit_jax(device='cpu', s0_rate_multiplier=1.5,
                                  mu=0.5)
        assert res == {}
        np.testing.assert_allclose(
            ll, jlf.bestfit_jax(s0_rate_multiplier=1.5, mu=0.5)[1],
            rtol=1e-10)


def test_bestfit_jax_matches_on_xenon(xenon_pair):
    """The 8-parameter model: the fit, its errors from the x-space Hessian
    of the fitter's vgh op, and the optimum at least scipy's."""
    jlf, tlf = xenon_pair
    port = tlf.bestfit_jax(device='cpu')
    _assert_same_jax_fit(port, jlf.bestfit_jax())
    assert port[1] >= tlf.bestfit_scipy()[1] - 1e-4


def test_fit_single_hessian_is_the_logl_hessian():
    """The errors' Hessian (the vgh op chained through an identity
    transform) against torch.func.hessian of the plain logl_with_data."""
    _, tlf = _binned_pair()
    compiled = cached_logl(tlf, device='cpu')
    res, _ = tfitter.fit_single(compiled)
    names = [k for k in res if not k.endswith('_error')]
    x = torch.tensor([[res[k] for k in names]], dtype=torch.float64)
    data = tfitter.observed_data(compiled)
    _, _, H = tfitter.x_space_ops(compiled, names)[1](
        x, data, torch.zeros((1, 0), dtype=torch.float64))

    def neg_logl(xv):
        p = dict(compiled.defaults, **dict(zip(names, xv)))
        return -compiled.logl_with_data(p, compiled.data,
                                        include_constant=False)
    ref = torch.func.hessian(neg_logl)(x[0])
    np.testing.assert_allclose(H[0].numpy(), ref.numpy(), rtol=1e-8,
                               atol=1e-8 * float(ref.abs().max()))
    errs = np.sqrt(np.diag(np.linalg.inv(ref.numpy())))
    np.testing.assert_allclose([res[k + '_error'] for k in names], errs,
                               rtol=1e-8)


def test_bestfit_jax_cache_invalidation():
    """A new dataset (set_data bumps the version) gets a fresh compile; a
    repeat on the same data reuses it; the CPU and float32 compiles of one
    likelihood are separate entries."""
    for cls in (tlik.BinnedLogLikelihood, tlik.UnbinnedLogLikelihood):
        lf = cls(tconf(n_sources=1, mc=(cls is tlik.BinnedLogLikelihood)))
        lf.add_rate_parameter('s0')
        lf.prepare()
        lf.set_data(make_data([dict(n_events=100, x=0.0)])[0])
        fit1, _ = tinf.bestfit_jax(lf, device='cpu')
        compiled1 = cached_logl(lf, device='cpu')
        lf.set_data(make_data([dict(n_events=2000, x=0.0)])[0])
        fit2, _ = tinf.bestfit_jax(lf, device='cpu')
        assert fit2['s0_rate_multiplier'] > 5 * fit1['s0_rate_multiplier']
        fit3, _ = tinf.bestfit_jax(lf, device='cpu')
        assert np.isclose(fit3['s0_rate_multiplier'],
                          fit2['s0_rate_multiplier'])
        compiled2 = cached_logl(lf, device='cpu')
        assert compiled2 is not compiled1
        assert cached_logl(lf, device='cpu') is compiled2
        f32 = cached_logl(lf, device='cpu', dtype=torch.float32)
        assert f32 is not compiled2 and f32.dtype == torch.float32


def test_make_batch_fitter_matches():
    jlf, tlf = _binned_pair()
    tc = cached_logl(tlf, device='cpu')
    expected = tc.expected_counts(tc.defaults).numpy()
    counts = np.random.default_rng(8).poisson(
        expected, (8,) + expected.shape).astype(float)
    tfit, tnames = tfitter.make_batch_fitter(tc, max_iter=60)
    jfit, jnames = jfitter.make_batch_fitter(jcached(jlf), max_iter=60)
    assert tnames == jnames
    tx, tll, _ = tfit(torch.as_tensor(counts))
    jx, jll, _ = jfit(counts)
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-3)

    # unbinned: the per-event densities of a batch with its mask
    _, ulf = _unbinned_pair()
    uc = cached_logl(ulf, device='cpu')
    ps = uc.ps_tensor.reshape(1, -1, *uc.ps_tensor.shape[-2:])
    ufit, _ = tfitter.make_batch_fitter(uc)
    x, ll, _ = ufit(ps.expand(2, -1, -1, -1))
    single = ulf.bestfit_jax(device='cpu', return_errors=False)[1]
    np.testing.assert_allclose(ll.numpy(), single, rtol=0, atol=1e-6)


def test_inference_methods_are_grafted():
    for cls in (tlik.LogLikelihoodBase, tlik.LogLikelihoodSum,
                tlik.LogAncillaryLikelihood, tlik.LogLikelihoodReParam):
        for name in tinf.__all__:
            assert getattr(cls, name) is getattr(tinf, name), (cls, name)
    assert set(tinf.BESTFIT_ROUTINES) == set(jinf.BESTFIT_ROUTINES)
    assert tinf.DEFAULT_BESTFIT_ROUTINE == jinf.DEFAULT_BESTFIT_ROUTINE
    assert tinf.__all__ == jinf.__all__


def test_one_parameter_interval_through_bestfit_jax(xenon_pair):
    """bestfit_routine='jax' on the CPU: the same upper limit as scipy."""
    _, tlf = xenon_pair
    ul = tlf.one_parameter_interval('wimp_rate_multiplier', 5.0,
                                    bestfit_routine='jax', device='cpu',
                                    **XENON_SHAPES)
    ref = tlf.one_parameter_interval('wimp_rate_multiplier', 5.0,
                                     **XENON_SHAPES)
    np.testing.assert_allclose(ul, ref, rtol=1e-4)
