"""The composition layer of the port against the JAX package, float64 on
the CPU: the correlated Gaussian prior; the compiled logl of a Sum (a
linear child, a log-morphed child and a correlated constraint, weights
1.0 / 0.7 / 1.0), of a re-parametrisation and of an ancillary term; the Sum
engine's (value, g, H); a whole profile study of that Sum on the same
numpy-made counts; the routing of joint parameters a child does not
declare; an observed interval and the saturated model of a Sum; and the
fits of what once raised naming ROADMAP item 16b (a Sum with an unbinned
child, a re-parametrisation, a term alone) against the JAX package's
autodiff fits.

The Sums are the JAX package's, bridged into the port by
``state_from_reference`` (which reads a composition of either package),
beside the port's own host classes.

Tolerances: the priors rtol 1e-12; compiled logl rtol 1e-10; the engine's
value rtol 1e-10, g and H within 1e-9 of each lane's largest entry; the
profile study max_ll rtol 1e-8, x atol 2e-3, t atol 1e-4 (as
``test_torch_small_models.py``); the interval rtol 1e-6."""

import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu import composition as jcomp
from blueice_tpu.compile import build_logl as jbuild
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.parallel import gof as jgof
from blueice_tpu.parallel import limits as jlimits
from blueice_tpu.priors import MultivariateNormalPrior as JaxMVN
from blueice_tpu_torch import composition as tcomp
from blueice_tpu_torch.compile import (CompiledLogLikelihoodSum, build_logl,
                                       build_logl_ancillary,
                                       build_logl_reparam, build_logl_sum,
                                       cached_logl)
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.parallel import (BinnedToyStudy, gof, limits,
                                        make_toy_fitter)
from blueice_tpu_torch.parallel import fitter as tfitter
from blueice_tpu_torch.priors import MultivariateNormalPrior

from test_torch_log_morphing import JAX, PORT, TARGET, blob_likelihood

MEAN, COV = [0.0, 1.0], [[0.09, 0.012], [0.012, 0.0064]]
WEIGHTS = [1.0, 0.7, 1.0]
CONSTRAINED = ['band_shift', 'er_rate_multiplier']


def _sum(pkg, comp, weights=WEIGHTS):
    """A linear child (30 days), a log-morphed child (60 days) and a
    correlated constraint on band_shift and the ER rate."""
    return comp.LogLikelihoodSum(
        [blob_likelihood(pkg, 'linear', livetime=30.0),
         blob_likelihood(pkg, 'log', livetime=60.0),
         comp.correlated_gaussian_constraint(CONSTRAINED, MEAN, COV)],
        likelihood_weights=weights)


@pytest.fixture(scope='module')
def sums():
    """(JAX Sum, port's own Sum, port compile of the JAX Sum, port compile
    of its own, JAX compile)."""
    jsum, tsum = _sum(JAX, jcomp), _sum(PORT, tcomp)
    return (jsum, tsum, build_logl(jsum, device='cpu'),
            build_logl(tsum, device='cpu'), jbuild(jsum))


def _counts(compiled, n, seed):
    """n numpy-made datasets of a Sum at its defaults: a tuple, one
    (n, bins) array per child ((n, 0) for the constraint)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.poisson(e.numpy(), size=(n,) + tuple(e.shape))
                 .astype(float)
                 for e in compiled.expected_counts(compiled.defaults))


def _rel_to_lane_max(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).reshape(b.shape[0], -1).max(1)
    return float((np.abs(a - b).reshape(b.shape[0], -1).max(1)
                  / scale).max())


POINTS = [{}, dict(band_shift=0.41, er_rate_multiplier=1.07,
                   wimp_rate_multiplier=1.8),
          dict(band_shift=-0.73, er_rate_multiplier=0.93)]


@pytest.mark.parametrize("x", [[0.1, 0.9], [-0.4, 1.13], [0.0, 1.0]])
def test_multivariate_normal_prior_matches(x):
    port, ref = MultivariateNormalPrior(MEAN, COV), JaxMVN(MEAN, COV)
    expected = ref(x)
    np.testing.assert_allclose(port(x), expected, rtol=1e-12)
    np.testing.assert_allclose(port(np.asarray(x)), expected, rtol=1e-12)
    values = dict(zip(CONSTRAINED, torch.as_tensor(x, dtype=torch.float64)))
    np.testing.assert_allclose(float(port(values)), expected, rtol=1e-12)
    np.testing.assert_allclose(
        float(port(values)), float(ref({k: jnp.asarray(float(v))
                                        for k, v in values.items()})),
        rtol=1e-12)
    # batched tensors: the parameters stack along a new last axis
    batch = [torch.full((3, 2), v, dtype=torch.float64) for v in x]
    np.testing.assert_allclose(port(batch).numpy(),
                               np.full((3, 2), expected), rtol=1e-12)
    # pickling, equality and hash by value
    again = pickle.loads(pickle.dumps(port))
    assert again == port and hash(again) == hash(port)
    assert port != MultivariateNormalPrior(MEAN, np.diag([0.09, 0.0064]))


def test_multivariate_normal_prior_validation():
    for cov, match in (([[1.0, 0.0]], 'must be'),
                       ([[1.0, 0.5], [0.4, 1.0]], 'symmetric'),
                       ([[1.0, 2.0], [2.0, 1.0]], 'positive definite')):
        for cls in (MultivariateNormalPrior, JaxMVN):
            with pytest.raises(ValueError, match=match):
                cls([0.0, 0.0], cov)
    for comp in (tcomp, jcomp):
        with pytest.raises(ValueError, match='parameter names'):
            comp.correlated_gaussian_constraint(['a'], MEAN, COV)


def test_host_composition_matches(sums):
    """The port's host classes against the JAX package's: registries,
    routing table, joint bounds and split_results."""
    jsum, tsum = sums[:2]
    assert tsum.likelihood_parameters == jsum.likelihood_parameters
    assert list(tsum.shape_parameters) == list(jsum.shape_parameters)
    assert tsum.get_bounds() == jsum.get_bounds()
    for p in ('wimp_rate_multiplier', 'er_rate_multiplier'):
        assert tsum.get_bounds(p) == jsum.get_bounds(p)
    fit = dict(band_shift=0.1, wimp_rate_multiplier=2.0, junk=3)
    assert tsum.split_results(fit) == jsum.split_results(fit)
    anc = tsum.likelihood_list[2]
    np.testing.assert_allclose(anc(band_shift=0.2),
                               jsum.likelihood_list[2](band_shift=0.2),
                               rtol=1e-12)


def test_sum_logl_matches(sums):
    """The compiled Sum's logl (the bridge of the JAX Sum and the port's
    own) against the JAX package's, on datasets of every child."""
    jsum, _, bridged, own, jc = sums
    for tc in (bridged, own):
        assert isinstance(tc, CompiledLogLikelihoodSum)
        assert tc.param_names == jc.param_names
        assert tc.bounds == {p: tuple(b) for p, b in jc.bounds.items()}
        assert [sorted(r) for r in tc.child_routed] == \
            [sorted(r) for r in jc.child_routed]
        assert [c.log_morph for c in tc.children[:2]] == [False, True]
    data = [c[0] for c in _counts(own, 1, 0)]
    for point in POINTS:
        ref = float(jc.logl_with_data(jc.params_from_kwargs(**point),
                                      [jnp.asarray(d) for d in data]))
        for tc in (bridged, own):
            out = float(tc.logl_with_data(
                tc.params_from_kwargs(**point),
                [torch.as_tensor(d) for d in data]))
            np.testing.assert_allclose(out, ref, rtol=1e-10)
        np.testing.assert_allclose(
            float(bridged.data_constant(tuple(torch.as_tensor(d)[None]
                                              for d in data),
                                        batch_dims=1)[0]),
            float(jc.data_constant([jnp.asarray(d) for d in data])),
            rtol=1e-12)
    assert build_logl_sum(jsum, device='cpu').param_names == jc.param_names
    with pytest.raises(TypeError, match='LogLikelihoodSum'):
        build_logl_sum(jsum.likelihood_list[0], device='cpu')


def test_reparam_and_ancillary_logl_match():
    """A re-parametrised likelihood (the WIMP rate as the square of a new
    coupling) and an ancillary term, compiled, against the JAX package's."""
    def conv(pkg, comp):
        lf = blob_likelihood(pkg, 'linear')
        lf.pdf_base_config['coupling'] = 1.0
        return comp.LogLikelihoodReParam(lf, {
            'wimp_rate_multiplier': {'params': ['coupling'],
                                     'func': lambda c: c ** 2},
            'coupling': (np.linspace(0.0, 3.0, 4), None, None)})
    jrp, trp = conv(JAX, jcomp), conv(PORT, tcomp)
    jc = jbuild(jrp)
    counts = np.random.default_rng(2).poisson(
        np.asarray(jc.expected_counts(jc.defaults))).astype(float)
    for tc in (build_logl_reparam(jrp, device='cpu'),
               build_logl(trp, device='cpu')):
        assert tc.param_names == jc.param_names
        assert tc.bounds == {p: tuple(b) for p, b in jc.bounds.items()}
        for point in ({}, dict(coupling=1.7, band_shift=0.3),
                      dict(coupling=0.4, er_rate_multiplier=1.1)):
            ref = jc.logl_with_data(jc.params_from_kwargs(**point),
                                    jnp.asarray(counts))
            out = tc.logl_with_data(tc.params_from_kwargs(**point),
                                    torch.as_tensor(counts))
            np.testing.assert_allclose(float(out), float(ref), rtol=1e-10)
    janc = jcomp.LogAncillaryLikelihood(
        lambda p: -(p['a'] - 1.0) ** 2 / 0.5 + 0.3 * p['b'], ['a', 'b'],
        config={'a': 1.0, 'b': 0.0})
    tanc = tcomp.LogAncillaryLikelihood(janc.func, ['a', 'b'],
                                        config={'a': 1.0, 'b': 0.0})
    jc = jbuild(janc)
    for tc in (build_logl_ancillary(janc, device='cpu'),
               build_logl(tanc, device='cpu')):
        assert not tc.has_data and tc.bounds == jc.bounds
        for point in ({}, dict(a=1.3, b=-2.0)):
            np.testing.assert_allclose(float(tc(**point)),
                                       float(jc(**point)), rtol=1e-10)


def test_ancillary_func_must_compute_with_tensors():
    """A func that returns no tensor (a host-only scipy logpdf) cannot be
    compiled: TypeError, as the JAX package's for a func it cannot trace;
    the host call still takes it."""
    from scipy import stats
    anc = tcomp.LogAncillaryLikelihood(
        lambda p: stats.norm(1.0, 0.1).logpdf(float(p['a'])), ['a'],
        config={'a': 1.0})
    assert np.isfinite(anc(a=1.1))
    with pytest.raises(TypeError, match='cannot be compiled'):
        build_logl(anc, device='cpu')


def _floating(compiled, fitter):
    names, fixed, transform, x0 = fitter._floating_setup(compiled, {})
    return names, fixed, transform, x0


def test_sum_engine_vgh_matches(sums):
    """The Sum engine's (value, g, H) in u, and its value at candidates,
    against the JAX package's at the same u, lane by lane."""
    _, _, tc, _, jc = sums
    names, fixed, transform, x0 = _floating(tc, tfitter)
    jnames, jfixed, jtransform, _ = _floating(jc, jfitter)
    assert names == jnames
    value_many, vgh = tfitter._make_sum_analytic_parts(
        tc, names, fixed, transform, 'analytic')
    jvalue, jvgh = (jax.jit(f) for f in jfitter._make_sum_analytic_parts(
        jc, jnames, jfixed, jtransform))
    B = 5
    rng = np.random.default_rng(7)
    u = transform.to_u_np(x0)[None] + rng.normal(0, 0.3, (B, len(names)))
    data = _counts(tc, B, 1)
    tdata = tuple(torch.as_tensor(d.reshape(B, -1)) for d in data)
    fv = torch.zeros((B, 0), dtype=torch.float64)
    val, g, H = vgh(torch.as_tensor(u), tdata, fv)
    cand_u = u[:, None, :] + rng.normal(0, 0.1, (B, 3, len(names)))
    cands = value_many(torch.as_tensor(cand_u), tdata, fv)
    refs, ref_cands = [], []
    for b in range(B):
        jdata = [jnp.asarray(d[b].reshape(-1)) for d in data]
        refs.append(jvgh(jnp.asarray(u[b]), jdata, ()))
        ref_cands.append([float(jvalue(jnp.asarray(c), jdata, ()))
                          for c in cand_u[b]])
    np.testing.assert_allclose(val.numpy(), [float(r[0]) for r in refs],
                               rtol=1e-10)
    np.testing.assert_allclose(cands.numpy(), ref_cands, rtol=1e-10)
    assert _rel_to_lane_max(g, np.stack([r[1] for r in refs])) < 1e-9
    assert _rel_to_lane_max(H, np.stack([r[2] for r in refs])) < 1e-9


def test_sum_profile_matches(sums):
    """A whole profile study of the Sum on identical numpy counts: the
    port's Sum engine against the JAX package's."""
    jsum = sums[0]
    jstudy = JaxStudy(jsum, max_iter=40, engine='analytic',
                      profile_mode='split')
    tstudy = BinnedToyStudy(jsum, device='cpu', max_iter=40)
    counts = _counts(tstudy.compiled, 8, 4)
    for e, je in zip(tstudy.expected_counts(), jstudy.expected_counts()):
        np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-12)
    jt, jfree, jcond = jstudy._run_profile(
        tuple(jnp.asarray(c) for c in counts), TARGET, 1.0, None)
    tt, tfree, tcond = tstudy._run_profile(counts, TARGET, 1.0, None)
    for port, ref in ((tfree, jfree), (tcond, jcond)):
        assert port.names == ref.names
        np.testing.assert_allclose(port.max_ll, ref.max_ll, rtol=1e-8)
        np.testing.assert_allclose(port.x, ref.x, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-4)
    toys = tstudy.simulate(3, 4)
    assert [tuple(c.shape) for c in toys] == \
        [(4,) + tuple(e.shape) for e in tstudy.expected_counts()]


def test_sum_routing_and_runtime_fixed():
    """Joint fixed and runtime-fixed values route like the host Sum: the
    WIMP rate, not declared on the second child, stays at that child's
    default there. Against the JAX Sum engine and the host Sum."""
    jsum = jcomp.LogLikelihoodSum([
        blob_likelihood(JAX, 'linear', livetime=30.0),
        blob_likelihood(JAX, 'linear', livetime=50.0, register_wimp=False)])
    jc, tc = jbuild(jsum), build_logl(jsum, device='cpu')
    assert 'wimp_rate_multiplier' not in tc.child_routed[1]
    counts = _counts(tc, 1, 9)
    fixed = {'wimp_rate_multiplier': 1.4}
    fit, names = make_toy_fitter(tc, fixed=fixed,
                                 runtime_fixed=['band_shift'])
    jfit, jnames = jfitter.make_toy_fitter(jc, fixed=fixed,
                                           runtime_fixed=('band_shift',),
                                           engine='analytic')
    assert names == jnames
    x, ll, _ = fit(counts, [0.35])
    jx, jll, _ = jfit(tuple(jnp.asarray(c[0].reshape(-1)) for c in counts),
                      None, (0.35,))
    np.testing.assert_allclose(x.numpy()[0], np.asarray(jx), atol=5e-5)
    np.testing.assert_allclose(float(ll[0]), float(jll), rtol=1e-10)
    # Oracle: everything fixed, against the host Sum at the same point
    for child, c in zip(jsum.likelihood_list, counts):
        child.set_data(_events_of(child, c[0]))
    host = jsum(wimp_rate_multiplier=1.4, band_shift=0.35,
                er_rate_multiplier=1.1)
    fit_all, _ = make_toy_fitter(tc, fixed=dict(
        wimp_rate_multiplier=1.4, band_shift=0.35, er_rate_multiplier=1.1))
    np.testing.assert_allclose(float(fit_all(counts)[1][0]), host,
                               rtol=1e-10)


def _events_of(lf, counts):
    """Events at the bin centers reproducing a count histogram."""
    space = lf.base_model.config['analysis_space']
    centers = [0.5 * (np.asarray(e)[1:] + np.asarray(e)[:-1])
               for _, e in space]
    idx = np.nonzero(counts)
    reps = counts[idx].astype(int)
    d = np.zeros(int(reps.sum()), dtype=[(name, float) for name, _ in space]
                 + [('source', int)])
    for (name, _), c, i in zip(space, centers, idx):
        d[name] = np.repeat(c[i], reps)
    return d


def test_sum_observed_interval():
    """observed_interval on a Sum's dataset passed as counts= (an empty
    entry for the constraint), against the JAX package's: two runs
    without shape parameters and a constraint on the ER rate."""
    jsum = jcomp.LogLikelihoodSum([
        blob_likelihood(JAX, livetime=30.0, K=0),
        blob_likelihood(JAX, livetime=60.0, K=0),
        jcomp.correlated_gaussian_constraint(['er_rate_multiplier'], [1.0],
                                             [[0.01]])])
    jstudy = JaxStudy(jsum, max_iter=40, engine='analytic')
    tstudy = BinnedToyStudy(jsum, device='cpu', max_iter=40)
    counts = tuple(c[0] for c in _counts(tstudy.compiled, 1, 11))
    hyps = np.linspace(0.0, 6.0, 13)
    ul = limits.observed_interval(tstudy, TARGET, hyps, counts=counts)
    jul = jlimits.observed_interval(
        jstudy, TARGET, hyps, counts=tuple(jnp.asarray(c) for c in counts))
    np.testing.assert_allclose(ul, jul, rtol=1e-6)
    with pytest.raises(ValueError, match='one count tensor per child'):
        tstudy.observed_counts()


def test_sum_saturated_logl(sums):
    """The saturated model of a Sum carries its weights, as the JAX
    package's."""
    jsum, _, tc = sums[:3]
    jstudy = JaxStudy(jsum, max_iter=40, engine='analytic')
    tstudy = BinnedToyStudy(jsum, device='cpu', max_iter=40)
    counts = tuple(c[0] for c in _counts(tc, 1, 11))
    batch = _counts(tc, 3, 12)
    np.testing.assert_allclose(
        gof.saturated_logl(tstudy, batch, batched=True),
        jgof.saturated_logl(jstudy, batch, batched=True), rtol=1e-12)
    np.testing.assert_allclose(gof.saturated_logl(tstudy, counts),
                               jgof.saturated_logl(jstudy, counts),
                               rtol=1e-12)


def test_refusals_name_item_16b():
    """The cases that once raised NotImplementedError naming ROADMAP item
    16b (a Sum with an unbinned child, a re-parametrised likelihood, a
    dataset-free term on its own) fit on the autodiff engine, as the JAX
    package's do: ``bestfit_jax`` of the port's own classes against the
    JAX package's on the same data (max_ll 1e-6, x 2e-3), and the
    ReParam's profile study on the same numpy-made toys (t 1e-4)."""
    from blueice_tpu.examples import xenon_like as jxenon

    def models(pkg, comp, xenon):
        ulf = xenon.build_likelihood('unbinned', n_cs1_bins=4, n_cs2_bins=3,
                                     livetime_days=1.0)
        ulf.set_data(ulf.base_model.simulate(rng=np.random.default_rng(1)))
        blob = blob_likelihood(pkg, 'linear')
        blob.set_data(blob.base_model.simulate(
            rng=np.random.default_rng(2)))
        mixed = comp.LogLikelihoodSum([blob, ulf])
        lf = blob_likelihood(pkg, 'linear')
        lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(3)))
        lf.pdf_base_config['coupling'] = 1.0
        reparam = comp.LogLikelihoodReParam(lf, {
            'wimp_rate_multiplier': {'params': ['coupling'],
                                     'func': lambda c: c ** 2},
            'coupling': (np.linspace(0.0, 3.0, 4), None, None)})
        constraint = comp.correlated_gaussian_constraint(CONSTRAINED, MEAN,
                                                         COV)
        return mixed, reparam, constraint
    port = models(PORT, tcomp, txenon)
    ref = models(JAX, jcomp, jxenon)
    # the ReParam as the JAX package fits it: without the snap candidates
    # at its wrapped likelihood's anchors (test_torch_ad_engine.py)
    cached_logl(port[1], device='cpu').child.shape_anchor_arrays = []
    for tm, jm in zip(port, ref):
        compiled = build_logl(tm, device='cpu')
        assert tfitter._engine_family(compiled) == 'ad'
        (tp, tll), (jp, jll) = (tm.bestfit_jax(device='cpu'),
                                jm.bestfit_jax())
        assert list(tp) == list(jp)
        np.testing.assert_allclose(tll, jll, rtol=0, atol=1e-6)
        values = [k for k in jp if not k.endswith('_error')]
        np.testing.assert_allclose([tp[k] for k in values],
                                   [jp[k] for k in values], rtol=2e-3,
                                   atol=2e-3)
    tstudy = BinnedToyStudy(port[1], device='cpu', max_iter=60)
    tstudy.compiled.child.shape_anchor_arrays = []
    jstudy = JaxStudy(ref[1], max_iter=60, two_stage=False)
    counts = np.random.default_rng(4).poisson(
        tstudy.expected_counts().numpy(), (3, 8, 6)).astype(float)
    tt, tfree, tcond = tstudy._run_profile(counts, 'coupling', 1.0, None)
    jt, jfree, jcond = jstudy._run_profile(jnp.asarray(counts), 'coupling',
                                           1.0, None)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=1e-4)
    for t, j in ((tfree, jfree), (tcond, jcond)):
        np.testing.assert_allclose(t.max_ll, np.asarray(j.max_ll), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(t.x, np.asarray(j.x), rtol=2e-3,
                                   atol=2e-3)