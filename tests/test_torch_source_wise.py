"""Source-wise morphing and mixed pdf interpolation methods of the port
against the JAX package, float64 on the CPU, on identical numpy inputs.

* The source-wise likelihood's value at random points: unbinned against the
  JAX package's source-wise build; binned (which the JAX package refuses)
  against the JAX package's global build of the same XENON-style model,
  whose templates do not vary along the efficiency that five of its six
  sources ignore, so the two are one function (rtol 1e-9).
* ``state_from_reference`` of a source-wise build, of either package.
* The unbinned study: the per-source scoring against the JAX study's, and
  the profile fits of the same event sets against the JAX autodiff fit
  vmapped. The port's fits snap to the shape parameters' anchors, the
  JAX package's source-wise fits do not: without the snaps the fits are
  the JAX package's, with them no toy's max_ll is lower. Where two fits
  of one toy may settle on either side of an anchor-grid kink, at least
  95% of the toys agree in x (2e-3), their max_ll within rtol 1e-7 and
  atol 1e-5, and every toy's |d max_ll| < 0.2 (the rule of
  ``tests/test_toys.py``).
* The XENON-shaped identity at a small size: source-wise (autodiff engine)
  and global (closed form) fits of the same toys, binned and unbinned.
* Mixed 'linear' / 'piecewise' scoring, sampled and generic, against the
  JAX study's, and its profile fits.
* ``profile_map`` refuses a source-wise build, as the JAX package does.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from blueice_tpu.compile import cached_logl as jcached
from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.parallel import UnbinnedToyStudy as JaxStudy
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.priors import NormalPrior as JaxNormal
from blueice_tpu_torch.compile import build_logl
from blueice_tpu_torch.convert import (build_logl_from_state,
                                       state_from_reference)
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
from blueice_tpu_torch.parallel import (BinnedToyStudy, UnbinnedToyStudy,
                                        fitter as tfitter)
from blueice_tpu_torch.priors import NormalPrior

from test_torch_ad_engine import with_data, xenon_lf
from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)
from test_torch_unbinned_study import _config, _numpy_events

TARGET = 'wimp_rate_multiplier'


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [dict(band_shift=rng.uniform(-1, 1),
                 band_width_scale=rng.uniform(0.8, 1.2),
                 cs1_tilt=rng.uniform(-1, 1),
                 efficiency=rng.uniform(0.7, 1.3),
                 wimp_rate_multiplier=rng.uniform(0.2, 3.0),
                 er_rate_multiplier=rng.uniform(0.9, 1.1))
            for _ in range(n)]


def test_unbinned_source_wise_value_matches_jax():
    jlf = with_data(xenon_lf('jax', source_wise=True), 21)
    tlf = with_data(xenon_lf('port', source_wise=True), 21)
    assert tlf._builds['ps'][0] == tlf._builds['mus'][0] == 'source_wise'
    assert {sn: len(a) for sn, a in tlf.anchor_sources.items()} == {
        sn: len(a) for sn, a in jlf.anchor_sources.items()}
    assert len(tlf.anchor_sources['wimp']) == 81
    assert len(tlf.anchor_sources['er']) == 27
    jc = jcached(jlf)
    compiled = (build_logl(tlf, device='cpu'), build_logl(jlf, device='cpu'))
    for point in [{}] + _points(4, 22):
        ref = float(jc(**point))
        np.testing.assert_allclose(tlf(**point), jlf(**point), rtol=1e-9)
        for tc in compiled:
            np.testing.assert_allclose(float(tc(**point)), ref, rtol=1e-9)


def test_binned_source_wise_value_matches_the_global_build():
    """The JAX package refuses a binned source-wise likelihood; the port's
    equals the JAX global build of the same XENON model."""
    with pytest.raises(NotImplementedError, match='binned'):
        xenon_lf('jax', 'binned', source_wise=True)
    jlf = with_data(xenon_lf('jax', 'binned'), 23)
    tlf = with_data(xenon_lf('port', 'binned', source_wise=True), 23)
    assert tlf._builds['ps'][0] == 'source_wise'
    jc, tc = jcached(jlf), build_logl(tlf, device='cpu')
    assert tc.anchor_arrays is None and tc.source_wise is not None
    for point in [{}] + _points(4, 24):
        np.testing.assert_allclose(tlf(**point), jlf(**point), rtol=1e-9)
        np.testing.assert_allclose(float(tc(**point)), float(jc(**point)),
                                   rtol=1e-9)
    with pytest.raises(NotImplementedError, match='finite-MC'):
        txenon.build_likelihood('binned', bb='bb_lite',
                                source_wise_interpolation=True,
                                n_cs1_bins=4, n_cs2_bins=3)


@pytest.mark.parametrize('kind', ['binned', 'unbinned'])
def test_state_from_reference_of_a_source_wise_build(kind):
    """Either package's source-wise build reads into the same state: per
    source its shape indices, anchors and payloads."""
    pkgs = ('port', 'jax') if kind == 'unbinned' else ('port',)
    states = [state_from_reference(with_data(
        xenon_lf(pkg, kind, source_wise=True), 25)) for pkg in pkgs]
    state = states[0]
    assert state['anchor_arrays'] is None
    wimp = state['source_names'].index('wimp')
    assert state['source_wise'][wimp]['shape_idx'] == [0, 1, 2, 3]
    assert all(e['shape_idx'] == [0, 1, 2]
               for i, e in enumerate(state['source_wise']) if i != wimp)
    assert state['mus'][wimp].shape == (3, 3, 3, 3)
    assert state['ps'][0].shape[:3] == (3, 3, 3)
    for other in states[1:]:
        assert other['source_wise'][wimp]['shape_idx'] == [0, 1, 2, 3]
        for a, b in zip(state['mus'] + state['ps'],
                        other['mus'] + other['ps']):
            np.testing.assert_array_equal(a, b)
    tc = build_logl_from_state(state, device='cpu')
    point = _points(1, 26)[0]
    np.testing.assert_allclose(float(tc(**point)),
                               float(build_logl(with_data(xenon_lf(
                                   'port', kind, source_wise=True), 25),
                                   device='cpu')(**point)), rtol=1e-12)


@pytest.fixture(scope='module')
def sw_studies():
    """The port's and the JAX package's unbinned source-wise studies of the
    small XENON model, and 6 numpy-made event sets."""
    jlf, tlf = xenon_lf('jax', source_wise=True), xenon_lf(
        'port', source_wise=True)
    jstudy = JaxStudy(jlf, max_iter=60, engine='ad', two_stage=False)
    tstudy = UnbinnedToyStudy(tlf, device='cpu', max_iter=60,
                              two_stage=False)
    weights = tstudy.expected_weights().numpy()
    np.testing.assert_allclose(
        weights, np.asarray(jstudy.expected_weights()), rtol=1e-12)
    events = _numpy_events(weights, tstudy.n_max, 6, tstudy.edges, 27)
    return jstudy, tstudy, events


def test_source_wise_scoring_matches(sw_studies):
    jstudy, tstudy, (coords, mask, bins) = sw_studies
    ps = tstudy.score_events(coords, bins)
    ref = jax.vmap(lambda c, b: jstudy._score_sampled(
        c, tuple(b[:, d] for d in range(b.shape[1]))))(
            jnp.asarray(coords), jnp.asarray(bins))
    assert isinstance(ps, tuple) and len(ps) == len(ref) == 6
    for port, r in zip(ps, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(port.numpy(), r.reshape(port.shape),
                                   rtol=1e-12, atol=0)
    # the generic path (no sampled bins) scores the same events alike
    for port, r in zip(tstudy.score_events(coords), ps):
        np.testing.assert_allclose(port.numpy(), r.numpy(), rtol=1e-12,
                                   atol=1e-300)


def _assert_95(port_x, port_ll, ref_x, ref_ll):
    agree = np.all(np.abs(port_x - ref_x) < 2e-3, axis=1)
    assert agree.mean() >= 0.95, agree
    np.testing.assert_allclose(port_ll[agree], ref_ll[agree], rtol=1e-7,
                               atol=1e-5)
    assert np.abs(port_ll - ref_ll).max() < 0.2


def test_source_wise_profile_matches_jax(sw_studies):
    """Free and conditional fits of the same event sets: the port's study
    (engine 'auto': the autodiff engine) against the JAX autodiff fit
    vmapped over the per-source scores. Without the snap candidates
    (which the JAX package's source-wise fits lack) the port's fits are
    the JAX package's; with them (the default) no toy ends lower."""
    jstudy, tstudy, events = sw_studies
    coords, mask, bins = events
    assert tfitter._engine_family(tstudy.compiled) == 'ad'
    tt, tfree, tcond = tstudy._run_profile(events, TARGET, 1.0, None)
    no_snap = UnbinnedToyStudy(tstudy.lf, device='cpu', max_iter=60,
                               two_stage=False)
    no_snap.compiled.shape_anchor_arrays = []
    _, nfree, ncond = no_snap._run_profile(events, TARGET, 1.0, None)
    ps = tuple(jnp.asarray(p.numpy().reshape(
        (p.shape[0],) + tuple(len(a) for a in m.anchor_z_arrays)
        + (p.shape[-1],)))
        for p, m in zip(tstudy.score_events(coords, bins),
                        jstudy.lf.source_morphers.values()))
    mask_j = jnp.asarray(mask)
    fit_free, names_free = jfitter.make_toy_fitter(
        jstudy.compiled, max_iter=60, engine='ad')
    fit_cond, names_cond = jfitter.make_toy_fitter(
        jstudy.compiled, runtime_fixed=[TARGET], max_iter=60, engine='ad')
    xf, llf, _ = jax.jit(jax.vmap(fit_free))(ps, mask_j)
    xc, llc, _ = jax.jit(jax.vmap(
        lambda p, mk: fit_cond(p, mk, (jnp.asarray(1.0),))))(ps, mask_j)
    assert tfree.names == names_free and tcond.names == names_cond
    _assert_95(nfree.x, nfree.max_ll, np.asarray(xf), np.asarray(llf))
    _assert_95(ncond.x, ncond.max_ll, np.asarray(xc), np.asarray(llc))
    assert (tfree.max_ll >= np.asarray(llf) - 1e-6).all()
    assert (tcond.max_ll >= np.asarray(llc) - 1e-6).all()
    assert (tt >= 0).all() and np.isfinite(tt).all()


@pytest.mark.parametrize('kind', ['binned', 'unbinned'])
def test_xenon_identity_global_vs_source_wise(kind):
    """The XENON-shaped identity at a small size: the source-wise model
    (autodiff engine) and the global one (closed form) give the same
    values and, on the same toys, the same profiles."""
    glob = xenon_lf('port', kind)
    sw = xenon_lf('port', kind, source_wise=True)
    cls = BinnedToyStudy if kind == 'binned' else UnbinnedToyStudy
    sg, ss = (cls(lf, device='cpu', max_iter=60) for lf in (glob, sw))
    for point in [{}] + _points(3, 28):
        for name in ('expected_counts', 'expected_weights'):
            if hasattr(sg, name):
                np.testing.assert_allclose(
                    getattr(ss, name)(**point).numpy(),
                    getattr(sg, name)(**point).numpy(), rtol=1e-9)
    toys = sg.simulate(29, 6)
    tg, fg, cg = sg._run_profile(toys, TARGET, 1.0, None)
    ts, fs, cs = ss._run_profile(toys, TARGET, 1.0, None)
    _assert_95(fs.x, fs.max_ll, fg.x, fg.max_ll)
    _assert_95(cs.x, cs.max_ll, cg.x, cg.max_ll)
    np.testing.assert_allclose(np.median(ts), np.median(tg), atol=1e-4)


def _mixed_lf(cls, prior, source_wise=False):
    config = _config(jxenon.GaussianBlobSource if cls is JaxUnbinned
                     else txenon.GaussianBlobSource)
    config['sources'][1]['pdf_interpolation_method'] = 'piecewise'
    if source_wise:
        config['sources'][0]['dont_hash_settings'] = ['band_shift']
        config['source_wise_interpolation'] = True
    lf = cls(config)
    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=prior(1, 0.05))
    lf.add_shape_parameter('band_shift', (-1.0, 0.0, 1.0),
                           log_prior=prior(0, 0.5))
    lf.prepare()
    return lf


@pytest.mark.parametrize('source_wise', [False, True],
                         ids=['global', 'source_wise'])
def test_mixed_methods_match_jax(source_wise):
    """One 'linear' and one 'piecewise' source, scored each with its own
    method (sampled and generic) as the JAX study scores them, and fitted
    to the same optima (global: the JAX closed form; source-wise, where
    the ER source ignores band_shift: the JAX autodiff engine)."""
    jstudy = JaxStudy(_mixed_lf(JaxUnbinned, JaxNormal, source_wise),
                      max_iter=40, engine='auto', two_stage=False)
    tstudy = UnbinnedToyStudy(
        _mixed_lf(UnbinnedLogLikelihood, NormalPrior, source_wise),
        device='cpu', max_iter=40, two_stage=False)
    assert jstudy._method is None and tstudy._method is None
    weights = tstudy.expected_weights().numpy()
    coords, mask, bins = _numpy_events(weights, tstudy.n_max, 5,
                                       tstudy.edges, 30)
    sampled = tstudy.score_events(coords, bins)
    generic = tstudy.score_events(coords)
    jsampled = jax.vmap(lambda c, b: jstudy._score_sampled(
        c, tuple(b[:, d] for d in range(b.shape[1]))))(
            jnp.asarray(coords), jnp.asarray(bins))
    jgeneric = jax.vmap(jstudy._score_events)(jnp.asarray(coords))
    flat = (lambda x: x) if source_wise else (lambda x: (x,))
    for port, ref in ((sampled, jsampled), (generic, jgeneric)):
        for p, r in zip(flat(port), flat(ref)):
            np.testing.assert_allclose(p.numpy(), np.asarray(r).reshape(
                p.shape), rtol=1e-12, atol=1e-300)
    ps = tuple(jnp.asarray(p.numpy()) for p in flat(sampled))
    if source_wise:
        ps = tuple(p if p.shape[1] == 1 else p.reshape(p.shape[0], 3, -1)
                   for p in ps)
        ps = (ps[0][:, 0], ps[1])     # ER unmorphed: (n_max,) a toy
    else:
        ps = ps[0].reshape(ps[0].shape[0], -1, ps[0].shape[-1])
    fit, names = jfitter.make_toy_fitter(jstudy.compiled, max_iter=40)
    jx, jll, _ = jax.jit(jax.vmap(fit))(ps, jnp.asarray(mask))
    res = tstudy.fit_events((coords, mask, bins))
    assert res.names == names
    _assert_95(res.x, res.max_ll, np.asarray(jx), np.asarray(jll))


def test_profile_map_refuses_a_source_wise_build():
    lfs = [with_data(xenon_lf(pkg, source_wise=True), 31)
           for pkg in ('jax', 'port')]
    message = 'dense global anchor grid.*host path'
    with pytest.raises(NotImplementedError, match=message):
        JaxStudy(lfs[0]).profile_map([(TARGET, [1.0])])
    with pytest.raises(NotImplementedError, match=message):
        UnbinnedToyStudy(lfs[1], device='cpu').profile_map([(TARGET, [1.0])])
