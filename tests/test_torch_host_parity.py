"""The port's host layer against the JAX package's, float64 on the CPU, on
identical numpy inputs: twins of ``tests/test_template_smoothing.py``,
``test_weighted_mc.py``, ``test_data_reading.py``, ``test_model.py`` and
``test_source.py``, each scenario built by both packages through their
test helpers (``FixedSampleSource``, ``make_data``, ``conf_for_test``) and
held to the same templates, counts, rates, toys and likelihood values (bit
for bit where both draw from the same generator; rtol 1e-12 for values),
and ``poisson_logpmf`` against the JAX package's. A log prior of another
kind than Normal or Uniform compiles when it computes with torch tensors,
as the JAX package compiles a jax-traceable one: the compiled value and
the fits of both engines against the JAX package's.
"""

import os
import shutil
import tempfile

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch
from scipy import stats
from scipy.ndimage import gaussian_filter

import blueice_tpu.likelihood as jlik
import blueice_tpu.models as jmodels
import blueice_tpu.models.source as jsource
import blueice_tpu.test_helpers as jhelpers
from blueice_tpu.models.model import expand_source_configs as jexpand
from blueice_tpu.ops.bb_lite import bb_lite_logl_host as jbb_lite_host
from blueice_tpu.ops.poisson import poisson_logpmf as jpoisson_logpmf
from blueice_tpu.compile import build_logl as jbuild
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.utils import data_reading as jdata_reading
import blueice_tpu_torch.likelihood as tlik
import blueice_tpu_torch.models as tmodels
import blueice_tpu_torch.models.source as tsource
import blueice_tpu_torch.test_helpers as thelpers
from blueice_tpu_torch.models.model import expand_source_configs as texpand
from blueice_tpu_torch.ops.bb_lite import bb_lite_logl_host
from blueice_tpu_torch.compile import build_logl
from blueice_tpu_torch.ops.poisson import poisson_logpmf, poisson_logpmf_np
from blueice_tpu_torch.parallel import fitter as tfitter
from blueice_tpu_torch.priors import TensorPrior
from blueice_tpu_torch.utils import data_reading, io

from test_torch_profile_grid_map import fresh_template_caches  # noqa: F401


def _weighted_classes(source_mod):
    class WeightedSampleSource(source_mod.DensityEstimatingSource):
        """Density estimated from literal (events, weights) in the config;
        the generated weight is the sum of the weights."""

        def get_events_for_density_estimate(self):
            d = self.config['data']
            return d, float(np.sum(d[self.config['weight_field']]))

    class WeightedGaussianMCSource(source_mod.MonteCarloSource):
        """Gaussian MC emitting a constant per-event weight."""

        def simulate(self, n_events, rng=None):
            if rng is None or rng is np.random:
                rng = np.random.default_rng(np.random.randint(2 ** 31))
            d = np.zeros(n_events, dtype=[('x', float), ('source', int),
                                          ('w', float)])
            d['x'] = rng.normal(self.config['mu'], self.config['sigma'],
                                n_events)
            d['w'] = self.config.get('event_weight', 1.0)
            return d
    return WeightedSampleSource, WeightedGaussianMCSource


PACKAGES = {
    'port': dict(helpers=thelpers, models=tmodels, lik=tlik,
                 weighted=_weighted_classes(tsource), expand=texpand),
    'jax': dict(helpers=jhelpers, models=jmodels, lik=jlik,
                weighted=_weighted_classes(jsource), expand=jexpand),
}


def both(build):
    """``build(pkg)`` for the port and for the JAX package, each from the
    same reset numpy state."""
    out = []
    for name in ('port', 'jax'):
        np.random.seed(0)
        out.append(build(PACKAGES[name]))
    return out


def _weighted_events(xs, ws):
    d = np.zeros(len(xs), dtype=[('x', float), ('source', int), ('w', float)])
    d['x'] = xs
    d['w'] = ws
    return d


def _same_source(a, b):
    npt.assert_array_equal(a._pdf_histogram.values, b._pdf_histogram.values)
    npt.assert_array_equal(a._n_events_histogram.values,
                           b._n_events_histogram.values)
    assert a.fraction_in_range == b.fraction_in_range
    assert a.expected_events == b.expected_events


# -- template smoothing -------------------------------------------------------

def _delta_conf(pkg, **kw):
    h = pkg['helpers']
    data, _ = h.make_data([dict(n_events=100, x=4.5)])
    return h.conf_for_test(default_source_class=h.FixedSampleSource,
                           analysis_space=[['x', np.arange(0, 10.5, 1.0)]],
                           data=data, **kw)


@pytest.mark.parametrize('sigma', [None, 0.0, 1.5, 2.0])
def test_template_smoothing_matches_jax(sigma):
    kw = {} if sigma is None else dict(template_smoothing_sigma=sigma)
    port, ref = both(lambda pkg: pkg['models'].Model(
        _delta_conf(pkg, **kw)).sources[0])
    _same_source(port, ref)
    raw = np.zeros(10)
    raw[4] = 100.0
    if sigma:
        raw = gaussian_filter(raw, sigma, mode='constant', cval=0.0) \
            * raw.sum() / gaussian_filter(raw, sigma, mode='constant',
                                          cval=0.0).sum()
    npt.assert_allclose(port._pdf_histogram.values, raw / 100.0, rtol=1e-12)
    # the MC-statistics histogram is the raw sample either way
    npt.assert_array_equal(port._n_events_histogram.values[4], 100.0)


def test_per_axis_smoothing_matches_jax():
    def build(pkg):
        h = pkg['helpers']
        data, _ = h.make_data([dict(n_events=50, x=2.5, y=2.5)])
        return pkg['models'].Model(h.conf_for_test(
            default_source_class=h.FixedSampleSource,
            analysis_space=[['x', np.arange(0, 5.5, 1.0)],
                            ['y', np.arange(0, 5.5, 1.0)]],
            data=data, template_smoothing_sigma=[0.7, 0.0])).sources[0]
    port, ref = both(build)
    _same_source(port, ref)
    vals = port._pdf_histogram.values
    assert np.sum(np.any(vals > 0, axis=0)) == 1      # y columns
    assert np.sum(np.any(vals > 0, axis=1)) > 1       # x rows spread


def test_smoothing_validation_and_hash():
    for pkg in PACKAGES.values():
        Model = pkg['models'].Model
        with pytest.raises(ValueError, match='>= 0'):
            Model(_delta_conf(pkg, template_smoothing_sigma=-1.0))
        with pytest.raises(ValueError, match='one per analysis axis'):
            Model(_delta_conf(pkg, template_smoothing_sigma=[1.0, 2.0]))
        assert (Model(_delta_conf(pkg)).sources[0].hash
                != Model(_delta_conf(pkg, template_smoothing_sigma=1.0))
                .sources[0].hash)


# -- weighted Monte Carlo -----------------------------------------------------

WEIGHTED = {
    # bin [0,1): weights 1,2,3 -> n_eff 36/14; bin [1,2): weight 2 -> 1
    'closed_form': ([0.5, 0.5, 0.5, 1.5], [1.0, 2.0, 3.0, 2.0], [0, 1, 2, 3]),
    'unit': ([0.5, 0.5, 1.5, 2.5, 2.5, 2.5], np.ones(6), [0, 1, 2, 3]),
    'constant': ([0.5, 0.5, 1.5], [7.0, 7.0, 7.0], [0, 1, 2]),
    'fraction': ([0.5, 5.0], [3.0, 1.0], [0, 1]),
    'negative_bin': ([0.5, 1.5, 1.5], [2.0, 0.5, -1.0], [0, 1, 2]),
    'fraction_above_one': ([0.5, 5.0], [3.0, -1.0], [0, 1]),
}


def _weighted_conf(pkg, case, **kw):
    xs, ws, edges = WEIGHTED[case]
    return pkg['helpers'].conf_for_test(
        default_source_class=pkg['weighted'][0],
        analysis_space=[['x', edges]], weight_field='w',
        data=_weighted_events(xs, ws), **kw)


@pytest.mark.parametrize('case', sorted(WEIGHTED))
def test_weighted_templates_match_jax(case):
    port, ref = both(lambda pkg: pkg['models'].Model(
        _weighted_conf(pkg, case)).sources[0])
    _same_source(port, ref)
    if case == 'closed_form':
        npt.assert_allclose(port._n_events_histogram.values,
                            [36 / 14, 1.0, 0.0])
        npt.assert_allclose(port._pdf_histogram.values, [6 / 8, 2 / 8, 0.0])
    if case == 'fraction':
        assert port.fraction_in_range == 0.75
    if case in ('negative_bin', 'fraction_above_one'):
        match = ('net-negative' if case == 'negative_bin'
                 else 'fraction_in_range')
        for s in (port, ref):
            with pytest.raises(ValueError, match=match):
                s.simulate_toy(100, rng=np.random.default_rng(0))


def test_nonpositive_total_weight_rejected():
    for pkg in PACKAGES.values():
        conf = pkg['helpers'].conf_for_test(
            default_source_class=pkg['weighted'][0],
            analysis_space=[['x', [0, 1]]], weight_field='w',
            data=_weighted_events([0.5, 0.5], [1.0, -1.0]))
        with pytest.raises(ValueError, match='positive net weight'):
            pkg['models'].Model(conf)


def test_weighted_mc_source_batches_match_jax():
    port, ref = both(lambda pkg: pkg['models'].Model(
        pkg['helpers'].conf_for_test(
            default_source_class=pkg['weighted'][1],
            n_events_for_pdf=int(3e4), pdf_sampling_batch_size=int(1e4),
            event_weight=2.5, weight_field='w',
            force_recalculation=True)).sources[0])
    _same_source(port, ref)
    assert abs(port.pdf([0.0])[0] - stats.norm.pdf(0)) < 0.02


def test_weighted_toys_and_mixed_sources_match_jax():
    """Toys drawn from a weighted template, and a model mixing a weighted
    and an unweighted source, from one generator seed: the same events."""
    def template_toys(pkg):
        conf = pkg['helpers'].conf_for_test(
            default_source_class=pkg['weighted'][0],
            analysis_space=[['x', [0, 1, 2]]], weight_field='w',
            data=_weighted_events([0.5] * 10 + [1.5] * 10,
                                  [3.0] * 10 + [1.0] * 10),
            events_per_day=4000.)
        return pkg['models'].Model(conf).simulate(
            rng=np.random.default_rng(42))

    def mixed_toys(pkg):
        weighted, gauss = pkg['weighted']
        conf = pkg['helpers'].conf_for_test(
            n_sources=2, analysis_space=[['x', [0, 1, 2]]],
            events_per_day=500.,
            sources=[dict(name='sig', **{'class': weighted},
                          weight_field='w',
                          data=_weighted_events([0.5] * 10, np.ones(10))),
                     dict(name='bg', **{'class': gauss})],
            mu=0.5, sigma=0.2, n_events_for_pdf=int(2e4))
        return pkg['models'].Model(conf).simulate(
            rng=np.random.default_rng(1))

    for make in (template_toys, mixed_toys):
        port, ref = both(make)
        assert port.dtype.names == ref.dtype.names
        for name in port.dtype.names:
            npt.assert_array_equal(port[name], ref[name])
    assert len(port) > 500
    toys = template_toys(PACKAGES['port'])
    assert 'w' not in toys.dtype.names
    # the weights' 3:1, not the events' 1:1
    assert 2.5 < np.sum(toys['x'] < 1) / np.sum(toys['x'] >= 1) < 3.5


@pytest.mark.parametrize('mode', [None, 'bb_lite'])
def test_weighted_likelihood_matches_jax(mode):
    """The binned host likelihood over weighted templates, plain and
    bb_lite on the effective counts (and a net-negative bin, finite)."""
    def build(pkg):
        h = pkg['helpers']
        if mode is None:
            conf = _weighted_conf(pkg, 'negative_bin')
            obs = [dict(n_events=2, x=0.5), dict(n_events=1, x=1.5)]
        else:
            conf = h.conf_for_test(
                default_source_class=pkg['weighted'][0],
                analysis_space=[['x', [0, 1, 2]]], weight_field='w',
                data=_weighted_events([0.5] * 3 + [1.5],
                                      [1.0, 2.0, 3.0, 2.0]),
                events_per_day=8. / 5.)
            obs = [dict(n_events=5, x=0.5), dict(n_events=1, x=1.5)]
        lf = pkg['lik'].BinnedLogLikelihood(conf, likelihood_config={
            'model_statistical_uncertainty_handling': mode})
        lf.prepare()
        lf.set_data(h.make_data(obs)[0])
        return lf
    port, ref = both(build)
    assert np.isfinite(port())
    npt.assert_allclose(port(), ref(), rtol=1e-12)
    if mode == 'bb_lite':
        mu = np.atleast_1d(port.base_model.expected_events())
        args = (mu, np.array([[6 / 8, 2 / 8]]), np.array([[36 / 14, 1.0]]),
                np.array([5.0, 1.0]))
        npt.assert_allclose(port(), bb_lite_logl_host(*args), rtol=1e-12)
        npt.assert_allclose(bb_lite_logl_host(*args), jbb_lite_host(*args),
                            rtol=1e-12)


# -- data reading -------------------------------------------------------------

@pytest.fixture
def tempdir():
    tmpdir = tempfile.mkdtemp()
    yield tmpdir
    shutil.rmtree(tmpdir)


def test_data_reading(tempdir):
    fn = 'important_setting.pkl'
    full_path = os.path.join(tempdir, fn)
    io.save_pickle('howdy', full_path)
    assert io.read_pickle(full_path) == 'howdy'
    with pytest.raises(FileNotFoundError):
        io.find_file_in_folders('gnork', folders=tempdir)
    assert io.find_file_in_folders(fn, folders=tempdir) == full_path
    assert io.data_file_name(fn, data_dirs=tempdir) == full_path
    with pytest.raises(FileNotFoundError):
        io.data_file_name('gnork.pkl', data_dirs=tempdir)

    c = dict(bla='nothing_special')
    assert data_reading.read_files_in(c, data_dirs=tempdir) == c
    c = dict(bla=fn)
    assert set(data_reading.FILE_READERS) == set(jdata_reading.FILE_READERS)
    pimped = data_reading.read_files_in(c, data_dirs=tempdir)
    assert c['bla'] == fn and pimped['bla'] == 'howdy'
    assert full_path in data_reading.CACHE
    assert jdata_reading.read_files_in(c, data_dirs=tempdir) == pimped
    data_reading.read_files_in(thelpers.conf_for_test(), data_dirs=tempdir)


def test_atomic_npz(tempdir):
    path = os.path.join(tempdir, 'payload.npz')
    io.save_npz(dict(a=np.arange(5), s=3.5), path)
    loaded = io.load_npz(path)
    npt.assert_array_equal(loaded['a'], np.arange(5))
    assert float(loaded['s']) == 3.5


# -- models and sources -------------------------------------------------------

def test_model_rates_match_jax():
    for n, kw in ((1, {}), (2, dict(some_multiplier=2)),
                  (1, dict(strlen_multiplier='hi'))):
        port, ref = both(lambda pkg: pkg['models'].Model(
            pkg['helpers'].conf_for_test(n_sources=n, **kw)))
        npt.assert_array_equal(port.expected_events(), ref.expected_events())
    npt.assert_array_equal(port.expected_events(), [2000])
    m = tmodels.Model(thelpers.conf_for_test(n_sources=2))
    for source in m.sources:
        source.config['livetime_days'] = 2
    npt.assert_array_equal(m.expected_events(), [2000, 2000])
    assert m.get_source('s1') is m.sources[1] and m.get_source_i('s1') == 1


def test_model_simulate_matches_jax():
    space = [['x', np.linspace(-1, 1, 10)]]
    for kw in (dict(), dict(rate_multipliers={'s0': 10})):
        port, ref = both(lambda pkg: pkg['models'].Model(
            pkg['helpers'].conf_for_test(analysis_space=space)).simulate(
                rng=np.random.default_rng(0), **kw))
        npt.assert_array_equal(port['x'], ref['x'])
        assert (np.abs(port['x']) <= 1).all()


def test_mc_source_matches_jax():
    """The Monte-Carlo template from one reset numpy state, the cache
    identity and the scenario rate hooks."""
    port, ref = both(lambda pkg: pkg['models'].Model(
        pkg['helpers'].conf_for_test(mc=True, n_events_for_pdf=int(2e4),
                                     some_multiplier=2,
                                     force_recalculation=True)).sources[0])
    _same_source(port, ref)
    assert port.events_per_day == pytest.approx(2000.0)
    bins = thelpers.conf_for_test()['analysis_space'][0][1]
    assert ((port.pdf([bins[0]]) + port.pdf([bins[1]])) / 2
            == port.pdf([(bins[0] + bins[1]) / 2]))
    conf = thelpers.conf_for_test(mc=True, n_events_for_pdf=int(1e4),
                                  sigma=1.7)
    s1 = tmodels.Model(conf).sources[0]
    s2 = tmodels.Model(dict(conf, pdf_sampling_batch_size=12345)).sources[0]
    assert s2.from_cache and s2.hash == s1.hash
    assert tmodels.Model(dict(conf, sigma=1.8)).sources[0].hash != s1.hash
    assert not tmodels.Model(dict(conf, force_recalculation=True)) \
        .sources[0].from_cache


def test_source_configs_match_jax():
    """The per-entry rate multiplier and the hash's indifference to the
    data directories and the source's name, as the JAX package's."""
    for pkg in PACKAGES.values():
        conf = pkg['helpers'].conf_for_test()
        conf['sources'] = [dict(name='s0', rate_multiplier=2.5)]
        (_, merged), = pkg['expand'](conf)
        assert merged['rate_multiplier'] == 2.5
        conf['s0_rate_multiplier'] = 4.0
        (_, merged), = pkg['expand'](conf)
        assert merged['rate_multiplier'] == 4.0
    base = thelpers.conf_for_test()
    base.update(name='s0', rate_multiplier=1,
                nohash_settings=['data_dirs', 'pdf_sampling_batch_size',
                                 'force_recalculation'])
    G, GMC = thelpers.GaussianSource, thelpers.GaussianMCSource
    h1 = G.normalized_config(dict(base, data_dirs='.'))[1]['hash']
    assert h1 == G.normalized_config(dict(base, data_dirs='/tmp'))[1]['hash']
    assert h1 == G.normalized_config(dict(base, name='other'))[1]['hash']
    assert h1 != GMC.normalized_config(dict(base))[1]['hash']


# -- helpers ------------------------------------------------------------------

def test_helpers_match_jax():
    spec = [dict(n_events=24, x=0.5), dict(n_events=56, x=1.5, y=2.0)]
    (d, n), (jd, jn) = thelpers.make_data(spec), jhelpers.make_data(spec)
    assert n == jn == 80 and d.dtype == jd.dtype
    for name in d.dtype.names:
        npt.assert_array_equal(d[name], jd[name])
    assert thelpers.almost_equal(1.0, 1.0 + 1e-7)
    assert not thelpers.almost_equal(1.0, 1.1)
    assert (thelpers.conf_for_reparam_test()['sources']
            == jhelpers.conf_for_reparam_test()['sources'])
    for key in ('events_per_day', 'mu', 'sigma', 'n_events_for_pdf'):
        assert thelpers.BASE_CONFIG[key] == jhelpers.BASE_CONFIG[key]
    for key, spec in jhelpers.BASE_CONV_CONFIG.items():
        port = thelpers.BASE_CONV_CONFIG[key]
        if isinstance(spec, dict):
            assert port['params'] == spec['params']
            assert port['func'](*[2.0] * len(spec['params'])) \
                == spec['func'](*[2.0] * len(spec['params']))
        else:
            npt.assert_array_equal(port[0], spec[0])


def test_poisson_logpmf_matches_jax():
    k = np.array([0.0, 0.0, 1.0, 3.0, 7.0, 120.0])
    mu = np.array([0.0, 2.5, 0.0, 2.5, 7.3, 99.0])
    ref = np.asarray(jpoisson_logpmf(k, mu))
    npt.assert_allclose(poisson_logpmf_np(k, mu), ref, rtol=1e-12)
    npt.assert_allclose(stats.poisson.logpmf(k, mu), ref, rtol=1e-12)
    got = poisson_logpmf(torch.as_tensor(k), torch.as_tensor(mu))
    assert got.dtype == torch.float64
    npt.assert_allclose(got.numpy(), ref, rtol=1e-12)
    assert got[2] == -np.inf and got[0] == 0.0


def _quartic_prior(x):
    """A log prior written with arithmetic only: it computes on floats,
    jax arrays and torch tensors alike."""
    return -((x - 1.0) / 0.3) ** 4


def test_custom_prior_compiles_as_jax():
    def build(pkg):
        h = pkg['helpers']
        lf = pkg['lik'].BinnedLogLikelihood(h.conf_for_test(
            n_sources=2, mc=True, analysis_space=[['x', [-10, -1, 0, 1, 10]]],
            n_events_for_pdf=int(1e5), events_per_day=50.))
        lf.add_rate_parameter('s0', log_prior=_quartic_prior)
        lf.add_shape_parameter('some_multiplier', (0.5, 1.0, 2.0))
        lf.prepare()
        lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(2)))
        return lf
    lf, jlf = both(build)
    c, jc = build_logl(lf, device='cpu'), jbuild(jlf)
    assert isinstance(c.prior_terms[0][1], TensorPrior)
    for kw in (dict(), dict(s0_rate_multiplier=1.4, some_multiplier=1.2)):
        npt.assert_allclose(float(c(**kw)), lf(**kw), rtol=1e-12)
        npt.assert_allclose(float(c(**kw)), float(jc(**kw)), rtol=1e-12)
    counts = c.expected_counts(c.defaults).numpy()
    counts = np.random.default_rng(3).poisson(
        counts, (3,) + counts.shape).astype(float)
    jfit, _ = jfitter.make_toy_fitter(jc)
    jll = np.asarray(jax.vmap(lambda d: jfit(d)[1])(counts))
    for engine in ('analytic', 'ad'):
        fit, _ = tfitter.make_toy_fitter(c, engine=engine)
        npt.assert_allclose(fit(torch.as_tensor(counts))[1].numpy(), jll,
                            rtol=0, atol=1e-6)
    with pytest.raises(TypeError, match='torch tensors'):
        TensorPrior(lambda x: stats.norm(1, 0.1).logpdf(x))
