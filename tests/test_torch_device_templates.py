"""Device-side template building of the port (``JaxDensitySource`` and
``prefill_anchor_templates``, the density in torch ops) against the JAX
package's, float64 on the CPU (``template_device='cpu'``): mirrors of
``tests/test_device_templates.py``.

The pmfs are held to the JAX package's device-built templates and to the
host (scipy, float64) closed forms at rtol 1e-6, atol 1e-12; the counts of
batched device calls (``DEVICE_CALLS``) to the JAX package's deltas.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import stats

from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.models import jax_source as jsource
from blueice_tpu.test_helpers import conf_for_test as jconf
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.likelihood import (BinnedLogLikelihood,
                                          UnbinnedLogLikelihood)
from blueice_tpu_torch.models import Model, jax_source
from blueice_tpu_torch.models.jax_source import (JaxDensitySource,
                                                 prefill_anchor_templates)
from blueice_tpu_torch.models.source import Source
from blueice_tpu_torch.test_helpers import conf_for_test
from blueice_tpu_torch.utils import set_progress

from test_torch_profile_grid_map import fresh_template_caches  # noqa: F401,E402

EDGES = np.linspace(-8, 8, 65)


def gauss_density(params, x):
    return torch.exp(-0.5 * ((x - params['mu']) / params['sigma']) ** 2) \
        / (params['sigma'] * math.sqrt(2 * math.pi))


def jax_gauss_density(params, x):
    return jnp.exp(-0.5 * ((x - params['mu']) / params['sigma']) ** 2) \
        / (params['sigma'] * jnp.sqrt(2 * jnp.pi))


def _conf(tmp_path, **kwargs):
    conf = conf_for_test(n_sources=1, cache_dir=str(tmp_path / 'cache'),
                         task_dir=str(tmp_path / 'tasks'))
    conf['default_source_class'] = JaxDensitySource
    conf['density'] = gauss_density
    conf['density_params'] = ['mu', 'sigma']
    conf['analysis_space'] = [['x', EDGES]]
    conf['template_device'] = 'cpu'
    conf.update(kwargs)
    return conf


def _jax_conf(tmp_path, **kwargs):
    conf = jconf(n_sources=1, cache_dir=str(tmp_path / 'jcache'),
                 task_dir=str(tmp_path / 'jtasks'))
    conf['default_source_class'] = jsource.JaxDensitySource
    conf['density'] = jax_gauss_density
    conf['density_params'] = ['mu', 'sigma']
    conf['analysis_space'] = [['x', EDGES]]
    conf.update(kwargs)
    return conf


def _oracle_pmf(mu, sigma, edges):
    """Host float64 closed form of the template: bin-center density x
    width, normalized over the space."""
    centers = 0.5 * (edges[1:] + edges[:-1])
    pmf = stats.norm(mu, sigma).pdf(centers) * np.diff(edges)
    return pmf / pmf.sum()


@pytest.fixture(autouse=True)
def quiet():
    set_progress(False)
    jax_set_progress(False)


def test_81_anchor_grid_one_device_call(tmp_path):
    """9 x 9 shape anchors -> 81 templates from one batched call, each
    matching the JAX package's device build and the scipy oracle."""
    mus, sigmas = np.linspace(-2, 2, 9), np.linspace(0.6, 1.6, 9)
    lfs = []
    for cls, conf, module in ((BinnedLogLikelihood, _conf, jax_source),
                              (JaxBinned, _jax_conf, jsource)):
        lf = cls(conf(tmp_path))
        lf.add_shape_parameter('mu', tuple(mus))
        lf.add_shape_parameter('sigma', tuple(sigmas))
        calls = module.DEVICE_CALLS
        lf.prepare()
        assert module.DEVICE_CALLS == calls + 1, \
            "all 81 anchors must build in ONE batched device call"
        lfs.append(lf)
    tlf, jlf = lfs
    assert len(tlf.anchor_models) == 81
    for (mu, sigma), model in tlf.anchor_models.items():
        got = model.sources[0].get_pmf_grid()[0]
        np.testing.assert_allclose(
            got, jlf.anchor_models[(mu, sigma)].sources[0].get_pmf_grid()[0],
            rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got, _oracle_pmf(mu, sigma, EDGES),
                                   rtol=1e-6, atol=1e-12)


def test_prefill_seeds_cache_for_second_prepare(tmp_path):
    lf = BinnedLogLikelihood(_conf(tmp_path))
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    calls0 = jax_source.DEVICE_CALLS
    lf.prepare()
    assert jax_source.DEVICE_CALLS == calls0 + 1
    # Same configs again: everything is cached, zero device calls
    lf2 = BinnedLogLikelihood(_conf(tmp_path))
    lf2.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    calls1 = jax_source.DEVICE_CALLS
    lf2.prepare()
    assert jax_source.DEVICE_CALLS == calls1


def test_template_device_is_not_hashed(tmp_path):
    """The device of the build is not in the template's content hash: a
    card build and a CPU build serve each other from one cache entry."""
    hashes = {JaxDensitySource.normalized_config(
        dict(_conf(tmp_path, template_device=dev), name='s0'))[1]['hash']
        for dev in ('cpu', 'cuda', None)}
    assert len(hashes) == 1


def test_default_template_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BinnedLogLikelihood(_conf(tmp_path, template_device=None, mu=0.31))


def test_serial_build_matches_batched(tmp_path):
    """A source built alone (cold cache, no prefill) produces the same
    template bytes as the batched path."""
    conf = _conf(tmp_path, mu=0.123, sigma=1.07)
    assert prefill_anchor_templates([conf]) == 1
    m_cached = Model(conf)
    conf2 = _conf(tmp_path / 'b', mu=0.123, sigma=1.07)
    _, c = JaxDensitySource.normalized_config(
        dict(conf2, name='s0', rate_multiplier=1))
    Source._data_cache.pop(c['hash'], None)
    m_serial = Model(conf2)
    np.testing.assert_array_equal(m_serial.sources[0].get_pmf_grid()[0],
                                  m_cached.sources[0].get_pmf_grid()[0])


def test_rate_function_scales_mus_across_anchors(tmp_path):
    conf = _conf(tmp_path, rate_function=lambda p: 1.0 + abs(float(p['mu'])))
    lf = BinnedLogLikelihood(conf)
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    lf.prepare()
    base = conf['events_per_day']
    for (mu,), model in lf.anchor_models.items():
        assert model.sources[0].events_per_day == pytest.approx(
            base * (1 + abs(mu)))


def test_incompatible_groups_batch_separately(tmp_path):
    """Two sources with different densities do not batch together, but
    each group is still a single call (as the JAX package's)."""
    def flat_density(params, x):
        return torch.ones_like(x) * params['sigma'] / params['sigma']

    conf = _conf(tmp_path, sigma=0.777)
    conf['sources'] = [{'name': 'gauss'},
                       {'name': 'flat', 'density': flat_density}]
    lf = BinnedLogLikelihood(conf)
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    calls0 = jax_source.DEVICE_CALLS
    lf.prepare()
    assert jax_source.DEVICE_CALLS == calls0 + 2
    assert len(lf.anchor_models) == 3


def test_fit_through_compiled_path(tmp_path):
    """The device-built templates drive the compiled fit: against scipy on
    the host and the JAX package's bestfit_jax on its own device-built
    templates, on the same events."""
    lfs = []
    for cls, conf in ((BinnedLogLikelihood, _conf), (JaxBinned, _jax_conf)):
        lf = cls(conf(tmp_path / cls.__module__))
        lf.add_rate_parameter('s0')
        lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
        lf.prepare()
        lfs.append(lf)
    events = lfs[1].base_model.simulate(rng=np.random.default_rng(7))
    for lf in lfs:
        lf.set_data(events)
    tlf, jlf = lfs
    fit_t, ll_t = tlf.bestfit_jax(device='cpu')
    fit_s, ll_s = tlf.bestfit_scipy()
    fit_j, ll_j = jlf.bestfit_jax()
    assert fit_t['s0_rate_multiplier'] == pytest.approx(
        fit_s['s0_rate_multiplier'], rel=1e-3)
    assert ll_t == pytest.approx(ll_s, abs=1e-3)
    assert ll_t == pytest.approx(ll_j, abs=1e-6)
    np.testing.assert_allclose(fit_t['mu'], fit_j['mu'], atol=2e-3)


def test_unbinned_likelihood_with_device_templates(tmp_path):
    lf = UnbinnedLogLikelihood(_conf(tmp_path))
    lf.add_rate_parameter('s0')
    lf.prepare()
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(3)))
    assert np.isfinite(lf())


def test_xenon_example_templates_match(tmp_path):
    """The XENON-style example's device-built templates (one batched call
    per source covering its anchors) match the JAX package's device build
    and the host-evaluated GaussianBlobSource templates."""
    small = dict(n_cs1_bins=14, n_cs2_bins=11)

    def dirs(name):
        return dict(cache_dir=str(tmp_path / name),
                    task_dir=str(tmp_path / (name + '_t')))
    lf_host = txenon.build_likelihood('binned', **small, **dirs('host'))
    calls0 = jax_source.DEVICE_CALLS
    lf_dev = txenon.build_likelihood('binned', jax_templates=True,
                                     template_device='cpu', **small,
                                     **dirs('dev'))
    # 6 single-template calls while the base model builds + 6 batched
    # calls in prepare(), each covering a source's remaining anchors
    assert jax_source.DEVICE_CALLS == calls0 + 12
    jcalls0 = jsource.DEVICE_CALLS
    lf_jax = jxenon.build_likelihood('binned', jax_templates=True, **small,
                                     **dirs('jax'))
    assert jsource.DEVICE_CALLS == jcalls0 + 12

    assert len(lf_dev.anchor_models) == 81
    for zs, m_host in lf_host.anchor_models.items():
        for s_host, s_dev, s_jax in zip(m_host.sources,
                                        lf_dev.anchor_models[zs].sources,
                                        lf_jax.anchor_models[zs].sources):
            got = s_dev.get_pmf_grid()[0]
            np.testing.assert_allclose(got, s_host.get_pmf_grid()[0],
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(got, s_jax.get_pmf_grid()[0],
                                       rtol=1e-6, atol=1e-12)
    ratio = (lf_dev.base_model.expected_events()
             / lf_host.base_model.expected_events())
    frac = np.array([s.fraction_in_range
                     for s in lf_host.base_model.sources])
    np.testing.assert_allclose(ratio * frac, 1.0, rtol=1e-6)
    np.testing.assert_allclose(lf_dev.base_model.expected_events(),
                               lf_jax.base_model.expected_events(),
                               rtol=1e-12)
