"""The port on small binned models against the JAX package, float64 on the
CPU: the tiny-system solves; whole profile studies of a two-source model
with no shape parameter (a 'constant' template build, 2x2 Newton systems)
and with one (3x3 systems, in-loop kink jumps) on the same numpy-made
counts; and density-estimated Monte-Carlo templates."""

import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu.priors import NormalPrior as JaxNormal
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.likelihood import BinnedLogLikelihood
from blueice_tpu_torch.parallel import BinnedToyStudy
from blueice_tpu_torch.parallel import fitter as tfitter
from blueice_tpu_torch.priors import NormalPrior
from blueice_tpu_torch.utils import set_progress

from test_torch_profile_grid_map import fresh_template_caches  # noqa: F401,E402

TARGET = 'wimp_rate_multiplier'


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 17])
def test_solve_spd_small_matches(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((5, n, n))
    A = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    b = rng.standard_normal((5, n))
    port = tfitter._solve_spd_small(torch.as_tensor(A), torch.as_tensor(b))
    ref = jax.vmap(jfitter._solve_spd_small)(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-9)


def test_solve_spd_small_indefinite_gives_nan():
    """An indefinite damped Hessian yields NaN in both packages (the
    signal that routes a Newton step to the steepest-descent rescue)."""
    A = np.diag([2.0, -1.0, 3.0, 1.0])[None]
    b = np.ones((1, 4))
    port = tfitter._solve_spd_small(torch.as_tensor(A), torch.as_tensor(b))
    ref = jfitter._solve_spd_small(jnp.asarray(A[0]), jnp.asarray(b[0]))
    assert not np.isfinite(np.asarray(ref)).all()
    assert torch.isnan(port).all()


def _config(source_class):
    space = [['cs1', np.linspace(0, 100, 9)],
             ['log10_cs2', np.linspace(1.0, 4.0, 7)]]
    sources = []
    for name, rate, mean, sigma, corr, resp in (jxenon.SOURCES[0],
                                               jxenon.SOURCES[5]):
        sources.append(dict(name=name, events_per_day=rate / 20,
                            blob_mean=mean, blob_sigma=sigma, blob_corr=corr,
                            band_shift_response=resp[0],
                            width_response=resp[1], tilt_response=resp[2]))
    return dict(analysis_space=space, default_source_class=source_class,
                livetime_days=30.0, band_shift=0.0, band_width_scale=1.0,
                cs1_tilt=0.0, sources=sources,
                cache_dir=tempfile.mkdtemp(prefix='small_model_cache_'))


def _likelihood(cls, source_class, prior, K):
    lf = cls(_config(source_class))
    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=prior(1, 0.05))
    if K:
        lf.add_shape_parameter('band_shift', (-1.0, 0.0, 1.0),
                               log_prior=prior(0, 0.5))
    lf.prepare()
    return lf


@pytest.mark.parametrize("K", [0, 1])
def test_profile_study_matches(K):
    set_progress(False)
    jax_set_progress(False)
    jlf = _likelihood(JaxBinned, jxenon.GaussianBlobSource, JaxNormal, K)
    tlf = _likelihood(BinnedLogLikelihood, txenon.GaussianBlobSource,
                      NormalPrior, K)
    assert (tlf._builds['ps'][0] == 'constant') == (K == 0)
    jstudy = JaxStudy(jlf, max_iter=40, engine='analytic',
                      profile_mode='split')
    tstudy = BinnedToyStudy(tlf, device='cpu', max_iter=40,
                            engine='fused')
    expected = tstudy.expected_counts().numpy()
    np.testing.assert_allclose(expected, np.asarray(jstudy.expected_counts()),
                               rtol=1e-12)
    counts = np.random.default_rng(K).poisson(
        expected, size=(8,) + expected.shape).astype(float)
    jt, jfree, jcond = jstudy._run_profile(jnp.asarray(counts), TARGET, 1.0,
                                           None)
    tt, tfree, tcond = tstudy._run_profile(counts, TARGET, 1.0, None)
    for port, ref in ((tfree, jfree), (tcond, jcond)):
        assert port.names == ref.names
        np.testing.assert_allclose(port.max_ll, ref.max_ll, rtol=1e-8)
        np.testing.assert_allclose(port.x, ref.x, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-4)


def _mc_source(base):
    class GaussianMC(base):
        """Monte-Carlo source: seeded normal draws around config['mu']."""

        def simulate(self, n_events):
            rng = np.random.default_rng(int(self.config['seed']))
            d = np.zeros(n_events, dtype=[('x', float), ('source', int)])
            d['x'] = rng.normal(self.config['mu'], 1.0, n_events)
            return d
    return GaussianMC


def test_monte_carlo_templates_match():
    """Density-estimated templates (MonteCarloSource -> Hist.add, which is
    numpy.histogramdd here and the native filler in the JAX package) and
    their anchor tensors agree between the packages."""
    from blueice_tpu.models import MonteCarloSource as JaxMC
    from blueice_tpu_torch.models import MonteCarloSource
    set_progress(False)
    jax_set_progress(False)
    builds = []
    for cls, source in ((JaxBinned, _mc_source(JaxMC)),
                        (BinnedLogLikelihood, _mc_source(MonteCarloSource))):
        config = dict(analysis_space=[['x', np.linspace(-3, 3, 13)]],
                      default_source_class=source, livetime_days=1.0,
                      mu=0.0, n_events_for_pdf=2e4, pdf_sampling_batch_size=7e3,
                      cache_dir=tempfile.mkdtemp(prefix='mc_cache_'),
                      sources=[dict(name='s', events_per_day=10.0, seed=1),
                               dict(name='b', events_per_day=5.0, seed=2)])
        lf = cls(config)
        lf.add_rate_parameter('s')
        lf.add_shape_parameter('mu', (-0.5, 0.0, 0.5))
        lf.prepare()
        builds.append(lf._builds)
    for name in ('mus', 'ps'):
        np.testing.assert_array_equal(builds[1][name][2], builds[0][name][2])


@pytest.mark.parametrize("name", ['profile_ts_grid', 'profile_ts_scan',
                                  'observed_counts', 'profile_map'])
def test_binned_study_grid_surface_raises(name):
    """The reference's grid, scan and map methods exist on the port's
    binned study, as methods (the reference's statistics tell binned from
    unbinned by ``hasattr(study, 'observed_counts')``), and called without
    their arguments or data they raise as the reference's do: a missing
    argument, or (observed_counts) no data bound."""
    set_progress(False)
    tlf = _likelihood(BinnedLogLikelihood, txenon.GaussianBlobSource,
                      NormalPrior, 0)
    study = BinnedToyStudy(tlf, device='cpu')
    assert callable(getattr(JaxStudy, name))
    assert callable(getattr(BinnedToyStudy, name))
    if name == 'observed_counts':
        with pytest.raises(ValueError, match='set_data'):
            study.observed_counts()
    else:
        with pytest.raises(TypeError, match='missing'):
            getattr(study, name)()
