"""The port's limits (``parallel/limits.py``) against the JAX package's,
float64 on the CPU, on identical numpy inputs.

* The pure helpers on identical arrays, as cases of one test.
* ``observed_interval`` ('upper', 'lower', 'central', 'unified'; explicit
  and 'auto' grids) on one observed dataset of the Gaussian model
  (``conf_for_test``, 3 bins) and, unbinned, on the Gaussian unbinned
  model's bound dataset.
* ``toy_upper_limits``, ``sensitivity_band`` and the other toy intervals
  through a test-only subclass of each package's study whose ``simulate``
  draws the counts with numpy from a seed of the truth
  (``test_torch_profile_grid_map.numpy_toys``), so both fit the same toys;
  the upper limits also on the reduced XENON1T-style model (12x10 bins,
  6 sources, 81 anchors).
* The seed rule: a Generator-seeded auto grid fits the same toys in its
  free-fit pass and its grid pass.

Tolerances: limits and edges to 1e-3 of the grid step (the explicit grid's,
or for 'auto' the port's final grid's).
"""

from collections import OrderedDict

import numpy as np
import jax
import pytest
import torch

from blueice_tpu.examples.xenon_like import build_likelihood as jax_xenon
from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.parallel import UnbinnedToyStudy as JaxUnbinnedStudy
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.parallel import _stats as jstats
from blueice_tpu.parallel import cls as jcls
from blueice_tpu.parallel import coverage as jcoverage
from blueice_tpu.parallel import limits as jlimits
from blueice_tpu.test_helpers import conf_for_test as jax_conf
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.examples.xenon_like import build_likelihood
from blueice_tpu_torch.likelihood import (BinnedLogLikelihood,
                                          UnbinnedLogLikelihood)
from blueice_tpu_torch.parallel import (BinnedToyStudy, UnbinnedToyStudy,
                                        _stats as tstats, cls as tcls,
                                        coverage as tcoverage,
                                        limits as tlimits)
from blueice_tpu_torch.test_helpers import conf_for_test
from blueice_tpu_torch.utils import set_progress

from test_torch_profile_grid_map import (one_torch_thread,  # noqa: F401
                                         COUNTS, RATE, UNBINNED_SPACE,
                                         JaxNumpyToys, TorchNumpyToys,
                                         gauss_lf)


# -- the pure helpers ---------------------------------------------------------

def _curves(hyps, x_hat, sigma):
    """t (H, T) of parabolic profile curves around the best fits."""
    return ((hyps[:, None] - x_hat[None, :]) / sigma) ** 2


def _stub_run_grid(x_hat, sigma):
    def run_grid(hyps):
        hyps = np.sort(np.asarray(hyps, dtype=float))
        return _curves(hyps, x_hat, sigma), hyps, {'x': x_hat}
    return run_grid


_RNG = np.random.default_rng(11)
_HYPS = np.linspace(0.0, 4.0, 9)
_EXCESS = _RNG.normal(0, 1, (9, 7)) + np.linspace(-2, 2, 9)[:, None]
_EXCESS[:, 0] = -1.0                     # never crosses
_EXCESS[:, 1] = 1.0                      # crosses at the start
_XHAT = np.array([0.0, 0.3, 1.2, 2.5, 0.0, 0.7])
_SIGMA = np.array([0.5, 0.4, 0.8, 1.0, 2.0, 0.1])
_LIMITS = np.array([1.5, np.nan, 0.2, np.inf, 3.0, 2.2, np.nan, 0.9])

HELPERS = {
    'first_upcrossing': lambda m: m._first_upcrossing(_HYPS, _EXCESS),
    'quantile_inf_aware': lambda m: [
        m._quantile_inf_aware(np.sort(np.where(np.isfinite(_LIMITS), _LIMITS,
                                               np.inf)), q)
        for q in (0.0, 0.16, 0.5, 0.84, 0.975, 1.0)],
    'band_from_limits': lambda m: m._band_from_limits(_LIMITS,
                                                      (0.16, 0.5, 0.84)),
    'band_all_finite': lambda m: m._band_from_limits(
        np.abs(_EXCESS[:, 3]), (0.025, 0.16, 0.5, 0.84, 0.975)),
    'grid_from_fits': lambda m: m._grid_from_fits(np.abs(_EXCESS.ravel()),
                                                  (0.0, None), 17),
    'grid_from_pinned_fits': lambda m: m._grid_from_fits(np.zeros(20),
                                                         (0.0, 10.0)),
    'grid_from_fits_bounded': lambda m: m._grid_from_fits(
        np.linspace(-1, 1, 30), (-0.5, 0.8), 9),
    'unified_edges_to_bounds': lambda m: m._unified_edges_to_bounds(
        [np.nan, 0.5, np.nan], [2.0, np.nan, np.nan],
        np.linspace(0.0, 3.0, 7), (0.0, 3.0)),
    'unified_edges_short_grid': lambda m: m._unified_edges_to_bounds(
        [np.nan, 0.5], [2.0, np.nan], np.linspace(0.1, 2.5, 7), (0.0, 3.0)),
    'edge_upper': lambda m: m._edge_from_curves(
        _curves(_HYPS, _XHAT, _SIGMA), _HYPS, _XHAT, np.full(9, 2.7),
        'upper'),
    'edge_lower': lambda m: m._edge_from_curves(
        _curves(_HYPS, _XHAT, _SIGMA), _HYPS, _XHAT, np.full(9, 1.0),
        'lower'),
    'adaptive_upper_grows': lambda m: m._adaptive_edges_impl(
        _stub_run_grid(_XHAT, _SIGMA), (0.0, None), np.linspace(0, 1, 11),
        'x', None, [('upper', 0.9)])[:3],
    'adaptive_upper_shrinks': lambda m: m._adaptive_edges_impl(
        _stub_run_grid(_XHAT[:3] * 0.01, _SIGMA[:3] * 0.01), (0.0, None),
        np.linspace(0, 10, 11), 'x', None, [('upper', 0.9)])[:3],
    'adaptive_central': lambda m: m._adaptive_edges_impl(
        _stub_run_grid(_XHAT + 1, _SIGMA), (None, None),
        np.linspace(0.5, 2, 11), 'x', None,
        [('lower', 0.05), ('upper', 0.95)])[:3],
    'adaptive_fixed_grid': lambda m: m._adaptive_edges_impl(
        _stub_run_grid(_XHAT, _SIGMA), (0.0, None), np.linspace(0, 2, 11),
        'x', lambda h, q: 1.0 + 0.1 * h, [('upper', 0.9)], adapt=False)[:3],
}


@pytest.mark.parametrize('name', sorted(HELPERS) + [
    'clopper_pearson', 'one_sided_qmu', 'tail_fraction', 'cls_crossing',
    'simulation_truth'])
def test_pure_helpers_match(name):
    """The port's copies of the numpy helpers give the JAX package's
    results on identical arrays (NaN and infinities in place)."""
    if name == 'clopper_pearson':
        port, ref = ([m.clopper_pearson(k, 40, conf) for k in (0, 7, 40)
                      for conf in (0.68, 0.95)]
                     for m in (tcoverage, jcoverage))
    elif name == 'one_sided_qmu':
        port, ref = ([m._one_sided_qmu(_EXCESS[:, :6] ** 2, _XHAT, _HYPS),
                      m._one_sided_qmu(_EXCESS[:, 2] ** 2, 1.3, _HYPS)]
                     for m in (tcls, jcls))
    elif name == 'cls_crossing':
        cls = np.array([1.0, 0.6, 0.3, 0.12, 0.05, 0.02])
        port, ref = ([m._cls_crossing(np.arange(6.0), c, 0.1)
                      for c in (cls, cls + 1, cls * 0.01)]
                     for m in (tcls, jcls))
    elif name == 'tail_fraction':
        sample = np.sort(np.abs(_EXCESS.ravel()))
        port, ref = (m.tail_fraction(sample, np.array([[0.0, 0.5],
                                                       [sample[5], 99.0]]))
                     for m in (tstats, jstats))
    elif name == 'simulation_truth':
        port, ref = (m.simulation_truth({'a': 1.0}, {'a': 2.0, 'b': 3.0},
                                        c=4.0) for m in (tstats, jstats))
    else:
        port, ref = HELPERS[name](tlimits), HELPERS[name](jlimits)
    _assert_same(port, ref)


def _assert_same(port, ref):
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref)
        for k in ref:
            _assert_same(port[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_same(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(port, dtype=float),
                                      np.asarray(ref, dtype=float))


def test_band_from_limits_warns_beyond_grid():
    with pytest.warns(UserWarning, match='beyond the hypothesis grid'):
        out = tlimits._band_from_limits(np.array([1.0, np.nan, np.nan]),
                                        (0.5, 0.975))
    assert out['n_beyond_grid'] == 2 and out['band'][0.975] == np.inf
    assert isinstance(out['band'], OrderedDict)


# -- observed intervals on one dataset ---------------------------------------

@pytest.fixture(scope='module')
def gauss():
    set_progress(False)
    jax_set_progress(False)
    return (JaxStudy(gauss_lf(JaxBinned, jax_conf), engine='analytic',
                     two_stage=False, profile_mode='split'),
            BinnedToyStudy(gauss_lf(BinnedLogLikelihood, conf_for_test),
                           device='cpu', two_stage=False))


def _step(hyps):
    return float(hyps[-1] - hyps[0]) / (len(hyps) - 1)


def _assert_edges(port, ref, step):
    np.testing.assert_allclose(np.ravel(port), np.ravel(ref), rtol=0,
                               atol=1e-3 * step)


@pytest.mark.parametrize('kind', ['upper', 'lower', 'central', 'unified'])
@pytest.mark.parametrize('grid', ['explicit', 'auto'])
def test_observed_interval_matches(gauss, kind, grid):
    jstudy, tstudy = gauss
    hyps = np.linspace(0.2, 0.5, 31) if grid == 'explicit' else 'auto'
    jout, jts, jh, jfree = jlimits.observed_interval(
        jstudy, RATE, hyps, counts=COUNTS, kind=kind, return_grid=True)
    tout, tts, th, tfree = tlimits.observed_interval(
        tstudy, RATE, hyps, counts=COUNTS, kind=kind, return_grid=True)
    np.testing.assert_allclose(th, np.asarray(jh), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tts, np.asarray(jts), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tfree.max_ll, np.asarray(jfree.max_ll),
                               rtol=0, atol=1e-6)
    _assert_edges(tout, jout, _step(th))
    assert np.isfinite(tout).all()


def test_xenon_toy_upper_limits_match():
    """The reduced XENON1T-style model (6 sources, 81 anchors, 8 floating
    parameters): per-toy upper limits of 8 numpy-made toys on an explicit
    grid, one stage (the straggler refits would add two more JAX
    compiles). The observed upper limit at XENON width, whose JAX map
    compiles a two-start program, is held to float64 on the card
    (``chip_smoke.py``)."""
    set_progress(False)
    jax_set_progress(False)
    size = dict(n_cs1_bins=12, n_cs2_bins=10, livetime_days=30.0)
    target = 'wimp_rate_multiplier'
    tstudy = TorchNumpyToys(build_likelihood('binned', **size),
                            device='cpu', max_iter=40, engine='fused',
                            two_stage=False)
    jstudy = JaxNumpyToys(jax_xenon('binned', **size), max_iter=40,
                          engine='analytic', profile_mode='split',
                          two_stage=False)
    tstudy.expected = jstudy.expected = (
        lambda truth: tstudy.expected_counts(**truth).numpy())
    hyps = np.linspace(0.0, 1.2, 7)
    juls, jts, jh, jfree = jlimits.toy_upper_limits(
        jstudy, jax.random.PRNGKey(0), target, hyps, 8, return_grid=True)
    tuls, tts, th, tfree = tlimits.toy_upper_limits(
        tstudy, 0, target, hyps, 8, return_grid=True)
    np.testing.assert_allclose(tts, np.asarray(jts), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tfree.max_ll, np.asarray(jfree.max_ll),
                               rtol=0, atol=1e-6)
    _assert_edges(tuls, juls, _step(hyps))
    assert np.isfinite(tuls).all() and (tuls > 0).all()


@pytest.fixture(scope='module')
def unbinned():
    """The Gaussian unbinned model (two Monte-Carlo sources) of both
    packages, bound to the same 300 numpy-made events."""
    set_progress(False)
    jax_set_progress(False)
    lfs = [gauss_lf(cls, conf, UNBINNED_SPACE, n_sources=2)
           for cls, conf in ((JaxUnbinned, jax_conf),
                             (UnbinnedLogLikelihood, conf_for_test))]
    rng = np.random.default_rng(5)
    d = np.zeros(300, dtype=[('x', float), ('source', int)])
    d['x'] = np.concatenate([rng.normal(0.0, 1.0, 90),
                             rng.normal(3.0, 1.0, 210)])
    for lf in lfs:
        lf.set_data(d)
    return (JaxUnbinnedStudy(lfs[0], engine='analytic', two_stage=False),
            UnbinnedToyStudy(lfs[1], device='cpu', two_stage=False))


@pytest.mark.parametrize('kind', ['upper', 'central'])
def test_unbinned_observed_interval_matches(unbinned, kind):
    jstudy, tstudy = unbinned
    jout, jts, jh, _ = jlimits.observed_interval(jstudy, RATE, kind=kind,
                                                 return_grid=True)
    tout, tts, th, _ = tlimits.observed_interval(tstudy, RATE, kind=kind,
                                                 return_grid=True)
    np.testing.assert_allclose(th, np.asarray(jh), rtol=0,
                               atol=1e-3 * _step(th))
    np.testing.assert_allclose(tts, np.asarray(jts), rtol=0, atol=1e-4)
    _assert_edges(tout, jout, _step(th))
    with pytest.raises(ValueError, match='binned studies'):
        tlimits.observed_interval(tstudy, RATE, counts=COUNTS)


# -- toy limits --------------------------------------------------------------

@pytest.fixture(scope='module')
def toy_studies():
    set_progress(False)
    jax_set_progress(False)
    tstudy = TorchNumpyToys(gauss_lf(BinnedLogLikelihood, conf_for_test),
                            device='cpu', two_stage=False)
    jstudy = JaxNumpyToys(gauss_lf(JaxBinned, jax_conf), engine='analytic',
                          two_stage=False, profile_mode='split')
    tstudy.expected = jstudy.expected = (
        lambda truth: tstudy.expected_counts(**truth).numpy())
    return jstudy, tstudy


@pytest.mark.parametrize('grid', ['explicit', 'auto'])
def test_toy_upper_limits_match(toy_studies, grid):
    jstudy, tstudy = toy_studies
    hyps = np.linspace(0.0, 0.6, 13) if grid == 'explicit' else 'auto'
    juls, jts, jh, jfree = jlimits.toy_upper_limits(
        jstudy, jax.random.PRNGKey(0), RATE, hyps, 8, return_grid=True)
    tuls, tts, th, tfree = tlimits.toy_upper_limits(
        tstudy, 0, RATE, hyps, 8, return_grid=True)
    np.testing.assert_allclose(th, np.asarray(jh), rtol=0,
                               atol=1e-3 * _step(th))
    np.testing.assert_allclose(tts, np.asarray(jts), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tfree.max_ll, np.asarray(jfree.max_ll),
                               rtol=0, atol=1e-6)
    _assert_edges(tuls, juls, _step(th))
    assert np.isfinite(tuls).all()


@pytest.mark.parametrize('fn', ['sensitivity_band', 'toy_lower_limits',
                                'toy_central_intervals',
                                'toy_unified_intervals'])
def test_toy_intervals_match(toy_studies, fn):
    jstudy, tstudy = toy_studies
    hyps = np.linspace(0.0, 2.4, 25)
    truth = None if fn == 'sensitivity_band' else {RATE: 1.0}
    ref = getattr(jlimits, fn)(jstudy, jax.random.PRNGKey(0), RATE, hyps, 8,
                               truth=truth)
    port = getattr(tlimits, fn)(tstudy, 0, RATE, hyps, 8, truth=truth)
    if fn == 'sensitivity_band':
        assert port['n_beyond_grid'] == ref['n_beyond_grid']
        assert list(port['band']) == list(ref['band'])
        _assert_edges(list(port['band'].values()),
                      list(ref['band'].values()), _step(hyps))
        port, ref = port['limits'], ref['limits']
    _assert_edges(port, ref, _step(hyps))


class RecordingToys(BinnedToyStudy):
    """The port's study, recording the counts of every fit."""

    def fit_toys(self, counts, fixed=None, guess=None):
        self.fitted.append(('run', counts.clone()))
        return super().fit_toys(counts, fixed, guess)

    def _run_profile_grid(self, counts, *args, **kwargs):
        self.fitted.append(('grid', counts.clone()))
        return super()._run_profile_grid(counts, *args, **kwargs)


def test_generator_seeded_auto_grid_fits_one_ensemble(gauss):
    """A Generator gives the limit functions one int seed at entry: the
    auto grid's free-fit pass and every grid pass fit the same toys, and
    a fresh Generator in the same state gives the same limits."""
    study = RecordingToys(gauss[1].lf, device='cpu', two_stage=False)
    study.fitted = []
    uls = tlimits.toy_upper_limits(study, torch.Generator().manual_seed(3),
                                   RATE, 'auto', 16)
    kinds = [k for k, _ in study.fitted]
    assert kinds[0] == 'run' and kinds.count('grid') >= 1
    for _, counts in study.fitted[1:]:
        assert torch.equal(counts, study.fitted[0][1])
    again = tlimits.toy_upper_limits(study, torch.Generator().manual_seed(3),
                                     RATE, 'auto', 16)
    np.testing.assert_array_equal(again, uls)
