"""The studies' grid, scan and map surface of the port against the JAX
package's, float64 on the CPU, on identical numpy inputs.

* Binned: ``profile_map`` (1-D and 2-D) and ``_run_profile_grid`` on a
  Gaussian Monte-Carlo model (``conf_for_test``, 3 bins, a rate and a shape
  parameter; the template draws from a reset numpy state, so both packages
  hold the same templates), and ``profile_ts_scan`` through a test-only
  subclass of each package's study whose ``simulate`` draws the counts with
  numpy from a seed of the truth.
* Unbinned: ``profile_map`` on the Gaussian unbinned model's bound dataset,
  and ``profile_ts_grid`` row h against ``_run_profile`` at h on the same
  event set.
* The seed rule: int seeds, Generators and child seeds.

Tolerances: max_ll to 1e-6 absolute, t to 1e-4 absolute. The JAX side runs
one stage (``two_stage=False``) and the 'split' profile mode, so that it
compiles few programs.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.parallel import UnbinnedToyStudy as JaxUnbinnedStudy
from blueice_tpu.test_helpers import conf_for_test as jax_conf
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.likelihood import (BinnedLogLikelihood,
                                          UnbinnedLogLikelihood)
from blueice_tpu_torch.parallel import (BinnedToyStudy, UnbinnedToyStudy,
                                        child_seed, seed_of)
from blueice_tpu_torch.test_helpers import conf_for_test
from blueice_tpu_torch.utils import set_progress

RATE = 's0_rate_multiplier'
COUNTS = np.array([30.0, 250.0, 40.0])


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's CPU fits here are many small ops: one intra-op thread a
    test worker runs them faster than eight, and several workers' thread
    pools do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def clear_template_caches(directory):
    """Empty both packages' process-wide template caches
    (``Source._data_cache``, keyed by the config hash, which leaves out
    ``cache_dir``) and point the JAX helpers' cache and task directories
    (one pair a process, ``blueice_tpu.test_helpers._SCRATCH``) at
    ``directory``; the port's helpers make fresh ones at every call."""
    from blueice_tpu import test_helpers as jhelpers
    from blueice_tpu.models.source import Source as JaxSource
    from blueice_tpu_torch.models.source import Source as TorchSource
    JaxSource._data_cache.clear()
    TorchSource._data_cache.clear()
    jhelpers._SCRATCH.update(cache_dir=str(directory / 'cache'),
                             task_dir=str(directory / 'tasks'))


@pytest.fixture(scope='module', autouse=True)
def fresh_template_caches(tmp_path_factory):
    """Every module that builds Monte-Carlo templates or counts device
    calls starts from empty template caches: a template of the same config
    hash that another module built in this worker, under another numpy
    state, would otherwise stand in for the one built here (on one side or
    both), and a device build would find its templates in memory."""
    from blueice_tpu import test_helpers as jhelpers
    saved = dict(jhelpers._SCRATCH)
    clear_template_caches(tmp_path_factory.mktemp('templates'))
    yield
    jhelpers._SCRATCH.update(saved)


def gauss_lf(cls, conf, space=(-10, -1, 1, 10), n_sources=1, seed=0):
    """The Gaussian model with a rate (s0) and a shape (mu) parameter, its
    Monte-Carlo templates drawn from a reset numpy state."""
    np.random.seed(seed)
    c = conf(n_sources=n_sources, mc=True, analysis_space=[['x', list(space)]],
             n_events_for_pdf=int(2e5))
    if n_sources > 1:
        c['sources'][1]['mu'] = 3.0
    lf = cls(c)
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    lf.prepare()
    return lf


def numpy_toys(expected, truth, n_toys):
    """Counts of ``n_toys`` toys drawn with numpy from a seed of the truth
    (and the toy count): a second draw at the same truth regenerates the
    same toys, as a JAX key or an int seed does."""
    seed = zlib.crc32(repr(sorted((k, float(v)) for k, v in
                                  (truth or {}).items())).encode())
    mu = expected(truth or {})
    return np.random.default_rng([seed, int(n_toys)]).poisson(
        mu, (int(n_toys),) + mu.shape).astype(float)


class JaxNumpyToys(JaxStudy):
    """The JAX study, its toys drawn by :func:`numpy_toys` from the port
    study's expected counts (``self.expected``)."""

    def simulate(self, key, n_toys, truth=None, mesh=None):
        return jnp.asarray(numpy_toys(self.expected, truth, n_toys))


class TorchNumpyToys(BinnedToyStudy):
    """The port's study, its toys drawn by :func:`numpy_toys`."""

    def simulate(self, seed_or_generator, n_toys, truth=None, mesh=None):
        return self._counts(numpy_toys(self.expected, truth, n_toys))


@pytest.fixture(scope='module')
def binned():
    set_progress(False)
    jax_set_progress(False)
    tstudy = TorchNumpyToys(gauss_lf(BinnedLogLikelihood, conf_for_test),
                            device='cpu', two_stage=False)
    jstudy = JaxNumpyToys(gauss_lf(JaxBinned, jax_conf), engine='analytic',
                          two_stage=False, profile_mode='split')
    tstudy.expected = jstudy.expected = (
        lambda truth: tstudy.expected_counts(**truth).numpy())
    return jstudy, tstudy


def assert_same_fits(port, ref):
    assert port.names == ref.names
    np.testing.assert_allclose(port.max_ll, np.asarray(ref.max_ll), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port.x, np.asarray(ref.x), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize('space', [
    [(RATE, np.linspace(0.7, 1.3, 5))],
    [('mu', np.linspace(-0.8, 0.8, 5))],
    [(RATE, np.linspace(0.8, 1.2, 3)), ('mu', np.linspace(-0.5, 0.5, 4))],
], ids=['rate', 'shape', '2d'])
def test_binned_profile_map_matches(binned, space):
    """One observed dataset: t, the free fit and every conditional lane
    agree (2-D: every parameter on the grid, nothing profiled)."""
    jstudy, tstudy = binned
    jt, jfree, jcond = jstudy.profile_map(space, counts=COUNTS)
    tt, tfree, tcond = tstudy.profile_map(space, counts=COUNTS)
    assert tt.shape == tuple(len(g) for _, g in space)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=1e-4)
    assert_same_fits(tfree, jfree)
    assert_same_fits(tcond, jcond)
    # the memo of observed_interval's retries: the same map from the free
    # fit of an earlier call
    again = tstudy.profile_map(space, counts=COUNTS, _free=tfree)
    np.testing.assert_array_equal(again[0], tt)


def test_binned_profile_grid_matches(binned):
    """One free fit and a conditional fit per hypothesis of the same toys:
    ts (H, n_toys), the free fits and every hypothesis's conditional
    fits."""
    jstudy, tstudy = binned
    toys = numpy_toys(tstudy.expected, {RATE: 1.0}, 6)
    hyps = np.array([2.0, 0.5, 1.0, 1.5])
    jts, jh, jfree, jconds = jstudy._run_profile_grid(jnp.asarray(toys),
                                                      RATE, np.sort(hyps),
                                                      None)
    tts, th, tfree, tconds = tstudy.profile_ts_grid(0, RATE, hyps, 6,
                                                    truth={RATE: 1.0})
    np.testing.assert_array_equal(th, np.sort(hyps))
    np.testing.assert_allclose(tts, np.asarray(jts), rtol=0, atol=1e-4)
    assert_same_fits(tfree, jfree)
    for port, ref in zip(tconds, jconds):
        assert_same_fits(port, ref)
    # return_cond=False: the same t, no conditional parameters
    ts2, _, _, conds = tstudy.profile_ts_grid(0, RATE, hyps, 6,
                                              truth={RATE: 1.0},
                                              return_cond=False)
    np.testing.assert_array_equal(ts2, tts)
    assert conds == [None] * len(hyps)


def test_binned_profile_scan_matches(binned):
    """A fresh ensemble per hypothesis, simulated at it: t and the free
    fits of every hypothesis."""
    jstudy, tstudy = binned
    hyps = [0.5, 1.0, 2.0]
    jts, jfrees = jstudy.profile_ts_scan(jax.random.PRNGKey(0), RATE, hyps,
                                         5, return_free=True)
    tts, tfrees = tstudy.profile_ts_scan(0, RATE, hyps, 5, return_free=True)
    np.testing.assert_allclose(tts, np.asarray(jts), rtol=0, atol=1e-4)
    for port, ref in zip(tfrees, jfrees):
        assert_same_fits(port, ref)


def test_binned_surface_checks_its_arguments(binned):
    _, tstudy = binned
    with pytest.raises(ValueError, match='twice'):
        tstudy.profile_map([(RATE, [1.0]), (RATE, [2.0])], counts=COUNTS)
    with pytest.raises(ValueError, match='fixed='):
        tstudy.profile_map([(RATE, [1.0])], counts=COUNTS,
                           fixed={RATE: 1.0})
    with pytest.raises(ValueError, match='empty grid'):
        tstudy.profile_map([(RATE, [])], counts=COUNTS)
    with pytest.raises(ValueError, match='does not match'):
        tstudy.observed_counts(np.ones(4))
    with pytest.raises(ValueError, match='set_data'):
        tstudy.observed_counts()
    with pytest.raises(ValueError, match='fixed='):
        tstudy.profile_ts_grid(0, RATE, [1.0], 2, fixed={RATE: 1.0})


# -- unbinned ---------------------------------------------------------------

UNBINNED_SPACE = np.linspace(-10, 10, 21)


def unbinned_pair():
    """Both packages' Gaussian unbinned model (two Monte-Carlo sources, a
    rate and a shape parameter) bound to the same 300 numpy-made events."""
    set_progress(False)
    jax_set_progress(False)
    lfs = [gauss_lf(cls, conf, UNBINNED_SPACE, n_sources=2)
           for cls, conf in ((JaxUnbinned, jax_conf),
                             (UnbinnedLogLikelihood, conf_for_test))]
    rng = np.random.default_rng(3)
    d = np.zeros(300, dtype=[('x', float), ('source', int)])
    d['x'] = np.concatenate([rng.normal(0.2, 1.0, 120),
                             rng.normal(3.0, 1.0, 180)])
    for lf in lfs:
        lf.set_data(d)
    return (JaxUnbinnedStudy(lfs[0], engine='analytic', two_stage=False),
            UnbinnedToyStudy(lfs[1], device='cpu', two_stage=False))


@pytest.fixture(scope='module')
def unbinned():
    return unbinned_pair()


@pytest.mark.parametrize('space', [
    [(RATE, np.linspace(0.2, 1.2, 6))],
    [(RATE, np.linspace(0.3, 0.9, 3)), ('mu', np.linspace(-0.6, 0.6, 3))],
], ids=['rate', '2d'])
def test_unbinned_profile_map_matches(unbinned, space):
    """The bound dataset's map: t, the free fit and every lane (the lanes
    all read toy 0 of the observed (1, G, S, E) tensor)."""
    jstudy, tstudy = unbinned
    jt, jfree, jcond = jstudy.profile_map(space)
    tt, tfree, tcond = tstudy.profile_map(space)
    assert tt.shape == tuple(len(g) for _, g in space)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=1e-4)
    assert_same_fits(tfree, jfree)
    assert_same_fits(tcond, jcond)


def test_unbinned_profile_grid_rows_are_profiles(unbinned):
    """profile_ts_grid scores the event set once: its row h equals
    _run_profile at h on the same events (free fits shared)."""
    _, tstudy = unbinned
    hyps = np.array([0.5, 1.0, 1.5])
    events = tstudy.simulate(4, 5)
    ts, _, free, conds = tstudy._run_profile_grid(events, RATE, hyps, None)
    for h, row, cond in zip(hyps, ts, conds):
        t, free_h, cond_h = tstudy._run_profile(events, RATE, h, None)
        np.testing.assert_allclose(free.max_ll, free_h.max_ll, rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(cond.max_ll, cond_h.max_ll, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(row, t, rtol=0, atol=1e-4)
    # the seeded entry point draws the same events
    ts2 = tstudy.profile_ts_grid(4, RATE, hyps, 5)[0]
    np.testing.assert_array_equal(ts2, ts)


def test_unbinned_map_after_a_stale_template(tmp_path):
    """The map's flaky failure under ``pytest -n 6 --dist loadfile``: an
    earlier test in the worker built a template of the same config hash
    under another numpy state, and the process-wide cache served it to
    one package.
    Fill both caches so, clear them as the module fixture does, and the
    pair built afterwards holds the same templates and maps alike."""
    stale = [gauss_lf(cls, conf, UNBINNED_SPACE, n_sources=2, seed=1)
             for cls, conf in ((JaxUnbinned, jax_conf),
                               (UnbinnedLogLikelihood, conf_for_test))]
    assert all(len(lf.anchor_models) == 3 for lf in stale)
    clear_template_caches(tmp_path)
    jstudy, tstudy = unbinned_pair()
    np.testing.assert_allclose(
        tstudy.lf._builds['ps'][2], jstudy.lf._builds['ps'][2], rtol=1e-12)
    space = [(RATE, np.linspace(0.2, 1.2, 6))]
    jt, jfree, _ = jstudy.profile_map(space)
    tt, tfree, _ = tstudy.profile_map(space)
    np.testing.assert_allclose(tt, np.asarray(jt), rtol=0, atol=1e-4)
    assert_same_fits(tfree, jfree)


def test_unbinned_study_has_no_observed_counts(unbinned):
    """The statistics tell the two studies apart by this attribute."""
    _, tstudy = unbinned
    assert not hasattr(tstudy, 'observed_counts')
    assert hasattr(BinnedToyStudy, 'observed_counts')


# -- seeds ------------------------------------------------------------------

def test_child_seeds_are_deterministic_and_distinct():
    seeds = [child_seed(7, i) for i in range(50)]
    assert seeds == [child_seed(7, i) for i in range(50)]
    assert len(set(seeds)) == 50 and child_seed(8, 0) != seeds[0]
    assert all(0 <= s < 2 ** 64 for s in seeds)
    assert child_seed(-1, 3) == child_seed(2 ** 64 - 1, 3)
    torch.Generator().manual_seed(max(seeds))       # a valid torch seed


def test_seed_of_draws_once_from_a_generator():
    assert seed_of(12) == 12
    gen = torch.Generator().manual_seed(5)
    a, b = seed_of(gen), seed_of(gen)
    assert a != b
    assert seed_of(torch.Generator().manual_seed(5)) == a
