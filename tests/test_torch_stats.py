"""The port's statistics on one dataset and on toy ensembles against the
JAX package's, float64 on the CPU, on identical numpy inputs: discovery,
asymptotics (Asimov), goodness of fit, nuisance ranking, CLs, the Neyman
construction and coverage.

The one-dataset functions run on the Gaussian model (``conf_for_test``, 3
bins) and, for the ranking, on a two-source blob model whose ER rate
carries a Gaussian prior. The toy-based ones run through a test-only
subclass of each package's study whose ``simulate`` draws the counts with
numpy from a seed of the truth (``test_torch_profile_grid_map``), so both
packages fit the same toys. Tolerances: max_ll to 1e-6 absolute, t to 1e-4
absolute, limits to 1e-3 of the grid step.
"""

import numpy as np
import jax
import pytest
import torch

from blueice_tpu.examples import xenon_like as jxenon
from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.parallel import asymptotics as jasym
from blueice_tpu.parallel import cls as jcls
from blueice_tpu.parallel import coverage as jcoverage
from blueice_tpu.parallel import discovery as jdisc
from blueice_tpu.parallel import gof as jgof
from blueice_tpu.parallel import neyman as jneyman
from blueice_tpu.parallel import ranking as jranking
from blueice_tpu.priors import NormalPrior as JaxNormal
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch import parallel
from blueice_tpu_torch.examples import xenon_like as txenon
from blueice_tpu_torch.likelihood import BinnedLogLikelihood
from blueice_tpu_torch.parallel import BinnedToyStudy
from blueice_tpu_torch.parallel import asymptotics as tasym
from blueice_tpu_torch.parallel import cls as tcls
from blueice_tpu_torch.parallel import coverage as tcoverage
from blueice_tpu_torch.parallel import discovery as tdisc
from blueice_tpu_torch.parallel import gof as tgof
from blueice_tpu_torch.parallel import neyman as tneyman
from blueice_tpu_torch.parallel import ranking as tranking
from blueice_tpu_torch.priors import NormalPrior
from blueice_tpu_torch.test_helpers import conf_for_test
from blueice_tpu_torch.utils import set_progress

from test_torch_profile_grid_map import (one_torch_thread,  # noqa: F401
                                         COUNTS, RATE, JaxNumpyToys,
                                         TorchNumpyToys, gauss_lf)
from test_torch_small_models import _likelihood as blob_lf

N_TOYS = 8
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope='module')
def studies():
    set_progress(False)
    jax_set_progress(False)
    from blueice_tpu.test_helpers import conf_for_test as jax_conf
    tstudy = TorchNumpyToys(gauss_lf(BinnedLogLikelihood, conf_for_test),
                            device='cpu', two_stage=False)
    jstudy = JaxNumpyToys(gauss_lf(JaxBinned, jax_conf), engine='analytic',
                          two_stage=False, profile_mode='split')
    tstudy.expected = jstudy.expected = (
        lambda truth: tstudy.expected_counts(**truth).numpy())
    return jstudy, tstudy


def assert_close(port, ref, atol):
    np.testing.assert_allclose(np.asarray(port, dtype=float),
                               np.asarray(ref, dtype=float), rtol=0,
                               atol=atol)


def assert_same_dict(port, ref, atol=1e-4, skip=()):
    assert set(port) == set(ref)
    for k in ref:
        if k in skip:
            continue
        if isinstance(ref[k], dict):
            assert_same_dict(port[k], ref[k], atol)
        elif not hasattr(ref[k], 'max_ll'):
            assert_close(port[k], ref[k], atol)


def test_observed_discovery_matches(studies):
    """Observed q0 with the asymptotic and the toy-calibrated p-values."""
    jstudy, tstudy = studies
    counts = COUNTS * np.array([1.0, 1.0, 5.0])     # an excess
    ref = jdisc.observed_discovery(jstudy, RATE, counts=counts, null=0.3,
                                   key=KEY, n_calibration=N_TOYS)
    port = tdisc.observed_discovery(tstudy, RATE, counts=counts, null=0.3,
                                    seed_or_generator=0,
                                    n_calibration=N_TOYS)
    assert port['q0'] > 1.0
    assert_same_dict(port, ref)


def test_discovery_ts_matches(studies):
    jstudy, tstudy = studies
    jq, jfree, _ = jdisc.discovery_ts(jstudy, KEY, N_TOYS, RATE,
                                      truth={RATE: 1.5}, null=1.0)
    tq, tfree, _ = tdisc.discovery_ts(tstudy, 0, N_TOYS, RATE,
                                      truth={RATE: 1.5}, null=1.0)
    assert_close(tq, jq, 1e-4)
    assert_close(tfree.max_ll, jfree.max_ll, 1e-6)
    assert (tq > 0).any()


@pytest.mark.parametrize('fn', ['asimov_discovery', 'discovery_reach',
                                'asimov_sigma', 'asimov_expected_limits',
                                'asimov_median_limit'])
def test_asimov_constructions_match(studies, fn):
    """The Asimov datasets (expected counts) of both packages: the median
    discovery significance and reach, and the asymptotic expected-limit
    band (plain and CLs)."""
    jstudy, tstudy = studies
    calls = {
        'asimov_discovery': lambda m, s: m.asimov_discovery(
            s, RATE, {RATE: 1.3}, null=1.0),
        'discovery_reach': lambda m, s: m.discovery_reach(
            s, RATE, np.linspace(1.0, 1.6, 7), null=1.0),
        'asimov_sigma': lambda m, s: m.asimov_sigma(s, RATE, 0.4),
        'asimov_expected_limits': lambda m, s: m.asimov_expected_limits(
            s, RATE, cls=True),
        'asimov_median_limit': lambda m, s: m.asimov_median_limit(s, RATE),
    }
    mods = ((tdisc, jdisc) if 'discovery' in fn or 'reach' in fn
            else (tasym, jasym))
    port, ref = (calls[fn](m, s) for m, s in zip(mods, (tstudy, jstudy)))
    if isinstance(ref, dict):
        if 'reach' in ref:
            assert port['reach'].keys() == ref['reach'].keys()
            assert_close(list(port['reach'].values()),
                         list(ref['reach'].values()), 1e-5)
        assert_same_dict(port, ref, skip=('reach',))
    else:
        assert_close(port, ref, 1e-6)


def test_gof_matches(studies):
    """The saturated-ratio statistic on one dataset and its parametric
    bootstrap (toys at the observed best fit)."""
    jstudy, tstudy = studies
    jt, jfit = jgof.gof_ts(jstudy, counts=COUNTS)
    tt, tfit = tgof.gof_ts(tstudy, counts=COUNTS)
    assert_close(tt, jt, 1e-4)
    assert_close(tfit.max_ll, jfit.max_ll, 1e-6)
    ref = jgof.gof_pvalue(jstudy, KEY, N_TOYS, counts=COUNTS)
    port = tgof.gof_pvalue(tstudy, 0, N_TOYS, counts=COUNTS)
    assert port['truth'].keys() == ref['truth'].keys()
    assert_same_dict(port, ref, skip=('truth', 'fit'))
    assert_close(tgof.saturated_logl(tstudy, torch.as_tensor(COUNTS)),
                 jgof.saturated_logl(jstudy, COUNTS), 1e-9)


def test_nuisance_ranking_matches():
    """Pulls, constraints and impacts on a blob model whose ER rate has a
    Gaussian prior, on one dataset's counts."""
    set_progress(False)
    jax_set_progress(False)
    jlf = blob_lf(JaxBinned, jxenon.GaussianBlobSource, JaxNormal, 0)
    tlf = blob_lf(BinnedLogLikelihood, txenon.GaussianBlobSource,
                  NormalPrior, 0)
    jstudy = JaxStudy(jlf, max_iter=40, engine='analytic', two_stage=False,
                      profile_mode='split')
    tstudy = BinnedToyStudy(tlf, device='cpu', max_iter=40, two_stage=False)
    expected = tstudy.expected_counts().numpy()
    counts = np.random.default_rng(2).poisson(expected).astype(float)
    target = 'wimp_rate_multiplier'
    ref = jranking.nuisance_ranking(jstudy, target, counts=counts)
    port = tranking.nuisance_ranking(tstudy, target, counts=counts)
    assert_close(port['target_hat'], ref['target_hat'], 1e-4)
    assert_close(port['target_interval'], ref['target_interval'], 1e-4)
    assert [r['name'] for r in port['nuisances']] == \
        [r['name'] for r in ref['nuisances']] == ['er_rate_multiplier']
    for p, r in zip(port['nuisances'], ref['nuisances']):
        assert list(p) == list(r)
        assert_close([np.nan if v is None else v for v in p.values()][1:],
                     [np.nan if v is None else v for v in r.values()][1:],
                     1e-4)


def test_cls_matches(studies):
    """The observed CLs curve with its two calibrations, the CLs upper
    limit and the expected CLs band."""
    jstudy, tstudy = studies
    hyps = np.linspace(0.1, 0.7, 7)
    ref = jcls.cls_curve(jstudy, KEY, RATE, hyps, N_TOYS, counts=COUNTS)
    port = tcls.cls_curve(tstudy, 0, RATE, hyps, N_TOYS, counts=COUNTS)
    assert_same_dict(port, ref)
    kwargs = dict(counts=COUNTS, cl=0.9)
    assert_close(tcls.cls_upper_limit(tstudy, 0, RATE, hyps, N_TOYS,
                                      **kwargs),
                 jcls.cls_upper_limit(jstudy, KEY, RATE, hyps, N_TOYS,
                                      **kwargs), 1e-4)
    ref = jcls.cls_expected_band(jstudy, KEY, RATE, hyps, N_TOYS)
    port = tcls.cls_expected_band(tstudy, 0, RATE, hyps, N_TOYS)
    assert_close(port['limits'], ref['limits'], 1e-4)
    assert_close(list(port['band'].values()), list(ref['band'].values()),
                 1e-4)


@pytest.mark.parametrize('statistic', ['two-sided', 'upper'])
def test_neyman_construction_matches(studies, statistic):
    jstudy, tstudy = studies
    hyps = [1.5, 0.5, 1.0]
    ref = jneyman.NeymanConstruction(jstudy, RATE, statistic=statistic)
    port = tneyman.NeymanConstruction(tstudy, RATE, statistic=statistic)
    ref.scan(KEY, hyps, N_TOYS)
    port.scan(0, hyps, N_TOYS)
    assert_close(port.hypotheses, ref.hypotheses, 0)
    assert_close(port.t_sorted, ref.t_sorted, 1e-4)
    for h, q in ((0.7, 0.9), (1.2, 0.1), (3.0, 0.5)):
        assert_close(port.t_ppf(h, q), ref.t_ppf(h, q), 1e-4)
    assert_close(port.coverage_check(0.9), ref.coverage_check(0.9), 0)


@pytest.mark.parametrize('kind', ['upper', 'central'])
def test_coverage_check_matches(studies, kind):
    jstudy, tstudy = studies
    kwargs = dict(kind=kind, hypotheses=np.linspace(0.0, 2.5, 26))
    ref = jcoverage.coverage_check(jstudy, KEY, RATE, [0.5, 1.0], N_TOYS,
                                   **kwargs)
    port = tcoverage.coverage_check(tstudy, 0, RATE, [0.5, 1.0], N_TOYS,
                                    **kwargs)
    for k in ('true_values', 'coverage', 'ci', 'n_covered', 'n_undecided'):
        assert_close(port[k], ref[k], 0)
    assert (port['n_toys'], port['kind'], port['nominal']) == \
        (ref['n_toys'], ref['kind'], ref['nominal'])
    for pe, re in zip(port['edges'], ref['edges']):
        assert_close(pe, re, 1e-3 * 0.1)


def _on_card(study):
    """A copy of a CPU study that says it lives on the CUDA device."""
    card = BinnedToyStudy.__new__(BinnedToyStudy)
    card.__dict__.update(study.__dict__)
    card.device = torch.device('cuda')
    return card


@pytest.mark.parametrize('name', [
    'sensitivity_band', 'toy_upper_limits', 'observed_interval', 'cls_curve',
    'discovery_ts', 'observed_discovery', 'asimov_sigma', 'gof_ts',
    'gof_pvalue', 'nuisance_ranking', 'coverage_check', 'NeymanConstruction'])
def test_entry_points_take_the_studys_device(studies, name):
    """No statistics function builds a study or moves one: a study whose
    device is the CUDA device sends every call there, which raises without
    CUDA (no quiet fallback to the CPU); a CPU study runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    cpu = BinnedToyStudy(studies[1].lf, device='cpu', two_stage=False)
    calls = {
        'sensitivity_band': lambda s: parallel.sensitivity_band(
            s, 0, RATE, np.linspace(0, 1, 5), 4),
        'toy_upper_limits': lambda s: parallel.toy_upper_limits(
            s, 0, RATE, 'auto', 4),
        'observed_interval': lambda s: parallel.observed_interval(
            s, RATE, counts=COUNTS),
        'cls_curve': lambda s: parallel.cls_curve(
            s, 0, RATE, [0.2, 0.4], 4, counts=COUNTS),
        'discovery_ts': lambda s: parallel.discovery_ts(s, 0, 4, RATE),
        'observed_discovery': lambda s: parallel.observed_discovery(
            s, RATE, counts=COUNTS),
        'asimov_sigma': lambda s: parallel.asimov_sigma(s, RATE, 0.5),
        'gof_ts': lambda s: parallel.gof_ts(s, counts=COUNTS),
        'gof_pvalue': lambda s: parallel.gof_pvalue(s, 0, 4, counts=COUNTS),
        'nuisance_ranking': lambda s: parallel.nuisance_ranking(
            s, RATE, counts=COUNTS),
        'coverage_check': lambda s: parallel.coverage_check(
            s, 0, RATE, [1.0], 4, hypotheses=np.linspace(0, 2, 5)),
        'NeymanConstruction': lambda s: parallel.NeymanConstruction(
            s, RATE).scan(0, [0.5, 1.0], 4),
    }
    with pytest.raises((RuntimeError, AssertionError), match='CUDA|cuda'):
        calls[name](_on_card(cpu))
    calls[name](cpu)
