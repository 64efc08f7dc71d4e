"""The port's plots (``blueice_tpu_torch.plots`` and the inference
module's ``plot_likelihood_ratio``) on the Agg backend: the seven cases of
``tests/test_plots.py``, and each statistics plot drawn by both packages
from the same result, their lines and bars equal."""

from collections import OrderedDict

import matplotlib
matplotlib.use('Agg')
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from blueice_tpu import plots as jplots  # noqa: E402
from blueice_tpu_torch import plots  # noqa: E402
from blueice_tpu_torch.inference import plot_likelihood_ratio  # noqa: E402
from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood  # noqa: E402
from blueice_tpu_torch.test_helpers import conf_for_test  # noqa: E402


def _fitted_lf():
    lf = UnbinnedLogLikelihood(conf_for_test())
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('some_multiplier', (0.5, 1, 2))
    lf.prepare()
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(0)))
    return lf


def test_plot_likelihood_ratio_1d():
    plot_likelihood_ratio(_fitted_lf(),
                          ('s0_rate_multiplier', np.linspace(0.5, 2, 3)))
    plt.close('all')


def test_plot_likelihood_ratio_2d():
    plot_likelihood_ratio(_fitted_lf(),
                          ('s0_rate_multiplier', np.linspace(0.5, 2, 3)),
                          ('some_multiplier', np.linspace(0.5, 2, 3)))
    plt.close('all')


def _fake_ranking():
    row = OrderedDict(
        name='er_slope', theta_hat=0.1, sigma_lo=0.9, sigma_hi=1.1,
        pull=0.1, constraint=1.0, prior_mu=0.0, prior_sigma=1.0,
        impact_lo=0.3, impact_hi=-0.25,
        prefit_impact_lo=0.35, prefit_impact_hi=-0.3)
    row2 = OrderedDict(
        name='free_bg_rate', theta_hat=1.05, sigma_lo=0.2, sigma_hi=0.2,
        pull=None, constraint=None, prior_mu=None, prior_sigma=None,
        impact_lo=0.1, impact_hi=-0.1,
        prefit_impact_lo=None, prefit_impact_hi=None)
    return {'target': 'wimp_rate_multiplier', 'target_hat': 1.0,
            'target_interval': (0.5, 1.5), 'nuisances': [row, row2]}


def _coverage():
    return {'true_values': np.array([0.0, 1.0, 2.0]),
            'coverage': np.array([0.95, 0.91, 0.89]),
            'ci': np.array([[0.93, 0.97], [0.89, 0.93], [0.87, 0.91]]),
            'n_covered': np.array([950, 910, 890]), 'n_toys': 1000,
            'nominal': 0.9, 'kind': 'upper', 'edges': []}


def _band():
    rng = np.random.default_rng(0)
    lims = rng.gamma(3.0, 0.3, size=400)
    lims[:3] = np.inf
    band = OrderedDict((q, float(np.quantile(lims[np.isfinite(lims)], q)))
                       for q in (0.025, 0.16, 0.5, 0.84, 0.975))
    return {'limits': lims, 'band': band, 'n_beyond_grid': 3}


def _cls_curve():
    h = np.linspace(0.1, 3.0, 8)
    return {'hypotheses': h, 'cls': np.exp(-h), 'clsb': 0.8 * np.exp(-h),
            'clb': np.full(8, 0.8), 'q_obs': h, 'x_hat': 0.0}


def test_plot_ranking():
    ax = plots.plot_ranking(_fake_ranking())
    assert len(ax.get_yticklabels()) == 2
    plt.close('all')
    with pytest.raises(ValueError, match="no nuisance rows"):
        plots.plot_ranking({'target': 'x', 'nuisances': []})


def test_plot_coverage():
    plots.plot_coverage(_coverage())
    plt.close('all')


def test_plot_limit_band():
    plots.plot_limit_band(_band(), observed=1.1)
    plt.close('all')
    with pytest.raises(ValueError, match="beyond the grid"):
        plots.plot_limit_band({'limits': np.array([np.inf]),
                               'band': OrderedDict([(0.5, np.inf)])})


def test_plot_cls():
    plots.plot_cls(_cls_curve(), cl=0.9, limit=2.3)
    plt.close('all')


def test_plot_profile_map():
    g1 = np.linspace(0, 2, 21)
    plots.plot_profile_map((g1 - 1.0) ** 2 * 8, [('mu', g1)])
    plt.close('all')
    g2 = np.linspace(-1, 1, 11)
    t2 = (g1[:, None] - 1.0) ** 2 * 8 + (g2[None, :]) ** 2 * 5
    ax = plots.plot_profile_map(t2, [('mu', g1), ('slope', g2)])
    assert ax.get_xlabel() == 'slope' and ax.get_ylabel() == 'mu'
    plt.close('all')
    with pytest.raises(ValueError, match="1 or 2"):
        plots.plot_profile_map(t2, [('a', g1), ('b', g2), ('c', g2)])


def _drawn(ax):
    """What an axis (and its twins) shows: labels, line data, patches."""
    axes = [ax] + ([ax._impact_ax] if hasattr(ax, '_impact_ax') else [])
    return [(a.get_xlabel(), a.get_ylabel(), a.get_xlim(), a.get_ylim(),
             [np.asarray(line.get_xydata()).tolist() for line in a.lines],
             [np.asarray(p.get_path().vertices).tolist() for p in a.patches])
            for a in axes]


@pytest.mark.parametrize('name,args,kwargs', [
    ('plot_ranking', (_fake_ranking(),), {}),
    ('plot_coverage', (_coverage(),), {}),
    ('plot_limit_band', (_band(),), dict(observed=1.1)),
    ('plot_cls', (_cls_curve(),), dict(cl=0.9, limit=2.3)),
    ('plot_profile_map', ((np.linspace(0, 2, 21) - 1.0) ** 2 * 8,
                          [('mu', np.linspace(0, 2, 21))]), {}),
])
def test_plots_draw_as_jax(name, args, kwargs):
    port = _drawn(getattr(plots, name)(*args, **kwargs))
    ref = _drawn(getattr(jplots, name)(*args, **kwargs))
    plt.close('all')
    assert port == ref
