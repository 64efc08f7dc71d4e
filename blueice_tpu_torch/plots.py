"""Plotting helpers for the statistics toolkit's results.

Counterpart of :mod:`blueice_tpu.plots`: the nuisance ranking plot,
interval-coverage curves, expected-limit (Brazil) distributions, profile
maps and CLs curves, each drawn from the result of the port's function of
the same construction (:mod:`blueice_tpu_torch.parallel`; its numbers are
numpy arrays and floats, as the JAX package's). Each imports matplotlib
lazily and draws onto a given axis or a fresh figure. ``Model.show`` and
``plot_likelihood_ratio`` live in :mod:`blueice_tpu_torch.inference`.
"""

import numpy as np

__all__ = ['plot_ranking', 'plot_coverage', 'plot_limit_band', 'plot_cls',
           'plot_profile_map']


def _ax(ax):
    if ax is not None:
        import matplotlib.pyplot as plt
        return ax, plt
    import matplotlib.pyplot as plt
    _, ax = plt.subplots()
    return ax, plt


def plot_ranking(ranking, max_rows=None, ax=None):
    """The classic ranking plot from a
    :func:`~blueice_tpu_torch.parallel.ranking.nuisance_ranking` result:
    per nuisance (top = largest post-fit impact), pulls with post-fit error bars
    on the bottom axis and pre/post-fit impacts on the POI on the top axis.

    :return: the matplotlib axis (pull scale; ``ax.twiny()`` carries the
      impact scale as ``ax._impact_ax``).
    """
    ax, plt = _ax(ax)
    rows = ranking['nuisances'][:max_rows]
    if not rows:
        raise ValueError("the ranking has no nuisance rows to plot")
    y = np.arange(len(rows))[::-1]
    ax2 = ax.twiny()
    dmax = max([abs(v) for r in rows
                for v in (r['impact_lo'], r['impact_hi'],
                          r['prefit_impact_lo'], r['prefit_impact_hi'])
                if v is not None and np.isfinite(v)] or [1.0])
    for yi, r in zip(y, rows):
        if r['prefit_impact_lo'] is not None:
            ax2.barh(yi, r['prefit_impact_hi'] - r['prefit_impact_lo'],
                     left=r['prefit_impact_lo'], height=0.8, color='none',
                     edgecolor='C0', linestyle='--', linewidth=1.0)
        ax2.barh(yi, r['impact_hi'] - r['impact_lo'], left=r['impact_lo'],
                 height=0.6, color='C0', alpha=0.35)
        if r['pull'] is not None:
            err = [[0.0], [0.0]]
            if r['prior_sigma']:
                err = [[r['sigma_lo'] / r['prior_sigma']],
                       [r['sigma_hi'] / r['prior_sigma']]]
            ax.errorbar([r['pull']], [yi], xerr=err, fmt='ko', capsize=3)
    ax.axvline(0.0, color='k', linewidth=0.8)
    for v in (-1.0, 1.0):
        ax.axvline(v, color='k', linewidth=0.6, linestyle=':')
    ax.set_yticks(y)
    ax.set_yticklabels([r['name'] for r in rows])
    # Pull axis wide enough for every marker + error bar (a |pull| > 2.5
    # nuisance is exactly what this plot exists to surface), never narrower
    # than the conventional +-2.5
    pmax = 2.5
    for r in rows:
        if r['pull'] is None:
            continue
        w = 0.0
        if r['prior_sigma']:
            w = max([s / r['prior_sigma']
                     for s in (r['sigma_lo'], r['sigma_hi'])
                     if np.isfinite(s)] or [0.0])
        pmax = max(pmax, abs(r['pull']) + w)
    ax.set_xlim(-1.05 * pmax, 1.05 * pmax)
    ax2.set_xlim(-1.2 * dmax, 1.2 * dmax)
    ax.set_xlabel(r'pull $(\hat\theta - \theta_0)/\sigma_{prior}$')
    ax2.set_xlabel(r'impact $\Delta$%s' % ranking['target'])
    ax._impact_ax = ax2
    return ax


def plot_coverage(result, ax=None):
    """Measured coverage vs truth from a
    :func:`~blueice_tpu_torch.parallel.coverage.coverage_check` result,
    with Clopper-Pearson error bars and the nominal level as a reference line."""
    ax, plt = _ax(ax)
    v = result['true_values']
    c = result['coverage']
    lo = c - result['ci'][:, 0]
    hi = result['ci'][:, 1] - c
    ax.errorbar(v, c, yerr=[lo, hi], fmt='o-', capsize=3,
                label='measured (%d toys)' % result['n_toys'])
    ax.axhline(result['nominal'], color='k', linestyle='--',
               label='nominal %.3g' % result['nominal'])
    ax.set_xlabel('true value')
    ax.set_ylabel('coverage of the %s %s interval'
                  % ('%.0f%%' % (100 * result['nominal']), result['kind']))
    ax.set_ylim(0.0, 1.02)
    ax.legend()
    return ax


def plot_limit_band(result, observed=None, ax=None, label='expected limits'):
    """Per-toy limit distribution with the quantile band from a
    :func:`~blueice_tpu_torch.parallel.limits.sensitivity_band` /
    :func:`~blueice_tpu_torch.parallel.cls.cls_expected_band` result
    (green/yellow
    Brazil shading for the inner quantile pairs, median line), optionally
    with the observed limit overlaid."""
    ax, plt = _ax(ax)
    lims = np.asarray(result['limits'], dtype=float)
    finite = lims[np.isfinite(lims)]
    if len(finite) == 0:
        raise ValueError("every toy limit lies beyond the grid; nothing "
                         "finite to plot")
    ax.hist(finite, bins=min(60, max(10, len(finite) // 20)),
            histtype='stepfilled', alpha=0.3, color='gray', label=label)
    band = result['band']
    qs = sorted(band)
    colors = {0: 'gold', 1: 'yellowgreen'}
    # Shade symmetric quantile pairs outside-in (2.5/97.5 then 16/84 ...):
    # SOLID spans with inner pairs drawn on top, so the inner +-1 sigma
    # region reads as pure green inside pure yellow (the Brazil convention)
    # instead of an alpha blend of both
    for depth, (ql, qh) in enumerate(zip(qs, qs[::-1])):
        if ql >= qh:
            break
        if np.isfinite(band[ql]) and np.isfinite(band[qh]):
            ax.axvspan(band[ql], band[qh], linewidth=0,
                       color=colors.get(depth, 'green'),
                       zorder=-10 + depth)
    med = result['band'].get(0.5)
    if med is not None and np.isfinite(med):
        ax.axvline(med, color='k', linestyle='--', label='median expected')
    if observed is not None:
        ax.axvline(observed, color='r', label='observed')
    ax.set_xlabel('upper limit')
    ax.set_ylabel('toys')
    ax.legend()
    return ax


def plot_profile_map(t, space, cls=(0.683, 0.9), ax=None):
    """Observed profile-LR map from
    :meth:`~blueice_tpu_torch.parallel.toys.BinnedToyStudy.profile_map`
    output,
    with Wilks confidence contours: a 1D curve with chi2(1) critical lines,
    or a 2D filled map with chi2(2) contour levels at each requested
    confidence level.

    :param t: the t array profile_map returned ((len(g1),) or
      (len(g1), len(g2))).
    :param space: the same (name, grid) pairs given to profile_map.
    :param cls: confidence levels to mark.
    """
    from scipy import stats
    ax, plt = _ax(ax)
    t = np.asarray(t, dtype=float)
    if len(space) == 1:
        (name, g), = space
        ax.plot(np.asarray(g), t, '-')
        for cl in cls:
            ax.axhline(stats.chi2(1).ppf(cl), linestyle=':', color='k')
            ax.text(float(np.asarray(g)[0]), stats.chi2(1).ppf(cl),
                    ' %.1f%%' % (100 * cl), va='bottom', fontsize=8)
        ax.set_xlabel(name)
        ax.set_ylabel(r'$t = 2\,(\ln L_{max} - \ln L)$')
        return ax
    if len(space) != 2 or t.ndim != 2:
        raise ValueError("space must be 1 or 2 (name, grid) pairs matching "
                         "t's shape")
    (n1, g1), (n2, g2) = space
    mesh = ax.pcolormesh(np.asarray(g2), np.asarray(g1), t, shading='auto',
                         vmax=min(float(np.nanmax(t)),
                                  2 * stats.chi2(2).ppf(max(cls))))
    levels = sorted(stats.chi2(2).ppf(cl) for cl in cls)
    cs = ax.contour(np.asarray(g2), np.asarray(g1), t, levels=levels,
                    colors='w', linewidths=1.0)
    ax.clabel(cs, fmt={lv: '%.0f%%' % (100 * cl)
                       for lv, cl in zip(levels, sorted(cls))}, fontsize=8)
    plt.colorbar(mesh, ax=ax, label='t')
    ax.set_xlabel(n2)
    ax.set_ylabel(n1)
    return ax


def plot_cls(curve, cl=0.9, limit=None, ax=None):
    """CLs / CLsb / CLb vs hypothesis from a
    :func:`~blueice_tpu_torch.parallel.cls.cls_curve` result, with the
    exclusion
    threshold alpha = 1 - cl and (optionally) the crossing limit marked."""
    ax, plt = _ax(ax)
    h = curve['hypotheses']
    ax.plot(h, curve['cls'], 'o-', color='C3', label='CLs')
    ax.plot(h, curve['clsb'], 's--', color='C0', alpha=0.6, label='CLsb')
    ax.plot(h, curve['clb'], '^--', color='C2', alpha=0.6, label='CLb')
    ax.axhline(1.0 - cl, color='k', linestyle=':',
               label=r'$\alpha$ = %.3g' % (1.0 - cl))
    if limit is not None and np.isfinite(limit):
        ax.axvline(limit, color='C3', linewidth=0.8)
    ax.set_xlabel('hypothesis')
    ax.set_ylabel('p-value')
    ax.set_ylim(0.0, 1.05)
    ax.legend()
    return ax
