"""Interval coverage validation: measure the ACTUAL coverage of a limit
procedure over toy ensembles at a grid of true parameter values.

The frequentist guarantee behind every interval this package (or the
reference) produces — "a 90% upper limit covers the truth in 90% of
repeated experiments" — is exact only for a perfectly calibrated critical
curve; Wilks' asymptotic critical values (the reference's default,
blueice/inference.py:360-364) over- or under-cover whenever the statistic's
true distribution departs from chi2 (bounded parameters, low counts,
near-degenerate models — see BENCH.md's XENON median-t discussion).
The reference offers no way to check: one coverage point is thousands of
`one_parameter_interval` optimizer loops. Here it is one call — the per-toy
limits are the batched crossing construction of
:mod:`~blueice_tpu_torch.parallel.limits` (batched fits on the study's
device). The counterpart of :mod:`blueice_tpu.parallel.coverage`.

This validates the *end-to-end interval procedure* (grid, interpolation,
adaptive rescaling, critical curve, fitter) out of sample — complementary to
:meth:`~blueice_tpu_torch.parallel.neyman.NeymanConstruction.coverage_check`,
which only re-reads the calibration ensemble's own quantiles.
"""

import warnings

import numpy as np
from scipy import stats

from .limits import _adaptive_edges
from .toys import child_seed, seed_of

__all__ = ['coverage_check', 'clopper_pearson']

_KIND_SPECS = {
    'upper': lambda cl: [('upper', cl)],
    'lower': lambda cl: [('lower', 1.0 - cl)],
    'central': lambda cl: [('lower', (1.0 - cl) / 2.0),
                           ('upper', 1.0 - (1.0 - cl) / 2.0)],
    # Unified (Feldman-Cousins-style) acceptance {h : t(h) < c} at the
    # two-sided level: quantile (1+cl)/2 maps to chi2(1).ppf(cl) under
    # Wilks and to the cl-quantile of the two-sided toy statistic under a
    # NeymanConstruction(statistic='two-sided') t_ppf
    'unified': lambda cl: [('lower', (1.0 + cl) / 2.0),
                           ('upper', (1.0 + cl) / 2.0)],
}


def clopper_pearson(k, n, conf=0.68):
    """Exact (Clopper-Pearson) binomial confidence interval for a coverage
    fraction of ``k`` successes in ``n`` trials. Returns (lo, hi)."""
    a = (1.0 - conf) / 2.0
    lo = 0.0 if k == 0 else float(stats.beta.ppf(a, k, n - k + 1))
    hi = 1.0 if k == n else float(stats.beta.ppf(1.0 - a, k + 1, n - k))
    return lo, hi


def _side_covered(side, edge, v, hyps):
    """Per-toy (covered, undecided) verdicts for one interval edge.

    An unresolved edge (NaN) lies BEYOND the final grid on its own side, so
    its verdict is decidable from the grid end whenever the truth lies
    inside the grid: an upper edge beyond the grid exceeds the grid top
    (>= any truth under it), a lower edge beyond the grid undercuts the
    grid bottom. A truth beyond the grid end on the SAME side is genuinely
    undecidable (the edge is somewhere past the grid, the truth too) —
    those toys are flagged and scored NOT covered, the conservative
    direction for a coverage validation."""
    nan = np.isnan(np.asarray(edge, dtype=float))
    if side == 'upper':
        covered = np.where(nan, float(hyps[-1]) >= v, edge >= v)
        undecided = nan & (v > float(hyps[-1]))
    else:
        covered = np.where(nan, float(hyps[0]) <= v, edge <= v)
        undecided = nan & (v < float(hyps[0]))
    return covered, undecided


def coverage_check(study, seed_or_generator, target, true_values, n_toys,
                   kind='upper', cl=0.9, hypotheses='auto', t_ppf=None,
                   truth=None, fixed=None, mesh=None, ci=0.68):
    """Measured coverage of the batched interval procedure at each true
    value of ``target``: simulate ``n_toys`` experiments with the target at
    the truth, compute every toy's interval exactly as
    :func:`~blueice_tpu_torch.parallel.limits.toy_upper_limits` (resp. lower /
    central / unified) would, and count the fraction containing the truth.

    :param study: a BinnedToyStudy or UnbinnedToyStudy (prepared likelihood).
    :param seed_or_generator: int seed or torch.Generator (one int seed
      drawn at entry); the i-th true value's ensemble takes the child seed
      ``child_seed(seed, i)``, so ensembles at different truths are
      independent (and reproducible per truth).
    :param true_values: iterable of target truths to probe.
    :param kind: 'upper', 'lower', 'central' or 'unified' (the
      Feldman-Cousins-style two-sided acceptance — with a
      ``NeymanConstruction(statistic='two-sided')`` ``t_ppf`` this is the
      fully toy-calibrated unified construction).
    :param cl: nominal confidence level whose coverage is being measured.
    :param hypotheses: grid or ``'auto'``, as in the limit functions.
    :param t_ppf: optional calibrated critical-value hook — pass the SAME
      hook you use for production limits; coverage is then a closed-loop
      validation of the calibration itself.
    :param truth: non-target simulation-truth settings (the target entry is
      overwritten per probed value).
    :param ci: confidence level of the per-point Clopper-Pearson error bars.
    :return: dict with 'true_values', 'coverage' (per-truth fraction),
      'ci' ((n, 2) Clopper-Pearson bounds), 'n_covered', 'n_undecided'
      (toys whose edge was unresolved on the truth's own side of the grid —
      scored not covered, with a warning), 'n_toys' (the ACTUAL ensemble
      size — a mesh rounds the request up to a device multiple),
      'nominal' (= cl), 'kind', and 'edges' (per-truth list of per-spec edge
      arrays, for diagnostics).
    """
    if kind not in _KIND_SPECS:
        raise ValueError("kind must be one of %s" % sorted(_KIND_SPECS))
    specs = _KIND_SPECS[kind](float(cl))
    true_values = [float(v) for v in np.atleast_1d(
        np.asarray(true_values, dtype=float))]
    seed = seed_of(seed_or_generator)
    seeds = [child_seed(seed, i) for i in range(len(true_values))]
    coverage, cis, n_cov, n_und, all_edges = [], [], [], [], []
    n_actual = int(n_toys)
    for s_i, v in zip(seeds, true_values):
        tv = dict(truth or {})
        tv[target] = v
        edges, _, hyps, _ = _adaptive_edges(
            study, s_i, target, hypotheses, n_toys, tv, fixed, mesh, t_ppf,
            specs)
        n_actual = len(edges[0])    # simulate() rounds up under a mesh
        covered = np.ones(n_actual, dtype=bool)
        undecided = np.zeros(n_actual, dtype=bool)
        for (side, _), e in zip(specs, edges):
            c, u = _side_covered(side, np.asarray(e, dtype=float), v, hyps)
            covered &= c
            undecided |= u
        if undecided.any():
            warnings.warn(
                "%d/%d toys at truth %g have an interval edge unresolved on "
                "the truth's own side of the grid [%g, %g]; they are scored "
                "NOT covered (conservative) — widen the grid or use "
                "hypotheses='auto'" % (int(undecided.sum()), n_actual, v,
                                       hyps[0], hyps[-1]))
        k = int(covered.sum())
        n_cov.append(k)
        n_und.append(int(undecided.sum()))
        coverage.append(k / float(n_actual))
        cis.append(clopper_pearson(k, n_actual, conf=ci))
        all_edges.append(edges)
    return {'true_values': np.asarray(true_values),
            'coverage': np.asarray(coverage),
            'ci': np.asarray(cis),
            'n_covered': np.asarray(n_cov),
            'n_undecided': np.asarray(n_und),
            'n_toys': n_actual,
            'nominal': float(cl),
            'kind': kind,
            'edges': all_edges}
