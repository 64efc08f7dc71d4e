"""Per-toy upper limits and expected-sensitivity ("Brazil") bands.

The counterpart of :mod:`blueice_tpu.parallel.limits`. The construction
is one toy ensemble, one batched free fit, and one batched conditional fit
reused across the hypothesis grid
(:meth:`~blueice_tpu_torch.parallel.toys.BinnedToyStudy.profile_ts_grid`),
on the study's device. The per-toy limit is the crossing of that toy's
profile-LR curve with the critical curve, linearly interpolated on the grid:
no per-toy optimizer loop runs on the host.

Statistic conventions match ``one_parameter_interval``: the default critical
value is Wilks' ``norm.ppf(cl)**2`` (reference: blueice/inference.py:360-364),
and a toy-calibrated ``t_ppf(hypothesis, cl)`` — e.g.
:meth:`~blueice_tpu_torch.parallel.neyman.NeymanConstruction.t_ppf` —
plugs in the same way. Limits use the one-sided (q_mu) convention: a toy
whose best fit exceeds the hypothesis does not reject it from below.
"""

import warnings
from collections import OrderedDict

import numpy as np

from ._stats import simulation_truth
from .toys import seed_of

__all__ = ['toy_upper_limits', 'toy_lower_limits', 'toy_central_intervals',
           'toy_unified_intervals', 'sensitivity_band', 'observed_interval']

_AUTO_GRID_POINTS = 33


def _critical_curve(hypotheses, cl, t_ppf):
    if t_ppf is None:
        from scipy import stats
        return np.full(len(hypotheses), float(stats.norm.ppf(cl) ** 2))
    return np.array([float(t_ppf(h, cl)) for h in hypotheses])


def _first_upcrossing(hyps, excess):
    """Per toy (column), the smallest hypothesis where ``excess`` (t - crit)
    reaches 0, linearly interpolated between grid points.

    :param hyps: (H,) ascending hypothesis grid.
    :param excess: (H, T).
    :return: (T,) crossings; NaN where the curve stays below 0 on the whole
      grid (limit beyond the grid); the grid start where it is already >= 0
      at the first point (limit at or below the grid start).
    """
    H, T = excess.shape
    nonneg = excess >= 0
    crossed = nonneg.any(axis=0)
    j = np.argmax(nonneg, axis=0)               # first nonneg index per toy
    uls = np.full(T, np.nan)
    at_start = crossed & (j == 0)
    uls[at_start] = hyps[0]
    ok = crossed & (j > 0)
    if ok.any():
        cols = np.flatnonzero(ok)
        jj = j[cols]
        e_hi = excess[jj, cols]
        e_lo = excess[jj - 1, cols]             # < 0 by first-crossing choice
        frac = -e_lo / (e_hi - e_lo)
        uls[cols] = hyps[jj - 1] + frac * (hyps[jj] - hyps[jj - 1])
    return uls


def _quantile_inf_aware(sorted_vals, q):
    """Linear-interpolation quantile that stays inf (not inf - inf = NaN)
    when the position lands among +inf order statistics."""
    pos = q * (len(sorted_vals) - 1)
    lo = int(np.floor(pos))
    hi = int(np.ceil(pos))
    a, b = float(sorted_vals[lo]), float(sorted_vals[hi])
    if np.isinf(b):
        return a if pos == lo else np.inf
    return a + (b - a) * (pos - lo)


def _auto_grid(study, seed, target, n_toys, truth, fixed, mesh,
               n_points=_AUTO_GRID_POINTS):
    """Hypothesis grid sized from a free-fit pass over the ensemble: cover
    the best-fit distribution plus a 6-sigma one-sided margin, clamped to
    the target's bounds. The free fits reuse the grid run's own fitter, and
    the toys regenerate identically from the int seed, so the extra cost is
    one batched fit."""
    free = study.run(seed, n_toys, truth=truth, fixed=fixed, mesh=mesh)
    return _grid_from_fits(np.asarray(free[target]),
                           study.compiled.bounds.get(target, (None, None)),
                           n_points)


def _auto_requested(hypotheses):
    """True for hypotheses='auto'; raises on any other string."""
    if isinstance(hypotheses, str):
        if hypotheses != 'auto':
            raise ValueError("hypotheses must be a grid of values or 'auto'")
        return True
    return False


def _grid_from_fits(x, bounds, n_points=_AUTO_GRID_POINTS):
    """Initial hypothesis grid covering best fits ``x`` plus a 6-sigma
    one-sided margin, clamped to the parameter ``bounds``."""
    q16, q50, q84 = np.percentile(x, [16, 50, 84])
    # Spread estimate robust to boundary pile-up (bg-only rate fits pile at
    # 0, which crushes the IQR — std survives a half-pile at ~0.6 sigma).
    # When EVERY fit sits exactly on the boundary (e.g. a zero-background
    # child pins x_hat = 0 for all toys) no data-driven scale exists: start
    # from the parameter's unit scale and let toy_upper_limits' adaptive
    # retry find the real one.
    sigma = max((q84 - q16) / 2.0, float(np.std(x)), abs(q50) / 4.0)
    if sigma == 0.0:
        sigma = max(abs(float(np.max(np.abs(x)))), 1.0) / 6.0
    lo_b, hi_b = bounds
    lo = min(0.0, float(np.min(x)))
    if lo_b is not None:
        # Fits respect the bounds, so this stays <= min(x) (every toy keeps
        # a bracketing grid point at or below its best fit)
        lo = max(lo, float(lo_b))
    # The limit sits ~1.3-2.3 sigma_fit above the best fit (cl 0.68-0.99),
    # and sigma here underestimates sigma_fit by up to ~2x under pile-up:
    # 6 sigma past the LARGEST best fit covers both with margin
    hi = float(np.max(x)) + 6.0 * sigma
    if hi_b is not None:
        hi = min(hi, float(hi_b))
    if not hi > lo:
        raise ValueError(
            "auto hypothesis grid is degenerate: [%g, %g] after clamping to "
            "bounds (%s, %s) — pass an explicit grid"
            % (lo, hi, lo_b, hi_b))
    return np.linspace(lo, hi, n_points)


def toy_upper_limits(study, seed_or_generator, target, hypotheses, n_toys,
                     truth=None, fixed=None, cl=0.9, t_ppf=None, mesh=None,
                     return_grid=False):
    """Batched per-toy upper limits on ``target``.

    For each toy dataset, the limit is the smallest hypothesis h where the
    one-sided profile-LR statistic t(h) = 2(LL_free - LL(target=h)) (zeroed
    where the best fit exceeds h) reaches the critical value — the batched
    equivalent of running ``one_parameter_interval(kind='upper')`` on every
    toy, at thousands of limits per second instead of one optimizer loop each.

    :param study: a BinnedToyStudy or UnbinnedToyStudy (prepared likelihood).
    :param seed_or_generator: int seed or torch.Generator of the toy
      ensemble; a Generator gives one int seed at entry
      (:func:`~blueice_tpu_torch.parallel.toys.seed_of`), which every draw
      of the call uses.
    :param hypotheses: grid of target values to scan; the limit is
      interpolated between grid points, so spacing sets the resolution.
      The grid must cover the limits: toys whose curve never crosses within
      the grid come back NaN (widen the grid). Pass ``'auto'`` to size the
      grid from the ensemble itself: a free-fit pass (the same fitter the
      grid run reuses; toys are regenerated identically from the seed) sets
      the range to cover best fits plus a 6-sigma one-sided margin, clamped
      to the target's bounds.
    :param truth: simulation truth dict; default ``{target: 0.0}`` — the
      standard background-only expected-limit ensemble.
    :param cl: confidence level (default 0.9).
    :param t_ppf: optional toy-calibrated critical-value hook
      ``t_ppf(hypothesis, cl)`` (e.g. ``NeymanConstruction.t_ppf``); default
      Wilks, exactly as in ``one_parameter_interval``.
    :param return_grid: also return (ts, hypotheses, free ToyResults) for
      diagnostics.
    :return: (n_toys,) array of limits; with return_grid, (limits, ts,
      hypotheses, free).
    """
    if truth is None:
        truth = {target: 0.0}
    edges, ts, hyps, free = _adaptive_edges(
        study, seed_or_generator, target, hypotheses, n_toys, truth, fixed,
        mesh, t_ppf, specs=[('upper', cl)])
    uls = edges[0]
    if return_grid:
        return uls, ts, hyps, free
    return uls


def _adaptive_edges(study, seed_or_generator, target, hypotheses, n_toys,
                    truth, fixed, mesh, t_ppf, specs):
    """Toy-ensemble front end of :func:`_adaptive_edges_impl`: run the
    profile-LR grid over a simulated ensemble. A Generator gives one int
    seed here, and every draw below uses it, so the auto grid's free fits,
    the grid and its retries all fit the same toys."""
    seed = seed_of(seed_or_generator)
    # Parameters held fixed in the fits must be simulated at those values
    # (explicit truth entries win) — otherwise the toy statistics belong to
    # a different model than the fits that evaluate them
    truth = simulation_truth(truth, fixed)
    auto = _auto_requested(hypotheses)
    if auto:
        hypotheses = _auto_grid(study, seed, target, n_toys, truth, fixed,
                                mesh)

    def run_grid(hyps):
        # return_cond=False: the edges only need t — skip copying the
        # per-hypothesis conditional parameters on every retry
        ts, hyps, free, _ = study.profile_ts_grid(
            seed, target, hyps, n_toys, truth=truth, fixed=fixed, mesh=mesh,
            return_cond=False)
        return np.asarray(ts), np.asarray(hyps), free

    return _adaptive_edges_impl(
        run_grid, study.compiled.bounds.get(target, (None, None)),
        hypotheses, target, t_ppf, specs, adapt=auto)


def _adaptive_edges_impl(run_grid, bounds, hypotheses, target, t_ppf, specs,
                         adapt=True):
    """Run the profile-LR grid and read off interval edges, retrying with a
    rescaled grid until every requested edge is resolved (or pinned at the
    parameter's bound).

    The free-fit spread that sizes an initial auto grid can wildly misjudge
    the limit scale (e.g. a zero-background child pins every best fit to
    exactly 0 while the limit is set by the Poisson upper tail); retries cost
    only further batched fits of the same fitters.

    :param run_grid: callable(hypotheses) -> (ts (H, T), sorted hypotheses,
      free ToyResults) — a toy ensemble or a single observed dataset (T=1).
    :param bounds: the target's (lo, hi) parameter bounds.
    :param specs: list of (side, cl) pairs — one interval edge each. The
      quantile handed to t_ppf is cl itself (matching
      ``one_parameter_interval``'s convention for each kind).
    :return: (list of per-spec edge arrays, ts, hyps, free).
    """
    n_points = len(np.asarray(hypotheses))
    lo_b, hi_b = bounds
    upper_only = all(side == 'upper' for side, _ in specs)
    for _attempt in range(6):
        ts, hyps, free = run_grid(hypotheses)
        x_hat = np.asarray(free[target])
        crits = [_checked_crit(hyps, cl, t_ppf) for _, cl in specs]
        edges = [_edge_from_curves(ts, hyps, x_hat, crit, side)
                 for (side, _), crit in zip(specs, crits)]
        if not adapt:
            break
        lo, hi = float(hyps[0]), float(hyps[-1])
        span = hi - lo
        new_lo, new_hi = lo, hi
        max_fin = -np.inf
        for (side, _), crit, edge in zip(specs, crits, edges):
            fin = np.isfinite(edge)
            if fin.any():
                max_fin = max(max_fin, float(np.max(edge[fin])))
            if fin.all():
                continue
            # Some toy's curve never reaches this critical value in-grid.
            # t(h) away from the best fit ranges from linear
            # (boundary-pinned fit, Poisson-linear regime) to quadratic
            # (Gaussian regime); LINEAR extrapolation of where the worst
            # uncrossed toy's curve meets crit — h_need = x_hat +/-
            # (h_edge - x_hat) * crit/t(h_edge) — is the conservative
            # (never-undershooting) choice for any convex curve. Growth is
            # clamped: at least a 2x span (progress even with a flat,
            # information-free tail), at most 4096x (a t ~ 0 toy would
            # otherwise fling the grid to infinity).
            if side == 'upper':
                t_edge = np.asarray(ts)[-1][~fin]
                d = np.maximum(hi - x_hat[~fin], 0.0)
            else:
                t_edge = np.asarray(ts)[0][~fin]
                d = np.maximum(x_hat[~fin] - lo, 0.0)
            with np.errstate(divide='ignore', invalid='ignore'):
                reach = d * (crit[-1 if side == 'upper' else 0]
                             / np.maximum(t_edge, 1e-300))
            reach = reach[np.isfinite(reach)]
            growth = float(np.clip(
                1.5 * float(np.max(reach)) if len(reach) else 8.0 * span,
                2.0 * span, 4096.0 * span))
            if side == 'upper':
                need = float(np.max(x_hat[~fin])) + growth
                new_hi = max(new_hi, need)
            else:
                need = float(np.min(x_hat[~fin])) - growth
                new_lo = min(new_lo, need)
        if new_hi == hi and new_lo == lo and upper_only \
                and np.isfinite(max_fin) and max_fin < lo + 0.12 * span:
            # Every upper limit crammed into the first cells: shrink for
            # interpolation resolution (only safe single-sided — a central
            # interval needs the grid to keep covering both edges)
            new_hi = lo + 3.0 * (max_fin - lo) + 1e-12
        if hi_b is not None:
            new_hi = min(new_hi, float(hi_b))
        if lo_b is not None:
            new_lo = max(new_lo, float(lo_b))
        new = np.linspace(new_lo, new_hi, n_points)
        # Progress check must be scale-free: allclose's default ABSOLUTE
        # tolerance would read any two microscopic grids (e.g. a
        # tightly-pinned parameter whose fits pile at ~1e-14) as equal and
        # end the search after one attempt
        if not new_hi > new_lo or np.allclose(new, hyps, rtol=1e-9, atol=0.0):
            break
        hypotheses = new
    return edges, ts, hyps, free


def toy_lower_limits(study, seed_or_generator, target, hypotheses, n_toys,
                     truth=None, fixed=None, cl=0.9, t_ppf=None, mesh=None,
                     return_grid=False):
    """Batched per-toy lower limits on ``target`` — the mirror of
    :func:`toy_upper_limits` (``one_parameter_interval(kind='lower')``): the
    largest hypothesis below the best fit where the one-sided statistic
    (zeroed where the best fit lies below h) reaches the critical value.

    :param truth: simulation truth; default the model defaults (signal
      present — a background-only ensemble has no meaningful lower limit).
      NaN marks limits below the grid; the quantile passed to ``t_ppf`` is
      ``1 - cl``, matching ``one_parameter_interval``.
    """
    truth = dict(truth or {})
    edges, ts, hyps, free = _adaptive_edges(
        study, seed_or_generator, target, hypotheses, n_toys, truth, fixed,
        mesh, t_ppf, specs=[('lower', 1.0 - cl)])
    lls = edges[0]
    if return_grid:
        return lls, ts, hyps, free
    return lls


def toy_central_intervals(study, seed_or_generator, target, hypotheses, n_toys,
                          truth=None, fixed=None, cl=0.9, t_ppf=None,
                          mesh=None):
    """Batched per-toy central intervals on ``target``
    (``one_parameter_interval(kind='central')``): both edges come from ONE
    grid run — the free fits and conditional curves are shared, so a central
    interval costs the same as a single-sided limit.

    :param truth: simulation truth; default the model defaults.
    :return: ((n_toys,) lower edges, (n_toys,) upper edges); NaN where an
      edge lies outside the grid. Tail quantiles (1-cl)/2 each side, exactly
      as in ``one_parameter_interval``.
    """
    truth = dict(truth or {})
    tail = (1.0 - cl) / 2.0
    edges, _, _, _ = _adaptive_edges(
        study, seed_or_generator, target, hypotheses, n_toys, truth, fixed,
        mesh, t_ppf, specs=[('lower', tail), ('upper', 1.0 - tail)])
    return edges[0], edges[1]


def toy_unified_intervals(study, seed_or_generator, target, hypotheses, n_toys,
                          truth=None, fixed=None, cl=0.9, t_ppf=None,
                          mesh=None):
    """Batched per-toy unified (Feldman-Cousins-style) intervals: the
    acceptance region {h : t(h) < c(h)} of the two-sided profile-LR
    statistic at level ``cl`` around each toy's best fit — the
    profile-likelihood form of the Feldman-Cousins construction
    (arXiv:physics/9711021's unified approach; the reference has no unified
    machinery, its `one_parameter_interval` kinds stop at upper/lower/central,
    blueice/inference.py:355-364).

    Both edges cross the SAME critical curve: quantile ``(1+cl)/2`` maps to
    ``chi2(1).ppf(cl)`` under the default Wilks hook and to the direct
    cl-quantile of the calibrated two-sided statistic under a
    ``NeymanConstruction(statistic='two-sided')`` ``t_ppf`` — i.e. with that
    hook this IS the fully toy-calibrated unified construction. Away from
    parameter bounds (the Wilks regime) the interval coincides with the
    central one; near a physical boundary the lower edge collapses onto the
    bound and the interval transitions smoothly to an upper limit — never
    empty, never flip-flopping between conventions.

    :param truth: simulation truth; default the model defaults.
    :return: ((n_toys,) lower edges, (n_toys,) upper edges). Edges
      unresolved at the target's own (finite) parameter bound ARE the bound
      — the boundary transition, on both sides; elsewhere NaN marks an edge
      beyond the (adaptively grown) grid.
    """
    truth = dict(truth or {})
    q = (1.0 + cl) / 2.0
    edges, _, hyps, _ = _adaptive_edges(
        study, seed_or_generator, target, hypotheses, n_toys, truth, fixed,
        mesh, t_ppf, specs=[('lower', q), ('upper', q)])
    return _unified_edges_to_bounds(
        edges[0], edges[1], hyps,
        study.compiled.bounds.get(target, (None, None)))


def _unified_edges_to_bounds(lo, hi, hyps, bounds):
    """Unified-interval boundary transitions: an edge whose crossing never
    happens out to the target's own (finite) parameter bound means the
    acceptance region reaches that bound — the edge IS the bound. Applies
    on BOTH sides (a shape parameter's anchor range bounds it above too);
    only when the grid actually reached the bound — an edge beyond a grid
    that stopped short stays NaN (widen the grid)."""
    lo = np.array(lo, dtype=float, copy=True)
    hi = np.array(hi, dtype=float, copy=True)
    lo_b, hi_b = bounds
    if lo_b is not None and np.isclose(float(hyps[0]), float(lo_b),
                                       rtol=1e-12, atol=0.0):
        lo[np.isnan(lo)] = float(lo_b)
    if hi_b is not None and np.isclose(float(hyps[-1]), float(hi_b),
                                       rtol=1e-12, atol=0.0):
        hi[np.isnan(hi)] = float(hi_b)
    return lo, hi


def _checked_crit(hyps, quantile, t_ppf):
    crit = _critical_curve(hyps, quantile, t_ppf)
    if (crit < 0).any():
        raise ValueError(
            "critical values must be nonnegative; got %s (is the t_ppf "
            "quantile convention right? It is called as "
            "t_ppf(hypothesis, quantile))" % crit[crit < 0][:3])
    # A calibrated critical value of exactly 0 is legitimate — e.g. a
    # one-sided Neyman statistic at a hypothesis where > cl of the
    # calibration toys sit at t = 0 (best fits piled on the rejecting side's
    # boundary): there, ANY t > 0 rejects, so the limit degenerates to the
    # best fit. Require strict positivity with a tiny floor so the zeroed
    # region around the best fit does not itself read as a crossing.
    return np.maximum(crit, 1e-12)


def _edge_from_curves(ts, hyps, x_hat, crit, side):
    """One interval edge per toy: the first crossing of the one-sided
    statistic with the critical curve, scanning away from the best fit."""
    if side == 'upper':
        # One-sided q_mu: an upward best-fit fluctuation past h is not
        # evidence against h as an upper limit
        t_os = np.where(x_hat[None, :] <= hyps[:, None], ts, 0.0)
        return _first_upcrossing(hyps, t_os - crit[:, None])
    # Lower edge: first crossing scanning DOWNWARD from the best fit —
    # the upcrossing search over the reversed grid in -h
    t_os = np.where(x_hat[None, :] >= hyps[:, None], ts, 0.0)
    e = (t_os - crit[:, None])[::-1]
    return -_first_upcrossing(-hyps[::-1], e)


def sensitivity_band(study, seed_or_generator, target, hypotheses, n_toys,
                     truth=None, fixed=None, cl=0.9, t_ppf=None, mesh=None,
                     quantiles=(0.025, 0.16, 0.5, 0.84, 0.975)):
    """Expected-limit (Brazil) band: quantiles of the per-toy upper limits
    over a background-only (by default) toy ensemble — the standard
    sensitivity deliverable of a counting experiment.

    Toys whose limit lies beyond the hypothesis grid enter the quantiles as
    +inf (they ARE larger than every in-grid limit, so the order statistics
    stay unbiased); a band edge that lands among them comes back inf with a
    warning to widen the grid.

    :return: dict with 'limits' ((n_toys,), NaN->inf preserved as inf),
      'band' (OrderedDict quantile -> limit), 'n_beyond_grid'.
    """
    uls = toy_upper_limits(study, seed_or_generator, target, hypotheses,
                           n_toys,
                           truth=truth, fixed=fixed, cl=cl, t_ppf=t_ppf,
                           mesh=mesh)
    return _band_from_limits(uls, quantiles)


def _band_from_limits(uls, quantiles):
    """Order-statistic band of per-toy limits; beyond-grid (NaN) limits
    enter as +inf so the quantiles stay unbiased."""
    beyond = ~np.isfinite(uls)
    n_beyond = int(beyond.sum())
    uls_full = np.where(beyond, np.inf, uls)
    srt = np.sort(uls_full)
    band = OrderedDict((float(q), _quantile_inf_aware(srt, float(q)))
                       for q in sorted(quantiles))
    if not np.isfinite(list(band.values())).all():
        warnings.warn(
            "%d/%d toy limits lie beyond the hypothesis grid: band edges "
            "among them are inf — widen the grid" % (n_beyond, len(uls)))
    return {'limits': uls_full, 'band': band, 'n_beyond_grid': n_beyond}


def observed_interval(study, target, hypotheses='auto', counts=None,
                      kind='upper', cl=0.9, t_ppf=None, fixed=None,
                      return_grid=False):
    """Confidence interval on the OBSERVED dataset from the compiled
    profile-LR curve — the device twin of ``one_parameter_interval``
    (reference: blueice/inference.py:332-389). The whole hypothesis scan is
    calls of one warm-started conditional fitter
    (:meth:`~blueice_tpu_torch.parallel.toys.BinnedToyStudy.profile_map`);
    the edge is the same critical-curve crossing interpolation as the
    per-toy limits. Wilks by default; a toy-calibrated
    ``t_ppf(hypothesis, quantile)`` (e.g. ``NeymanConstruction.t_ppf``)
    plugs in identically.

    :param study: a BinnedToyStudy or UnbinnedToyStudy. The dataset is the
      likelihood's ``set_data`` one; binned studies also accept explicit
      ``counts=`` tensors.
    :param hypotheses: grid of target values (edges interpolate between
      points, NaN beyond the grid), or ``'auto'`` to size the grid from the
      observed best fit and rescale until every requested edge resolves or
      pins at a parameter bound.
    :param kind: 'upper', 'lower' or 'central' — conventions (including the
      quantile handed to t_ppf per side) exactly as in
      ``one_parameter_interval`` — or 'unified' for the Feldman-Cousins-style
      two-sided acceptance (see :func:`toy_unified_intervals`; an edge
      unresolved at the target's own finite parameter bound IS the bound,
      on either side).
    :return: float for 'upper'/'lower', (lower, upper) floats for
      'central'/'unified'. With return_grid, (result, ts (H,), hypotheses,
      free ToyResults).
    """
    if kind == 'upper':
        specs = [('upper', cl)]
    elif kind == 'lower':
        specs = [('lower', 1.0 - cl)]
    elif kind == 'central':
        tail = (1.0 - cl) / 2.0
        specs = [('lower', tail), ('upper', 1.0 - tail)]
    elif kind == 'unified':
        # Feldman-Cousins-style two-sided acceptance at level cl; see
        # toy_unified_intervals for the quantile mapping and the
        # edge-to-bound boundary transitions
        q = (1.0 + cl) / 2.0
        specs = [('lower', q), ('upper', q)]
    else:
        raise ValueError(
            "kind must be 'upper', 'lower', 'central' or 'unified'")

    map_kwargs = {'fixed': fixed}
    if counts is not None:
        if not hasattr(study, 'observed_counts'):
            raise ValueError(
                "counts= applies to binned studies; unbinned observed data "
                "is bound with lf.set_data")
        map_kwargs['counts'] = counts
    # Binned studies run the free fit as a call of its own: memoize its
    # result across the adaptive retries (one dataset, identical fit). The
    # unbinned map's free fit is one lane beside the grid's — nothing to
    # save.
    binned = hasattr(study, 'observed_counts')
    memo = {}

    def run_grid(hyps):
        hyps = np.sort(np.asarray(hyps, dtype=float))
        kw = dict(map_kwargs)
        if binned and 'free' in memo:
            kw['_free'] = memo['free']
        t, free, _ = study.profile_map([(target, hyps)], **kw)
        memo['free'] = free
        return np.asarray(t)[:, None], hyps, free

    bounds = study.compiled.bounds.get(target, (None, None))
    auto = _auto_requested(hypotheses)
    if auto:
        # Seed the grid from the observed best fit. The seed scan uses a
        # constant grid of the SAME length as the later attempts, so every
        # call of the map (points shape (n, 1)) has the same lanes.
        x0 = float(study.compiled.defaults[target])
        _, _, free0 = run_grid(np.full(_AUTO_GRID_POINTS, x0))
        hypotheses = _grid_from_fits(np.asarray(free0[target]), bounds,
                                     _AUTO_GRID_POINTS)

    edges, ts, hyps, free = _adaptive_edges_impl(
        run_grid, bounds, hypotheses, target, t_ppf, specs, adapt=auto)
    if kind == 'unified':
        edges[0], edges[1] = _unified_edges_to_bounds(edges[0], edges[1],
                                                      hyps, bounds)

    if auto and all(np.isfinite(e).all() for e in edges):
        # One zoom pass for interpolation resolution: the auto grid is sized
        # to FIND the edges (best fit + 6 sigma), which for one dataset can
        # dwarf the interval itself. Re-run the map on a grid hugging the
        # found edges and the best fit.
        finite = [float(e[0]) for e in edges]
        span = float(hyps[-1] - hyps[0])
        step = span / max(len(hyps) - 1, 1)
        x_hat = float(np.asarray(free[target])[0])
        g_lo = min(min(finite), x_hat) - step
        g_hi = max(max(finite), x_hat) + step
        if bounds[0] is not None:
            g_lo = max(g_lo, float(bounds[0]))
        if bounds[1] is not None:
            g_hi = min(g_hi, float(bounds[1]))
        if g_hi > g_lo and (g_hi - g_lo) < 0.6 * span:
            zoomed = _adaptive_edges_impl(
                run_grid, bounds, np.linspace(g_lo, g_hi, len(hyps)),
                target, t_ppf, specs, adapt=False)
            if kind == 'unified':
                zoomed[0][0], zoomed[0][1] = _unified_edges_to_bounds(
                    zoomed[0][0], zoomed[0][1], zoomed[2], bounds)
            # Keep the zoom only if every edge is still resolved (a crossing
            # could in principle slip past the one-step margin)
            if all(np.isfinite(e).all() for e in zoomed[0]):
                edges, ts, hyps, free = zoomed

    for (side, _), e in zip(specs, edges):
        if not np.isfinite(e).all():
            warnings.warn(
                "the %s edge did not resolve within the hypothesis grid "
                "[%g, %g]%s — returning NaN. The profile-LR curve may never "
                "reach the critical value inside the parameter's bounds "
                "(no exclusion at this confidence level), or an explicit "
                "grid may be too narrow."
                % (side, float(hyps[0]), float(hyps[-1]),
                   " (after adaptive rescaling)" if auto else ""))
    out = (float(edges[0][0]) if kind in ('upper', 'lower')
           else (float(edges[0][0]), float(edges[1][0])))
    if return_grid:
        return out, np.asarray(ts)[:, 0], hyps, free
    return out
