"""Inference helpers on top of likelihood functions: objectives, best fits,
profile-likelihood confidence intervals, MCMC, likelihood-ratio plots.

Counterpart of :mod:`blueice_tpu.inference`: the same free functions, also
grafted as methods onto the likelihood classes. The host functions
(``make_objective``, ``bestfit_scipy``, ``bestfit_minuit``,
``bestfit_emcee``, ``one_parameter_interval``, ...) run on the host numpy
likelihoods, unchanged in semantics. The device ones run on the compiled
likelihood (:func:`blueice_tpu_torch.compile.cached_logl`):

* :func:`bestfit_jax` (the JAX package's name, kept for the users' code and
  ``BESTFIT_ROUTINES['jax']``) is the damped-Newton fit of
  :func:`blueice_tpu_torch.parallel.fitter.fit_single`, the toy studies'
  fit on one dataset, with parabolic errors from the Hessian at the
  optimum. On the card it runs the vgh and value kernels.
* :func:`bestfit_emcee_device` is the stretch-move chain of
  :mod:`blueice_tpu_torch.parallel.mcmc` on the device.

Both take ``device`` as a keyword of their own (their other keywords are
fixed parameter values): None is the card, raising without CUDA; 'cpu'
the CPU. :func:`bestfit_emcee` runs on a built-in affine-invariant
ensemble sampler when the optional ``emcee`` package is absent, so MCMC
works out of the box.
"""

import warnings
from collections import OrderedDict

import numpy as np
from scipy import stats
from scipy.optimize import brentq, minimize

from .exceptions import (NoOpimizationNecessary, OptimizationFailed,
                         InvalidParameterSpecification)

DEFAULT_BESTFIT_ROUTINE = 'scipy'

__all__ = ['best_anchor', 'make_objective', 'bestfit_scipy', 'bestfit_minuit',
           'bestfit_jax', 'plot_likelihood_ratio', 'one_parameter_interval',
           'bestfit_emcee', 'bestfit_emcee_device']


def best_anchor(lf):
    """Shape-parameter dict of the anchor model with the highest likelihood —
    a cheap global-fit guess."""
    if not len(lf.shape_parameters):
        return dict()
    shape_par_names = list(lf.shape_parameters.keys())
    anchors = list(lf.anchor_models.keys())

    def dictzip_shapes(anchor_vals):
        return {shape_par_names[j]: anchor_vals[j]
                for j in range(len(shape_par_names))}

    results = np.array([lf(**dictzip_shapes(a)) for a in anchors])
    return dictzip_shapes(anchors[int(np.argmax(results))])


RATE_SUFFIX = '_rate_multiplier'


def _free_parameters(lf, fixed, guess, rates_in_log_space):
    """Records ``(name, guess, bounds, decode)`` for every floating parameter
    — rate multipliers of registered rate parameters first, then shape
    parameters. ``decode`` maps an optimizer-space value back to the
    likelihood's parameter space (None = identity)."""
    guess = guess or {}
    records = []

    for source_name in lf.rate_parameters:
        name = source_name + RATE_SUFFIX
        if name in fixed:
            continue
        g = guess.get(name, 1)
        if rates_in_log_space:
            records.append((name, np.log10(g), (None, None),
                            lambda v: 10 ** v))
        else:
            # Ask the likelihood: allow_negative sources open to (-inf, inf)
            records.append((name, g, lf.get_bounds(name), None))

    for name, (_, _, base_value) in lf.shape_parameters.items():
        if name in fixed:
            continue
        g = guess.get(name)
        if g is None:
            base_setting = lf.pdf_base_config.get(name)
            g = (base_setting if isinstance(base_setting, (int, float))
                 else base_value)
        if g is None:
            # float(None) would silently turn into a NaN guess; samplers
            # then return NaN medians without any error
            raise InvalidParameterSpecification(
                "No starting guess for parameter %r: pass guess={...} or "
                "give it a numeric base value" % name)
        records.append((name, g, lf.get_bounds(name), None))

    return records


def make_objective(lf, guess=None, minus=True, rates_in_log_space=False,
                   **kwargs):
    """Wrap the likelihood lf for an optimizer.
    :param kwargs: fixed values for certain parameters (not fitted).
    :param guess: guesses for the floating parameters (default: base settings).
    :param minus: multiply by -1 (minimizers like that; samplers don't).
    :param rates_in_log_space: optimizer sees log10 of the rate multipliers.
    :return: (f, names, guesses, bounds): f takes an array of the floating
      parameters; names/guesses/bounds are in f's argument order.
    """
    records = _free_parameters(lf, kwargs, guess, rates_in_log_space)
    if not records:
        raise NoOpimizationNecessary(
            "All parameters are fixed — nothing to optimize")

    sign = -1 if minus else 1

    def objective(x):
        point = dict(kwargs)
        for (name, _, _, decode), v in zip(records, x):
            point[name] = decode(v) if decode is not None else v
        return sign * lf(**point)

    return (objective,
            [r[0] for r in records],
            np.array([r[1] for r in records], dtype=float),
            [r[2] for r in records])


def bestfit_scipy(lf, minimize_kwargs=None, rates_in_log_space=False,
                  pass_bounds_to_minimizer=False, **kwargs):
    """Minimize -lf over the parameters not fixed in kwargs with scipy.
    Returns ({param: best fit}, max loglikelihood). On failure, retries with the
    slower-but-robust Nelder-Mead before raising OptimizationFailed.
    :param pass_bounds_to_minimizer: pass bounds explicitly (usually unnecessary:
      the likelihood returns -inf outside its bounds anyway).
    """
    options = dict(minimize_kwargs or {})

    try:
        f, names, guess, bounds = lf.make_objective(
            minus=True, rates_in_log_space=rates_in_log_space, **kwargs)
    except NoOpimizationNecessary:
        return {}, lf(**kwargs)
    bounds_arg = bounds if pass_bounds_to_minimizer else None

    result = minimize(f, guess, bounds=bounds_arg, **options)
    if not result.success:
        # Retry once with the slow-but-sturdy simplex before giving up
        options.pop('method', None)
        result = minimize(f, guess, bounds=bounds_arg, method='Nelder-Mead',
                          **options)
        if not result.success:
            raise OptimizationFailed("Optimization failure: ", result)

    fit = OrderedDict()
    for name, v in zip(names, np.atleast_1d(result.x)):
        in_log = rates_in_log_space and name.endswith(RATE_SUFFIX)
        fit[name] = 10 ** v if in_log else float(v)
    return fit, -result.fun


def bestfit_minuit(lf, minimize_kwargs=None, rates_in_log_space=False, **kwargs):
    """Minimize -lf with iminuit's Migrad (iminuit 2.x API). Returns
    ({param: value, param_error: parabolic error}, max loglikelihood).
    Requires the optional iminuit package."""
    try:
        from iminuit import Minuit
    except ImportError as e:
        raise ImportError(
            "bestfit_minuit requires the optional iminuit package; use "
            "bestfit_scipy or bestfit_jax (which also gives parabolic errors "
            "from the exact jax Hessian) instead") from e
    if minimize_kwargs is None:
        minimize_kwargs = {}

    try:
        f, names, guess, bounds = lf.make_objective(
            minus=True, rates_in_log_space=rates_in_log_space, **kwargs)
    except NoOpimizationNecessary:
        return {}, lf(**kwargs)

    m = Minuit(f, guess, name=names)
    m.errordef = 0.5   # correct 1-sigma definition for a log likelihood
    for i, name in enumerate(names):
        m.limits[name] = bounds[i]
    for k, v in minimize_kwargs.items():
        setattr(m, k, v)
    m.migrad()

    fit_result = {}
    for name in names:
        v, err = float(m.values[name]), float(m.errors[name])
        if rates_in_log_space and name.endswith(RATE_SUFFIX):
            # Migrad saw log10(rate): decode the value like bestfit_scipy
            # does, and scale the parabolic error with the local Jacobian
            v = 10 ** v
            err = err * np.log(10) * v
        fit_result[name] = v
        fit_result[name + '_error'] = err
    return fit_result, -m.fval


def bestfit_jax(lf, return_errors=True, fit_options=None, device=None,
                **kwargs):
    """Fit of the *compiled* likelihood by the toy studies' bound-respecting
    damped Newton, on one dataset. Returns ({param: best fit, param_error:
    parabolic error}, max loglikelihood). The name is the JAX package's.

    :param kwargs: fixed values for certain parameters (not fitted).
    :param fit_options: dict passed to parallel.fitter.fit_single
      (max_iter, tol, guess).
    :param device: where the likelihood compiles (None: the card, raising
      without CUDA; 'cpu' for the CPU).
    """
    from .compile import cached_logl
    from .parallel.fitter import fit_single

    return fit_single(cached_logl(lf, device=device), fixed=kwargs,
                      return_errors=return_errors, **(fit_options or {}))


def _stretch_move_sampler(log_prob, p0, n_steps, rng, a=2.0):
    """Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move) —
    built-in replacement for the optional emcee dependency.
    :param p0: (n_walkers, n_dim) initial ensemble.
    :return: chain (n_walkers, n_steps, n_dim).
    """
    n_walkers, n_dim = p0.shape
    pos = p0.copy()
    logp = np.array([log_prob(p) for p in pos])
    chain = np.empty((n_walkers, n_steps, n_dim))
    half = n_walkers // 2
    groups = [np.arange(half), np.arange(half, n_walkers)]
    for step in range(n_steps):
        for g in (0, 1):
            idx = groups[g]
            other = groups[1 - g]
            z = ((a - 1.0) * rng.random(len(idx)) + 1) ** 2 / a
            partners = other[rng.integers(0, len(other), len(idx))]
            proposal = pos[partners] + z[:, None] * (pos[idx] - pos[partners])
            logp_prop = np.array([log_prob(p) for p in proposal])
            log_accept = (n_dim - 1) * np.log(z) + logp_prop - logp[idx]
            accept = np.log(rng.random(len(idx))) < log_accept
            pos[idx[accept]] = proposal[accept]
            logp[idx[accept]] = logp_prop[accept]
        chain[:, step, :] = pos
    return chain


def bestfit_emcee(ll, quiet=True, return_errors=False, return_samples=False,
                  n_walkers=40, n_steps=200, n_burn_in=100, n_threads=1,
                  seed=None, **kwargs):
    """Optimize the loglikelihood with ensemble MCMC. Walkers start at
    [0.95, 1.05] * the guesses; guesses of exactly 0 get an additive
    +-0.05 jitter instead — affine-invariant proposals are linear
    combinations of walker positions, so a coordinate where the whole
    ensemble starts identical (0 * anything) could otherwise never move.
    Uses the optional emcee package when importable, otherwise the built-in
    affine-invariant sampler (identical algorithm).

    :param return_errors: also return {param: 1 sigma error} as a third result.
    :param return_samples: also return the flattened post-burn-in samples.
    :return: ({param: median}, loglikelihood at the median point).
    """
    f, names, guess, _ = ll.make_objective(minus=False, **kwargs)
    n_dim = len(guess)
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0.95, 1.05, size=(n_walkers, n_dim)) * guess
    degenerate = np.asarray(guess) == 0
    if degenerate.any():
        p0[:, degenerate] += rng.uniform(
            -0.05, 0.05, size=(n_walkers, int(degenerate.sum())))

    try:
        import emcee
        sampler = emcee.EnsembleSampler(n_walkers, n_dim, f)
        try:
            # Seed emcee's internal RNG so ``seed`` governs the whole chain,
            # not just the walker initialization (otherwise two runs with the
            # same seed differ on emcee-equipped machines only)
            sampler.random_state = np.random.RandomState(seed).get_state()
        except AttributeError:      # pragma: no cover - very old emcee
            pass
        sampler.run_mcmc(p0, n_steps)
        if hasattr(sampler, 'get_chain'):
            # emcee 3.x: get_chain() is (n_steps, n_walkers, n_dim)
            chain = np.swapaxes(sampler.get_chain(), 0, 1)
        else:
            # emcee 2.x: .chain is already (n_walkers, n_steps, n_dim)
            chain = sampler.chain
    except ImportError:
        chain = _stretch_move_sampler(f, p0, n_steps, rng)

    samples = chain[:, n_burn_in:, :].reshape((-1, n_dim))

    if not quiet:
        try:
            import corner
            import matplotlib.pyplot as plt
            corner.corner(chain.reshape((-1, n_dim)), show_titles=True,
                          labels=names, range=[0.99] * len(names), truths=guess)
            plt.show()
        except ImportError:
            warnings.warn("corner/matplotlib not available for diagnostics plot")

    fit_result = np.median(samples, axis=0)
    fit_result_dict = OrderedDict(
        (names[i], fit_result[i]) for i in range(len(names)))
    # Evaluate through the objective, which has the fixed kwargs baked in:
    # ll(**medians) alone would drop them and report the LL at the wrong
    # point (e.g. the conditional fits of a profile-LR interval)
    best_ll = float(f(fit_result))

    if return_errors:
        l, r = np.percentile(samples, 100 * stats.norm.cdf([-1, 1]), axis=0)
        fit_errors = (r - l) / 2
        fit_errors_dict = OrderedDict(
            (names[i], fit_errors[i]) for i in range(len(names)))
        return fit_result_dict, best_ll, fit_errors_dict
    if return_samples:
        return fit_result_dict, best_ll, samples
    return fit_result_dict, best_ll


def _get_bestfit_routine(key):
    if hasattr(key, '__call__'):
        return key
    if key is None:
        key = DEFAULT_BESTFIT_ROUTINE
    return BESTFIT_ROUTINES[key]


def one_parameter_interval(lf, target, bound, confidence_level=0.9, kind='upper',
                           bestfit_routine=None, t_ppf=None, **kwargs):
    """Confidence interval of the given kind (central/upper/lower) on the
    parameter ``target``, from the profile-likelihood-ratio test statistic.
    :param bound: line-search bound(s): single value for upper/lower,
      2-tuple for central.
    :param t_ppf: function (hypothesis, quantile) -> critical value of the test
      statistic -2 log L(test)/L(bestfit) (e.g. from a Neyman construction).
      Defaults to Wilks' theorem.
    :param kwargs: passed to the bestfit routine (fixing parameters, etc).
    """
    fit = _get_bestfit_routine(bestfit_routine)
    if target is None:
        source_names = getattr(lf, 'source_name_list', None)
        if not source_names:
            raise ValueError(
                "target=None needs a likelihood with sources (to default to "
                "the last source's rate multiplier); pass target explicitly")
        target = source_names[-1] + RATE_SUFFIX

    # Denominator of the likelihood ratio: the unconditional best fit
    best, ll_best = fit(lf, **kwargs)
    x_best = best[target]

    def excess(hypothesis, quantile):
        """t(hypothesis) minus its critical value; brentq finds the zero."""
        if t_ppf is not None:
            critical = t_ppf(hypothesis, quantile)
        else:
            # Wilks: stats.norm.ppf(q)**2 == stats.chi2(1).ppf(2q - 1);
            # the chi2 form is quoted for central CIs, the normal for bounds
            critical = stats.norm.ppf(quantile) ** 2
        one_sided_zero = ((kind == 'upper' and hypothesis <= x_best)
                          or (kind == 'lower' and hypothesis >= x_best))
        if one_sided_zero:
            return -critical
        _, ll_cond = fit(lf, **{target: hypothesis, **kwargs})
        return 2 * (ll_best - ll_cond) - critical

    if kind == 'upper':
        return brentq(excess, x_best, bound, args=(confidence_level,))
    if kind == 'lower':
        return brentq(excess, bound, x_best, args=(1 - confidence_level,))
    if kind == 'central':
        tail = (1 - confidence_level) / 2
        return (brentq(excess, bound[0], x_best, args=(tail,)),
                brentq(excess, x_best, bound[1], args=(1 - tail,)))
    raise ValueError("Unknown interval kind %s" % kind)


def plot_likelihood_ratio(lf, *space, vmax=15, bestfit_routine=None,
                          plot_kwargs=None, **kwargs):
    """Plot the -loglikelihood ratio in a 1D or 2D parameter space, profiling the
    remaining parameters at each point.
    :param space: tuples (dim_name, points); further kwargs are passed to lf and
      parameters not passed are fitted at each point.

    This is the reference-style host loop (one scipy fit per grid point;
    reference: blueice/inference.py:392-443). For dense grids, the same
    surface computes at toy-ensemble throughput on the device via
    :meth:`blueice_tpu_torch.parallel.toys.BinnedToyStudy.profile_map` (t/2
    is this function's ratio).
    """
    import itertools
    import matplotlib.pyplot as plt

    if len(space) not in (1, 2):
        raise ValueError("Can't handle %d dimensions" % len(space))
    fit = _get_bestfit_routine(bestfit_routine)
    plot_kwargs = plot_kwargs or {}
    dims = [name for name, _ in space]
    grids = [np.asarray(pts) for _, pts in space]

    # Profile the remaining parameters at every grid point
    lls = np.array([fit(lf, **{**dict(zip(dims, point)), **kwargs})[1]
                    for point in itertools.product(*grids)])
    ratio = (np.nanmax(lls) - lls).reshape([len(g) for g in grids])

    label = "-Log likelihood ratio"
    if len(space) == 1:
        plt.plot(grids[0], ratio, **plot_kwargs)
        plt.ylim(0, vmax)
        plt.ylabel(label)
        plt.xlabel(dims[0])
        plt.xlim(grids[0].min(), grids[0].max())
    else:
        xx, yy = np.meshgrid(*grids)
        plt.pcolormesh(xx, yy, ratio.T, vmax=vmax, **plot_kwargs)
        plt.colorbar(label=label)
        plt.xlabel(dims[0])
        plt.ylabel(dims[1])


def bestfit_emcee_device(ll, device=None, **kwargs):
    """Device-side ensemble MCMC twin of :func:`bestfit_emcee`: the
    stretch-move chain runs on the device over the compiled likelihood,
    each half-ensemble scored by one call of the fitter's value op (see
    :mod:`blueice_tpu_torch.parallel.mcmc`). Needs prepare() + set_data();
    the host sampler remains the path for likelihoods that are not
    compiled.

    :param device: where the likelihood compiles (None: the card, raising
      without CUDA; 'cpu' for the CPU).
    """
    from .parallel.mcmc import bestfit_emcee_device as _impl
    return _impl(ll, device=device, **kwargs)


BESTFIT_ROUTINES = dict(scipy=bestfit_scipy, minuit=bestfit_minuit,
                        emcee=bestfit_emcee, jax=bestfit_jax,
                        emcee_device=bestfit_emcee_device)
