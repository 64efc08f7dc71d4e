"""Batched binned toy-MC studies: simulate -> fit, batched over toys on one
device.

Counterpart of :mod:`blueice_tpu.parallel.toys` for binned studies. The
sufficient statistic of a binned likelihood is the per-bin count, so toys are
Poisson draws over the expected count tensor (``torch.poisson`` with an
explicit ``torch.Generator``), and every fit of the ensemble runs as one
batch. Multi-device sharding (``mesh=``) and the unbinned study are not
ported yet (ROADMAP queue 1 items 14 and 9).
"""

from collections import OrderedDict

import numpy as np
import torch

from ..compile import build_logl
from .fitter import make_toy_fitter, check_fixed_in_bounds

__all__ = ['BinnedToyStudy', 'ToyResults']


def _refine_stragglers(fit_long, counts, x, ll, it, cap, fixed_values=None):
    """Straggler pass for lockstep batched fits.

    A batched Newton loop runs until its slowest toy finishes, so stage 1
    runs with a short iteration cap; this pass re-fits the toys that hit it
    with the long-cap fitter, warm-started from their stage-1 points, and
    keeps each refit that did not lower the likelihood.

    :param fit_long: batched fitter (data, fixed_values, x0) -> (x, ll, it).
    :return: (x, ll, it) numpy arrays with stragglers refined, plus the
      straggler count.
    """
    it = np.array(it)
    x = np.array(x)
    ll = np.array(ll)
    idx = np.flatnonzero(it >= cap)
    if idx.size == 0:
        return x, ll, it, 0
    sel = torch.as_tensor(idx, device=counts.device)
    xs, lls, its = (v.cpu().numpy() for v in
                    fit_long(counts[sel], fixed_values, x0=x[idx]))
    better = lls >= ll[idx]
    x[idx[better]] = xs[better]
    ll[idx[better]] = lls[better]
    it[idx] = cap + its
    return x, ll, it, idx.size


def _warm_cols(names_free, names_cond):
    """Free-fit columns that warm-start the conditional fit, or None when
    the conditional names are not a subset of the free ones."""
    if set(names_cond) <= set(names_free):
        return [names_free.index(n) for n in names_cond]
    return None


def _check_target_not_fixed(target, fixed):
    """A fixed profile target would constrain the 'free' fit too, so t
    would not be a profile-likelihood-ratio statistic."""
    if target in (fixed or {}):
        raise ValueError(
            "the profile target %r cannot also be in fixed= — a fixed "
            "target would constrain the free fit, so t would not be a "
            "profile-likelihood-ratio statistic" % (target,))


def _freeze_opts(d):
    """Hashable cache key of an options dict."""
    return tuple(sorted((d or {}).items()))


class ToyResults:
    """Results of a batched toy study: parameter arrays keyed by name, the
    maximum log likelihoods, and Newton iteration counts."""

    def __init__(self, names, x, max_ll, n_iter):
        self.names = list(names)
        self.x = np.asarray(x)
        self.max_ll = np.asarray(max_ll)
        self.n_iter = np.asarray(n_iter)

    def __getitem__(self, name):
        return self.x[:, self.names.index(name)]

    def as_dict(self):
        d = OrderedDict((n, self[n]) for n in self.names)
        d['max_ll'] = self.max_ll
        return d

    def __repr__(self):
        return "ToyResults(n_toys=%d, params=%s)" % (len(self.max_ll),
                                                     self.names)


class BinnedToyStudy:
    """Batched binned-likelihood toy fits on one device.

    :param lf: a prepared (data not required) BinnedLogLikelihood.
    :param dtype: tensor dtype (None: float32 on CUDA, float64 on the CPU).
    :param device: torch device of the study ('cpu' default, 'cuda').
    :param engine: fit engine, see
      :func:`~blueice_tpu_torch.parallel.fitter.make_toy_fitter`.
    :param two_stage: re-fit the toys that hit the stage-1 iteration cap
      with a 4x cap, warm-started (see :func:`_refine_stragglers`).
    :param profile_mode: 'fused' or 'split' — accepted for the JAX
      package's signature; both run the same path here (the split exists
      there to keep XLA programs small).
    :param polish: post-convergence coordinate-sweep rounds per fit.
    """

    def __init__(self, lf, dtype=None, device=None, max_iter=60, tol=1e-8,
                 engine='auto', two_stage=True, profile_mode='fused',
                 polish=4):
        self.lf = lf
        self.compiled = build_logl(lf, dtype=dtype, device=device)
        self.device = self.compiled.device
        self.max_iter = max_iter
        self.tol = tol
        self.engine = engine
        self.two_stage = two_stage
        self.polish = polish
        if profile_mode not in ('fused', 'split'):
            raise ValueError("profile_mode must be 'fused' or 'split'")
        self.profile_mode = profile_mode
        self._fit_cache = {}
        self._profile_cache = {}

    def _make_fitter(self, **opts):
        """(stage-1 fit, long-cap fit or None, names)."""
        opts.setdefault('polish', self.polish)
        fit, names = make_toy_fitter(
            self.compiled, max_iter=self.max_iter, tol=self.tol,
            engine=self.engine, **opts)
        fit_long = None
        if self.two_stage and names:
            fit_long, _ = make_toy_fitter(
                self.compiled, max_iter=4 * self.max_iter, tol=self.tol,
                engine=self.engine, **opts)
        return fit, fit_long, names

    def expected_counts(self, **truth):
        """Expected counts per analysis-space bin at the truth parameters."""
        return self.compiled.expected_counts(
            self.compiled.params_from_kwargs(**truth))

    def _generator(self, seed_or_generator):
        if isinstance(seed_or_generator, torch.Generator):
            return seed_or_generator
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed_or_generator))
        return gen

    def simulate(self, seed_or_generator, n_toys, truth=None, mesh=None):
        """(n_toys, *bins) Poisson count tensors at the truth parameters,
        drawn on the study's device.

        :param seed_or_generator: an int seed or a torch.Generator on the
          study's device.
        """
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device toy sharding) is not ported yet "
                "(ROADMAP queue 1 item 14)")
        expected = self.expected_counts(**(truth or {}))
        rates = expected.expand((int(n_toys),) + tuple(expected.shape))
        return torch.poisson(rates.contiguous(),
                             generator=self._generator(seed_or_generator))

    def _fit_entry(self, fixed=None, guess=None):
        key = (_freeze_opts(fixed), _freeze_opts(guess))
        if key not in self._fit_cache:
            self._fit_cache[key] = self._make_fitter(fixed=fixed, guess=guess)
        return self._fit_cache[key]

    def _counts(self, counts):
        return torch.as_tensor(counts, dtype=self.compiled.dtype,
                               device=self.device)

    def fit_toys(self, counts, fixed=None, guess=None):
        """Fit every toy dataset; returns ToyResults."""
        counts = self._counts(counts)
        fit, fit_long, names = self._fit_entry(fixed, guess)
        x, ll, it = (v.cpu().numpy() for v in fit(counts))
        if fit_long is not None:
            x, ll, it, _ = _refine_stragglers(fit_long, counts, x, ll, it,
                                              self.max_iter)
        return ToyResults(names, x, ll, it)

    def run(self, seed_or_generator, n_toys, truth=None, fixed=None,
            mesh=None):
        """Simulate and fit n_toys datasets in one go."""
        counts = self.simulate(seed_or_generator, n_toys, truth, mesh)
        return self.fit_toys(counts, fixed=fixed)

    def profile_ts(self, seed_or_generator, n_toys, target, hypothesis,
                   truth=None, mesh=None, fixed=None):
        """Profile-likelihood-ratio test statistic t = 2(LL_free - LL_cond)
        for each toy, with the conditional fit fixing ``target=hypothesis``.

        :return: (t array (n_toys,), free ToyResults, conditional ToyResults)
        """
        counts = self.simulate(seed_or_generator, n_toys, truth, mesh)
        return self._run_profile(counts, target, hypothesis, fixed)

    def _run_profile(self, counts, target, hypothesis, fixed):
        _check_target_not_fixed(target, fixed)
        check_fixed_in_bounds(self.compiled, {target: hypothesis})
        counts = self._counts(counts)
        (fit_free, free_long, fit_cond, cond_long, names_free, names_cond,
         warm_cols) = self._profile_fn(target, fixed)
        h = [float(hypothesis)]
        xf, llf, itf = fit_free(counts)
        x0c = xf[:, warm_cols] if warm_cols else None
        xc, llc, itc = fit_cond(counts, h, x0=x0c)
        t = torch.clamp(2.0 * (llf - llc), min=0.0)
        xf, llf, itf, xc, llc, itc, t = (
            v.cpu().numpy() for v in (xf, llf, itf, xc, llc, itc, t))
        if free_long is not None:
            xf, llf, itf = _refine_stragglers(
                free_long, counts, xf, llf, itf, self.max_iter)[:3]
            xc, llc, itc = _refine_stragglers(
                cond_long, counts, xc, llc, itc, self.max_iter,
                fixed_values=h)[:3]
            t = np.maximum(2.0 * (llf - llc), 0.0)
        return (t, ToyResults(names_free, xf, llf, itf),
                ToyResults(names_cond, xc, llc, itc))

    def _profile_fn(self, target, fixed):
        """The free and conditional fitters (hypothesis as a runtime value),
        their long-cap refiners — paired: stragglers are refined in both fits
        or neither, since a one-sided refinement would bias t — and the
        free-fit columns that warm-start the conditional fit."""
        fixed = dict(fixed or {})
        key = (target, _freeze_opts(fixed))
        if key not in self._profile_cache:
            fit_free, free_long, names_free = self._make_fitter(fixed=fixed)
            fit_cond, cond_long, names_cond = self._make_fitter(
                fixed=fixed, runtime_fixed=[target])
            if cond_long is None or not names_cond:
                free_long = cond_long = None
            self._profile_cache[key] = (
                fit_free, free_long, fit_cond, cond_long, names_free,
                names_cond, _warm_cols(names_free, names_cond))
        return self._profile_cache[key]
