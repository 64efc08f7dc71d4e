"""Batched toy-MC studies: simulate -> fit, batched over toys on one device.

Counterpart of :mod:`blueice_tpu.parallel.toys`:

* :class:`BinnedToyStudy`: the sufficient statistic of a binned likelihood
  is the per-bin count, so toys are Poisson draws over the expected count
  tensor (``torch.poisson`` with an explicit ``torch.Generator``).
* :class:`UnbinnedToyStudy`: toys are event sets drawn from the per-(source,
  bin) expectation at the truth point (uniform inside a bin), padded to
  ``n_max`` with an event mask, and scored at every anchor point into a
  (B, G, S, E) density tensor.

Every fit of an ensemble runs as one batch. Multi-device sharding
(``mesh=``) is not ported yet (ROADMAP queue 1 item 14).
"""

import itertools
import warnings
from collections import OrderedDict
from functools import reduce

import numpy as np
import torch

from ..compile import build_logl
from .fitter import make_toy_fitter, check_fixed_in_bounds, unbinned_center

__all__ = ['BinnedToyStudy', 'UnbinnedToyStudy', 'ToyResults']

#: toys per scoring step of :meth:`UnbinnedToyStudy.score_events` (bounds
#: the (toys, G*S, E) gather's memory)
SCORE_CHUNK = 32


def _refine_stragglers(fit_long, data, x, ll, it, cap, fixed_values=None,
                       idx=None):
    """Straggler pass for lockstep batched fits.

    A batched Newton loop runs until its slowest toy finishes, so stage 1
    runs with a short iteration cap; this pass re-fits the toys that hit it
    (or the toys ``idx``) with the long-cap fitter, warm-started from their
    stage-1 points, and keeps each refit that did not lower the likelihood.

    :param fit_long: batched fitter (data, fixed_values, x0, lanes) ->
      (x, ll, it), run on the lanes ``idx`` of ``data``.
    :return: (x, ll, it) numpy arrays with stragglers refined, plus the
      straggler count.
    """
    it = np.array(it)
    x = np.array(x)
    ll = np.array(ll)
    if idx is None:
        idx = np.flatnonzero(it >= cap)
    if idx.size == 0:
        return x, ll, it, 0
    xs, lls, its = (v.cpu().numpy() for v in
                    fit_long(data, fixed_values, x0=x[idx], lanes=idx))
    better = lls >= ll[idx]
    x[idx[better]] = xs[better]
    ll[idx[better]] = lls[better]
    it[idx] = it[idx] + its
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


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-device toy sharding) is not ported yet "
            "(ROADMAP queue 1 item 14)")


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


class _ToyStudy:
    """What the binned and unbinned studies share: the compiled likelihood
    on the study's device, the fitters (stage 1 and the long-cap refiners)
    and the profile fit with paired straggler refinement. A subclass turns
    a toy batch into the fitters' ``data`` (:meth:`_fit_data`)."""

    def __init__(self, lf, dtype, device, max_iter, tol, engine, two_stage,
                 polish):
        self.lf = lf
        self.compiled = build_logl(lf, dtype=dtype, device=device)
        self.device = self.compiled.device
        self.max_iter = max_iter
        self.tol = tol
        self.engine = engine
        self.two_stage = two_stage
        self.polish = polish
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

    def _generator(self, seed_or_generator):
        if isinstance(seed_or_generator, torch.Generator):
            return seed_or_generator
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed_or_generator))
        return gen

    def _fit_entry(self, fixed=None, guess=None):
        key = (_freeze_opts(fixed), _freeze_opts(guess))
        if key not in self._fit_cache:
            self._fit_cache[key] = self._make_fitter(fixed=fixed, guess=guess)
        return self._fit_cache[key]

    def _fit(self, data, fixed=None, guess=None):
        fit, fit_long, names = self._fit_entry(fixed, guess)
        x, ll, it = (v.cpu().numpy() for v in fit(data))
        if fit_long is not None:
            x, ll, it, _ = _refine_stragglers(fit_long, data, x, ll, it,
                                              self.max_iter)
        return ToyResults(names, x, ll, it)

    def _profile(self, data, target, hypothesis, fixed):
        """(t, free ToyResults, conditional ToyResults) of the fitters'
        ``data``. Stragglers are refined in pairs: a toy that hit the
        stage-1 cap in either fit is refit in both, since a one-sided
        refinement would bias t."""
        _check_target_not_fixed(target, fixed)
        check_fixed_in_bounds(self.compiled, {target: hypothesis})
        (fit_free, free_long, fit_cond, cond_long, names_free, names_cond,
         warm_cols) = self._profile_fn(target, fixed)
        h = [float(hypothesis)]
        xf, llf, itf = fit_free(data)
        x0c = xf[:, warm_cols] if warm_cols else None
        xc, llc, itc = fit_cond(data, h, x0=x0c)
        xf, llf, itf, xc, llc, itc = (
            v.cpu().numpy() for v in (xf, llf, itf, xc, llc, itc))
        if free_long is not None:
            idx = np.flatnonzero((itf >= self.max_iter)
                                 | (itc >= self.max_iter))
            xf, llf, itf = _refine_stragglers(
                free_long, data, xf, llf, itf, self.max_iter, idx=idx)[:3]
            xc, llc, itc = _refine_stragglers(
                cond_long, data, xc, llc, itc, self.max_iter,
                fixed_values=h, idx=idx)[:3]
        t = np.maximum(2.0 * (llf - llc), 0.0)
        return (t, ToyResults(names_free, xf, llf, itf),
                ToyResults(names_cond, xc, llc, itc))

    def _profile_fn(self, target, fixed):
        """The free and conditional fitters (hypothesis as a runtime value),
        their long-cap refiners (both or neither) and the free-fit columns
        that warm-start the conditional fit."""
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


class BinnedToyStudy(_ToyStudy):
    """Batched binned-likelihood toy fits on one device.

    :param lf: a prepared (data not required) BinnedLogLikelihood.
    :param dtype: tensor dtype (None: float32 on CUDA, float64 on the CPU).
    :param device: torch device of the study (None: the CUDA device, which
      raises without CUDA; 'cpu' for the CPU).
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
        super().__init__(lf, dtype, device, max_iter, tol, engine, two_stage,
                         polish)
        if profile_mode not in ('fused', 'split'):
            raise ValueError("profile_mode must be 'fused' or 'split'")
        self.profile_mode = profile_mode

    def expected_counts(self, **truth):
        """Expected counts per analysis-space bin at the truth parameters."""
        return self.compiled.expected_counts(
            self.compiled.params_from_kwargs(**truth))

    def simulate(self, seed_or_generator, n_toys, truth=None, mesh=None):
        """(n_toys, *bins) Poisson count tensors at the truth parameters,
        drawn on the study's device.

        :param seed_or_generator: an int seed or a torch.Generator on the
          study's device.
        """
        _no_mesh(mesh)
        expected = self.expected_counts(**(truth or {}))
        rates = expected.expand((int(n_toys),) + tuple(expected.shape))
        return torch.poisson(rates.contiguous(),
                             generator=self._generator(seed_or_generator))

    def _counts(self, counts):
        return torch.as_tensor(counts, dtype=self.compiled.dtype,
                               device=self.device)

    def fit_toys(self, counts, fixed=None, guess=None):
        """Fit every toy dataset; returns ToyResults."""
        return self._fit(self._counts(counts), fixed, guess)

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
        return self._profile(self._counts(counts), target, hypothesis, fixed)

    # The reference's grid, scan and map surface. Methods (not attributes
    # that fail): the reference's statistics tell a binned study from an
    # unbinned one by ``hasattr(study, 'observed_counts')``.

    def profile_ts_grid(self, *args, **kwargs):
        raise NotImplementedError(
            "BinnedToyStudy.profile_ts_grid is not ported yet (ROADMAP "
            "queue 1 item 16a)")

    def profile_ts_scan(self, *args, **kwargs):
        raise NotImplementedError(
            "BinnedToyStudy.profile_ts_scan is not ported yet (ROADMAP "
            "queue 1 item 16a)")

    def observed_counts(self, *args, **kwargs):
        raise NotImplementedError(
            "BinnedToyStudy.observed_counts is not ported yet (ROADMAP "
            "queue 1 item 16a)")

    def profile_map(self, *args, **kwargs):
        raise NotImplementedError(
            "BinnedToyStudy.profile_map is not ported yet (ROADMAP queue 1 "
            "item 16a)")


class UnbinnedToyStudy(_ToyStudy):
    """Batched unbinned-likelihood toy fits on one device.

    Toy events are drawn from the (source, bin) expectation tensor at the
    truth point (uniform within a bin) and scored against the anchor pdf
    templates on the bin-center grid, with the interpolation the host
    sources use (``HistogramPdfSource.pdf``); analytic sources are
    represented by their pdf evaluated on that grid. Event sets are padded
    to ``n_max`` with a validity mask.

    An event set is ``(coords (B, n_max, ndim) float64, mask (B, n_max)
    bool, bins (B, n_max, ndim) int64)`` (:meth:`simulate`); the fits read
    it through :meth:`score_events` and the per-toy centering
    (:func:`~blueice_tpu_torch.parallel.fitter.unbinned_center`), computed
    once and shared by the free, conditional and refined fits.

    :param lf: a prepared UnbinnedLogLikelihood (data not required).
    :param n_max: events per toy before truncation (None: the base-model
      expectation + 6 sqrt + 10).
    :param dtype, device, max_iter, tol, engine, two_stage, polish: as for
      :class:`BinnedToyStudy`.
    """

    def __init__(self, lf, n_max=None, dtype=None, device=None, max_iter=60,
                 tol=1e-8, engine='auto', two_stage=True, polish=4):
        super().__init__(lf, dtype, device, max_iter, tol, engine, two_stage,
                         polish)
        if self.compiled.is_binned:
            raise TypeError("UnbinnedToyStudy needs an UnbinnedLogLikelihood")
        methods = {s.config.get('pdf_interpolation_method', 'linear')
                   for s in lf.base_model.sources}
        if len(methods) > 1:
            raise NotImplementedError(
                "sources with mixed pdf interpolation methods are not ported "
                "yet (ROADMAP queue 1 item 17)")
        self._method = methods.pop()
        if self._method not in ('linear', 'piecewise'):
            raise NotImplementedError(
                "pdf interpolation method %r" % (self._method,))

        space = lf.base_model.config['analysis_space']
        self.edges = [np.asarray(e, dtype=float) for _, e in space]
        self.centers = [0.5 * (e[1:] + e[:-1]) for e in self.edges]
        self.bin_volumes = reduce(np.multiply,
                                  np.ix_(*[np.diff(e) for e in self.edges]))
        self.ndim = len(self.edges)
        self.bins_shape = tuple(len(c) for c in self.centers)
        dev = self.device

        pdf = self._build_pdf_tensor()                  # (*grid, S, *bins)
        self._pdf_tensor = self.compiled._tensor(pdf)
        S = len(lf.source_name_list)
        self._pdf_rows = self._pdf_tensor.reshape(
            -1, int(np.prod(self.bins_shape))).contiguous()   # (G*S, n_bins)
        self._grid_sources = (self._pdf_rows.shape[0] // S, S)
        self._volumes = self.compiled._tensor(self.bin_volumes)
        self._edges_t = [torch.as_tensor(e, dtype=torch.float64, device=dev)
                         for e in self.edges]
        self._centers_t = [torch.as_tensor(c, dtype=torch.float64, device=dev)
                           for c in self.centers]
        self._bin_strides = [int(np.prod(self.bins_shape[d + 1:]))
                             for d in range(self.ndim)]

        if n_max is None:
            mu_tot = float(np.sum(lf.base_model.expected_events()))
            n_max = int(mu_tot + 6 * np.sqrt(mu_tot + 1) + 10)
        self.n_max = n_max

    # -- host-side template construction ------------------------------------

    def _source_pdf_grid(self, source):
        """pdf values of one source on the bin-center grid."""
        h = getattr(source, '_pdf_histogram', None)
        if h is not None:
            return np.asarray(h.values, dtype=float)
        mesh = np.meshgrid(*self.centers, indexing='ij')
        vals = source.pdf(*[m.ravel() for m in mesh])
        return np.asarray(vals, dtype=float).reshape(mesh[0].shape)

    def _build_pdf_tensor(self):
        """(*grid, n_sources, *bins) float64 pdf values of every anchor
        model's sources on the bin-center grid ((n_sources, *bins) without
        shape parameters)."""
        lf = self.lf
        if not len(lf.shape_parameters):
            return np.stack([self._source_pdf_grid(s)
                             for s in lf.base_model.sources])
        grid_shape = tuple(len(a) for a in lf.morpher.anchor_z_arrays)
        tensor = np.zeros(grid_shape + (len(lf.source_name_list),)
                          + self.bins_shape)
        for idx, zs in zip(np.ndindex(*grid_shape),
                           lf.morpher.get_anchor_points()):
            for si, s in enumerate(lf.anchor_models[tuple(zs)].sources):
                tensor[idx + (si,)] = self._source_pdf_grid(s)
        return tensor

    # -- simulation and scoring -----------------------------------------------

    def _morph_pdf(self, params):
        """The pdf tensor (n_sources, *bins) morphed to params."""
        return self.compiled._morph(self._pdf_tensor,
                                    self.compiled._clipped_zs(params)[0])

    def expected_weights(self, **truth):
        """(n_sources, *bins) expected counts per source and bin at truth.
        Warns when the truth's expectation comes within 4 sigma of the
        study's event capacity ``n_max`` (sized at construction from the
        default parameters): events beyond n_max are dropped by the
        fixed-shape sampler, which biases high-rate ensembles."""
        p = self.compiled.params_from_kwargs(**truth)
        mus = self.compiled.rates(p)
        weights = (mus.reshape((-1,) + (1,) * self.ndim)
                   * self._morph_pdf(p) * self._volumes)
        mu_tot = float(weights.sum())
        if self.n_max < mu_tot + 4 * np.sqrt(mu_tot + 1):
            warnings.warn(
                "UnbinnedToyStudy.n_max=%d is within 4 sigma of the "
                "simulated expectation (%.0f events at this truth): toys "
                "will be truncated. Construct the study with n_max >= %d."
                % (self.n_max, mu_tot,
                   int(mu_tot + 6 * np.sqrt(mu_tot + 1) + 10)),
                stacklevel=2)
        return weights

    def _sample(self, gen, weights, n_toys):
        """Event sets drawn from per-(source, bin) weights: n = min(Poisson
        (total), n_max) events per toy, each in a bin drawn with probability
        proportional to its weight summed over sources (bins with a negative
        net weight count as empty, so they are never drawn and the total
        draws from the same clamped distribution), uniform inside it.

        The CDF and the total are float64 whatever the study's dtype (a
        float32 cumsum over thousands of bins misweights the small ones)."""
        dev = self.device
        f64 = torch.float64
        wb = torch.clamp(weights.to(f64).sum(0).reshape(-1), min=0.0)
        cdf = torch.cumsum(wb, 0)
        total = cdf[-1]
        n = torch.poisson(total.expand(n_toys).contiguous(), generator=gen)
        n = torch.clamp(n, max=self.n_max).to(torch.int64)
        mask = torch.arange(self.n_max, device=dev)[None, :] < n[:, None]
        u = torch.rand((n_toys, self.n_max), generator=gen, dtype=f64,
                       device=dev)
        # cdf[j-1] < target <= cdf[j], target in (0, total]: a zero-weight
        # bin has an empty interval and is never chosen
        flat = torch.searchsorted(cdf, ((1.0 - u) * total).contiguous())
        flat = torch.clamp(flat, max=wb.shape[0] - 1)
        bins = torch.stack([(flat // st) % nb for st, nb in
                            zip(self._bin_strides, self.bins_shape)], dim=-1)
        u = torch.rand((n_toys, self.n_max, self.ndim), generator=gen,
                       dtype=f64, device=dev)
        cols = []
        for d, e in enumerate(self._edges_t):
            lo, hi = e[bins[..., d]], e[bins[..., d] + 1]
            cols.append(lo + u[..., d] * (hi - lo))
        return torch.stack(cols, dim=-1), mask, bins

    def simulate(self, seed_or_generator, n_toys, truth=None, mesh=None):
        """n_toys event sets at the truth parameters, drawn on the study's
        device: ``(coords (n_toys, n_max, ndim) float64, mask (n_toys,
        n_max) bool, bins (n_toys, n_max, ndim) int64)``.

        :param seed_or_generator: an int seed or a torch.Generator on the
          study's device.
        """
        _no_mesh(mesh)
        weights = self.expected_weights(**(truth or {}))
        return self._sample(self._generator(seed_or_generator), weights,
                            int(n_toys))

    def _score_terms(self, coords, bins):
        """[(flat bin index (n, E), weight (n, E))] of the interpolation at
        the events: one term for 'piecewise' (the event's bin), 2^ndim for
        'linear' (the cell over bin centers that holds the event: the
        sampled bin or its left neighbour, clipped to the center range)."""
        if self._method == 'piecewise':
            flat = sum(bins[..., d] * st
                       for d, st in enumerate(self._bin_strides))
            return [(flat, None)]
        cells, fracs = [], []
        for d, c in enumerate(self._centers_t):
            x = coords[..., d]
            b = bins[..., d]
            cell = torch.clamp(b - (x < c[b]).to(b.dtype), 0, c.shape[0] - 2)
            t = (torch.clamp(x, c[0], c[-1]) - c[cell]) / (c[cell + 1]
                                                           - c[cell])
            cells.append(cell)
            fracs.append(torch.clamp(t, 0.0, 1.0))
        terms = []
        for offs in itertools.product((0, 1), repeat=self.ndim):
            w, flat = None, 0
            for d, o in enumerate(offs):
                wd = fracs[d] if o else 1.0 - fracs[d]
                w = wd if w is None else w * wd
                flat = flat + (cells[d] + o) * self._bin_strides[d]
            terms.append((flat, w.to(self.compiled.dtype)))
        return terms

    def score_events(self, coords, bins):
        """(B, G, S, E) density of every anchor model's sources at the
        events of each toy (G = 1 without shape parameters), in the study's
        dtype; chunked over toys so the peak memory stays a small multiple
        of the output."""
        coords = torch.as_tensor(coords, dtype=torch.float64,
                                 device=self.device)
        bins = torch.as_tensor(bins, dtype=torch.int64, device=self.device)
        B, E = bins.shape[:2]
        G, S = self._grid_sources
        out = torch.empty((B, G, S, E), dtype=self.compiled.dtype,
                          device=self.device)
        for b0 in range(0, B, SCORE_CHUNK):
            b1 = min(B, b0 + SCORE_CHUNK)
            acc = None
            for flat, w in self._score_terms(coords[b0:b1], bins[b0:b1]):
                term = self._pdf_rows[:, flat.reshape(-1)].reshape(
                    G * S, b1 - b0, E)
                if w is not None:
                    term = term * w
                acc = term if acc is None else acc + term
            out[b0:b1] = acc.permute(1, 0, 2).reshape(b1 - b0, G, S, E)
        return out

    def _fit_data(self, events):
        """The fitters' data of an event set: (ps, mask, center)."""
        coords, mask, bins = events
        ps = self.score_events(coords, bins)
        mask = torch.as_tensor(mask, dtype=torch.bool,
                               device=self.device).contiguous()
        return ps, mask, unbinned_center(self.compiled, ps, mask)

    # -- fits ----------------------------------------------------------------------

    def fit_events(self, events, fixed=None, guess=None):
        """Fit every toy of an event set; returns ToyResults."""
        return self._fit(self._fit_data(events), fixed, guess)

    def run(self, seed_or_generator, n_toys, truth=None, fixed=None,
            mesh=None):
        """Simulate and fit n_toys event sets."""
        events = self.simulate(seed_or_generator, n_toys, truth, mesh)
        return self.fit_events(events, fixed=fixed)

    def profile_ts(self, seed_or_generator, n_toys, target, hypothesis,
                   truth=None, fixed=None, mesh=None):
        """Profile-likelihood-ratio test statistic per toy (see
        :meth:`BinnedToyStudy.profile_ts`).

        :return: (t array (n_toys,), free ToyResults, conditional ToyResults)
        """
        events = self.simulate(seed_or_generator, n_toys, truth, mesh)
        return self._run_profile(events, target, hypothesis, fixed)

    def _run_profile(self, events, target, hypothesis, fixed):
        """:meth:`profile_ts` on a given event set (coords, mask, bins)."""
        return self._profile(self._fit_data(events), target, hypothesis,
                             fixed)

    def profile_ts_grid(self, *args, **kwargs):
        raise NotImplementedError(
            "UnbinnedToyStudy.profile_ts_grid is not ported yet (ROADMAP "
            "queue 1 item 17)")

    def profile_ts_scan(self, *args, **kwargs):
        raise NotImplementedError(
            "UnbinnedToyStudy.profile_ts_scan is not ported yet (ROADMAP "
            "queue 1 item 17)")

    def profile_map(self, *args, **kwargs):
        raise NotImplementedError(
            "UnbinnedToyStudy.profile_map is not ported yet (ROADMAP queue 1 "
            "item 17)")
