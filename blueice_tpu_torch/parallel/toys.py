"""Batched toy-MC studies: simulate -> fit, batched over toys on one device.

Counterpart of :mod:`blueice_tpu.parallel.toys`:

* :class:`BinnedToyStudy`: the sufficient statistic of a binned likelihood
  is the per-bin count, so toys are Poisson draws over the expected count
  tensor (``torch.poisson`` with an explicit ``torch.Generator``). For a
  compiled LogLikelihoodSum a dataset is a tuple, one count tensor per
  child (empty for a dataset-free child); :func:`tree_map` maps over it.
* :class:`UnbinnedToyStudy`: toys are event sets drawn from the per-(source,
  bin) expectation at the truth point (uniform inside a bin), padded to
  ``n_max`` with an event mask, and scored at every anchor point into a
  (B, G, S, E) density tensor.

Every fit of an ensemble runs as one batch on the study's device. The toy
axis spreads over processes through a mesh (``mesh=`` on every entry,
:func:`make_mesh`, :mod:`blueice_tpu_torch.parallel.distributed`): one
device per process, each rank fitting its contiguous block of the toys and
every rank returning the whole, gathered result.

Seeds. Where the JAX package takes a PRNG key, the port takes
``seed_or_generator``: an int seed or a ``torch.Generator``. A key's
``fold_in(key, i)`` and ``split(key, n)`` become child int seeds
(:func:`child_seed`), and a function that draws from one seed more than
once (a free-fit pass, then the grid over the same toys) reads one int
seed from a Generator at entry (:func:`seed_of`) and uses only that seed
from then on, so every draw regenerates the same toys.
"""

import itertools
import warnings
from collections import OrderedDict
from functools import reduce

import numpy as np
import torch

from ..compile import build_logl
from . import distributed
from .fitter import (make_toy_fitter, check_fixed_in_bounds, unbinned_center,
                     tree_map)
from ..utils.progress import count, trace, traced

__all__ = ['make_mesh', 'shard_toys', 'ToyMesh', 'BinnedToyStudy',
           'UnbinnedToyStudy', 'ToyResults', 'seed_of', 'child_seed']

#: toys per scoring step of :meth:`UnbinnedToyStudy.score_events` (bounds
#: the (toys, G*S, E) gather's memory)
SCORE_CHUNK = 32


def seed_of(seed_or_generator):
    """The int seed of a call: an int as given, or one int drawn from a
    ``torch.Generator`` (which advances by that one draw)."""
    if isinstance(seed_or_generator, torch.Generator):
        return int(torch.randint(0, 2 ** 62, (1,),
                                 generator=seed_or_generator,
                                 device=seed_or_generator.device))
    return int(seed_or_generator)


def child_seed(seed, i):
    """The ``i``-th child int seed of ``seed`` (the port's
    ``jax.random.fold_in(key, i)``, and element ``i`` of
    ``jax.random.split(key, n)``): a 64-bit word of
    ``np.random.SeedSequence([seed, i])``, deterministic and independent
    across ``i``."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, int(i)])
               .generate_state(1, np.uint64)[0])


def _refine_stragglers(fit_long, data, x, ll, it, cap, fixed_values=None,
                       idx=None, lanes=None):
    """Straggler pass for lockstep batched fits.

    A batched Newton loop runs until its slowest toy finishes, so stage 1
    runs with a short iteration cap; this pass re-fits the toys that hit it
    (or the toys ``idx``) with the long-cap fitter, warm-started from their
    stage-1 points, and keeps each refit that did not lower the likelihood.

    :param fit_long: batched fitter (data, fixed_values, x0, lanes) ->
      (x, ll, it), run on the lanes ``idx`` of ``data`` (``lanes``: other
      lanes of ``data`` that hold the toys ``idx``).
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
    out = fit_long(data, fixed_values, x0=x[idx],
                   lanes=idx if lanes is None else lanes)
    with trace('sync'):
        xs, lls, its = (v.cpu().numpy() for v in out)
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


def _best_of_two(a, b):
    """Per lane, the better of two (x, max_ll, n_iter) fit results (NaN
    lls lose); the iteration counts add (both fits were paid for)."""
    xa, lla, ita = a
    xb, llb, itb = b
    lla = np.where(np.isnan(lla), -np.inf, lla)
    llb = np.where(np.isnan(llb), -np.inf, llb)
    take_a = lla >= llb
    return (np.where(take_a[:, None], xa, xb), np.maximum(lla, llb),
            ita + itb)


def _cond_scan(hypotheses, call_cond, refine_cond, llf, names_cond, cap,
               need_cond=True, gather=None):
    """The per-hypothesis conditional loop of ``profile_ts_grid``: run the
    conditional fit at each hypothesis, refine its stragglers, compute the
    statistic from the refined optima.

    :param call_cond: h -> (xc, llc, itc) tensors.
    :param refine_cond: (xc, llc, itc, h) -> refined numpy (xc, llc, itc),
      or None when no refiner exists (then the free fit was not refined
      either: a one-sided refinement would bias t).
    :param need_cond: when False, the conditional parameters are not copied
      to the host (unless stragglers need them); the conds list then holds
      None.
    :param gather: tensors -> numpy arrays of the whole toy axis
      (:meth:`_Whole.gather`, or a shard's gather across the ranks).
    :return: (ts (n_hypotheses, n_toys), list of conditional ToyResults).
    """
    gather = gather or _Whole.gather
    ts, conds = [], []
    for h in hypotheses:
        xc_d, llc_d, itc_d = call_cond(float(h))
        llc, itc = gather(llc_d, itc_d)
        refine = refine_cond is not None and (itc >= cap).any()
        xc = gather(xc_d)[0] if need_cond or refine else None
        if refine:
            xc, llc, itc = refine_cond(xc, llc, itc, float(h))
        ts.append(np.maximum(2.0 * (llf - llc), 0.0))
        conds.append(ToyResults(names_cond, xc, llc, itc)
                     if need_cond else None)
    return np.stack(ts), conds


def _check_map_space(compiled, space, fixed=None):
    """Validate a profile_map ``space``: 1 or 2 distinct (name, grid)
    pairs, none also in ``fixed`` (a duplicated name would let the last
    grid value win, a fixed one would constrain the free fit), nonempty
    grids, every grid point inside the parameter's range. Returns (names,
    grids)."""
    space = list(space)
    if len(space) not in (1, 2):
        raise ValueError(
            "space must be 1 or 2 (name, grid) pairs, got %d" % len(space))
    targets = [name for name, _ in space]
    if len(set(targets)) != len(targets):
        raise ValueError("space names a parameter twice: %s" % targets)
    clash = sorted(set(targets) & set(fixed or {}))
    if clash:
        raise ValueError(
            "space parameters %s are also in fixed= — a fixed target would "
            "constrain the free fit too, so the map would not be a "
            "profile-LR surface" % clash)
    grids = [np.asarray(g, dtype=float).ravel() for _, g in space]
    for name, g in zip(targets, grids):
        if g.size == 0:
            raise ValueError("empty grid for %r" % name)
        for v in g:
            check_fixed_in_bounds(compiled, {name: float(v)})
    return targets, grids


def _check_target_not_fixed(target, fixed):
    """A fixed profile target would constrain the 'free' fit too, so t
    would not be a profile-likelihood-ratio statistic."""
    if target in (fixed or {}):
        raise ValueError(
            "the profile target %r cannot also be in fixed= — a fixed "
            "target would constrain the free fit, so t would not be a "
            "profile-likelihood-ratio statistic" % (target,))


def _same_device(a, b):
    """Whether two torch devices are one (an index-less CUDA device is the
    current one)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != 'cuda':
        return True
    current = torch.cuda.current_device()
    return (a.index if a.index is not None else current) == (
        b.index if b.index is not None else current)


def _freeze_opts(d):
    """Hashable cache key of an options dict."""
    return tuple(sorted((d or {}).items()))


class ToyMesh:
    """The toy axis of a study spread over processes: the port's
    counterpart of the JAX package's 1-d device mesh.

    JAX partitions one program over the devices of a process; torch runs
    one process per device (``torch.distributed``). So a mesh is this
    process's place in a process group: the group (None: this process
    alone), its world size, this process's rank, this rank's torch device
    (None: the study's own) and the axis name. Make one with
    :func:`make_mesh`, or :func:`~blueice_tpu_torch.parallel.distributed.
    global_mesh` after
    :func:`~blueice_tpu_torch.parallel.distributed.init_distributed`."""

    def __init__(self, group=None, world_size=1, rank=0, device=None,
                 axis_name='toys'):
        world_size, rank = int(world_size), int(rank)
        if not 0 <= rank < world_size:
            raise ValueError("rank %d outside a world of %d"
                             % (rank, world_size))
        if group is None and world_size != 1:
            raise ValueError("a mesh of %d ranks needs their process group"
                             % world_size)
        self.group = group
        self.world_size = world_size
        self.rank = rank
        self.device = None if device is None else torch.device(device)
        self.axis_name = axis_name

    @property
    def size(self):
        """Devices on the mesh (the JAX mesh's ``devices.size``)."""
        return self.world_size

    def block(self, n_toys):
        """(lo, hi): this rank's contiguous rows of an ``n_toys`` axis."""
        if n_toys % self.world_size:
            raise ValueError(
                "%d toys do not split over %d ranks: round the count up "
                "(_round_up_toys)" % (n_toys, self.world_size))
        per = n_toys // self.world_size
        return self.rank * per, (self.rank + 1) * per

    def __repr__(self):
        return ("ToyMesh(%s=%d, rank=%d, device=%s%s)"
                % (self.axis_name, self.world_size, self.rank, self.device,
                   '' if self.group is None else ', grouped'))


def make_mesh(devices=None, axis_name='toys'):
    """A mesh over the toy axis (:class:`ToyMesh`).

    In a process with no process group: this process alone, on
    ``devices[0]`` (default: the study's own device). In a process of an
    initialised group (:func:`~blueice_tpu_torch.parallel.distributed.
    init_distributed`): every rank of the group, this rank on its device.
    A mesh holds one device per process: more than one device raises.
    """
    devices = None if devices is None else list(devices)
    if devices is not None and len(devices) != 1:
        raise ValueError(
            "a mesh of the port holds one device per process, got %d: run "
            "one process per device and join them with "
            "blueice_tpu_torch.parallel.distributed.init_distributed (then "
            "make_mesh() or global_mesh())" % len(devices))
    device = torch.device(devices[0]) if devices else None
    if distributed.is_initialized():
        import torch.distributed as dist
        return ToyMesh(dist.group.WORLD, dist.get_world_size(),
                       dist.get_rank(), device or distributed.rank_device(),
                       axis_name)
    return ToyMesh(None, 1, 0, device, axis_name)


def _round_up_toys(n_toys, mesh):
    size = mesh.size
    return -(-int(n_toys) // size) * size


def _n_toys(toys):
    """Toys in an ensemble (a tensor, or a tuple of them: a Sum's counts,
    an unbinned event set)."""
    return (toys[0] if isinstance(toys, (tuple, list)) else toys).shape[0]


def _take(toys, rows):
    """The toys ``rows`` (a slice or an index array) of an ensemble."""
    if not isinstance(rows, slice):
        rows = torch.as_tensor(rows, dtype=torch.int64)
    return tree_map(lambda v: torch.as_tensor(v)[rows], toys)


def shard_toys(mesh, tree, axis_name='toys'):
    """This rank's contiguous block of rows of every leaf of ``tree``
    (leading axis the whole toy axis, a multiple of the world size), on
    the mesh's device: the rows the JAX package's ``shard_toys`` places on
    this rank's device. One process: the whole tree."""
    lo, hi = mesh.block(_n_toys(tree))
    rows = _take(tree, slice(lo, hi))
    if mesh.device is None:
        return rows
    return tree_map(lambda v: v.to(mesh.device), rows)


class _Whole:
    """The fitters' ``data`` of a whole ensemble, fitted in this process:
    what a stage fits, gathers and refines is every toy."""

    def __init__(self, data):
        self.data = data

    def stage(self, fit, fixed_values=None, x0=None):
        return fit(self.data, fixed_values, x0=x0)

    @staticmethod
    @traced('study.gather')
    def gather(*tensors):
        with trace('sync'):
            return [v.cpu().numpy() for v in tensors]

    @staticmethod
    def local(x):
        return x

    @traced('study.refine')
    def refine(self, fit_long, x, ll, it, cap, fixed_values=None, idx=None):
        return _refine_stragglers(fit_long, self.data, x, ll, it, cap,
                                  fixed_values, idx)


class _Shard(_Whole):
    """This rank's block of an ensemble that every rank holds whole
    (``toys``): a stage fits the block alone (its fit data, for an
    unbinned study the scored events and their centering, made for the
    block only), :meth:`gather` returns the whole toy axis on every rank,
    and the straggler pass runs after the gather on the stragglers of the
    whole axis, identically on every rank."""

    def __init__(self, study, mesh, toys):
        lo, hi = mesh.block(_n_toys(toys))
        self.rows = slice(lo, hi)
        super().__init__(study._prepare(_take(toys, self.rows)))
        self.study, self.mesh, self.toys = study, mesh, toys
        self._stragglers = (None, None)

    @traced('study.gather')
    def gather(self, *tensors):
        return distributed.gather_to_hosts(tensors, self.mesh)

    def local(self, x):
        return x[self.rows]

    @traced('study.refine')
    def refine(self, fit_long, x, ll, it, cap, fixed_values=None, idx=None):
        if idx is None:
            idx = np.flatnonzero(np.asarray(it) >= cap)
        if idx.size == 0:
            return np.array(x), np.array(ll), np.array(it), 0
        key, data = self._stragglers
        if key != tuple(idx):
            data = self.study._prepare(_take(self.toys, idx))
            self._stragglers = (tuple(idx), data)
        return _refine_stragglers(fit_long, data, x, ll, it, cap,
                                  fixed_values, idx, np.arange(idx.size))


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

    def _mesh(self, mesh):
        """``mesh`` checked against the study (None stays None)."""
        if mesh is None:
            return None
        if not isinstance(mesh, ToyMesh):
            raise TypeError(
                "mesh must be a ToyMesh (parallel.make_mesh or "
                "parallel.distributed.global_mesh), got %s"
                % type(mesh).__name__)
        if mesh.device is not None and not _same_device(mesh.device,
                                                        self.device):
            raise ValueError("the mesh's device %s is not the study's %s"
                             % (mesh.device, self.device))
        return mesh

    def _ensemble(self, toys, mesh=None):
        """The fitters' view of an ensemble: whole in this process, or
        this rank's block of it under a grouped mesh."""
        if mesh is None or mesh.group is None:
            return _Whole(self._prepare(toys))
        return _Shard(self, mesh, toys)

    def _draw_args(self, seed_or_generator, n_toys, mesh):
        """(seed, n_toys) of a draw under ``mesh`` (see
        :func:`~blueice_tpu_torch.parallel.distributed._prepare_ensemble`)."""
        mesh = self._mesh(mesh)
        if mesh is None:
            return seed_or_generator, int(n_toys)
        n_toys, seed = distributed._prepare_ensemble(seed_or_generator,
                                                     n_toys, mesh)
        return seed, n_toys

    @traced('study.fit')
    def _fit(self, ens, fixed=None, guess=None):
        fit, fit_long, names = self._fit_entry(fixed, guess)
        with trace('study.stage', fit='free'):
            out = ens.stage(fit)
        x, ll, it = ens.gather(*out)
        count('study.toys', len(it))
        if fit_long is not None:
            x, ll, it, n = ens.refine(fit_long, x, ll, it, self.max_iter)
            count('study.refit_toys', n)
        return ToyResults(names, x, ll, it)

    @traced('study.profile')
    def _profile(self, ens, target, hypothesis, fixed):
        """(t, free ToyResults, conditional ToyResults) of an ensemble
        (:meth:`_ensemble`). Stragglers are refined in pairs: a toy that
        hit the stage-1 cap in either fit is refit in both, since a
        one-sided refinement would bias t."""
        _check_target_not_fixed(target, fixed)
        check_fixed_in_bounds(self.compiled, {target: hypothesis})
        (fit_free, free_long, fit_cond, cond_long, names_free, names_cond,
         warm_cols) = self._profile_fn(target, fixed)
        h = [float(hypothesis)]
        with trace('study.stage', fit='free'):
            xf, llf, itf = ens.stage(fit_free)
        x0c = xf[:, warm_cols] if warm_cols else None
        with trace('study.stage', fit='cond'):
            xc, llc, itc = ens.stage(fit_cond, h, x0=x0c)
        xf, llf, itf, xc, llc, itc = ens.gather(xf, llf, itf, xc, llc, itc)
        count('study.toys', len(itf))
        if free_long is not None:
            idx = np.flatnonzero((itf >= self.max_iter)
                                 | (itc >= self.max_iter))
            # one refit of each toy, its free and conditional fit a pair
            xf, llf, itf, n = ens.refine(free_long, xf, llf, itf,
                                         self.max_iter, idx=idx)
            count('study.refit_toys', n)
            xc, llc, itc = ens.refine(cond_long, xc, llc, itc,
                                      self.max_iter, fixed_values=h,
                                      idx=idx)[:3]
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

    @traced('study.profile_grid')
    def _profile_grid(self, ens, target, hypotheses, fixed,
                      return_cond=True):
        """(ts (H, n_toys), hypotheses, free ToyResults, conditional
        ToyResults per hypothesis) of an ensemble: one free fit,
        its stragglers refined once (only where a conditional refiner
        exists), then at each hypothesis a conditional fit warm-started
        from it, with that hypothesis's own stragglers refined. (The
        pairing of :meth:`_profile` cannot apply: the free fit is shared by
        every hypothesis.)"""
        (fit_free, free_long, fit_cond, cond_long, names_free, names_cond,
         warm_cols) = self._profile_fn(target, fixed)
        with trace('study.stage', fit='free'):
            out = ens.stage(fit_free)
        xf, llf, itf = ens.gather(*out)
        # the toys enter the free fit and each hypothesis's conditional fit
        count('study.toys', len(itf) * (1 + len(hypotheses)))
        if free_long is not None:
            xf, llf, itf, n = ens.refine(free_long, xf, llf, itf,
                                         self.max_iter)
            count('study.refit_toys', n)
        x0c = ens.local(xf[:, warm_cols]) if warm_cols else None
        refine = None
        if cond_long is not None:
            def refine(xc, llc, itc, h):
                xc, llc, itc, n = ens.refine(cond_long, xc, llc, itc,
                                             self.max_iter, fixed_values=[h])
                count('study.refit_toys', n)
                return xc, llc, itc

        def call_cond(h):
            with trace('study.stage', fit='cond'):
                return ens.stage(fit_cond, [h], x0=x0c)
        ts, conds = _cond_scan(
            hypotheses, call_cond, refine, llf, names_cond, self.max_iter,
            need_cond=return_cond, gather=ens.gather)
        return ts, hypotheses, ToyResults(names_free, xf, llf, itf), conds

    def profile_ts_grid(self, seed_or_generator, target, hypotheses, n_toys,
                        truth=None, fixed=None, mesh=None, return_cond=True):
        """Profile-LR statistics of one toy ensemble across a hypothesis
        grid: the free fit runs once, then each hypothesis adds a
        conditional fit warm-started from it, all through the same two
        fitters. The engine of per-toy limits
        (:mod:`blueice_tpu_torch.parallel.limits`); :meth:`profile_ts_scan`
        draws a fresh ensemble per hypothesis instead.

        :param return_cond: False skips copying the per-hypothesis
          conditional parameters to the host (the conds list holds None).
        :return: (ts (n_hypotheses, n_toys), sorted hypotheses, free
          ToyResults, list of per-hypothesis conditional ToyResults).
        """
        _check_target_not_fixed(target, fixed)
        hypotheses = np.sort(np.asarray(hypotheses, dtype=float))
        for h in hypotheses:
            check_fixed_in_bounds(self.compiled, {target: float(h)})
        mesh = self._mesh(mesh)
        toys = self.simulate(seed_or_generator, n_toys, truth, mesh)
        return self._run_profile_grid(toys, target, hypotheses, fixed,
                                      return_cond, mesh=mesh)

    def profile_ts_scan(self, seed_or_generator, target, hypotheses, n_toys,
                        fixed=None, mesh=None, truth=None,
                        truth_at_hypothesis=True, return_free=False):
        """Profile-LR toy distributions across a hypothesis grid (the
        engine of a Neyman construction): a fresh ensemble per hypothesis,
        drawn from the child seed ``child_seed(seed, i)`` of the i-th
        hypothesis.

        :param truth_at_hypothesis: simulate each ensemble with the target
          at the hypothesis (the standard construction); otherwise at
          ``truth`` for all.
        :param return_free: also return the per-hypothesis free ToyResults.
        :return: (n_hypotheses, n_toys) t values; with ``return_free``,
          (t array, list of free ToyResults).
        """
        mesh = self._mesh(mesh)
        seed = seed_of(seed_or_generator)
        out, frees = [], []
        for i, h in enumerate(np.asarray(hypotheses, dtype=float)):
            sim_truth = dict(truth or {})
            if truth_at_hypothesis:
                sim_truth[target] = float(h)
            toys = self.simulate(child_seed(seed, i), n_toys, sim_truth, mesh)
            t, free, _ = self._run_profile(toys, target, h, fixed, mesh=mesh)
            out.append(t)
            frees.append(free)
        ts = np.stack(out)
        return (ts, frees) if return_free else ts

    def _map_fitter(self, targets, fixed):
        """(fit, names, default start) of a map's conditional lanes: one
        stage at the long cap (a map is one dataset lockstep across its
        lanes, so the straggler pass would buy nothing), the map's
        parameters fixed at run time."""
        key = (tuple(targets), _freeze_opts(fixed), 'map')
        if key not in self._profile_cache:
            fit, names = make_toy_fitter(
                self.compiled, fixed=dict(fixed or {}),
                runtime_fixed=list(targets), tol=self.tol,
                max_iter=(4 * self.max_iter if self.two_stage
                          else self.max_iter),
                engine=self.engine, polish=self.polish)
            x0 = np.array([float(self.compiled.defaults[n]) for n in names])
            self._profile_cache[key] = (fit, names, x0)
        return self._profile_cache[key]

    def _map(self, data, targets, grids, fixed, free):
        """(t, free, conditional ToyResults) of a profile map on one
        dataset: the grid's P points as lanes of one call of the map
        fitter. With a warm start (the free optimum ``free``'s columns)
        every point takes two lanes, the warm start and the default start,
        and keeps the better optimum: far from the best fit the warm start
        can sit across an anchor kink from the conditional optimum and
        stall short of it. ``data``: binned, the counts (1, N), one row a
        lane; unbinned, (ps, mask, center) of one toy, every lane on toy
        0."""
        fit, names_cond, x_cold = self._map_fitter(targets, fixed)
        warm = _warm_cols(free.names, names_cond)
        points = np.asarray(list(itertools.product(*grids)), dtype=float)
        P = len(points)
        fv, x0 = points, None
        if names_cond and warm is not None:
            fv = np.concatenate([points, points])
            x0 = np.concatenate([np.tile(free.x[0][warm], (P, 1)),
                                 np.tile(x_cold, (P, 1))])
        if self.compiled.is_binned:
            lanes = None
            data = tree_map(lambda d: d.expand(len(fv), -1).contiguous(),
                            data)
        else:
            lanes = torch.zeros(len(fv), dtype=torch.int64,
                                device=self.device)
        out = [v.cpu().numpy() for v in fit(data, fv, x0=x0, lanes=lanes)]
        if x0 is not None:
            out = _best_of_two([v[:P] for v in out], [v[P:] for v in out])
        xc, llc, itc = out
        t = np.maximum(2.0 * (free.max_ll[0] - llc), 0.0)
        return (t.reshape(tuple(len(g) for g in grids)), free,
                ToyResults(names_cond, xc, llc, itc))


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
        """Expected counts per analysis-space bin at the truth parameters.
        For a compiled LogLikelihoodSum this is a tuple with one count tensor
        per child (empty for dataset-free constraint terms)."""
        return self.compiled.expected_counts(
            self.compiled.params_from_kwargs(**truth))

    def simulate(self, seed_or_generator, n_toys, truth=None, mesh=None):
        """(n_toys, *bins) Poisson count tensors at the truth parameters,
        drawn on the study's device (a tuple of them, one per child, for a
        compiled Sum, drawn child after child from one generator).

        :param seed_or_generator: an int seed or a torch.Generator on the
          study's device.
        :param mesh: a :class:`ToyMesh`: n_toys is rounded up to a multiple
          of its world size (the padded toys are ordinary toys) and, in a
          process group, every rank draws the whole ensemble from one int
          seed that every rank read (see
          :func:`~blueice_tpu_torch.parallel.distributed._prepare_ensemble`),
          so toy i is the same dataset at any world size.
        """
        seed_or_generator, n_toys = self._draw_args(seed_or_generator,
                                                    n_toys, mesh)
        expected = self.expected_counts(**(truth or {}))
        gen = self._generator(seed_or_generator)

        def draw(e):
            rates = e.expand((n_toys,) + tuple(e.shape)).contiguous()
            return torch.poisson(rates, generator=gen)
        return tree_map(draw, expected)

    def _counts(self, counts):
        return tree_map(lambda c: torch.as_tensor(
            c, dtype=self.compiled.dtype, device=self.device), counts)

    _prepare = _counts

    def fit_toys(self, counts, fixed=None, guess=None):
        """Fit every toy dataset; returns ToyResults."""
        return self._fit(_Whole(self._counts(counts)), fixed, guess)

    def run(self, seed_or_generator, n_toys, truth=None, fixed=None,
            mesh=None):
        """Simulate and fit n_toys datasets in one go (under a grouped
        mesh, each rank fits its block and returns every toy's fit)."""
        mesh = self._mesh(mesh)
        counts = self.simulate(seed_or_generator, n_toys, truth, mesh)
        if mesh is None or mesh.group is None:
            return self.fit_toys(counts, fixed=fixed)
        return self._fit(self._ensemble(counts, mesh), fixed)

    def profile_ts(self, seed_or_generator, n_toys, target, hypothesis,
                   truth=None, mesh=None, fixed=None):
        """Profile-likelihood-ratio test statistic t = 2(LL_free - LL_cond)
        for each toy, with the conditional fit fixing ``target=hypothesis``.

        :param mesh: a :class:`ToyMesh`; in a process group each rank fits
          its contiguous block of the toys and every rank returns the whole
          result.
        :return: (t array (n_toys,), free ToyResults, conditional ToyResults)
        """
        mesh = self._mesh(mesh)
        counts = self.simulate(seed_or_generator, n_toys, truth, mesh)
        return self._run_profile(counts, target, hypothesis, fixed, mesh=mesh)

    def _run_profile(self, counts, target, hypothesis, fixed, mesh=None):
        return self._profile(self._ensemble(counts, mesh), target,
                             hypothesis, fixed)

    def _run_profile_grid(self, counts, target, hypotheses, fixed,
                          return_cond=True, mesh=None):
        return self._profile_grid(self._ensemble(counts, mesh), target,
                                  hypotheses, fixed, return_cond)

    def observed_counts(self, counts=None):
        """The observed count tensor of one dataset on the study's device,
        shape-checked against :meth:`expected_counts`; ``counts=None``
        takes the histogram of the likelihood's own ``set_data`` events.
        (The statistics tell a binned study from an unbinned one by this
        method.)"""
        if counts is None:
            h = getattr(self.lf, 'data_events_per_bin', None)
            if h is None:
                raise ValueError(
                    "No counts given and the likelihood has no data bound — "
                    "call lf.set_data(...) first or pass counts= explicitly "
                    "(for a compiled Sum: one count tensor per child)")
            counts = h.values

        def check(e, c):
            c = self._counts(c)
            if c.shape != e.shape:
                raise ValueError(
                    "counts shape %s does not match the analysis space %s"
                    % (tuple(c.shape), tuple(e.shape)))
            return c
        return tree_map(check, self.expected_counts(), counts)

    def profile_map(self, space, counts=None, fixed=None, _free=None):
        """Profiled likelihood-ratio map on one observed dataset:
        t(theta) = 2(LL_free - LL(theta fixed, rest profiled)) over a 1- or
        2-dimensional parameter grid, every grid point two lanes (a warm
        and a cold start) of one conditional-fit call after one free fit:
        the batched twin of ``plot_likelihood_ratio``'s per-point fits.

        :param space: 1 or 2 ``(param_name, grid values)`` pairs.
        :param counts: observed counts shaped like :meth:`expected_counts`;
          default the likelihood's ``set_data`` histogram.
        :param fixed: extra parameters held fixed everywhere.
        :param _free: a previous call's free ToyResults on the same dataset
          (``observed_interval``'s adaptive retries), which skips the free
          fit.
        :return: (t shaped ``(len(grid1)[, len(grid2)])``, free ToyResults
          (1 row), conditional ToyResults (one row per grid point, C
          order)).
        """
        targets, grids = _check_map_space(self.compiled, space, fixed)
        counts1 = tree_map(lambda c: c.reshape(1, -1),
                           self.observed_counts(counts))
        free = (_free if _free is not None
                else self._fit(_Whole(counts1), fixed))
        return self._map(counts1, targets, grids, fixed, free)


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
        # Each source scores events with its own pdf interpolation
        # method, as set_data's host pdf() does: 'linear' or 'piecewise'
        self._methods = [s.config.get('pdf_interpolation_method', 'linear')
                         for s in lf.base_model.sources]
        for method in set(self._methods) - {'linear', 'piecewise'}:
            raise NotImplementedError(
                "pdf interpolation method %r" % (method,))
        self._method = (self._methods[0]
                        if len(set(self._methods)) == 1 else None)
        self._source_wise = bool(lf.source_wise_interpolation
                                 and len(lf.shape_parameters))

        space = lf.base_model.config['analysis_space']
        self.edges = [np.asarray(e, dtype=float) for _, e in space]
        self.centers = [0.5 * (e[1:] + e[:-1]) for e in self.edges]
        self.bin_volumes = reduce(np.multiply,
                                  np.ix_(*[np.diff(e) for e in self.edges]))
        self.ndim = len(self.edges)
        self.bins_shape = tuple(len(c) for c in self.centers)
        dev = self.device
        n_bins = int(np.prod(self.bins_shape))
        S = len(lf.source_name_list)

        # The anchor pdf templates on the bin-center grid and, for scoring,
        # their rows (R, n_bins) in blocks of one method each: every
        # source's own (*sub_grid, *bins) tensor (source-wise), or the
        # (*grid, S, *bins) tensor whole (one method) or source by source
        if self._source_wise:
            self._pdf_tensor = [self.compiled._tensor(t) for t in
                                self._build_pdf_tensors_source_wise()]
            self._blocks = [(t.reshape(-1, n_bins).contiguous(), m)
                            for t, m in zip(self._pdf_tensor, self._methods)]
        else:
            self._pdf_tensor = self.compiled._tensor(self._build_pdf_tensor())
            rows = self._pdf_tensor.reshape(-1, S, n_bins)
            self._grid_sources = (rows.shape[0], S)
            self._blocks = (
                [(rows.reshape(-1, n_bins).contiguous(), self._method)]
                if self._method is not None else
                [(rows[:, s].contiguous(), m)
                 for s, m in enumerate(self._methods)])
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

    def _build_pdf_tensors_source_wise(self):
        """Per-source float64 anchor pdf tensors: (*sub_grid, *bins) over
        each morphed source's own anchor grid, (*bins) for the others."""
        lf = self.lf
        tensors = []
        for sn, base_source in zip(lf.source_name_list,
                                   lf.base_model.sources):
            if sn not in lf.source_morphers:
                tensors.append(self._source_pdf_grid(base_source))
                continue
            morpher = lf.source_morphers[sn]
            grid_shape = tuple(len(a) for a in morpher.anchor_z_arrays)
            tensor = np.zeros(grid_shape + self.bins_shape)
            for idx, anchor in zip(np.ndindex(*grid_shape),
                                   morpher.get_anchor_points()):
                tensor[idx] = self._source_pdf_grid(
                    lf.anchor_sources[sn][tuple(anchor)])
            tensors.append(tensor)
        return tensors

    # -- simulation and scoring -----------------------------------------------

    def _morph_pdf(self, params):
        """The pdf tensor (n_sources, *bins) morphed to params."""
        c = self.compiled
        return c._morph(self._pdf_tensor,
                        c._weights(c._clipped_zs(params)[0]))

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
        :param mesh: as for :meth:`BinnedToyStudy.simulate`.
        """
        seed_or_generator, n_toys = self._draw_args(seed_or_generator,
                                                    n_toys, mesh)
        weights = self.expected_weights(**(truth or {}))
        return self._sample(self._generator(seed_or_generator), weights,
                            n_toys)

    def _score_terms(self, coords, bins, method):
        """[(flat bin index (n, E), weight (n, E))] of ``method``'s
        interpolation at the events: one term for 'piecewise' (the
        event's bin), 2^ndim for 'linear' (the cell over bin centers that
        holds the event: the sampled bin or its left neighbour, clipped to
        the center range)."""
        if method == 'piecewise':
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

    def _score_block(self, rows, terms, n):
        """(n, R, E) densities of the template ``rows`` (R, n_bins) at the
        events of n toys, from the interpolation ``terms``."""
        acc = None
        for flat, w in terms:
            term = rows[:, flat.reshape(-1)].reshape(
                rows.shape[0], n, -1)
            if w is not None:
                term = term * w
            acc = term if acc is None else acc + term
        return acc.permute(1, 0, 2)

    def score_events(self, coords, bins=None):
        """The anchor densities at the events of each toy, in the study's
        dtype: (B, G, S, E) (G = 1 without shape parameters), or for a
        source-wise build a tuple of per-source (B, G_s, E) (G_s = 1 for
        an unmorphed source). Each source scores with its own
        interpolation method. ``bins``: the events' bins as
        :meth:`simulate` draws them (the sampled bin is the method's cell);
        None scores any events through
        :func:`~blueice_tpu_torch.ops.interp.interp_at_points` and
        :func:`~blueice_tpu_torch.ops.interp.piecewise_lookup`. Chunked
        over toys so the peak memory stays a small multiple of the
        output."""
        coords = torch.as_tensor(coords, dtype=torch.float64,
                                 device=self.device)
        B, E = coords.shape[:2]
        outs = [torch.empty((B, rows.shape[0], E), dtype=self.compiled.dtype,
                            device=self.device) for rows, _ in self._blocks]
        if bins is not None:
            bins = torch.as_tensor(bins, dtype=torch.int64,
                                   device=self.device)
        for b0 in range(0, B, SCORE_CHUNK):
            b1 = min(B, b0 + SCORE_CHUNK)
            if bins is None:
                for out, (rows, m) in zip(outs, self._blocks):
                    out[b0:b1] = self._score_points(rows, coords[b0:b1], m)
                continue
            terms = {}
            for out, (rows, m) in zip(outs, self._blocks):
                if m not in terms:
                    terms[m] = self._score_terms(coords[b0:b1], bins[b0:b1],
                                                 m)
                out[b0:b1] = self._score_block(rows, terms[m], b1 - b0)
        if self._source_wise:
            return tuple(outs)
        G, S = self._grid_sources
        if len(outs) == 1:
            return outs[0].reshape(B, G, S, E)
        return torch.stack(outs, dim=2)

    def _score_points(self, rows, coords, method):
        """(n, R, E) densities of the template ``rows`` at arbitrary
        events (n, E, ndim): the generic path of :meth:`score_events`."""
        from ..ops.interp import interp_at_points, piecewise_lookup
        n, E = coords.shape[:2]
        values = rows.reshape((rows.shape[0],) + self.bins_shape)
        flat = coords.reshape(n * E, self.ndim)
        if method == 'piecewise':
            out = piecewise_lookup(values, self._edges_t, flat)
        else:
            out = interp_at_points(values, self._centers_t, flat)
        return out.reshape(rows.shape[0], n, E).permute(1, 0, 2)

    def _fit_data(self, events):
        """The fitters' data of an event set: (ps, mask, center). Counts
        the toys scored and their event slots (``study.scored_toys``,
        ``study.event_slots``) from the event set's shape."""
        coords, mask, bins = events
        with trace('study.score'):
            ps = self.score_events(coords, bins)
            count('study.scored_toys', coords.shape[0])
            count('study.event_slots', coords.shape[0] * coords.shape[1])
        mask = torch.as_tensor(mask, dtype=torch.bool,
                               device=self.device).contiguous()
        with trace('study.center'):
            center = unbinned_center(self.compiled, ps, mask)
        return ps, mask, center

    _prepare = _fit_data

    # -- fits ----------------------------------------------------------------------

    def fit_events(self, events, fixed=None, guess=None):
        """Fit every toy of an event set; returns ToyResults."""
        return self._fit(_Whole(self._fit_data(events)), fixed, guess)

    def run(self, seed_or_generator, n_toys, truth=None, fixed=None,
            mesh=None):
        """Simulate and fit n_toys event sets (a grouped mesh as for
        :meth:`BinnedToyStudy.run`)."""
        mesh = self._mesh(mesh)
        events = self.simulate(seed_or_generator, n_toys, truth, mesh)
        if mesh is None or mesh.group is None:
            return self.fit_events(events, fixed=fixed)
        return self._fit(self._ensemble(events, mesh), fixed)

    def profile_ts(self, seed_or_generator, n_toys, target, hypothesis,
                   truth=None, fixed=None, mesh=None):
        """Profile-likelihood-ratio test statistic per toy (see
        :meth:`BinnedToyStudy.profile_ts`; under a grouped mesh a rank
        scores and centers the events of its own block only).

        :return: (t array (n_toys,), free ToyResults, conditional ToyResults)
        """
        mesh = self._mesh(mesh)
        events = self.simulate(seed_or_generator, n_toys, truth, mesh)
        return self._run_profile(events, target, hypothesis, fixed, mesh=mesh)

    def _run_profile(self, events, target, hypothesis, fixed, mesh=None):
        """:meth:`profile_ts` on a given event set (coords, mask, bins)."""
        return self._profile(self._ensemble(events, mesh), target,
                             hypothesis, fixed)

    def _run_profile_grid(self, events, target, hypotheses, fixed,
                          return_cond=True, mesh=None):
        # The JAX package re-samples and re-scores the toys for every
        # hypothesis from the same keys; here the event set is drawn and
        # scored once and its (B, G, S, E) tensor and centering reused by
        # every hypothesis. The events are identical, so is the result.
        return self._profile_grid(self._ensemble(events, mesh), target,
                                  hypotheses, fixed, return_cond)

    def profile_map(self, space, fixed=None):
        """Profiled likelihood-ratio map on the observed dataset (the events
        bound by ``lf.set_data``): the unbinned twin of
        :meth:`BinnedToyStudy.profile_map`. The per-event anchor densities
        are read from the likelihood's current ``set_data`` build, viewed
        as one toy (1, G, S, E) with every event valid; the free fit and
        every map lane run on that toy (the lanes' rows all 0). Both fits
        are one stage at the long cap.

        :return: (t shaped ``(len(grid1)[, len(grid2)])``, free ToyResults
          (1 row), conditional ToyResults (one row per grid point, C
          order)).
        """
        targets, grids = _check_map_space(self.compiled, space, fixed)
        build = getattr(self.lf, '_builds', {}).get('ps')
        if build is None:
            raise ValueError(
                "No observed dataset bound — call lf.set_data(...) first")
        if build[0] == 'source_wise':
            raise NotImplementedError(
                "profile_map needs a dense global anchor grid (or no shape "
                "parameters); source-wise morphing maps run via the host "
                "path (plot_likelihood_ratio)")
        tensor = self.compiled._tensor(build[2] if build[0] == 'global'
                                       else build[1])
        S, E = tensor.shape[-2:]
        ps = tensor.reshape(1, -1, S, E).contiguous()
        mask = torch.ones((1, E), dtype=torch.bool, device=self.device)
        data = (ps, mask, unbinned_center(self.compiled, ps, mask))
        fit_free, names_free, _ = self._map_fitter((), fixed)
        free = ToyResults(names_free,
                          *(v.cpu().numpy() for v in fit_free(data)))
        return self._map(data, targets, grids, fixed, free)
