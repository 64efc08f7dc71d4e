"""Lower a prepared likelihood to torch tensors on one device.

Counterpart of :mod:`blueice_tpu.compile`: binned, with its Beeston-Barlow
modes ('bb_single', 'bb_lite') and geometric (log) template morphing, and
extended unbinned, data-bound or data-free (the toy studies supply each toy's
per-event density tensor at call time), morphed over a global anchor grid,
source by source, or over the scattered anchors of a
:class:`~blueice_tpu_torch.morphers.RadialInterpolator`; and for the
compositions of
:mod:`blueice_tpu_torch.composition` (:func:`build_logl_sum`,
:func:`build_logl_reparam`, :func:`build_logl_ancillary`). The anchor tensors
move to the device once, and every evaluation (morphing, rate multipliers,
efficiencies, priors, physicality, the finite-MC adjustment, the Poisson or
extended reduction) is torch on that device. Out-of-bounds and unphysical
parameter points return -inf like the host path. The compiled object also
carries the metadata the closed-form fit engines read (anchor tensors and
arrays, names, priors). With ``include_livetime`` the live time is a
parameter, ``livetime_days``, which scales every source's rate (a Sum shares
one joint live time among the children that compiled with it); fits never
float it.
"""

import warnings
from collections import OrderedDict

import numpy as np
import torch

from .device import resolve
from .morphers import radial_weights
from .ops.bb_lite import bb_lite_logl
from .ops.beeston_barlow import bb_single_adjust
from .ops.interp import (cell_rows, clip, corner_offsets, corner_weights,
                         grid_strides, morph_rows, morph_weights)
from .ops.poisson import (binned_poisson_logl, binned_poisson_logl_constant,
                          extended_logl)
from .priors import PRIORS

__all__ = ['CompiledLogLikelihood', 'CompiledLogLikelihoodSum',
           'CompiledReParam', 'CompiledAncillary', 'build_logl',
           'build_logl_sum', 'build_logl_reparam', 'build_logl_ancillary',
           'cached_logl']


def build_logl(lf, dtype=None, device=None, include_livetime=False,
               with_priors=True):
    """Compile the prepared likelihood ``lf`` onto ``device``: a binned
    one, or an unbinned one with its data set or without (data-free: for
    toy studies, which pass each toy's density tensor), or a composition
    of them (a LogLikelihoodSum, LogLikelihoodReParam or
    LogAncillaryLikelihood of either package).

    :param dtype: tensor dtype (None: float32 on CUDA, float64 on the CPU).
    :param device: torch device (None: the CUDA device, raising without
      CUDA; 'cpu' for the CPU).
    :param include_livetime: expose 'livetime_days' as a parameter (its
      default the base config's live time, which must be present and
      nonzero; bounds (0, inf)), scaling every source's rate.
    :param with_priors: include rate/shape log-prior terms.
    :return: :class:`CompiledLogLikelihood`.
    """
    from .convert import state_from_reference, build_logl_from_state
    if hasattr(lf, 'is_prepared') and not lf.is_prepared:
        if len(lf.shape_parameters):
            raise RuntimeError("Call prepare() before compiling the likelihood")
        lf.prepare()
    return build_logl_from_state(state_from_reference(lf), device=device,
                                 dtype=dtype, with_priors=with_priors,
                                 include_livetime=include_livetime)


def cached_logl(lf, device=None, dtype=None):
    """:func:`build_logl` with a per-likelihood cache, invalidated whenever
    ``prepare()`` or ``set_data()`` bumps the payload version (a Sum: the
    tuple of its children's versions), so interval scans and repeated
    samplers compile once per dataset and a new dataset always gets a fresh
    compile. The key adds the resolved device and dtype: a CPU compile and
    a card compile of one likelihood never share an entry. Shared by
    ``bestfit_jax`` and ``bestfit_emcee_device``."""
    device, dtype = resolve(device, dtype)
    token = getattr(lf, '_build_version', None)
    if token is None and hasattr(lf, 'likelihood_list'):
        token = tuple(getattr(ll, '_build_version', None)
                      for ll in lf.likelihood_list)
    cache = lf.__dict__.setdefault('_torch_compiled_for_fit', {})
    key = (str(device), dtype)
    cached = cache.get(key)
    if cached is None or cached[0] != token:
        cache[key] = cached = (token, build_logl(lf, dtype=dtype,
                                                 device=device))
    return cached[1]


def _build_composition(lf, name, **opts):
    if not any(c.__name__ == name for c in type(lf).__mro__):
        raise TypeError("expected a %s, got %r" % (name, type(lf).__name__))
    return build_logl(lf, **opts)


def build_logl_sum(sum_lf, dtype=None, device=None, include_livetime=False,
                   with_priors=True):
    """Compile a LogLikelihoodSum: each child compiles on its own anchor
    tensors; the joint logl routes parameters by name and adds the weighted
    child terms (:class:`CompiledLogLikelihoodSum`)."""
    return _build_composition(sum_lf, 'LogLikelihoodSum', dtype=dtype,
                              device=device, include_livetime=include_livetime,
                              with_priors=with_priors)


def build_logl_reparam(rp, dtype=None, device=None, include_livetime=False,
                       with_priors=True):
    """Compile a LogLikelihoodReParam: the wrapped likelihood compiles as
    usual and the parameter transform runs in front of it
    (:class:`CompiledReParam`)."""
    return _build_composition(rp, 'LogLikelihoodReParam', dtype=dtype,
                              device=device, include_livetime=include_livetime,
                              with_priors=with_priors)


def build_logl_ancillary(anc, dtype=None, device=None, include_livetime=False,
                         with_priors=True):
    """Compile a LogAncillaryLikelihood, whose func must compute with torch
    tensors (:class:`CompiledAncillary`; it has no live time)."""
    return _build_composition(anc, 'LogAncillaryLikelihood', dtype=dtype,
                              device=device, include_livetime=include_livetime,
                              with_priors=with_priors)


class CompiledLogLikelihood:
    """A log likelihood on torch tensors, plus its parameter metadata.

    Attributes:
      param_names: all parameter names, rates first then shapes.
      defaults / bounds: per-parameter base values and (lo, hi) tuples.
      is_binned: False for the extended unbinned likelihood, whose
        ``outlier_likelihood`` is the density floor of events whose summed
        density is not positive.
      data: the bound observed counts (tensor) or None (unbinned: None; the
        bound events are the per-event ``ps_tensor``).
      mus_tensor (*grid, S), ps_tensor (*grid, S, *bins), or for an
        unbinned likelihood (*grid, S, n_events): anchor payloads on the
        device; ps_tensor is None for a data-free unbinned compile.
      anchor_arrays, shape_names, rate_names, prior_terms [(name, prior)]:
        what the closed-form fit engines read.
      has_bb / has_bb_lite / bb_source_i: the finite-MC-statistics mode
        ('bb_single' of source bb_source_i, or 'bb_lite').
      nme_tensor (*grid, S, *bins): the MC counts behind the templates on
        the device (None without a Beeston-Barlow mode), and
        nme_tensor_host, the same payload as float64 numpy.
      log_morph: geometric (log) template morphing: ps_tensor is the log
        anchor tensor, and masses_host (*grid, S) its per-anchor template
        masses (float64 numpy; ``mass_tensor`` on the device), which the
        morph's linear mass rescale lerps.
      radial: for scattered anchors (a RadialInterpolator; anchor_arrays
        None), the anchors' tensors on the device (``normed``, ``mins``,
        ``lengths``, ``r_influence``); the payloads' leading axis indexes
        the anchors. None on a grid.
      base_livetime: with ``include_livetime``, the live time the rates
        were built for ('livetime_days' scales them by its ratio to it);
        else None.
    """

    #: dataset-free terms (ancillary constraints) have none
    has_data = True

    def __init__(self, state, device=None, dtype=None, with_priors=True,
                 include_livetime=False):
        self.device, self.dtype = resolve(device, dtype)
        self.shape_names = list(state['shape_names'])
        self.rate_names = list(state['rate_names'])
        self.param_names = self.rate_names + self.shape_names
        self.defaults = OrderedDict(state['defaults'])
        self.bounds = OrderedDict(state['bounds'])
        self.base_livetime = None
        if include_livetime:
            base = state.get('base_livetime')
            if not base:
                raise ValueError("Cannot expose livetime_days: base livetime "
                                 "is absent or zero")
            self.base_livetime = float(base)
            self.defaults['livetime_days'] = float(base)
            self.bounds['livetime_days'] = (0.0, float('inf'))
            self.param_names = self.param_names + ['livetime_days']
        self.registered = list(state['registered'])
        self.allowed_negative = np.asarray(state['allow_negative'], bool)
        self.apply_eff = np.asarray(state['apply_efficiency'], bool)
        self.eff_names = list(state['efficiency_names'])
        sw = state.get('source_wise')
        # per source: (its shape-parameter indices, its anchor tensors), or
        # None for an unmorphed source; None without source-wise morphing
        self.source_wise = None if sw is None else [
            None if e is None else (list(e['shape_idx']),
                                    [self._tensor(a)
                                     for a in e['anchor_arrays']])
            for e in sw]
        self.anchor_arrays = (None if state['anchor_arrays'] is None
                              else [np.asarray(a, dtype=float)
                                    for a in state['anchor_arrays']])
        radial = state.get('radial')
        self.radial = None if radial is None else {
            k: self._tensor(radial[k])
            for k in ('normed', 'mins', 'lengths', 'r_influence')}
        self.prior_terms = ([(name, PRIORS[kind](*numbers))
                             for name, kind, numbers in state['priors']]
                            if with_priors else [])
        self.is_binned = state.get('kind', 'binned') == 'binned'
        self.outlier_likelihood = float(state.get('outlier_likelihood', 0.0))
        # the rates in float64 too, for the centered unbinned value
        # (logl_with_data)
        self._mus64 = (torch.as_tensor(np.asarray(state['mus']),
                                       dtype=torch.float64, device=self.device)
                       if self.source_wise is None else
                       [torch.as_tensor(np.asarray(m), dtype=torch.float64,
                                        device=self.device)
                        for m in state['mus']])
        if self.source_wise is None:
            self.mus_tensor = self._tensor(state['mus'])
            self.ps_tensor = (None if state['ps'] is None
                              else self._tensor(state['ps']))
        else:
            self.mus_tensor = [self._tensor(m) for m in state['mus']]
            self.ps_tensor = (None if state['ps'] is None
                              else tuple(self._tensor(p)
                                         for p in state['ps']))
        self.data = (None if state['data'] is None
                     else self._tensor(state['data']))
        mode = state.get('mode')
        self.has_bb = mode == 'bb_single'
        self.has_bb_lite = mode == 'bb_lite'
        self.bb_source_i = state.get('bb_source_i')
        nme = state.get('nme')
        self.nme_tensor_host = (None if nme is None
                                else np.asarray(nme, dtype=float))
        self.nme_tensor = None if nme is None else self._tensor(nme)
        self.log_morph = bool(state.get('log_morph', False))
        masses = state.get('masses')
        self.masses_host = (None if masses is None
                            else np.asarray(masses, dtype=float))
        self.mass_tensor = None if masses is None else self._tensor(masses)
        self._anchor_tensors = [self._tensor(a)
                                for a in self.anchor_arrays or []]
        grids = ([] if self.anchor_arrays is None
                 else [tuple(len(a) for a in self.anchor_arrays)])
        if self.source_wise is not None:
            grids += [g for g in self._source_grids() if g]
        for g in grids:    # made outside any torch.func transform
            corner_offsets(grid_strides(g), self.device)
        self._param_anchors = self._anchor_tensors
        if self.source_wise is not None:
            # each parameter's anchors, from a source that morphs over it
            # (the per-source grids take the shape parameters' anchors)
            by_param = {i: a for e in self.source_wise if e is not None
                        for i, a in zip(*e)}
            self._param_anchors = [
                by_param.get(d, self._tensor(self.bounds[sp]))
                for d, sp in enumerate(self.shape_names)]
        self._apply_eff_t = torch.as_tensor(self.apply_eff,
                                            device=self.device)
        # each shape parameter's anchors (the fits' snap candidates): the
        # global grid's axes, or those the sources of a source-wise build
        # morph over
        self.shape_anchor_arrays = [
            np.asarray(a.cpu(), dtype=float) for a in self._param_anchors]
        K = len(self.shape_names)
        self._shape_lo = self._tensor(
            [self.bounds[sp][0] for sp in self.shape_names]).reshape(K)
        self._shape_hi = self._tensor(
            [self.bounds[sp][1] for sp in self.shape_names]).reshape(K)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def _value(self, v, dtype=None):
        dtype = dtype or self.dtype
        if torch.is_tensor(v):
            # a copy: under torch.func's forward-mode AD a parameter made by
            # float arithmetic on a 0-d tensor (a re-parametrisation's
            # transform) carries a float64 tangent even where its value is
            # float32, and the copy converts the tangent too
            return v.to(dtype=dtype, device=self.device, copy=True)
        return torch.as_tensor(v, dtype=dtype, device=self.device)

    # -- parameters ---------------------------------------------------------------

    def params_from_kwargs(self, **kwargs):
        """Full params dict: defaults overridden by kwargs."""
        unknown = set(kwargs) - set(self.param_names)
        if unknown:
            raise ValueError("Unknown parameters: %s" % sorted(unknown))
        p = dict(self.defaults)
        p.update(kwargs)
        return p

    def _clipped_zs(self, params):
        """(zs clamped into the shape bounds, out_of_bounds flag)."""
        if not self.shape_names:
            return None, self._value(False).bool()
        zs_raw = torch.stack([self._value(params[sp])
                              for sp in self.shape_names])
        oob = torch.any((zs_raw < self._shape_lo) | (zs_raw > self._shape_hi))
        return clip(zs_raw, self._shape_lo, self._shape_hi), oob

    def _weights(self, zs):
        """Per shape parameter, (cell index, lerp weight) at zs (None
        without shape parameters), with a memo of the cells
        (:meth:`_cell`) that the point's payloads read: made once a point
        for every payload morphed there (rates, templates, MC counts,
        every source of a source-wise build). For scattered anchors, the
        (n_anchors,) radial weights
        (:func:`~blueice_tpu_torch.morphers.radial_weights`)."""
        if zs is None:
            return None
        if self.radial is not None:
            r = self.radial
            return radial_weights(zs, r['normed'], r['mins'], r['lengths'],
                                  r['r_influence'])
        idx, ts = morph_weights(self._param_anchors, zs)
        return idx, ts, {}

    def _cell(self, w, params):
        """(corner rows (2^k,), corner weights (2^k,)) of the cell at the
        weights ``w`` on the grid of the shape parameters ``params``."""
        key = tuple(params)
        memo = w[2]
        if key not in memo:
            grid = tuple(len(self._param_anchors[i]) for i in key)
            memo[key] = (cell_rows([w[0][i] for i in key], grid, self.device),
                         corner_weights([w[1][i] for i in key]))
        return memo[key]

    def _morph(self, tensor, w):
        """A payload at the weights ``w`` (:meth:`_weights`): a global
        anchor tensor morphed over the grid, or a source-wise list of
        per-source payloads, each morphed over its own parameters, stacked
        over sources."""
        if self.source_wise is None:
            if w is None:
                return tensor
            if self.radial is not None:
                dtype = torch.promote_types(w.dtype, tensor.dtype)
                return torch.tensordot(w.to(dtype), tensor.to(dtype), dims=1)
            K = len(self.shape_names)
            return morph_rows(tensor, K, *self._cell(w, range(K)))
        return torch.stack([
            t if e is None else morph_rows(t, len(e[0]),
                                           *self._cell(w, e[0]))
            for t, e in zip(tensor, self.source_wise)])

    def _source_grids(self):
        """Per source, the shape of its anchor grid (() unmorphed)."""
        return [() if e is None else tuple(len(a) for a in e[1])
                for e in self.source_wise]

    def _event_densities(self, data, w):
        """(S, n_events) per-event densities at the weights ``w`` of one
        toy's anchor payload: a (*grid, S, n_events) tensor (grid
        flattened or not), or for a source-wise build a sequence of
        per-source (*sub_grid, n_events) tensors (sub-grid flattened or
        not)."""
        if self.source_wise is not None:
            return self._morph([d.reshape(g + d.shape[-1:])
                                for d, g in zip(data, self._source_grids())],
                               w)
        data = data if torch.is_tensor(data) else self._tensor(data)
        grid = ((self.radial['normed'].shape[0],) if self.radial is not None
                else tuple(len(a) for a in self.anchor_arrays))
        return self._morph(data.reshape(grid + tuple(data.shape[-2:])), w)

    def _morph_ps(self, ps, w):
        """The morphed pmfs (S, *bins) at the weights ``w``; geometric with
        ``log_morph`` (:meth:`blueice_tpu_torch.morphers.LogMorpher.eval`,
        the masses from the float64 host payload)."""
        if not self.log_morph or w is None:
            return self._morph(ps, w)
        raw = torch.exp(self._morph(ps, w))
        axes = tuple(range(1, raw.dim()))
        scale = self._morph(self.mass_tensor, w) / torch.clamp(
            raw.sum(dim=axes), min=torch.finfo(raw.dtype).tiny)
        return raw * scale.reshape((-1,) + (1,) * len(axes))

    def _mus_at(self, params, w, dtype=None):
        """Per-source expected counts: base rates at the weights ``w``,
        scaled by rate multipliers, the live time and applied efficiencies
        (the analytic engines' rates follow the same pipeline); with
        ``dtype`` float64, from the float64 rate payload."""
        mus = self._morph(self._mus64 if dtype == torch.float64
                          else self.mus_tensor, w)
        mults = torch.stack([self._value(params[rn], dtype)
                             for rn in self.rate_names])
        mus = mus * mults
        if self.base_livetime is not None:
            mus = mus * (self._value(params['livetime_days'], dtype)
                         / self.base_livetime)
        if self.apply_eff.any():
            effs = torch.stack([
                self._value(params[self.eff_names[i]], dtype)
                if self.apply_eff[i] and self.eff_names[i] in self.shape_names
                else self._value(1.0, dtype)
                for i in range(len(self.rate_names))])
            mus = torch.where(self._apply_eff_t, mus * effs, mus)
        return mus

    def rates(self, params):
        """Per-source expected counts at params."""
        return self._mus_at(params, self._weights(self._clipped_zs(params)[0]))

    def densities(self, params):
        """The morphed PMF grids (n_sources, *bins) at params."""
        return self._morph_ps(self.ps_tensor,
                              self._weights(self._clipped_zs(params)[0]))

    def expected_counts(self, params):
        """Expected counts per analysis-space bin at params."""
        return torch.tensordot(self.rates(params), self.densities(params),
                               dims=([0], [0]))

    # -- evaluation ----------------------------------------------------------------

    def logl_with_data(self, params, data, mask=None, include_constant=True,
                       center=None):
        """Log likelihood at one parameter point for the observed-counts
        tensor ``data`` (*bins), or for an unbinned likelihood one toy's
        per-event density payload (see :meth:`_event_densities`) with its
        optional event ``mask`` (n_events,) (False: padding).

        :param center: unbinned only: ``(inv_ref (n_events,), ref_msum)``
          of :func:`~blueice_tpu_torch.parallel.fitter.unbinned_center`,
          which make the value the centered log likelihood, every term
          O(1) (add the toy's ``ref_ll`` back for the absolute value)."""
        zs, oob = self._clipped_zs(params)
        # the centered unbinned value in float64 from the payloads as they
        # are: float32 rounding of the rates and the morph weights, which
        # every event's density shares, sums over ~1e4 events to ~6e-4,
        # and moved an upper limit by 1e-4 (a profile's two fits round
        # differently)
        wide = (torch.float64 if center is not None and not self.is_binned
                else None)
        w = self._weights(zs if zs is None or wide is None
                          else zs.to(wide))
        if self.is_binned:
            data = data if torch.is_tensor(data) else self._tensor(data)
            ps = self._morph_ps(self.ps_tensor, w)
            data = data.reshape(ps.shape[1:])
        else:
            ps = self._event_densities(data, w)
        mus = self._mus_at(params, w, wide)

        finite = torch.all(mus < float('inf'))
        if not self.allowed_negative.any():
            unphysical = ~(torch.all(mus >= 0) & finite)
            mus_safe = torch.clamp(mus, min=0.0)
        else:
            per_source_bad = torch.any(
                (mus < 0) & ~torch.as_tensor(self.allowed_negative,
                                             device=self.device))
            unphysical = (~finite) | (torch.sum(mus) < 0) | per_source_bad
            mus_safe = mus

        if not self.is_binned:
            ll = extended_logl(mus_safe, ps, self.outlier_likelihood,
                               mask=None if mask is None
                               else torch.as_tensor(mask, dtype=torch.bool,
                                                    device=self.device),
                               center=center)
        elif self.has_bb_lite:
            ll = bb_lite_logl(mus_safe, ps, self._morph(self.nme_tensor, w),
                              data, include_constant=include_constant)
        else:
            if self.has_bb:
                mus_safe, ps = bb_single_adjust(
                    mus_safe, ps, self._morph(self.nme_tensor, w), data,
                    self.bb_source_i)
            ll = binned_poisson_logl(mus_safe, ps, data,
                                     include_constant=include_constant)
        for pname, prior in self.prior_terms:
            ll = ll + prior(self._value(params[pname]))
        return torch.where(oob | unphysical,
                           self._value(-float('inf')), ll)

    def logl(self, params):
        data = self.data if self.is_binned else self.ps_tensor
        if data is None:
            raise RuntimeError("No data bound: call set_data() before "
                               "compiling, or use logl_with_data")
        return self.logl_with_data(params, data)

    def __call__(self, **kwargs):
        return self.logl(self.params_from_kwargs(**kwargs))

    def data_constant(self, data, batch_dims=0):
        """The parameter-independent part of the log likelihood of ``data``
        (summed over the bins; ``batch_dims`` leading toy dimensions kept):
        optimizers drop it inside their loops and add it back once.

        Summed in float64 whatever the working dtype: each bin's
        k log k - k - lgamma(k+1) is a difference of terms ~k log k, which
        float32 resolves only to ~1e-4 at XENON-scale counts; the sum is
        computed once per fit. The extended unbinned likelihood has none
        (zeros)."""
        if not self.is_binned:
            return torch.zeros(data.shape[:batch_dims], dtype=data.dtype,
                               device=data.device)
        return binned_poisson_logl_constant(
            data.to(torch.float64), batch_dims=batch_dims).to(data.dtype)


class _CompiledComposition:
    """What the compiled compositions share: the parameter lookup and the
    call on keyword arguments."""

    has_data = True

    def params_from_kwargs(self, **kwargs):
        """Full params dict: defaults overridden by kwargs."""
        unknown = set(kwargs) - set(self.param_names)
        if unknown:
            raise ValueError("Unknown parameters: %s" % sorted(unknown))
        p = dict(self.defaults)
        p.update(kwargs)
        return p

    def __call__(self, **kwargs):
        return self.logl(self.params_from_kwargs(**kwargs))

    def _split_names(self):
        self.shape_names = [p for p in self.param_names
                            if not p.endswith('_rate_multiplier')]
        self.rate_names = [p for p in self.param_names
                           if p.endswith('_rate_multiplier')]


def _intersect(b0, b1):
    """Joint bounds of a shared parameter (None = unbounded): the
    intersection, as the host Sum's ``get_bounds``."""
    lo = (b1[0] if b0[0] is None else b0[0] if b1[0] is None
          else max(b0[0], b1[0]))
    hi = (b1[1] if b0[1] is None else b0[1] if b1[1] is None
          else min(b0[1], b1[1]))
    return lo, hi


class CompiledLogLikelihoodSum(_CompiledComposition):
    """A compiled LogLikelihoodSum: each child compiled on its own tensors;
    the joint logl routes parameters by name and adds the weighted child
    terms.

    Attributes (beyond the single likelihood's parameter metadata):
      children: the compiled children; child_weights: the sum's weights;
      child_routed: per child, the frozenset of joint parameter names it
        declares. A joint parameter a child does not declare keeps that
        child's default there (the host Sum's routing).
      A dataset is a tuple, one entry per child (an empty tensor for a
      dataset-free child). With ``include_livetime`` every child that
      compiled with it shares the one joint 'livetime_days'.
    """

    def __init__(self, state, device=None, dtype=None, with_priors=True,
                 include_livetime=False):
        from .convert import build_logl_from_state
        self.device, self.dtype = resolve(device, dtype)
        self.children = [build_logl_from_state(
            c, device=self.device, dtype=self.dtype, with_priors=with_priors,
            include_livetime=include_livetime)
            for c in state['children']]
        self.child_weights = [float(w) for w in state['weights']]
        # livetime is not a declared parameter: route the joint one to every
        # child that compiled with it
        self.child_routed = [
            frozenset(r) | ({'livetime_days'} & set(c.param_names))
            for r, c in zip(state['routed'], self.children)]
        self.registered = list(state['registered'])
        self.defaults, self.bounds = OrderedDict(), OrderedDict()
        self.param_names = []
        for c, routed in zip(self.children, self.child_routed):
            for p in c.param_names:
                if p not in routed:
                    continue
                if p not in self.defaults:
                    self.defaults[p] = c.defaults[p]
                    self.bounds[p] = c.bounds[p]
                    self.param_names.append(p)
                    continue
                self.bounds[p] = _intersect(self.bounds[p], c.bounds[p])
                if float(c.defaults[p]) != float(self.defaults[p]):
                    warnings.warn(
                        "Children of this LogLikelihoodSum disagree on the "
                        "default of shared parameter %r (%s vs %s); the "
                        "compiled likelihood uses the first child's value "
                        "as its default and starting point, while the host "
                        "sum evaluated without kwargs uses each child's own "
                        "base value" % (p, self.defaults[p], c.defaults[p]))
        self._split_names()
        # Dataset-free children (ancillary constraints) don't vote
        self.is_binned = all(c.is_binned for c in self.children
                             if c.has_data)
        self.has_bb = any(c.has_bb for c in self.children)
        self.has_bb_lite = any(c.has_bb_lite for c in self.children)
        self.prior_terms = [t for c in self.children for t in c.prior_terms]
        self.ps_tensor = self.anchor_arrays = None
        self.log_morph = False
        self.data = [c.data for c in self.children]

    def _child_params(self, params, i):
        c, routed = self.children[i], self.child_routed[i]
        return {p: (params[p] if p in routed else c.defaults[p])
                for p in c.param_names}

    def logl(self, params):
        return sum(w * c.logl(self._child_params(params, i))
                   for i, (c, w) in enumerate(zip(self.children,
                                                  self.child_weights)))

    def logl_with_data(self, params, data, mask=None, include_constant=True):
        """``data`` and ``mask`` are sequences, one entry per child."""
        return sum(w * c.logl_with_data(self._child_params(params, i),
                                        data[i],
                                        None if mask is None else mask[i],
                                        include_constant)
                   for i, (c, w) in enumerate(zip(self.children,
                                                  self.child_weights)))

    def data_constant(self, data, batch_dims=0):
        """The weighted children's constants, each and their sum in
        float64, returned in the dtype of the data."""
        total = sum(w * c.data_constant(d.to(torch.float64), batch_dims)
                    for c, w, d in zip(self.children, self.child_weights,
                                       data))
        return total.to(data[0].dtype)

    def expected_counts(self, params):
        """Tuple of per-child expected-count tensors at params (an empty
        tensor for a dataset-free child): the Poisson means a joint toy
        study simulates from."""
        return tuple(
            c.expected_counts(self._child_params(params, i)) if c.has_data
            else torch.zeros((0,), dtype=self.dtype, device=self.device)
            for i, c in enumerate(self.children))


class CompiledReParam(_CompiledComposition):
    """A compiled LogLikelihoodReParam: the wrapped likelihood compiled as
    usual, with the parameter transform ``func(*new)/func(*base)`` in front
    of it, on tensors. Its fits are the autodiff engine's
    (``parallel.fitter``): there is no anchor grid in the new
    parameters."""

    def __init__(self, state, device=None, dtype=None, with_priors=True,
                 include_livetime=False):
        from .composition import ParameterTransform
        from .convert import build_logl_from_state
        from .exceptions import InvalidParameter
        self.device, self.dtype = resolve(device, dtype)
        self.child = child = build_logl_from_state(
            state['child'], device=self.device, dtype=self.dtype,
            with_priors=with_priors, include_livetime=include_livetime)
        self.transform = ParameterTransform(state['targets'],
                                            state['base_values'])
        targets = set(self.transform.targets)
        inputs = list(state['input_bounds'])
        unknown = targets - set(child.param_names)
        if unknown:
            # A typo'd target would make the new parameters silent no-ops
            raise InvalidParameter(
                "Transform target(s) %s are not parameters of the wrapped "
                "likelihood (has: %s)"
                % (sorted(unknown), list(child.param_names)))
        passthrough = [p for p in child.param_names if p not in targets]
        self.defaults = OrderedDict((p, child.defaults[p])
                                    for p in passthrough)
        self.bounds = OrderedDict((p, child.bounds[p]) for p in passthrough)
        for p in inputs:
            self.defaults[p] = float(state['base_values'][p])
            self.bounds[p] = state['input_bounds'][p]
        self.param_names = passthrough + inputs
        self._inputs, self._targets = inputs, targets
        self.registered = list(state['registered'])
        self._split_names()
        self.is_binned = child.is_binned
        self.has_bb, self.has_bb_lite = child.has_bb, child.has_bb_lite
        self.prior_terms = child.prior_terms
        # the transform precedes the anchor morphing: no anchor grid here
        self.ps_tensor = self.anchor_arrays = None
        self.log_morph = False
        self.data = child.data

    def _child_params(self, params):
        converted = self.transform({p: params[p] for p in self._inputs})
        return {p: (converted[p] if p in self._targets else params[p])
                for p in self.child.param_names}

    def logl(self, params):
        return self.child.logl(self._child_params(params))

    def logl_with_data(self, params, data, mask=None, include_constant=True):
        return self.child.logl_with_data(self._child_params(params), data,
                                         mask, include_constant)

    def rates(self, params):
        return self.child.rates(self._child_params(params))

    def densities(self, params):
        return self.child.densities(self._child_params(params))

    def expected_counts(self, params):
        return self.child.expected_counts(self._child_params(params))

    def data_constant(self, data, batch_dims=0):
        return self.child.data_constant(data, batch_dims)


class CompiledAncillary(_CompiledComposition):
    """A compiled LogAncillaryLikelihood: its func on the parameter values
    as tensors (any common batch shape). Dataset-free."""

    has_data = False

    def __init__(self, state, device=None, dtype=None, with_priors=True,
                 include_livetime=False):
        self.device, self.dtype = resolve(device, dtype)
        self.param_names = list(state['parameters'])
        self.defaults = OrderedDict(state['defaults'])
        self.bounds = OrderedDict((p, (-np.inf, np.inf))
                                  for p in self.param_names)
        self.registered = list(state['registered'])
        self.func, self.func_kwargs = state['func'], state['func_kwargs']
        self.shape_names, self.rate_names = list(self.param_names), []
        self.is_binned = None    # dataset-free: binned/unbinned-agnostic
        self.has_bb = self.has_bb_lite = self.log_morph = False
        self.prior_terms = []
        self.ps_tensor = self.anchor_arrays = self.data = None
        try:
            out = self.logl({p: torch.zeros((), dtype=self.dtype,
                                            device=self.device)
                             for p in self.param_names})
            if not torch.is_tensor(out):
                raise TypeError("func returned %r, not a tensor" % (out,))
        except Exception as e:
            raise TypeError(
                "The ancillary likelihood's func does not compute with torch "
                "tensors, so it cannot be compiled (use torch/arithmetic "
                "expressions instead of e.g. scipy.stats frozen logpdfs; the "
                "host __call__ path still accepts those)") from e

    def logl(self, params):
        values = OrderedDict(
            (p, torch.as_tensor(params[p], dtype=self.dtype,
                                device=self.device))
            for p in self.param_names)
        return self.func(values, **self.func_kwargs)

    def logl_with_data(self, params, data, mask=None, include_constant=True):
        return self.logl(params)    # an analytic term has no dataset

    def data_constant(self, data, batch_dims=0):
        return torch.zeros(data.shape[:batch_dims], dtype=data.dtype,
                           device=data.device)
