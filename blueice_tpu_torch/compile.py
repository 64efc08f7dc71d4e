"""Lower a prepared likelihood to torch tensors on one device.

Counterpart of :mod:`blueice_tpu.compile` for the global-grid branch of
``build_logl``: binned, with its Beeston-Barlow modes ('bb_single',
'bb_lite'), and extended unbinned, data-bound or data-free (the toy studies
supply each toy's per-event density tensor at call time). The anchor tensors
move to the device once, and every evaluation (morphing, rate multipliers,
efficiencies, priors, physicality, the finite-MC adjustment, the Poisson or
extended reduction) is torch on that device. Out-of-bounds and unphysical
parameter points return -inf like the host path. The compiled object also
carries the metadata the closed-form fit engines read (anchor tensors and
arrays, names, priors).

Sums, re-parametrisations and ancillary terms are ROADMAP queue 1 item 11;
exposing the livetime as a parameter is item 16c.
"""

from collections import OrderedDict

import numpy as np
import torch

from .device import resolve
from .ops.bb_lite import bb_lite_logl
from .ops.beeston_barlow import bb_single_adjust
from .ops.interp import clip, morph_templates
from .ops.poisson import (binned_poisson_logl, binned_poisson_logl_constant,
                          extended_logl)
from .priors import PRIORS

__all__ = ['CompiledLogLikelihood', 'build_logl']


def build_logl(lf, dtype=None, device=None, include_livetime=False,
               with_priors=True):
    """Compile the prepared likelihood ``lf`` onto ``device``: a binned
    one, or an unbinned one with its data set or without (data-free: for
    toy studies, which pass each toy's density tensor).

    :param dtype: tensor dtype (None: float32 on CUDA, float64 on the CPU).
    :param device: torch device (None: the CUDA device, raising without
      CUDA; 'cpu' for the CPU).
    :param with_priors: include rate/shape log-prior terms.
    :return: :class:`CompiledLogLikelihood`.
    """
    from .convert import state_from_reference, build_logl_from_state
    if include_livetime:
        raise NotImplementedError(
            "include_livetime is not ported yet (ROADMAP queue 1 item 16c)")
    if not lf.is_prepared:
        if len(lf.shape_parameters):
            raise RuntimeError("Call prepare() before compiling the likelihood")
        lf.prepare()
    return build_logl_from_state(state_from_reference(lf), device=device,
                                 dtype=dtype, with_priors=with_priors)


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
    """

    def __init__(self, state, device=None, dtype=None, with_priors=True):
        self.device, self.dtype = resolve(device, dtype)
        self.shape_names = list(state['shape_names'])
        self.rate_names = list(state['rate_names'])
        self.param_names = self.rate_names + self.shape_names
        self.defaults = OrderedDict(state['defaults'])
        self.bounds = OrderedDict(state['bounds'])
        self.registered = list(state['registered'])
        self.allowed_negative = np.asarray(state['allow_negative'], bool)
        self.apply_eff = np.asarray(state['apply_efficiency'], bool)
        self.eff_names = list(state['efficiency_names'])
        self.anchor_arrays = [np.asarray(a, dtype=float)
                              for a in state['anchor_arrays']]
        self.prior_terms = ([(name, PRIORS[kind](*numbers))
                             for name, kind, numbers in state['priors']]
                            if with_priors else [])
        self.is_binned = state.get('kind', 'binned') == 'binned'
        self.outlier_likelihood = float(state.get('outlier_likelihood', 0.0))
        self.mus_tensor = self._tensor(state['mus'])
        self.ps_tensor = (None if state['ps'] is None
                          else self._tensor(state['ps']))
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
        self._anchor_tensors = [self._tensor(a) for a in self.anchor_arrays]
        K = len(self.shape_names)
        self._shape_lo = self._tensor(
            [self.bounds[sp][0] for sp in self.shape_names]).reshape(K)
        self._shape_hi = self._tensor(
            [self.bounds[sp][1] for sp in self.shape_names]).reshape(K)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def _value(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

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

    def _morph(self, tensor, zs):
        return (tensor if zs is None
                else morph_templates(tensor, self._anchor_tensors, zs))

    def _mus_at(self, params, zs):
        """Per-source expected counts: base rates at zs, scaled by rate
        multipliers and applied efficiencies (the analytic engines' rates
        follow the same pipeline)."""
        mus = self._morph(self.mus_tensor, zs)
        mults = torch.stack([self._value(params[rn]) for rn in self.rate_names])
        mus = mus * mults
        if self.apply_eff.any():
            effs = torch.stack([
                self._value(params[self.eff_names[i]])
                if self.apply_eff[i] and self.eff_names[i] in self.shape_names
                else self._value(1.0) for i in range(len(self.rate_names))])
            mus = torch.where(torch.as_tensor(self.apply_eff,
                                              device=self.device),
                              mus * effs, mus)
        return mus

    def rates(self, params):
        """Per-source expected counts at params."""
        return self._mus_at(params, self._clipped_zs(params)[0])

    def densities(self, params):
        """The morphed PMF grids (n_sources, *bins) at params."""
        return self._morph(self.ps_tensor, self._clipped_zs(params)[0])

    def expected_counts(self, params):
        """Expected counts per analysis-space bin at params."""
        return torch.tensordot(self.rates(params), self.densities(params),
                               dims=([0], [0]))

    # -- evaluation ----------------------------------------------------------------

    def logl_with_data(self, params, data, mask=None, include_constant=True):
        """Log likelihood at one parameter point for the observed-counts
        tensor ``data`` (*bins), or for an unbinned likelihood one toy's
        per-event density tensor (*grid, S, n_events), grid flattened or
        not, with its optional event ``mask`` (n_events,) (False: padding)."""
        zs, oob = self._clipped_zs(params)
        data = data if torch.is_tensor(data) else self._tensor(data)
        if self.is_binned:
            ps = self._morph(self.ps_tensor, zs)
        else:
            grid = tuple(len(a) for a in self.anchor_arrays)
            ps = self._morph(data.reshape(grid + tuple(data.shape[-2:])), zs)
        mus = self._mus_at(params, zs)

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
                                                    device=self.device))
        elif self.has_bb_lite:
            ll = bb_lite_logl(mus_safe, ps, self._morph(self.nme_tensor, zs),
                              data, include_constant=include_constant)
        else:
            if self.has_bb:
                mus_safe, ps = bb_single_adjust(
                    mus_safe, ps, self._morph(self.nme_tensor, zs), data,
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
