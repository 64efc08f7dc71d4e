"""The bridge for weights and state between a prepared binned likelihood and
the port's compiled likelihood.

:func:`state_from_reference` reads a prepared ``BinnedLogLikelihood`` — one
of the JAX package or one of this package; the two keep the same attributes
— into a plain dict of numpy arrays, names and numbers, without importing
either framework. :func:`build_logl_from_state` turns such a state into the
port's :class:`~blueice_tpu_torch.compile.CompiledLogLikelihood` on a torch
device. The tests use the pair to feed both packages bit-identical
templates; :func:`blueice_tpu_torch.compile.build_logl` is the same two steps
on the port's own likelihood.
"""

from collections import OrderedDict

import numpy as np

__all__ = ['state_from_reference', 'build_logl_from_state']


def _prior_state(name, prior):
    """(kind, numbers) of a Normal/Uniform prior of either package."""
    kind = {'NormalPrior': 'normal', 'UniformPrior': 'uniform'}.get(
        type(prior).__name__)
    if kind == 'normal':
        return kind, (float(prior.mu), float(prior.sigma))
    if kind == 'uniform':
        return kind, (float(prior.lo), float(prior.hi))
    raise TypeError(
        "The log prior of parameter %r (%r) cannot be compiled: use "
        "NormalPrior or UniformPrior (other priors are ROADMAP queue 1 "
        "item 16)" % (name, prior))


def state_from_reference(lf):
    """Numpy state of a prepared binned likelihood.

    :return: dict with the anchor payloads ``mus`` (*grid, S) and ``ps``
      (*grid, S, *bins) (``lf._builds['mus'][2]`` / ``lf._builds['ps'][2]``
      for a morphed likelihood), ``anchor_arrays``, ``source_names``,
      ``shape_names``, ``rate_names``, ``defaults``, ``bounds``, ``priors``
      ([(name, kind, numbers)]), ``registered`` (the parameters a fit
      floats by default), ``allow_negative``, ``apply_efficiency``,
      ``efficiency_names``, ``data`` (the bound data's counts or None),
      and the finite-MC-statistics mode: ``mode`` (None, 'bb_single' or
      'bb_lite'), ``nme`` (the n_model_events payload on the layout of
      ``ps``, ``lf._builds['n_model_events']``, or None without a mode) and
      ``bb_source_i`` (the finite source of 'bb_single', else None).
    """
    if not getattr(lf, 'is_prepared', False):
        raise RuntimeError("Call prepare() before reading the likelihood")
    if not any(c.__name__ == 'BinnedLogLikelihood'
               for c in type(lf).__mro__):
        raise NotImplementedError(
            "only binned likelihoods are ported (unbinned is ROADMAP queue "
            "1 item 9, compositions item 11)")
    source_names = list(lf.source_name_list)
    shape_names = list(lf.shape_parameters.keys())
    ps_build = lf._builds['ps']
    if ps_build[0] == 'global':
        morpher = ps_build[1]
        if type(morpher).__name__ != 'GridInterpolator':
            raise NotImplementedError(
                "%s template morphing is not ported yet (ROADMAP queue 1 "
                "items 11, 16)" % type(morpher).__name__)
        mus = np.asarray(lf._builds['mus'][2], dtype=float)
        ps = np.asarray(ps_build[2], dtype=float)
        anchor_arrays = [np.asarray(a, dtype=float)
                         for a in morpher.anchor_z_arrays]
    elif ps_build[0] == 'constant':
        mus = np.asarray(lf.base_model.expected_events(), dtype=float)
        ps = np.asarray(ps_build[1], dtype=float)
        anchor_arrays = []
    else:
        raise NotImplementedError(
            "%r template builds are not ported yet (ROADMAP queue 1 item 16)"
            % (ps_build[0],))

    rate_names = [sn + '_rate_multiplier' for sn in source_names]
    defaults = OrderedDict()
    bounds = OrderedDict()
    for rn in rate_names:
        defaults[rn] = 1.0
        bounds[rn] = tuple(float(b) for b in lf.get_bounds(rn))
    for sp, (anchors, _, base_value) in lf.shape_parameters.items():
        base_setting = lf.pdf_base_config.get(sp)
        defaults[sp] = float(base_setting
                             if isinstance(base_setting, (int, float))
                             else base_value)
        bounds[sp] = tuple(float(b) for b in lf.get_bounds(sp))

    priors = []
    for sn in source_names:
        prior = lf.rate_parameters.get(sn)
        if prior is not None:
            priors.append((sn + '_rate_multiplier',)
                          + _prior_state(sn, prior))
    for sp, (_, prior, _) in lf.shape_parameters.items():
        if prior is not None:
            priors.append((sp,) + _prior_state(sp, prior))

    data = (np.asarray(lf.data_events_per_bin.values, dtype=float)
            if getattr(lf, 'is_data_set', False) else None)

    mode = getattr(lf, 'model_statistical_uncertainty_handling', None)
    nme = bb_source_i = None
    if mode is not None:
        nme_build = lf._builds['n_model_events']
        nme = np.asarray(nme_build[2] if nme_build[0] == 'global'
                         else nme_build[1], dtype=float)
        if mode == 'bb_single':
            if lf.config.get('bb_single_source') is None:
                raise ValueError("You need to specify bb_single_source to "
                                 "use bb_single expectation adjustment")
            bb_source_i = int(lf.base_model.get_source_i(
                lf.config['bb_single_source']))
    return dict(
        mus=mus, ps=ps, anchor_arrays=anchor_arrays,
        source_names=source_names, shape_names=shape_names,
        rate_names=rate_names, defaults=defaults, bounds=bounds,
        priors=priors,
        registered=([sn + '_rate_multiplier' for sn in lf.rate_parameters]
                    + shape_names),
        allow_negative=[bool(a) for a in lf.source_allowed_negative],
        apply_efficiency=[bool(a) for a in lf.source_apply_efficiency],
        efficiency_names=[str(e) for e in lf.source_efficiency_names],
        data=data, mode=mode, nme=nme, bb_source_i=bb_source_i)


def build_logl_from_state(state, device=None, dtype=None, with_priors=True):
    """The port's compiled likelihood from a :func:`state_from_reference`
    state, its tensors on ``device`` in ``dtype`` (see
    :func:`blueice_tpu_torch.device.resolve`)."""
    from .compile import CompiledLogLikelihood
    return CompiledLogLikelihood(state, device=device, dtype=dtype,
                                 with_priors=with_priors)
