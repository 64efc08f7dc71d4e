"""The bridge for weights and state between a prepared likelihood and the
port's compiled likelihood.

:func:`state_from_reference` reads a prepared ``BinnedLogLikelihood`` or
``UnbinnedLogLikelihood``, or a composition of them (``LogLikelihoodSum``,
``LogLikelihoodReParam``, ``LogAncillaryLikelihood``) — one of the JAX
package or one of this package; the two keep the same attributes — into a
plain dict of numpy arrays, names and numbers, without importing either
framework.
:func:`build_logl_from_state` turns such a state into the port's
:class:`~blueice_tpu_torch.compile.CompiledLogLikelihood` on a torch
device. The tests use the pair to feed both packages bit-identical
templates; :func:`blueice_tpu_torch.compile.build_logl` is the same two steps
on the port's own likelihood.
"""

from collections import OrderedDict

import numpy as np

__all__ = ['state_from_reference', 'build_logl_from_state']


def _prior_state(name, prior):
    """(kind, numbers) of a Normal/Uniform prior of either package; any
    other log prior is carried as it is ('callable'), and must compute
    with torch tensors (:class:`~blueice_tpu_torch.priors.TensorPrior`)."""
    kind = {'NormalPrior': 'normal', 'UniformPrior': 'uniform'}.get(
        type(prior).__name__)
    if kind == 'normal':
        return kind, (float(prior.mu), float(prior.sigma))
    if kind == 'uniform':
        return kind, (float(prior.lo), float(prior.hi))
    return 'callable', (prior,)


def _is_a(lf, name):
    return any(c.__name__ == name for c in type(lf).__mro__)


def _registered(lf):
    """The parameters a fit floats by default: the registered rate
    multipliers and every shape parameter."""
    return ([sn + '_rate_multiplier' for sn in lf.rate_parameters]
            + list(lf.shape_parameters.keys()))


def _child_state(lf):
    """State of a composition's member, preparing a shape-free binned or
    unbinned likelihood first as :func:`~blueice_tpu_torch.compile.build_logl`
    does."""
    if (hasattr(lf, 'is_prepared') and not lf.is_prepared
            and not len(lf.shape_parameters)):
        lf.prepare()
    return state_from_reference(lf)


def _sum_state(lf):
    return dict(kind='sum',
                children=[_child_state(ll) for ll in lf.likelihood_list],
                weights=[float(w) for w in lf.likelihood_weights],
                routed=[list(names) for names in lf.likelihood_parameters],
                registered=_registered(lf))


def _reparam_state(rp):
    transform = rp.transform
    return dict(kind='reparam', child=_child_state(rp._likelihood),
                targets=OrderedDict(transform.targets),
                base_values=dict(transform.base_values),
                input_bounds=OrderedDict(
                    (p, tuple(float(b) for b in rp.get_bounds(p)))
                    for p in transform.input_names),
                registered=_registered(rp))


def _ancillary_state(anc):
    """An ancillary term's parameters, defaults and func. A JAX package
    ``MultivariateNormalPrior`` becomes this package's; any other func is
    carried as it is, and must compute with torch tensors."""
    func = anc.func
    if type(func).__name__ == 'MultivariateNormalPrior':
        from .priors import MultivariateNormalPrior
        func = MultivariateNormalPrior(func.mean, func.cov)
    names = list(anc.shape_parameters)
    return dict(kind='ancillary', parameters=names,
                defaults=OrderedDict((p, float(anc.pdf_base_config[p]))
                                     for p in names),
                func=func, func_kwargs=dict(anc.func_kwargs),
                registered=names)


def _source_wise_state(lf, mus_builds, ps_builds):
    """(mus, ps, source_wise) of a source-wise build: per source, its rate
    payload (*sub_grid) and density payload (*sub_grid, *bins or
    n_events), each over the grid of the shape parameters it depends on
    (``source_wise[s]``: their ``shape_idx`` into the shape parameters and
    their ``anchor_arrays``), or without a morpher a constant payload and
    None; ``ps`` is None for a data-free unbinned likelihood."""
    mus, ps, source_wise = [], None if ps_builds is None else [], []
    for sn in lf.source_name_list:
        morpher, tensor = mus_builds[sn]
        mus.append(np.asarray(tensor, dtype=float))
        if ps is not None:
            ps.append(np.asarray(ps_builds[sn][1], dtype=float))
        if morpher is None:
            source_wise.append(None)
            continue
        if type(morpher).__name__ != 'GridInterpolator':
            raise NotImplementedError(
                "source_wise_interpolation requires a deterministic anchor "
                "grid per source (morpher 'GridInterpolator'), not %s"
                % type(morpher).__name__)
        source_wise.append(dict(
            shape_idx=[int(i) for i in lf._get_shape_indices(sn)],
            anchor_arrays=[np.asarray(a, dtype=float)
                           for a in morpher.anchor_z_arrays]))
    return mus, ps, source_wise


def _radial_state(morpher):
    """The scattered anchors of a RadialInterpolator of either package: in
    the order its payloads are stacked (``anchors``), bounds-normalized
    (``normed``), the bounds' ``mins`` and ``lengths``, and each anchor's
    decay length (``r_influence``: its r0 times ``decay_multiplier``)."""
    decay = float(morpher.config.get('decay_multiplier', 5))
    return dict(anchors=np.asarray(morpher._anchor_order, dtype=float),
                normed=np.asarray(morpher._normed_model_zs, dtype=float),
                mins=np.asarray(morpher._mins, dtype=float),
                lengths=np.asarray(morpher._lengths, dtype=float),
                r0s=np.asarray(morpher._r0s, dtype=float),
                decay_multiplier=decay,
                r_influence=np.asarray(morpher._r0s, dtype=float) * decay)


def state_from_reference(lf):
    """Numpy state of a prepared binned or unbinned likelihood, or of a
    composition (its members prepared).

    A composition's state has ``kind`` 'sum' (``children``, their
    ``weights`` and ``routed``: the joint parameter names each child
    declares), 'reparam' (the wrapped ``child``, the transform's
    ``targets`` {target: (inputs, func)} and ``base_values``, and the new
    parameters' ``input_bounds``) or 'ancillary' (``parameters``,
    ``defaults``, ``func``, ``func_kwargs``), and ``registered``.

    :return: dict with ``kind`` ('binned' or 'unbinned'), the anchor
      payloads ``mus`` (*grid, S) and ``ps`` (*grid, S, *bins), or for an
      unbinned likelihood the per-event densities of its data (*grid, S,
      n_events), None when no data is set (``lf._builds['mus'][2]`` /
      ``lf._builds['ps'][2]`` for a morphed likelihood),
      ``outlier_likelihood`` (unbinned; 0 for binned), ``anchor_arrays``,
      ``source_names``, ``shape_names``, ``rate_names``, ``defaults``,
      ``bounds``, ``priors`` ([(name, kind, numbers)]), ``registered`` (the parameters a fit
      floats by default), ``allow_negative``, ``apply_efficiency``,
      ``efficiency_names``, ``data`` (the bound data's counts or None),
      and the finite-MC-statistics mode: ``mode`` (None, 'bb_single' or
      'bb_lite'), ``nme`` (the n_model_events payload on the layout of
      ``ps``, ``lf._builds['n_model_events']``, or None without a mode) and
      ``bb_source_i`` (the finite source of 'bb_single', else None);
      ``log_morph`` (geometric template morphing: ``ps`` is the log anchor
      tensor) with ``masses`` (*grid, S), the per-anchor template masses
      in float64 from the full template, else None; ``source_wise``: for a
      source-wise build (``anchor_arrays`` None), per source its
      ``shape_idx`` and ``anchor_arrays``, or None for an unmorphed
      source, with ``mus`` and ``ps`` lists of per-source payloads
      (:func:`_source_wise_state`); else None; ``radial``: for a
      RadialInterpolator's scattered anchors (``anchor_arrays`` None, the
      payloads' leading axis the anchors), :func:`_radial_state`, else
      None; ``base_livetime``: the base config's ``livetime_days`` (None
      without one), which ``include_livetime`` scales from.
    """
    for name, reader in (('LogLikelihoodSum', _sum_state),
                         ('LogLikelihoodReParam', _reparam_state),
                         ('LogAncillaryLikelihood', _ancillary_state)):
        if _is_a(lf, name):
            return reader(lf)
    if not getattr(lf, 'is_prepared', False):
        raise RuntimeError("Call prepare() before reading the likelihood")
    binned = _is_a(lf, 'BinnedLogLikelihood')
    if not binned and not _is_a(lf, 'UnbinnedLogLikelihood'):
        raise TypeError("Cannot read %r: expected a binned or unbinned "
                        "likelihood or a composition of them"
                        % type(lf).__name__)
    source_names = list(lf.source_name_list)
    shape_names = list(lf.shape_parameters.keys())
    ps_build = lf._builds.get('ps')
    source_wise = None
    if ps_build is None and not binned:
        # Data-free unbinned likelihood: the rates and the anchor grid only;
        # each toy brings its own per-event densities
        ps_build = (('constant', None) if not shape_names
                    else ('source_wise', None)
                    if lf.source_wise_interpolation
                    else ('global', lf.morpher, None))
    log_morph = False
    radial = None
    if ps_build[0] == 'source_wise':
        mus, ps, source_wise = _source_wise_state(lf, lf._builds['mus'][1],
                                                  ps_build[1])
        anchor_arrays = None
    elif ps_build[0] == 'global':
        morpher = ps_build[1]
        if type(morpher).__name__ == 'LogMorpher':
            morpher, log_morph = morpher.inner, True
        mus = np.asarray(lf._builds['mus'][2], dtype=float)
        ps = None if ps_build[2] is None else np.asarray(ps_build[2],
                                                         dtype=float)
        if type(morpher).__name__ == 'RadialInterpolator':
            radial, anchor_arrays = _radial_state(morpher), None
        elif type(morpher).__name__ == 'GridInterpolator':
            anchor_arrays = [np.asarray(a, dtype=float)
                             for a in morpher.anchor_z_arrays]
        else:
            raise TypeError("Cannot read the %s morpher: expected a "
                            "GridInterpolator or a RadialInterpolator"
                            % type(morpher).__name__)
    elif ps_build[0] == 'constant':
        mus = np.asarray(lf.base_model.expected_events(), dtype=float)
        ps = None if ps_build[1] is None else np.asarray(ps_build[1],
                                                         dtype=float)
        anchor_arrays = []
    else:
        raise ValueError("Unknown build kind %r" % (ps_build[0],))

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
            if binned and getattr(lf, 'is_data_set', False) else None)

    masses = None
    if log_morph:
        # The linear mass rescale's anchor masses, from the full template
        lead = 2 if radial is not None else len(anchor_arrays) + 1
        masses = np.exp(ps.reshape(ps.shape[:lead] + (-1,))).sum(axis=-1)

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
        kind='binned' if binned else 'unbinned',
        outlier_likelihood=(0.0 if binned else float(
            lf.config.get('outlier_likelihood', 1e-12))),
        mus=mus, ps=ps, anchor_arrays=anchor_arrays,
        source_names=source_names, shape_names=shape_names,
        rate_names=rate_names, defaults=defaults, bounds=bounds,
        priors=priors,
        registered=_registered(lf),
        allow_negative=[bool(a) for a in lf.source_allowed_negative],
        apply_efficiency=[bool(a) for a in lf.source_apply_efficiency],
        efficiency_names=[str(e) for e in lf.source_efficiency_names],
        data=data, mode=mode, nme=nme, bb_source_i=bb_source_i,
        log_morph=log_morph, masses=masses, source_wise=source_wise,
        radial=radial, base_livetime=lf.pdf_base_config.get('livetime_days'))


def build_logl_from_state(state, device=None, dtype=None, with_priors=True,
                          include_livetime=False):
    """The port's compiled likelihood from a :func:`state_from_reference`
    state, its tensors on ``device`` in ``dtype`` (see
    :func:`blueice_tpu_torch.device.resolve`), with 'livetime_days' as a
    parameter when ``include_livetime``."""
    from . import compile as c
    cls = {'sum': c.CompiledLogLikelihoodSum,
           'reparam': c.CompiledReParam,
           'ancillary': c.CompiledAncillary}.get(state.get('kind'),
                                                 c.CompiledLogLikelihood)
    return cls(state, device=device, dtype=dtype, with_priors=with_priors,
               include_livetime=include_livetime)
