"""Device-side template building for sources with a closed-form density.

Counterpart of :mod:`blueice_tpu.models.jax_source`; the names are the JAX
package's, so a reader finds the twin. The density callable is written in
torch ops here (the JAX package's in ``jax.numpy``).

The reference builds each anchor model's templates one at a time on the host
(reference: blueice/likelihood.py:190-208 builds a Model per anchor config;
blueice/source.py:287-347 runs per-source Monte Carlo into a histogram). For a
source whose density is a closed-form expression, none of that is needed:
every anchor's template is the same function of different shape-parameter
values, so ALL anchors of a source are built in ONE batched call on the
device (``torch.func.vmap`` over the anchors' parameter vectors, float64).

* :class:`JaxDensitySource` — a :class:`HistogramPdfSource` whose template
  comes from a density ``density(params, *coords)`` in torch ops declared in
  config, evaluated at the analysis-space bin centers and normalized over
  the space.
* :func:`prefill_anchor_templates` — given the anchor model configs the
  likelihood is about to build, finds every uncached JaxDensitySource
  template, groups compatible ones, and computes each group in a single
  batched device call, seeding the (process + disk) template caches that the
  ordinary host build then hits.

The device is the config setting ``template_device`` (None: the CUDA
device, raising without CUDA; 'cpu' for the CPU), listed in the source's
``dont_hash_settings``: a template built on the card and one built on the
CPU share one cache entry. It is read only where such a source is built.

``LogLikelihoodBase.prepare`` calls :func:`prefill_anchor_templates`
automatically, so an 81-anchor XENON-style grid costs one device call per
source instead of 81 host builds.
"""

import os
from collections import OrderedDict

import numpy as np
import torch

from .. import utils
from ..device import resolve
from ..ops.hist import Hist
from .model import Model, expand_source_configs
from .source import HistogramPdfSource, Source

__all__ = ['JaxDensitySource', 'prefill_anchor_templates']

#: (density, analysis-space key, param-name tuple, device) -> batch kernel
_KERNEL_CACHE = {}

#: incremented once per batched device call — lets tests assert "one call"
DEVICE_CALLS = 0


def _space_key(analysis_space):
    return tuple((name, tuple(np.asarray(edges, dtype=float).tolist()))
                 for name, edges in analysis_space)


def _batch_kernel(density, analysis_space, param_names, device=None):
    """``(n_anchors, n_params) -> (n_anchors, *bins)`` normalized-pmf kernel
    on ``device`` (see :func:`blueice_tpu_torch.device.resolve`), float64,
    cached per (density function, binning, parameter set, device). It takes
    and returns numpy arrays."""
    device = resolve(device, torch.float64)[0]
    key = (density, _space_key(analysis_space), tuple(param_names),
           str(device))
    if key in _KERNEL_CACHE:
        return _KERNEL_CACHE[key]

    # One source of truth for bin geometry: Hist's centers/volumes (the host
    # build path normalizes against the same values)
    h = Hist.from_analysis_space(analysis_space)

    def f64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)
    mesh = torch.meshgrid(*[f64(c) for c in h.bin_centers()], indexing='ij')
    volumes = f64(h.bin_volumes())

    def one_template(param_vector):
        params = {name: param_vector[i]
                  for i, name in enumerate(param_names)}
        pmf = density(params, *mesh) * volumes
        return pmf / pmf.sum()
    batched = torch.func.vmap(one_template)

    def kernel(params):
        return batched(f64(params)).cpu().numpy()
    _KERNEL_CACHE[key] = kernel
    return kernel


def _payload_from_pmf(c, pmf):
    """The cache payload dict for one source, from its normalized (summing to
    one) pmf grid over the analysis space."""
    mh = Hist.from_analysis_space(c['analysis_space'])
    volumes = mh.bin_volumes()
    pmf = np.asarray(pmf, dtype=float)

    pdf_hist = mh.similar_blank()
    pdf_hist.values = pmf / volumes
    # Exact density: infinite effective MC statistics behind every bin
    # (Source.get_pmf_grid contract). Do not use these sources with
    # Beeston-Barlow handling — there is no MC uncertainty to profile.
    n_events_hist = mh.similar_blank()
    n_events_hist.values = np.full(mh.shape, np.inf)

    rate_function = c.get('rate_function')
    events_per_day = float(c['events_per_day'])
    if rate_function is not None:
        events_per_day *= float(rate_function(
            {k: c[k] for k in c['density_params']}))

    return {'_pdf_histogram': pdf_hist,
            '_n_events_histogram': n_events_hist,
            '_bin_volumes': volumes,
            'fraction_in_range': 1.0,
            'events_per_day': events_per_day,
            'pdf_has_been_computed': True}


class JaxDensitySource(HistogramPdfSource):
    """A source whose PDF template is a closed-form density in torch ops.

    Config keys:

    * ``density`` — callable ``(params, *coords) -> density`` built from
      torch ops; ``params`` is a dict of the settings named in
      ``density_params`` (0-d float64 tensors), ``coords`` are the
      analysis-space bin-center meshgrids. Need not be normalized: the
      template is normalized over the analysis space (so
      ``fraction_in_range`` is 1 by construction). It must be traceable by
      ``torch.func.vmap``: no ``.item()`` or branches on values.
    * ``density_params`` — list of (numeric, scalar) config setting names the
      density reads. These are exactly the settings a shape parameter may
      vary: anchors differing only in them batch into one device call.
    * ``rate_function`` — optional callable ``params -> multiplier`` applied
      to ``events_per_day`` on the host (for shape parameters that also scale
      the rate).
    * ``template_device`` — the device of the build (None: the card).

    Templates for many anchors are built in ONE batched device call by
    :func:`prefill_anchor_templates`; a source constructed outside that path
    builds its own template with the same (singly-batched) kernel, so the two
    paths agree bit-for-bit.
    """

    defaults = dict(density=None, density_params=[], rate_function=None,
                    template_device=None,
                    dont_hash_settings=['template_device'])

    def build_histogram(self):
        c = self.config
        if c.get('density') is None:
            raise ValueError(
                "JaxDensitySource %s needs a 'density' config setting" % self)
        kernel = _batch_kernel(c['density'], c['analysis_space'],
                               c['density_params'], c['template_device'])
        params = np.asarray([[float(c[k]) for k in c['density_params']]])
        global DEVICE_CALLS
        DEVICE_CALLS += 1
        pmf = kernel(params)[0]
        for k, v in _payload_from_pmf(c, pmf).items():
            if k != 'pdf_has_been_computed':
                setattr(self, k, v)


def _jax_source_entries(model_configs):
    """Yield ``(cls, name, normalized_config)`` for every JaxDensitySource in
    every anchor model config, with hashes identical to what the real model
    build will compute (Model's own defaults merged in first)."""
    for config in model_configs:
        model_conf = utils.combine_dicts(Model.defaults, config,
                                         deep_copy=True)
        for cls, merged in expand_source_configs(model_conf):
            if not (isinstance(cls, type)
                    and issubclass(cls, JaxDensitySource)):
                continue
            name, c = cls.normalized_config(merged)
            yield cls, name, c


def prefill_anchor_templates(model_configs):
    """Build every uncached JaxDensitySource template across the given anchor
    model configs on the device, in one batched call per compatible group,
    and seed the template caches. Returns the number of templates built.

    Anchors are compatible (batch together) when their configs differ only in
    ``density_params`` values — i.e. they share the density function, binning
    and everything else pdf-relevant.
    """
    # group key -> (representative config, [(hash, param_vector, config)])
    groups = OrderedDict()
    seen_hashes = set()
    for cls, name, c in _jax_source_entries(model_configs):
        h = c['hash']
        if h in seen_hashes or h in Source._data_cache:
            continue
        seen_hashes.add(h)
        cache_file = os.path.join(c['cache_dir'], h)
        if not c['force_recalculation'] and os.path.exists(cache_file):
            continue
        if c.get('density') is None:
            raise ValueError(
                "JaxDensitySource %r needs a 'density' config setting" % name)

        group_key = utils.deterministic_hash(utils.combine_dicts(
            c, exclude=list(c['dont_hash_settings']) + list(c['density_params'])))
        rep_c, members = groups.setdefault(group_key, (c, []))
        members.append((h, [float(c[k]) for k in c['density_params']], c))

    n_built = 0
    global DEVICE_CALLS
    for rep_c, members in groups.values():
        kernel = _batch_kernel(rep_c['density'], rep_c['analysis_space'],
                               rep_c['density_params'],
                               rep_c['template_device'])
        params = np.asarray([pv for _, pv, _ in members], dtype=float)
        DEVICE_CALLS += 1
        pmfs = kernel(params)   # (n_anchors, *bins)

        for (h, _, c), pmf in zip(members, pmfs):
            payload = _payload_from_pmf(c, pmf)
            Source._data_cache[h] = payload
            if not c['never_save_to_cache']:
                os.makedirs(c['cache_dir'], exist_ok=True)
                utils.save_pickle(payload, os.path.join(c['cache_dir'], h))
            n_built += 1
    return n_built
