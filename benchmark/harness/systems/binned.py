"""The binned kind's system under test: the port's binned likelihood and
``BinnedToyStudy``, built from a configuration file through the port's
public config API (as ``blueice_tpu_torch.examples.xenon_like.build_config``
and ``build_likelihood`` build theirs). Its datasets are the counts tensors
that ``benchmark/reference/binned.py`` draws."""

import os

import numpy as np

__all__ = ['build_likelihood', 'build_study']


def port_config(config, cache_dir):
    """The port's ``pdf_base_config`` for a configuration file's model."""
    from blueice_tpu_torch.examples.xenon_like import GaussianBlobSource
    if config.get('source_model') != 'gaussian_blob':
        raise ValueError("unknown source model %r"
                         % config.get('source_model'))
    eff = config.get('efficiency_parameter')
    sources = []
    for s in config['sources']:
        entry = dict(name=s['name'], events_per_day=float(s['events_per_day']),
                     blob_mean=tuple(s['blob_mean']),
                     blob_sigma=tuple(s['blob_sigma']),
                     blob_corr=float(s['blob_corr']),
                     band_shift_response=float(s['band_shift_response']),
                     width_response=float(s['width_response']),
                     tilt_response=float(s['tilt_response']),
                     n_mc_events=int(s['n_mc_events']),
                     apply_efficiency=bool(s.get('apply_efficiency', False)))
        if eff:
            # the efficiency scales rates only: no template depends on it
            entry.update(efficiency_name=eff, dont_hash_settings=[eff])
        sources.append(entry)
    out = dict(
        analysis_space=[[name, np.linspace(float(lo), float(hi), int(n) + 1)]
                        for name, lo, hi, n in config['analysis_space']],
        default_source_class=GaussianBlobSource,
        livetime_days=float(config['livetime_days']),
        cache_dir=os.path.join(cache_dir, 'pdf_cache'),
        task_dir=os.path.join(cache_dir, 'pdf_tasks'),
        sources=sources)
    for p in config['shape_parameters']:
        out[p['name']] = float(p['base'])
    return out


def build_likelihood(config, cache_dir):
    """The prepared port likelihood of a configuration file's model."""
    from blueice_tpu_torch.likelihood import BinnedLogLikelihood
    from blueice_tpu_torch.priors import NormalPrior
    if config.get('likelihood') != 'binned':
        raise ValueError("the harness drives binned likelihoods")
    likelihood_config = None
    bb = config.get('statistical_uncertainty')
    if bb is not None:
        likelihood_config = {
            'model_statistical_uncertainty_handling': bb['mode'],
            'bb_single_source': bb['source']}
    lf = BinnedLogLikelihood(port_config(config, cache_dir),
                             likelihood_config=likelihood_config)
    for r in config['rate_parameters']:
        prior = r.get('normal_prior')
        lf.add_rate_parameter(r['source'], log_prior=(
            NormalPrior(*prior) if prior else None))
    for p in config['shape_parameters']:
        prior = p.get('normal_prior')
        lf.add_shape_parameter(
            p['name'], tuple(p['anchors']),
            log_prior=NormalPrior(*prior) if prior else None)
    lf.prepare()
    return lf


def build_study(config, device, cache_dir, dtype):
    """(likelihood, toy study) on ``device``: the port's
    ``BinnedToyStudy`` in the configuration's ``dtype``."""
    from blueice_tpu_torch.parallel.toys import BinnedToyStudy
    lf = build_likelihood(config, cache_dir)
    return lf, BinnedToyStudy(lf, dtype=dtype, device=device)
