"""The unbinned kind's system under test: the port's extended unbinned
likelihood and ``UnbinnedToyStudy``, built from a configuration file
through the port's public config API, the templates as the binned kind
builds them (``systems/binned.py`` ``port_config``). Its datasets are the
``(coords, mask, bins)`` event sets that ``benchmark/reference/unbinned.py``
draws; the study scores and centres them inside the timed call."""

from benchmark.harness.systems.binned import port_config

__all__ = ['build_likelihood', 'build_study']


def build_likelihood(config, cache_dir):
    """The prepared port ``UnbinnedLogLikelihood`` of a configuration
    file's model: its sources, rate and shape parameters and priors as the
    binned kind sets them, its events scored by the configuration's
    ``pdf_interpolation_method`` and its ``outlier_likelihood``."""
    from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
    from blueice_tpu_torch.priors import NormalPrior
    if config.get('likelihood') != 'unbinned':
        raise ValueError("the unbinned kind drives unbinned likelihoods")
    base = port_config(config, cache_dir)
    base['pdf_interpolation_method'] = config['pdf_interpolation_method']
    lf = UnbinnedLogLikelihood(base, likelihood_config={
        'outlier_likelihood': float(config['outlier_likelihood'])})
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
    ``UnbinnedToyStudy`` with the configuration's ``n_max`` event slots a
    toy, in its ``dtype``."""
    from blueice_tpu_torch.parallel.toys import UnbinnedToyStudy
    lf = build_likelihood(config, cache_dir)
    return lf, UnbinnedToyStudy(lf, n_max=int(config['n_max']), dtype=dtype,
                                device=device)
