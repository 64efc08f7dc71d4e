"""A XENON1T-style 2D WIMP-search likelihood (BASELINE.json config #4).

Six sources over a 2D (cs1, log10_cs2) analysis space, four shape nuisances on
a 3^4 = 81-point morphing anchor grid, Gaussian-constrained background rates.
The physics is synthetic (correlated 2D Gaussian blobs standing in for the real
ER/NR bands) but the computational shape — template sizes, anchor-grid
dimensionality, source count, constraint structure — matches the target
workload, so this is the scaling benchmark for the fused likelihood path.

Counterpart of :mod:`blueice_tpu.examples.xenon_like` on the host-built
template path (``jax_templates=False``): the templates are the same numpy
arrays the JAX package builds.
"""

import numpy as np

from ..models.source import HistogramPdfSource
from ..ops.hist import Hist
from ..likelihood import BinnedLogLikelihood
from ..priors import NormalPrior

__all__ = ['GaussianBlobSource', 'build_config', 'build_likelihood']


class GaussianBlobSource(HistogramPdfSource):
    """Template source: a correlated 2D Gaussian blob over the analysis space,
    evaluated analytically on the bin grid (instant template build — the
    morphing/likelihood layers neither know nor care that no MC ran)."""

    defaults = dict(blob_mean=(30.0, 2.5),
                    blob_sigma=(10.0, 0.3),
                    blob_corr=0.0,
                    # Shape nuisances every source responds to (scaled by the
                    # per-source sensitivity below):
                    band_shift=0.0,       # shifts the cs2 band position
                    band_width_scale=1.0,  # scales the cs2 band width
                    cs1_tilt=0.0,          # shifts the cs1 position
                    efficiency=1.0,        # detection efficiency (rate only)
                    band_shift_response=0.0,
                    width_response=0.0,
                    tilt_response=0.0,
                    n_mc_events=int(1e6))

    def build_histogram(self):
        c = self.config
        mh = Hist.from_analysis_space(c['analysis_space'])
        centers = mh.bin_centers()
        x, y = np.meshgrid(*centers, indexing='ij')

        mx, my = c['blob_mean']
        sx, sy = c['blob_sigma']
        rho = c['blob_corr']

        # Apply the shape nuisances through per-source response coefficients
        my = my + c['band_shift'] * c['band_shift_response']
        sy = sy * (1.0 + (c['band_width_scale'] - 1.0) * c['width_response'])
        mx = mx + c['cs1_tilt'] * c['tilt_response']

        dx = (x - mx) / sx
        dy = (y - my) / sy
        norm = 1.0 / (2 * np.pi * sx * sy * np.sqrt(1 - rho ** 2))
        dens = norm * np.exp(-(dx ** 2 - 2 * rho * dx * dy + dy ** 2)
                             / (2 * (1 - rho ** 2)))

        self._bin_volumes = mh.bin_volumes()
        total = (dens * self._bin_volumes).sum()
        self.fraction_in_range = min(float(total), 1.0)

        self._pdf_histogram = mh.similar_blank()
        self._pdf_histogram.values = dens / total
        # Pretend-finite MC statistics behind the template (for BB studies)
        self._n_events_histogram = mh.similar_blank()
        self._n_events_histogram.values = np.maximum(
            dens / total * self._bin_volumes * c['n_mc_events'], 1e-3)
        return mh


SOURCES = [
    # name, events/day, mean, sigma, corr, (band, width, tilt) responses
    ('er', 620.0, (35.0, 2.55), (18.0, 0.16), -0.2, (1.0, 1.0, 0.2)),
    ('nr', 0.9, (32.0, 2.10), (16.0, 0.18), 0.3, (0.6, 0.8, 0.3)),
    ('ac', 0.6, (20.0, 1.60), (25.0, 0.40), 0.0, (0.0, 0.3, 0.0)),
    ('wall', 1.8, (8.0, 1.90), (6.0, 0.35), 0.5, (0.2, 0.5, 1.0)),
    ('cnns', 0.15, (6.0, 2.00), (3.0, 0.20), 0.4, (0.7, 0.9, 0.1)),
    ('wimp', 2.5, (25.0, 2.05), (12.0, 0.17), 0.35, (0.8, 0.9, 0.5)),
]


def build_config(n_cs1_bins=50, n_cs2_bins=62, livetime_days=278.0,
                 cache_dir=None, task_dir=None, jax_templates=False):
    """:param jax_templates: only False is ported (device-side batched
    template building is ROADMAP queue 1 item 13)."""
    if jax_templates:
        raise NotImplementedError(
            "jax_templates=True (device-side batched template building) is "
            "not ported yet (ROADMAP queue 1 item 13)")
    import tempfile
    cache_dir = cache_dir or tempfile.mkdtemp(prefix='xenon_like_cache_')
    task_dir = task_dir or tempfile.mkdtemp(prefix='xenon_like_tasks_')

    def source_entry(name, rate, mean, sigma, corr, resp):
        entry = dict(name=name, events_per_day=rate,
                     apply_efficiency=(name == 'wimp'),
                     efficiency_name='efficiency',
                     # 'efficiency' scales rates at the likelihood level
                     # only — build_histogram never reads it, so it must not
                     # enter the template content hash (without this, each
                     # source built 3x redundant cached templates, one per
                     # efficiency anchor)
                     dont_hash_settings=['efficiency'])
        entry.update(blob_mean=mean, blob_sigma=sigma, blob_corr=corr,
                     band_shift_response=resp[0],
                     width_response=resp[1], tilt_response=resp[2])
        return entry

    config = dict(
        analysis_space=[['cs1', np.linspace(0, 100, n_cs1_bins + 1)],
                        ['log10_cs2', np.linspace(1.0, 4.0, n_cs2_bins + 1)]],
        default_source_class=GaussianBlobSource,
        livetime_days=livetime_days,
        band_shift=0.0,
        band_width_scale=1.0,
        cs1_tilt=0.0,
        efficiency=1.0,
        cache_dir=cache_dir,
        task_dir=task_dir,
        sources=[source_entry(*s) for s in SOURCES],
    )
    return config


def build_likelihood(kind='binned', n_anchors=3, prepare=True, bb=False,
                     **kwargs):
    """The full 6-source, 4-shape-nuisance likelihood.

    Shape nuisances (3 anchors each by default -> 3^4 = 81 anchor models):
    band_shift, band_width_scale, cs1_tilt (morphing) + efficiency (rate-like,
    applied to the wimp source). Background rates carry Gaussian constraints.

    :param kind: only 'binned' is ported (unbinned is ROADMAP queue 1
      item 9).
    :param bb: finite-MC-statistics handling. True or 'bb_single' enables
      the reference's one-source Beeston-Barlow on the dominant 'er'
      background (blueice/likelihood.py:618-660); 'bb_lite' enables the
      HistFactory-style all-source per-bin scale (ops/bb_lite.py). Either
      requires the blob templates, which carry synthetic per-bin MC counts;
      binned only.
    """
    likelihood_config = None
    if bb:
        mode = 'bb_single' if bb is True else bb
        if mode not in ('bb_single', 'bb_lite'):
            raise ValueError("bb must be True/'bb_single' or 'bb_lite'; "
                             "got %r" % (bb,))
        if kind != 'binned' or kwargs.get('jax_templates'):
            raise ValueError("Beeston-Barlow needs the binned likelihood "
                             "over blob templates (which carry MC counts)")
        likelihood_config = {
            'model_statistical_uncertainty_handling': mode}
        if mode == 'bb_single':
            likelihood_config['bb_single_source'] = 'er'
    if kind != 'binned':
        raise NotImplementedError(
            "kind=%r is not ported yet (ROADMAP queue 1 item 9)" % (kind,))
    config = build_config(**kwargs)
    lf = BinnedLogLikelihood(config, likelihood_config=likelihood_config)

    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=NormalPrior(1, 0.05))
    lf.add_rate_parameter('nr', log_prior=NormalPrior(1, 0.2))
    lf.add_rate_parameter('wall', log_prior=NormalPrior(1, 0.3))

    zs = tuple(np.linspace(-1, 1, n_anchors))
    lf.add_shape_parameter('band_shift', zs,
                           log_prior=NormalPrior(0, 0.5))
    lf.add_shape_parameter('band_width_scale',
                           tuple(np.linspace(0.8, 1.2, n_anchors)),
                           log_prior=NormalPrior(1, 0.1))
    lf.add_shape_parameter('cs1_tilt', zs, log_prior=NormalPrior(0, 0.5))
    lf.add_shape_parameter('efficiency',
                           tuple(np.linspace(0.7, 1.3, n_anchors)),
                           log_prior=NormalPrior(1, 0.1))

    if prepare:
        lf.prepare()
    return lf
