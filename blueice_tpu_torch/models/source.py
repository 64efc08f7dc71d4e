"""Source base classes, in order of increasing functionality:

* :class:`Source` — config normalization, content-addressed template caching,
  delayed computation via task files. Use directly for analytic PDFs.
* :class:`HistogramPdfSource` — PDF backed by a dense N-dim histogram template.
* :class:`DensityEstimatingSource` — builds that template by binning sample events.
* :class:`MonteCarloSource` — gets the sample from its own ``simulate()``.

Role parity with the reference class ladder (reference: blueice/source.py:33-348),
re-designed template-first: a source's PDF is a dense array payload (the thing a
device consumes), host code only builds/caches it. The content-addressed cache
(sha1 of the pdf-relevant config, two tiers: per-process dict + on-disk pickle,
atomic writes) mirrors reference blueice/source.py:97-126; the template payload is
what checkpoint/resume means in this framework (SURVEY.md §5).
"""

import os

import numpy as np

from .. import utils
from ..exceptions import PDFNotComputedException
from ..ops.hist import Hist
from ..ops.interp import interp_at_points_np
from ..utils.data_reading import read_files_in

__all__ = ['Source', 'HistogramPdfSource', 'DensityEstimatingSource',
           'MonteCarloSource']

# Settings that never influence the PDF itself and are therefore excluded from the
# content hash (reference: blueice/source.py:77-80)
_ALWAYS_DONT_HASH = ['hash', 'rate_multiplier', 'force_recalculation',
                     'never_save_to_cache', 'dont_hash_settings', 'label', 'color',
                     'extra_dont_hash_settings', 'delay_pdf_computation',
                     'cache_dir', 'task_dir', 'nohash_settings',
                     # likelihood-level morphing strategy; no effect on any pdf
                     'source_wise_interpolation']


def simulate_with_rng(simulate, n_events, rng):
    """Call a source's ``simulate``, forwarding ``rng`` only when the
    signature opts into it (toy reproducibility without forcing every custom
    generator to accept the argument). Shared by Model.simulate and
    Source.simulate_toy."""
    import inspect
    try:
        params = inspect.signature(simulate).parameters
    except (TypeError, ValueError):
        params = {}
    if rng is not None and 'rng' in params:
        return simulate(n_events, rng=rng)
    return simulate(n_events)


def _merge_unique(*lists):
    """Concatenate lists, keeping first occurrence of each item, in order."""
    out = []
    for lst in lists:
        for x in lst:
            if x not in out:
                out.append(x)
    return out


class Source:
    """Base class for a source of events."""

    # Process-level second cache tier: hash -> dict of cached attributes
    _data_cache = dict()

    #: Config defaults; child classes extend via their own `defaults`.
    defaults = dict(
        name='unnamed_source',
        label='Unnamed source',
        color='black',                 # color to use in plots
        events_per_day=0,              # events/day this source produces (detected or not)
        rate_multiplier=1,             # per-source rate multiplier (model-level, not LL-level)
        fraction_in_range=1,           # fraction of simulated events inside analysis space
        cache_attributes=[],           # attribute names persisted in the template cache
        delay_pdf_computation=False,   # write a task file instead of computing now
        dont_hash_settings=[],         # settings with no impact on the pdf
        extra_dont_hash_settings=[],
        force_recalculation=False,     # never *read* the cache (writing still happens)
        never_save_to_cache=False,     # never *write* the cache (reading still happens)
        cache_dir='pdf_cache',
        task_dir='pdf_tasks',
    )

    def __repr__(self):
        return "%s[%s]" % (self.name, getattr(self, 'hash', 'nohashknown'))

    def __init__(self, config, *args, **kwargs):
        name, c = self.normalized_config(config)
        self.name = name
        self.events_per_day = c['events_per_day']
        self.fraction_in_range = c['fraction_in_range']
        self.pdf_has_been_computed = False
        self.hash = c['hash']

        os.makedirs(c['cache_dir'], exist_ok=True)
        self._cache_filename = os.path.join(c['cache_dir'], self.hash)

        self.from_cache = False
        in_process_cache = self.hash in self._data_cache
        if not c['force_recalculation'] and (
                in_process_cache or os.path.exists(self._cache_filename)):
            self.from_cache = True
            if in_process_cache:
                stuff = self._data_cache[self.hash]
            else:
                stuff = self._data_cache[self.hash] = \
                    utils.read_pickle(self._cache_filename)
            for k, v in stuff.items():
                if k not in c['cache_attributes']:
                    raise ValueError(
                        "%s found in cached file, but you only wanted %s from "
                        "cache. Old cache?" % (k, c['cache_attributes']))
                setattr(self, k, v)

        # Replace filename-valued settings with the file contents
        c = read_files_in(c, config.get('data_dirs', tuple('.')))
        self.config = c

        if self.from_cache:
            assert self.pdf_has_been_computed
        elif self.config['delay_pdf_computation']:
            self.prepare_task()
        else:
            self.compute_pdf()

    @classmethod
    def normalized_config(cls, config):
        """``(name, c)``: the source name and the fully merged config, with the
        content hash set at ``c['hash']`` — exactly what ``__init__`` would
        compute, but without building anything (addresses the cache for
        sources not instantiated yet)."""
        defaults = cls._gather_defaults()
        c = utils.combine_dicts(defaults, config)
        # List-valued bookkeeping settings append (class ladder + user config)
        # rather than override, as in the reference's per-class chaining.
        c['cache_attributes'] = _merge_unique(
            defaults['cache_attributes'], config.get('cache_attributes', ()),
            ['fraction_in_range', 'events_per_day', 'pdf_has_been_computed'])
        c['dont_hash_settings'] = _merge_unique(
            defaults['dont_hash_settings'], config.get('dont_hash_settings', ()),
            # Model.defaults declares nohash_settings (data_dirs etc.):
            # honoring it keeps the content hash stable when the same data
            # files live under a different directory root
            config.get('nohash_settings', ()),
            _ALWAYS_DONT_HASH, c['extra_dont_hash_settings'])
        del c['extra_dont_hash_settings']
        name = c.pop('name')

        # Content address: hash of the pdf-relevant config PLUS the source
        # class itself — two classes with identical configs compute different
        # templates (their compute_pdf/simulate differ), and colliding them
        # would silently bind one source's template to the other. The name is
        # deliberately NOT hashed: same-physics sources under different names
        # legitimately share one cached template.
        if 'hash' not in c:
            hash_config = utils.combine_dicts(c, exclude=c['dont_hash_settings'])
            hash_config['__source_class__'] = '%s.%s' % (cls.__module__,
                                                         cls.__qualname__)
            c['hash'] = utils.deterministic_hash(hash_config)
        return name, c

    @classmethod
    def _gather_defaults(cls):
        """Merge the `defaults` dicts along the class MRO (base first). The
        list-valued bookkeeping keys accumulate across the ladder instead of
        overriding."""
        from copy import deepcopy
        result = {}
        for klass in reversed(cls.__mro__):
            d = klass.__dict__.get('defaults')
            if not d:
                continue
            for k, v in d.items():
                if k in ('cache_attributes', 'dont_hash_settings') and k in result:
                    result[k] = _merge_unique(result[k], v)
                else:
                    result[k] = deepcopy(v)
        return result

    # -- template computation and caching -------------------------------------

    def compute_pdf(self):
        """Compute the PDF template. Called after config init, only when the source
        was not loaded from cache. Child classes do their work, then call super().
        """
        if self.pdf_has_been_computed:
            raise RuntimeError("compute_pdf called twice on a source!")
        self.pdf_has_been_computed = True
        self.save_to_cache()

    def save_to_cache(self):
        """Persist the attributes named in config['cache_attributes']."""
        if not self.from_cache and not self.config['never_save_to_cache']:
            utils.save_pickle(
                {k: getattr(self, k) for k in self.config['cache_attributes']},
                self._cache_filename)
        return self._cache_filename

    def prepare_task(self):
        """Write a task file for delayed/remote computation (reference:
        blueice/source.py:162-165)."""
        os.makedirs(self.config['task_dir'], exist_ok=True)
        task_filename = os.path.join(self.config['task_dir'], self.hash)
        utils.save_pickle((self.__class__, self.config), task_filename)

    # -- interface -------------------------------------------------------------

    def pdf(self, *args):
        """PDF values at the given per-dimension coordinate arrays."""
        raise NotImplementedError

    def get_pmf_grid(self):
        """Return (pmf_grid, n_events):
        - pmf_grid: probability mass per analysis-space bin;
        - n_events: events per bin behind the density estimate (inf for exact pdfs).
        Used by binned likelihoods.
        """
        raise NotImplementedError

    def simulate(self, n_events):
        """Simulate n_events from this source (may return fewer)."""
        raise NotImplementedError

    @property
    def expected_events(self):
        """Total number of events expected in the analysis range."""
        return (self.events_per_day * self.config['livetime_days']
                * self.fraction_in_range * self.config['rate_multiplier'])


class HistogramPdfSource(Source):
    """A source whose PDF is a dense histogram template.

    The payload (`_pdf_histogram`, `_n_events_histogram`, `_bin_volumes`) is the
    device-ready template: per-bin density values plus the MC counts behind them.
    """
    _pdf_histogram = None
    _bin_volumes = None
    _n_events_histogram = None

    defaults = dict(pdf_sampling_multiplier=1,
                    pdf_interpolation_method='linear',
                    cache_attributes=['_pdf_histogram', '_n_events_histogram',
                                      '_bin_volumes'])

    def build_histogram(self):
        """Set the _pdf_histogram (Hist), _n_events_histogram (Hist) and
        _bin_volumes (ndarray) attributes."""
        raise NotImplementedError

    def compute_pdf(self):
        self.build_histogram()
        Source.compute_pdf(self)

    def pdf(self, *args):
        if not self.pdf_has_been_computed:
            raise PDFNotComputedException(
                "%s: attempt to call a PDF that has not been computed" % self)

        method = self.config['pdf_interpolation_method']
        h = self._pdf_histogram

        if method == 'linear':
            # Multilinear interpolation between bin centers; coordinates beyond
            # the outermost centers clip (constant density in boundary half-bins).
            coords = np.stack([np.asarray(a, dtype=float).ravel() for a in args],
                              axis=-1)
            return interp_at_points_np(h.values, h.bin_centers(), coords)
        elif method == 'piecewise':
            return h.lookup(*args)
        else:
            raise NotImplementedError(
                "PDF interpolation method %s not implemented" % method)

    def simulate(self, n_events, rng=None):
        """Simulate n_events from the PDF template (host path; the device path is
        ops.sampling.sample_from_template).

        With fraction_in_range < 1, the requested count is binomially thinned
        first: Model.simulate requests Poisson(expected / fraction_in_range)
        events expecting the range cut to trim the out-of-range share, but a
        template draw is in-range by construction — without thinning, toy
        datasets are overpopulated by 1/fraction_in_range (the reference has
        this bug: its template sources also draw in-range-only,
        blueice/source.py:219-246 vs model.py's 1/fraction scale-up)."""
        if not self.pdf_has_been_computed:
            raise PDFNotComputedException(
                "%s: attempt to simulate events from a PDF that has not been "
                "computed" % self)
        n_events = int(n_events)
        if self.fraction_in_range < 1.0:
            r = np.random if rng is None else rng
            n_events = int(r.binomial(n_events, self.fraction_in_range))
        events_per_bin = self._pdf_histogram * self._bin_volumes
        q = events_per_bin.get_random(n_events, rng=rng)
        d = np.zeros(n_events,
                     dtype=[('source', int)] + [(x[0], float)
                                                for x in self.config['analysis_space']])
        for i, x in enumerate(self.config['analysis_space']):
            d[x[0]] = q[:, i]
        return d

    def get_pmf_grid(self):
        return (self._pdf_histogram.values * self._bin_volumes,
                self._n_events_histogram.values)


class DensityEstimatingSource(HistogramPdfSource):
    """A source that estimates its PDF template from events you feed it.

    Child classes implement get_events_for_density_estimate (returning, or
    yielding in batches, (events, n_simulated)).

    **Weighted events** (beyond the reference, whose density estimation is
    unweighted-only — blueice/source.py:272-310): set ``weight_field`` to the
    name of a per-event weight field. Then:

    * the template is the per-bin weight sum, normalized to a density;
    * ``n_simulated`` must be the total *generated weight* of each batch
      (events the generator would cut must still be returned, with weight 0,
      or accounted for in this total), so ``fraction_in_range`` becomes
      (in-range weight)/(generated weight);
    * the MC-statistics histogram consumed by the Beeston-Barlow modes holds
      the per-bin *effective* counts n_eff = (sum w)^2 / (sum w^2) — the
      standard scaled-Poisson-distribution equivalent sample size, which
      reduces exactly to the raw count for unit weights;
    * toy datasets are drawn from the built template, not from the weighted
      generator (weighted events are not a toy sample) — see
      :attr:`simulates_weighted_events`.

    Negative weights (e.g. NLO MC) are accepted for template building; bins
    whose net weight is negative make the template unusable for toy sampling
    and are rejected there with a clear error.

    **Template smoothing** (beyond the reference): set
    ``template_smoothing_sigma`` to a Gaussian kernel width in BIN units
    (scalar, or one value per analysis axis) to smooth the estimated density.
    The smoothed template is renormalized to the unsmoothed in-range mass, so
    rates and ``fraction_in_range`` are untouched. The MC-statistics
    histogram keeps the RAW per-bin (effective) counts: smoothing correlates
    neighboring bins, so the raw sample size is the honest input to the
    Beeston-Barlow modes.
    """

    defaults = dict(n_events_for_pdf=1e6,
                    weight_field=None,
                    template_smoothing_sigma=None)

    @property
    def simulates_weighted_events(self):
        """True when simulate() returns weighted events — Model.simulate then
        draws toys from the built template instead."""
        return self.config.get('weight_field') is not None

    def simulate_toy(self, n_events, rng=None):
        """Unweighted toy draw: the template sample for weighted sources,
        the plain simulate() otherwise."""
        if not self.simulates_weighted_events:
            return simulate_with_rng(self.simulate, n_events, rng)
        if not self.pdf_has_been_computed:
            raise PDFNotComputedException(
                "%s: attempt to simulate toys from a PDF that has not been "
                "computed" % self)
        if np.any(self._pdf_histogram.values < 0):
            raise ValueError(
                "%s: the weighted template has net-negative bins; it cannot "
                "be sampled as a toy distribution" % self)
        if self.fraction_in_range > 1.0 + 1e-9:
            # Net-negative OUT-of-range weight: expected_events stays
            # consistent, but the caller's 1/fraction_in_range scale-up
            # cannot be undone by binomial thinning (it would need to ADD
            # events) — refusing beats silently under-populating every toy.
            # (The relative tolerance passes the f == 1 + roundoff case of
            # weight normalizations like w / w.mean().)
            raise ValueError(
                "%s: fraction_in_range = %.3f > 1 (net-negative out-of-range "
                "weight); host toy simulation cannot represent this source"
                % (self, self.fraction_in_range))
        return HistogramPdfSource.simulate(self, n_events, rng=rng)

    def build_histogram(self):
        mh = Hist.from_analysis_space(self.config['analysis_space'])
        weight_field = self.config.get('weight_field')
        mh2 = mh.similar_blank() if weight_field is not None else None

        get = self.get_events_for_density_estimate
        import inspect
        if not inspect.isgeneratorfunction(get):
            def get():
                return [self.get_events_for_density_estimate()]

        n_events = 0
        for events, n_simulated in get():
            n_events += n_simulated
            coords = utils.events_to_analysis_dimensions(
                events, self.config['analysis_space'])
            if weight_field is None:
                mh.add(*coords)
            else:
                w = np.asarray(events[weight_field], dtype=float)
                mh.add(*coords, weights=w)
                mh2.add(*coords, weights=w * w)

        if weight_field is not None and mh.n <= 0:
            raise ValueError(
                "%s: the total in-range weight is %s; a weighted template "
                "needs positive net weight to define a density" % (self, mh.n))
        self.fraction_in_range = mh.n / n_events

        # weight sums -> density: divide by in-range weight and bin volumes
        self._bin_volumes = mh.bin_volumes()
        self._pdf_histogram = mh.similar_blank()
        self._pdf_histogram.values = (
            self._smoothed_values(mh.values.astype(float)) / mh.n
            / self._bin_volumes)
        if weight_field is None:
            self._n_events_histogram = mh
        else:
            # Effective sample size per bin: what the Beeston-Barlow modes
            # treat as the Poisson-distributed MC count behind each bin.
            # Bins whose NET weight is negative carry no usable MC-count
            # information (the scaled-Poisson equivalence assumes a positive
            # mean), so they get 0 — the BB modes then treat them like
            # empty-MC bins instead of healthy ones.
            neff = mh.similar_blank()
            sumw2 = mh2.values
            with np.errstate(divide='ignore', invalid='ignore'):
                neff.values = np.where((sumw2 > 0) & (mh.values > 0),
                                       mh.values ** 2 / np.where(sumw2 > 0,
                                                                 sumw2, 1.0),
                                       0.0)
            self._n_events_histogram = neff
        return mh

    def _smoothed_values(self, values):
        """Gaussian-smooth the accumulated per-bin weights (see class
        docstring); identity when template_smoothing_sigma is unset."""
        sigma = self.config.get('template_smoothing_sigma')
        if sigma is None:
            return values
        sigmas = np.atleast_1d(np.asarray(sigma, dtype=float))
        if np.any(sigmas < 0):
            raise ValueError("template_smoothing_sigma must be >= 0; got %r"
                             % (sigma,))
        if sigmas.size not in (1, values.ndim):
            raise ValueError(
                "template_smoothing_sigma needs 1 value or one per analysis "
                "axis (%d); got %d" % (values.ndim, sigmas.size))
        if not np.any(sigmas > 0):
            return values
        from scipy.ndimage import gaussian_filter
        # mode='constant' keeps mass from wrapping/reflecting; the rescale
        # below puts the kernel tail lost over the edges back
        smoothed = gaussian_filter(
            values, sigma=(float(sigmas[0]) if sigmas.size == 1
                           else tuple(float(s) for s in sigmas)),
            mode='constant', cval=0.0)
        total, smoothed_total = values.sum(), smoothed.sum()
        if total > 0 and smoothed_total > 0:
            smoothed *= total / smoothed_total
        return smoothed

    def get_events_for_density_estimate(self):
        """Return (or yield in batches) (events, n_simulated). The count is needed
        because simulators may already have cut some events."""
        raise NotImplementedError


class MonteCarloSource(DensityEstimatingSource):
    """A DensityEstimatingSource fed by its own simulate() method."""

    defaults = dict(n_events_for_pdf=1e6,
                    pdf_sampling_multiplier=1,
                    pdf_sampling_batch_size=1e6,
                    dont_hash_settings=['pdf_sampling_batch_size'])

    def get_events_for_density_estimate(self):
        # Simulate in batches to bound memory (reference: blueice/source.py:338-348).
        # The last batch covers the remainder, so non-integer multiples of the
        # batch size still produce the full configured MC statistics.
        weight_field = self.config.get('weight_field')
        n_todo = int(round(self.config['n_events_for_pdf']
                           * self.config['pdf_sampling_multiplier']))
        batch_size = int(self.config['pdf_sampling_batch_size'])
        while n_todo > 0:
            n = min(batch_size, n_todo)
            events = self.simulate(n_events=n)
            if weight_field is None:
                yield events, n
            else:
                # Weighted generator contract (see DensityEstimatingSource):
                # every generated event comes back (weight 0 if cut), so the
                # generated weight IS the sum of the returned weights
                yield events, float(np.sum(np.asarray(events[weight_field],
                                                      dtype=float)))
            n_todo -= n
