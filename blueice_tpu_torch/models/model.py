"""Model: the set of Sources built from one config — the unit the likelihood
layer instantiates per shape-parameter anchor.

Capability parity with the reference model layer (reference: blueice/model.py),
organized around two jobs:

* **config fan-out** (:func:`expand_source_configs`): the global config is
  merged under each entry of ``config['sources']``, and global
  ``<name>_rate_multiplier`` settings are folded into that source's own
  ``rate_multiplier``;
* **stacked payloads**: :meth:`Model.pmf_grids` / :meth:`Model.score_events` /
  :meth:`Model.expected_events` return arrays with a leading source axis —
  exactly the per-anchor slices the device likelihood tensors are built from.

Toy simulation (:meth:`Model.simulate`) draws per-source Poisson counts with an
optional seeded generator, concatenates the source samples and applies the
analysis-space range cut.
"""

import numpy as np

from .. import utils
from .source import simulate_with_rng

__all__ = ['Model', 'expand_source_configs']

_MODEL_ONLY_KEYS = ('sources', 'default_source_class', 'class')


def expand_source_configs(config):
    """Fan the model config out into per-source (source_class, config) pairs.

    Each source sees the global config with its own ``sources`` entry merged on
    top. Global ``<name>_rate_multiplier`` keys become that source's
    ``rate_multiplier`` (default 1) and are stripped from every source's view.
    """
    fallback_class = config.get('default_source_class')
    pairs = []
    for entry in config['sources']:
        cls = entry.get('class', fallback_class)
        if cls is None:
            raise ValueError(
                "Source %r has no 'class' key and the config sets no "
                "default_source_class" % entry.get('name', '?'))
        merged = utils.combine_dicts(config, entry, exclude=_MODEL_ONLY_KEYS)
        own_multiplier_key = '%s_rate_multiplier' % merged.get(
            'name', 'unnamed_source')
        # Precedence: a global '<name>_rate_multiplier' setting, else the
        # entry's own documented 'rate_multiplier', else 1
        multiplier = merged.get(own_multiplier_key,
                                merged.get('rate_multiplier', 1))
        merged = {k: v for k, v in merged.items()
                  if not k.endswith('_rate_multiplier')}
        merged['rate_multiplier'] = multiplier
        pairs.append((cls, merged))
    return pairs


def _call_simulate(source, n, rng):
    """source.simulate(n), threading the generator through for sources whose
    signature opts into an ``rng`` argument (full toy reproducibility; the
    Poisson count draw is seeded either way).

    Sources whose simulate() returns *weighted* events (weight_field set on a
    DensityEstimatingSource) are not a toy sample; those route through
    simulate_toy, which draws unweighted events from the built template."""
    if getattr(source, 'simulates_weighted_events', False):
        return source.simulate_toy(n, rng=rng)
    return simulate_with_rng(source.simulate, n, rng)


def _concat_events(parts):
    """Concatenate per-source event arrays, tolerating differing dtypes by
    projecting onto the shared fields (first part's order and field dtypes).
    Needed when e.g. one source's generator events carry a weight column that
    another source's template-drawn toys do not."""
    if len({p.dtype for p in parts}) == 1:
        return np.concatenate(parts)
    common = [f for f in parts[0].dtype.names
              if all(f in (q.dtype.names or ()) for q in parts)]
    dtype = [(f, parts[0].dtype[f]) for f in common]
    out = np.zeros(sum(len(p) for p in parts), dtype=dtype)
    i = 0
    for p in parts:
        for f in common:
            out[f][i:i + len(p)] = p[f]
        i += len(p)
    return out


class Model:
    """Several Sources behind one config, with dataset simulation and the
    stacked per-source payload views the likelihood layer consumes."""

    defaults = dict(livetime_days=1,
                    data_dirs='.',
                    nohash_settings=['data_dirs', 'pdf_sampling_batch_size',
                                     'force_recalculation'])

    def __init__(self, config, **kwargs):
        """
        :param config: dict of detector parameters, the source list, etc.
        :param kwargs: overrides applied on top of config.
        """
        self.config = utils.combine_dicts(self.defaults, config, kwargs,
                                          deep_copy=True)
        if 'rate_multiplier' in self.config:
            raise ValueError(
                "A bare 'rate_multiplier' setting in the model config is "
                "ambiguous; use <source_name>_rate_multiplier")

        self.sources = [cls(conf)
                        for cls, conf in expand_source_configs(self.config)]
        # The built sources are authoritative from here on; drop the list so a
        # later mutation of config['sources'] can't silently do nothing
        del self.config['sources']

    # -- source access ---------------------------------------------------------

    def get_source_i(self, source_id):
        """Source index from an index or a (substring of a) source name.
        An exact name match wins; an ambiguous substring raises instead of
        silently picking the first hit (the reference's lookup did —
        blueice/model.py:51-59 — so e.g. 'er' resolved to 'wimp_er')."""
        if isinstance(source_id, (int, float)):
            return int(source_id)
        exact = [i for i, s in enumerate(self.sources)
                 if s.name == source_id]
        if exact:
            return exact[0]
        matches = [i for i, s in enumerate(self.sources)
                   if source_id in s.name]
        if not matches:
            raise ValueError("Unknown source %s" % source_id)
        if len(matches) > 1:
            raise ValueError(
                "Source id %r is ambiguous: matches %s"
                % (source_id, [self.sources[i].name for i in matches]))
        return matches[0]

    def get_source(self, source_id):
        return self.sources[self.get_source_i(source_id)]

    # -- datasets ----------------------------------------------------------------

    @property
    def analysis_space(self):
        return self.config['analysis_space']

    def range_cut(self, d):
        """The events of dataset d inside the analysis-space bounds."""
        in_range = np.ones(len(d), dtype=bool)
        for coords, edges in zip(self.to_analysis_dimensions(d),
                                 (e for _, e in self.analysis_space)):
            in_range &= (edges[0] <= coords) & (coords <= edges[-1])
        return d[in_range]

    def simulate(self, rate_multipliers=None, livetime_days=None, rng=None):
        """Make a toy dataset: per-source Poisson counts, sampled events,
        concatenated and range-cut.
        :param rate_multipliers: dict {source name: multiplier}.
        :param livetime_days: exposure to simulate (scales every source).
        :param rng: optional numpy Generator for reproducibility.
        """
        rate_multipliers = rate_multipliers or {}
        rng = np.random if rng is None else rng

        # Expected counts BEFORE the range cut: simulate() also produces events
        # outside the analysis space, which range_cut removes below — so scale
        # up by 1/fraction_in_range.
        mus = np.array([
            self.expected_events(s)
            * rate_multipliers.get(s.name, 1) / s.fraction_in_range
            for s in self.sources])
        if livetime_days is not None:
            mus *= livetime_days / self.config['livetime_days']

        parts = []
        for i, (source, n) in enumerate(zip(self.sources, rng.poisson(mus))):
            events = _call_simulate(source, n, rng)
            events['source'] = i
            parts.append(events)
        return self.range_cut(_concat_events(parts))

    def to_analysis_dimensions(self, d):
        """List of per-dimension coordinate arrays for the events of d."""
        return utils.events_to_analysis_dimensions(d, self.analysis_space)

    # -- stacked per-source payloads ------------------------------------------------

    def score_events(self, d):
        """(n_sources, n_events) pdf values for each source at each event."""
        coords = self.to_analysis_dimensions(d)
        return np.vstack([s.pdf(*coords) for s in self.sources])

    def pmf_grids(self):
        """(pmfs, n_model_events), each (n_sources, *analysis_space_shape)."""
        pmfs, n_events = zip(*(s.get_pmf_grid() for s in self.sources))
        return np.stack(pmfs), np.stack(n_events)

    def expected_events(self, s=None):
        """Expected events in the analysis range for source s (stacked over all
        sources if None)."""
        if s is not None:
            return s.expected_events
        return np.array([s.expected_events for s in self.sources])

    # -- diagnostics ---------------------------------------------------------------

    def show(self, d, ax=None, dims=None, **kwargs):
        """Scatter the events of d in (up to two) analysis dimensions, colored
        per source."""
        import matplotlib.pyplot as plt
        kwargs.setdefault('s', 5)
        names = [n for n, _ in self.analysis_space]
        edges = [e for _, e in self.analysis_space]
        if dims is None:
            dims = (0, 1)[:len(names)]
        ax = ax or plt.gca()

        for i, source in enumerate(self.sources):
            coords = self.to_analysis_dimensions(d[d['source'] == i])
            x = coords[dims[0]]
            y = coords[dims[1]] if len(dims) > 1 else np.zeros_like(x)
            ax.scatter(x, y, color=source.config['color'],
                       label=source.config['label'], **kwargs)

        ax.set_xlabel(names[dims[0]])
        ax.set_xlim(edges[dims[0]][0], edges[dims[0]][-1])
        if len(dims) > 1:
            ax.set_ylabel(names[dims[1]])
            ax.set_ylim(edges[dims[1]][0], edges[dims[1]][-1])
