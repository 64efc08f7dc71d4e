"""Gaussian scenario sources and configs for small test and benchmark models.

Counterpart of :mod:`blueice_tpu.test_helpers`: three source families
(:class:`GaussianSource`, an analytic pdf; :class:`GaussianMCSource`, the
same physics through the Monte-Carlo template build; :class:`FixedSampleSource`,
a density estimated from a literal event array, so every bin count is known
exactly), the scenario configs and two small helpers. The scenario keeps the
JAX package's observable behavior: ``some_multiplier`` scales a source's rate
by its (numeric) value and ``strlen_multiplier`` by the length of a string.
"""

import tempfile

import numpy as np

from .exceptions import PDFNotComputedException
from .models.source import Source, MonteCarloSource, DensityEstimatingSource
from .utils import combine_dicts

__all__ = ['GaussianSource', 'GaussianMCSource', 'FixedSampleSource',
           'BASE_CONFIG', 'BASE_CONV_CONFIG', 'conf_for_test',
           'conf_for_reparam_test', 'almost_equal', 'make_data']

_SQRT_2PI = float(np.sqrt(2 * np.pi))


class _RateHookMixin:
    """Multiply ``events_per_day`` by ``some_multiplier`` and by
    ``len(strlen_multiplier)``."""

    def _apply_rate_hooks(self, numeric=True, strlen=True):
        if numeric:
            self.events_per_day *= self.config.get('some_multiplier', 1)
        if strlen:
            self.events_per_day *= len(self.config.get('strlen_multiplier',
                                                       'x'))


def _gauss_sample(config, n_events, rng=None):
    """n_events x-draws from the config's Gaussian, as an event record array
    (``rng`` None: a generator seeded from numpy's global state)."""
    if rng is None or rng is np.random:
        rng = np.random.default_rng(np.random.randint(2 ** 31))
    d = np.zeros(n_events, dtype=[('x', float), ('source', int)])
    d['x'] = rng.normal(config['mu'], config['sigma'], n_events)
    return d


class GaussianSourceBase(Source):
    """Common simulate() of the Gaussian scenario sources."""

    def simulate(self, n_events, rng=None):
        return _gauss_sample(self.config, n_events, rng)


class GaussianSource(_RateHookMixin, GaussianSourceBase):
    """1d analytic Gaussian pdf."""

    def compute_pdf(self):
        self._apply_rate_hooks()
        super().compute_pdf()

    def pdf(self, *args):
        if not self.pdf_has_been_computed:
            raise PDFNotComputedException(
                "Trying to call a PDF that hasn't been computed!")
        mu, sigma = self.config['mu'], self.config['sigma']
        x = np.asarray(args[0], dtype=float)
        return np.exp(-0.5 * ((x - mu) / sigma) ** 2) / (sigma * _SQRT_2PI)


class GaussianMCSource(_RateHookMixin, GaussianSourceBase, MonteCarloSource):
    """The same Gaussian, its template estimated from its own MC sample."""

    def compute_pdf(self):
        self._apply_rate_hooks()
        super().compute_pdf()


class FixedSampleSource(_RateHookMixin, DensityEstimatingSource):
    """Density estimated from the literal events in ``config['data']``:
    exact bin counts for closed-form checks. Only the strlen rate hook
    applies, at construction."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._apply_rate_hooks(numeric=False)

    def get_events_for_density_estimate(self):
        return self.config['data'], len(self.config['data'])


def _base_config():
    return dict(
        cache_dir=tempfile.mkdtemp(prefix='blueice_tpu_torch_pdf_cache_'),
        task_dir=tempfile.mkdtemp(prefix='blueice_tpu_torch_pdf_tasks_'),
        sources=[{'name': 's0', 'events_per_day': 1000.}],
        default_source_class=GaussianSource,
        events_per_day=1000.,
        mu=0, sigma=1,
        some_multiplier=1,
        strlen_multiplier='q',
        n_events_for_pdf=int(1e6),
        analysis_space=[['x', np.linspace(-10, 10, 100)]],
    )


#: A ready-made instance of the base scenario config (prefer conf_for_test()).
BASE_CONFIG = _base_config()


def conf_for_test(n_sources=1, mc=False, **kwargs):
    """The scenario config with ``n_sources`` Gaussian sources named s0, s1,
    ... (MC-templated when ``mc``), plus any overrides."""
    conf = _base_config()
    conf['sources'] = [{'name': 's%d' % i} for i in range(n_sources)]
    if mc:
        conf['default_source_class'] = GaussianMCSource
    return combine_dicts(conf, kwargs, deep_copy=True)


#: Re-parametrisation scenario: three rate multipliers that are quadratic
#: or bilinear functions of two new couplings np0, np1.
BASE_CONV_CONFIG = dict(
    np0=(np.linspace(1e-12, 10, 2), None, None),
    np1=(np.linspace(1e-12, 10, 2), None, None),
    op0_rate_multiplier=dict(params=["np0"], func=lambda np0: np0 ** 2),
    op1_rate_multiplier=dict(params=["np1"], func=lambda np1: np1 ** 2),
    op2_rate_multiplier=dict(params=["np0", "np1"],
                             func=lambda np0, np1: np0 * np1),
)


def conf_for_reparam_test(n_source=1, mc=False, **kwargs):
    """Scenario config for LogLikelihoodReParam tests: sources op0, op1,
    op2 with unit couplings np0 = np1 = 1."""
    conf = conf_for_test(n_source, mc, **kwargs)
    conf['sources'] = [dict(name='op0'), dict(name='op1'), dict(name='op2')]
    conf['np0'] = conf['np1'] = 1
    return conf


def almost_equal(a, b, fraction=1e-6):
    """|a - b| within the given fraction of a."""
    return abs((a - b) / a) <= fraction


def make_data(instructions):
    """Event records from a literal spec: make_data([dict(n_events=24,
    x=0.5), dict(n_events=56, x=1.5)]) gives 24 events at x=0.5 and 56 at
    x=1.5.
    :return: (record array accepted by set_data, total event count)
    """
    fields = sorted(set().union(*(set(i) for i in instructions))
                    - {'n_events'})
    counts = [int(i['n_events']) for i in instructions]
    d = np.zeros(sum(counts), dtype=[('source', int)]
                 + [(f, float) for f in fields])
    for f in fields:
        d[f] = np.repeat([i.get(f, 0) for i in instructions], counts)
    return d, len(d)
