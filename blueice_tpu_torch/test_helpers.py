"""Gaussian scenario sources and configs for small test and benchmark models.

Counterpart of the part of :mod:`blueice_tpu.test_helpers` that the
two-source Gaussian toy study needs (an analytic Gaussian source, its Monte
Carlo twin, and the scenario config). The scenario keeps the JAX package's
observable behavior: ``some_multiplier`` scales a source's rate by its
(numeric) value and ``strlen_multiplier`` by the length of a string.
"""

import tempfile

import numpy as np

from .exceptions import PDFNotComputedException
from .models.source import Source, MonteCarloSource
from .utils import combine_dicts

__all__ = ['GaussianSource', 'GaussianMCSource', 'conf_for_test']

_SQRT_2PI = float(np.sqrt(2 * np.pi))


class _RateHookMixin:
    """Multiply ``events_per_day`` by ``some_multiplier`` and by
    ``len(strlen_multiplier)``."""

    def _apply_rate_hooks(self):
        self.events_per_day *= self.config.get('some_multiplier', 1)
        self.events_per_day *= len(self.config.get('strlen_multiplier', 'x'))


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


def conf_for_test(n_sources=1, mc=False, **kwargs):
    """The scenario config with ``n_sources`` Gaussian sources named s0, s1,
    ... (MC-templated when ``mc``), plus any overrides."""
    conf = _base_config()
    conf['sources'] = [{'name': 's%d' % i} for i in range(n_sources)]
    if mc:
        conf['default_source_class'] = GaussianMCSource
    return combine_dicts(conf, kwargs, deep_copy=True)
