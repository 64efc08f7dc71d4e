"""``ops/sampling.py`` of the port: sampling from histogram templates and
Poisson counts with an explicit ``torch.Generator``. The JAX package draws
with its own PRNG, so the draws are held to their distributions by
statistics, the seeds stated: a chi-square of the drawn bins against the
weights (below its 99.9% quantile), every point inside its bin, empty and
negative bins never drawn, the Poisson mean and variance (five standard
errors), and the JAX package's validation of the edges.
"""

import numpy as np
import jax
import pytest
import torch
from scipy import stats

from blueice_tpu.ops import sampling as jsampling
from blueice_tpu_torch.ops import poisson_counts, sample_from_template

EDGES = [np.linspace(0.0, 4.0, 5), np.array([-1.0, 0.0, 2.0, 5.0])]


def _generator(seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def _bins_of(points, edges):
    return tuple(np.clip(np.searchsorted(e, points[:, d], side='right') - 1,
                         0, len(e) - 2) for d, e in enumerate(edges))


@pytest.mark.parametrize('seed', [0, 1])
def test_sample_from_template_follows_the_weights(seed):
    weights = np.array([[1.0, 2.0, 0.0], [3.0, 0.5, 1.5],
                        [0.0, 4.0, 2.0], [1.0, 1.0, -2.0]])
    n = 40000
    points = sample_from_template(_generator(seed), torch.as_tensor(weights),
                                  EDGES, n).numpy()
    assert points.shape == (n, 2) and points.dtype == np.float64
    counts = np.zeros(weights.shape)
    np.add.at(counts, _bins_of(points, EDGES), 1)
    drawn = weights > 0
    assert counts[~drawn].sum() == 0
    expected = n * weights[drawn] / weights[drawn].sum()
    chi2 = (((counts[drawn] - expected) ** 2) / expected).sum()
    assert chi2 < stats.chi2.ppf(0.999, drawn.sum() - 1)
    # uniform inside the bin: the position within a bin has mean 1/2
    for d, e in enumerate(EDGES):
        b = _bins_of(points, EDGES)[d]
        frac = (points[:, d] - e[b]) / np.diff(e)[b]
        assert ((frac >= 0) & (frac <= 1)).all()
        assert abs(frac.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    # the same generator state repeats the draw
    again = sample_from_template(_generator(seed), torch.as_tensor(weights),
                                 EDGES, n).numpy()
    np.testing.assert_array_equal(again, points)


def test_sample_from_template_checks_edges_as_jax():
    weights = np.ones((4, 3))
    for bad in ([EDGES[0]], [EDGES[0], EDGES[0]], EDGES[0]):
        with pytest.raises(ValueError, match='edges must be'):
            sample_from_template(_generator(0), torch.as_tensor(weights),
                                 bad, 10)
        with pytest.raises(ValueError, match='edges must be'):
            jsampling.sample_from_template(jax.random.PRNGKey(0), weights,
                                           bad, 10)


@pytest.mark.parametrize('mean', [0.7, 25.0])
def test_poisson_counts_mean_and_variance(mean):
    n = 20000
    draws = poisson_counts(_generator(3), torch.full((n,), mean,
                                                     dtype=torch.float64))
    draws = draws.numpy()
    assert (draws >= 0).all() and (draws == np.round(draws)).all()
    assert abs(draws.mean() - mean) < 5 * np.sqrt(mean / n)
    # the variance of a Poisson sample variance: (mu + 2 mu^2 (n/(n-1))) / n
    assert abs(draws.var(ddof=1) - mean) < 5 * np.sqrt(
        (mean + 2 * mean ** 2) / n)
    ref = np.asarray(jsampling.poisson_counts(jax.random.PRNGKey(3),
                                              np.full(n, mean)))
    assert abs(draws.mean() - ref.mean()) < 7 * np.sqrt(2 * mean / n)
