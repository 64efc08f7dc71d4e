"""The port's native histogram filler (its own copy of ``fasthist.cpp``)
against ``numpy.histogramdd`` and the JAX package's filler: the four cases
of ``tests/test_native.py``, the two packages' ``histogram_nd`` on the same
inputs (exact counts; weighted sums rtol 1e-12), ``Hist.add`` through the
native path, and the numpy fallback where no library loads."""

import logging
import os

import numpy as np
import pytest

from blueice_tpu import native as jnative
from blueice_tpu_torch import native
from blueice_tpu_torch.ops.hist import Hist


def test_native_builds():
    # g++ is part of this environment; the filler must be available, and
    # it builds beside the package, not under the home directory
    assert native.available()
    assert os.path.exists(native.library_path())
    assert native.library_path().startswith(native.BUILD_DIR)


def _sample(ndim, n):
    rng = np.random.default_rng(ndim)
    sample = rng.normal(0, 2, size=(n, ndim))
    # Mixed uniform / irregular axes, including exact-edge values
    edges = []
    for d in range(ndim):
        if d % 2 == 0:
            edges.append(np.linspace(-3, 3, 7 + d))
        else:
            edges.append(np.array([-4.0, -1.0, -0.5, 0.25, 2.0, 5.0]))
    # Inject values exactly on edges (incl. first/last) and NaN/inf
    sample[:50, 0] = edges[0][rng.integers(0, len(edges[0]), 50)]
    sample[50] = np.nan
    sample[51] = np.inf
    return sample, edges, rng.random(n)


@pytest.mark.parametrize("ndim,n", [(1, 10000), (2, 20000), (3, 5000)])
def test_matches_histogramdd(ndim, n):
    sample, edges, w = _sample(ndim, n)
    expected, _ = np.histogramdd(sample, bins=edges)
    np.testing.assert_array_equal(native.histogram_nd(sample, edges),
                                  expected)
    expected_w, _ = np.histogramdd(sample, bins=edges, weights=w)
    np.testing.assert_allclose(native.histogram_nd(sample, edges, weights=w),
                               expected_w, rtol=1e-12)


@pytest.mark.parametrize("ndim,n", [(1, 10000), (2, 20000), (3, 5000)])
def test_matches_jax_package(ndim, n):
    sample, edges, w = _sample(ndim, n)
    np.testing.assert_array_equal(native.histogram_nd(sample, edges),
                                  jnative.histogram_nd(sample, edges))
    np.testing.assert_allclose(native.histogram_nd(sample, edges, weights=w),
                               jnative.histogram_nd(sample, edges, weights=w),
                               rtol=1e-12)


def test_native_speed_sanity():
    """Not a strict benchmark, but the native path should not be slower than
    numpy by more than noise on a realistic template-build workload."""
    import time
    rng = np.random.default_rng(0)
    sample = rng.normal(0, 2, size=(500_000, 2))
    edges = [np.linspace(-5, 5, 51), np.linspace(-5, 5, 63)]

    native.histogram_nd(sample, edges)   # warm (and build)
    t0 = time.time()
    native.histogram_nd(sample, edges)
    t_native = time.time() - t0

    t0 = time.time()
    np.histogramdd(sample, bins=edges)
    t_numpy = time.time() - t0
    assert t_native < max(2 * t_numpy, 0.5), (t_native, t_numpy)


def test_histogram_nd_validates_weights_and_dims():
    sample = np.full((5, 1), 0.25)
    edges = [np.linspace(0, 1, 3)]
    with pytest.raises(ValueError):
        native.histogram_nd(sample, edges, weights=np.ones(3))
    with pytest.raises(ValueError):
        native.histogram_nd(sample, edges + edges)
    h = native.histogram_nd(sample, edges, weights=np.full(5, 2.0))
    np.testing.assert_array_equal(h, [10.0, 0.0])


def test_hist_add_fills_natively():
    """``Hist.add`` fills through the native filler: counts equal
    ``np.histogramdd``'s, with NaN, inf and exact-edge events."""
    sample, edges, w = _sample(2, 20000)
    h = Hist(edges, axis_names=('x', 'y'))
    h.add(sample[:, 0], sample[:, 1])
    np.testing.assert_array_equal(h.values,
                                  np.histogramdd(sample, bins=edges)[0])
    hw = h.similar_blank().add(sample[:, 0], sample[:, 1], weights=w)
    np.testing.assert_allclose(
        hw.values, np.histogramdd(sample, bins=edges, weights=w)[0],
        rtol=1e-12)
    with pytest.raises(ValueError, match='weights'):
        h.add(sample[:, 0], sample[:, 1], weights=w[:10])


def test_numpy_fallback_warns(monkeypatch, caplog):
    """Where the library cannot be built or loaded, the filler says so at
    warning level and fills with numpy, with the same counts."""
    def fail():
        raise OSError("no compiler")
    monkeypatch.setattr(native, '_build_and_load', fail)
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, '_TRIED', False)
    with caplog.at_level(logging.WARNING, logger='blueice_tpu_torch.native'):
        assert not native.available()
    assert any(r.levelno == logging.WARNING and 'numpy' in r.getMessage()
               for r in caplog.records)
    sample, edges, _ = _sample(2, 2000)
    np.testing.assert_array_equal(native.histogram_nd(sample, edges),
                                  np.histogramdd(sample, bins=edges)[0])
