"""The port's batched profile toy study against the JAX package's on the
reduced XENON1T-style likelihood (12x10 bins, 6 sources, 3^4 = 81 anchors),
float64 on the CPU, on the same numpy-made counts."""

import numpy as np
import jax.numpy as jnp
import pytest

from blueice_tpu.examples.xenon_like import build_likelihood as jax_build
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.examples.xenon_like import build_likelihood
from blueice_tpu_torch.parallel import BinnedToyStudy
from blueice_tpu_torch.utils import set_progress

SIZE = dict(n_cs1_bins=12, n_cs2_bins=10, livetime_days=30.0)
TARGET = 'wimp_rate_multiplier'


@pytest.fixture(scope='module')
def lfs():
    set_progress(False)
    jax_set_progress(False)
    return jax_build('binned', **SIZE), build_likelihood('binned', **SIZE)


@pytest.fixture(scope='module')
def studies(lfs):
    jlf, tlf = lfs
    return (JaxStudy(jlf, max_iter=40, engine='analytic',
                     profile_mode='split'),
            BinnedToyStudy(tlf, device='cpu', max_iter=40, engine='fused'))


@pytest.fixture(scope='module')
def counts(studies):
    """8 toy count tensors, Poisson draws at the default parameters."""
    expected = studies[1].expected_counts().numpy()
    return np.random.default_rng(0).poisson(
        expected, size=(8,) + expected.shape).astype(float)


def test_profile_study_matches(studies, counts):
    """The port's study (engine='fused': the kernels' plain versions on the
    CPU) and the JAX package's closed-form study fit the same 8 count
    tensors to the same optima. The JAX side compiles its 'split' profile
    mode — the same statistics as 'fused' (bench.py's cold-cache choice),
    in less compile time."""
    jstudy, tstudy = studies
    jt, jfree, jcond = jstudy._run_profile(jnp.asarray(counts), TARGET, 1.0,
                                           None)
    tt, tfree, tcond = tstudy._run_profile(counts, TARGET, 1.0, None)
    assert tfree.names == jfree.names and tcond.names == jcond.names
    for port, ref in ((tfree, jfree), (tcond, jcond)):
        np.testing.assert_allclose(port.max_ll, ref.max_ll, rtol=1e-8)
        np.testing.assert_allclose(port.x, ref.x, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-4)
    assert (tt >= 0).all()
    assert 0.5 < tfree[TARGET].mean() < 1.5


def test_expected_counts_and_simulation(studies):
    """Expected counts agree; the port's torch.poisson ensemble (a torch
    Generator, so not the JAX draws) has the expected mean."""
    jstudy, tstudy = studies
    exp_t = tstudy.expected_counts().numpy()
    np.testing.assert_allclose(exp_t, np.asarray(jstudy.expected_counts()),
                               rtol=1e-12)
    toys = tstudy.simulate(5, 2000)
    assert toys.shape == (2000,) + exp_t.shape
    assert abs(float(toys.sum(dim=(1, 2)).mean()) / exp_t.sum() - 1) < 0.01
    # a seed is reproducible
    assert (tstudy.simulate(5, 3) == tstudy.simulate(5, 3)).all()
