"""The port's batched profile toy study with Barlow-Beeston-lite (one
profiled scale per bin on the total template) against the JAX package's, on
the reduced XENON1T-style likelihood (12x10 bins, 6 sources, 3^4 = 81
anchors), float64 on the CPU, on the same numpy-made counts. The bb_single
study is in test_torch_bb_study.py."""

import numpy as np
import jax.numpy as jnp

from blueice_tpu.examples.xenon_like import build_likelihood as jax_build
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.examples.xenon_like import build_likelihood
from blueice_tpu_torch.parallel import BinnedToyStudy
from blueice_tpu_torch.utils import set_progress

SIZE = dict(n_cs1_bins=12, n_cs2_bins=10, livetime_days=30.0)
TARGET = 'wimp_rate_multiplier'


def test_bblite_profile_study_matches():
    """8 toys' counts fitted by both packages (the port with engine='fused':
    the bb-lite kernels' plain versions on the CPU; JAX with its closed-form
    bb-lite engine) reach the same optima: max_ll to 1e-6, t to 1e-4. One
    stage (two_stage=False) keeps the JAX compile to one program per fit."""
    set_progress(False)
    jax_set_progress(False)
    jstudy = JaxStudy(jax_build('binned', bb='bb_lite', **SIZE), max_iter=60,
                      engine='analytic', profile_mode='split',
                      two_stage=False)
    tstudy = BinnedToyStudy(build_likelihood('binned', bb='bb_lite', **SIZE),
                            device='cpu', max_iter=60, engine='fused',
                            two_stage=False)
    assert tstudy.compiled.has_bb_lite and not tstudy.compiled.has_bb
    expected = tstudy.expected_counts().numpy()
    counts = np.random.default_rng(0).poisson(
        expected, size=(8,) + expected.shape).astype(float)
    jt, jfree, jcond = jstudy._run_profile(jnp.asarray(counts), TARGET, 1.0,
                                           None)
    tt, tfree, tcond = tstudy._run_profile(counts, TARGET, 1.0, None)
    assert tfree.names == jfree.names and tcond.names == jcond.names
    for port, ref in ((tfree, jfree), (tcond, jcond)):
        np.testing.assert_allclose(port.max_ll, ref.max_ll, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(port.x, ref.x, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tt, np.asarray(jt), atol=1e-4)
    assert (tt >= 0).all() and 0.5 < tfree[TARGET].mean() < 1.5
