"""The reference against the port on the CPU, in float64, at a small size:
the same likelihood at any point, the same profile fits."""

import numpy as np
import pytest
import torch

from benchmark.harness.systems import binned as system
from benchmark.reference.binned import BinnedModel, profile_fits
from conftest import tiny_config


@pytest.fixture(scope='module', params=[False, True], ids=['plain', 'bb'])
def pair(request, tmp_path_factory):
    cfg = tiny_config(bb=request.param)
    _, study = system.build_study(cfg, 'cpu', str(tmp_path_factory.mktemp(
        'cache')), dtype=torch.float64)
    return cfg, study, BinnedModel(cfg, 'cpu')


def _counts(study, n, seed):
    gen = torch.Generator().manual_seed(seed)
    e = study.expected_counts().reshape(1, -1).expand(n, -1).contiguous()
    return torch.poisson(e, generator=gen)


def test_likelihood_matches_the_port(pair):
    cfg, study, ref = pair
    c = study.compiled
    counts = _counts(study, 8, 1)
    rng = np.random.default_rng(2)
    x = np.tile(ref.defaults, (8, 1))
    x[:, :ref.R] *= rng.uniform(0.7, 1.3, (8, ref.R))
    for k, a in enumerate(ref.anchors):
        x[:, ref.R + k] = rng.uniform(a[0], a[-1], 8)
    x[0, ref.R:] = [a[1] for a in ref.anchors]      # on the middle anchors
    mine = ref.loglik_at(x, counts)
    port = [float(c.logl_with_data(
        c.params_from_kwargs(**dict(zip(ref.names, xi.tolist()))),
        counts[i].reshape(ref.bin_shape))) for i, xi in enumerate(x)]
    np.testing.assert_allclose(mine, port, rtol=1e-12, atol=1e-8)


def test_profile_fits_match_the_port(pair):
    cfg, study, ref = pair
    counts = _counts(study, 5, 3)
    t, free, cond = study._run_profile(counts.reshape((5,) + ref.bin_shape),
                                       'wimp_rate_multiplier', 1.0, None)
    mine = profile_fits(ref, counts, 'wimp_rate_multiplier', 1.0)
    np.testing.assert_allclose(mine['ll_free'], free.max_ll, atol=1e-6)
    np.testing.assert_allclose(mine['ll_cond'], cond.max_ll, atol=1e-6)
    np.testing.assert_allclose(mine['t'], t, atol=2e-6)


def test_expected_counts_match_the_port(pair):
    cfg, study, ref = pair
    X = torch.as_tensor(ref.defaults[None])
    np.testing.assert_allclose(ref.expected(X, ref.cells_of(X))[0].numpy(),
                               study.expected_counts().reshape(-1).numpy(),
                               rtol=1e-12)
