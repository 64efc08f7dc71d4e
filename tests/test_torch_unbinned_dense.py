"""The port's dense unbinned engine (``ops/unbinned_dense.py``) against the
JAX package's, float64 on the CPU, on the same numpy-made inputs: value,
gradient, Hessian and the A-candidate value batch, with and without the
centering and the outlier floor; the port's lane-batched calls against the
JAX functions toy by toy; and the engine end to end through the fitter's
test hook against the gather engine on the same event sets.

Tolerances as tests/test_unbinned_dense.py: values rtol 1e-12 (1e-10
centered), gradients rtol 1e-10, Hessians rtol 1e-9."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.ops.binned_vgh import gather_corners
from blueice_tpu.ops.unbinned_dense import (
    unbinned_vgh_dense as jax_vgh_dense,
    unbinned_ll_dense_many as jax_ll_dense_many)
from blueice_tpu.ops.unbinned_vgh import (unbinned_vgh as jax_vgh,
                                          reference_center as jax_center)
from blueice_tpu_torch.ops.unbinned_dense import (unbinned_vgh_dense,
                                                  unbinned_ll_dense_many)
from blueice_tpu_torch.ops.unbinned_vgh import unbinned_ll

from test_torch_profile_grid_map import (  # noqa: F401,E402
    fresh_template_caches, one_torch_thread)


def _setup(grid_shape, S, E, seed=0, holes=False):
    """numpy (ps (G, S, E), strides, idx (K,), t, m, mask) of one toy."""
    rng = np.random.default_rng(seed)
    K = len(grid_shape)
    G = int(np.prod(grid_shape))
    ps = rng.uniform(0.01, 0.5, (G, S, E))
    if holes:
        ps[:, :, E // 3] = 0.0      # a dead event: exercises the outlier path
    strides = tuple(int(np.prod(grid_shape[d + 1:], dtype=int))
                    for d in range(K))
    idx = np.array([rng.integers(0, g - 1) for g in grid_shape])
    t = rng.uniform(0, 1, K)
    m = rng.uniform(5, 50, S)
    mask = rng.uniform(size=E) > 0.1
    return ps, strides, idx, t, m, mask


def _jax_args(ps, idx, t, m, mask):
    return (jnp.asarray(ps), [jnp.asarray(i, jnp.int32) for i in idx],
            jnp.asarray(t), jnp.asarray(m), jnp.asarray(mask))


def _t(x):
    x = np.array(x)
    return torch.as_tensor(x, dtype=torch.int64 if x.dtype.kind == 'i'
                           else None)


def _jax_center(ps, grid_shape, idx, t, m, mask):
    corners = gather_corners(jnp.asarray(ps).reshape(grid_shape
                                                     + ps.shape[1:]),
                             [jnp.asarray(i, jnp.int32) for i in idx],
                             len(grid_shape))
    inv_ref, ref_msum, _ = jax_center(corners, jnp.asarray(m),
                                      jnp.asarray(t), jnp.asarray(mask))
    return corners, np.asarray(inv_ref), float(ref_msum)


def _assert_vgh(port, ref, ll_rtol=1e-12):
    np.testing.assert_allclose(float(port[0]), float(ref[0]), rtol=ll_rtol,
                               atol=1e-12)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize('grid_shape,S,E', [((3,), 2, 96), ((3, 3), 3, 64),
                                            ((3, 3, 3, 3), 6, 160)])
@pytest.mark.parametrize('outlier', [0.0, 1e-12])
def test_vgh_dense_matches_jax(grid_shape, S, E, outlier):
    """The port's dense vgh against the JAX dense vgh and the JAX gather
    closed form on the same toy."""
    ps, strides, idx, t, m, mask = _setup(grid_shape, S, E,
                                          holes=outlier != 0)
    port = unbinned_vgh_dense(_t(ps), strides, _t(idx), _t(t), _t(m),
                              _t(mask), outlier_likelihood=outlier)
    jps, jidx, jt, jm, jmask = _jax_args(ps, idx, t, m, mask)
    _assert_vgh(port, jax_vgh_dense(jps, strides, jidx, jt, jm, jmask,
                                    outlier_likelihood=outlier))
    corners = gather_corners(jps.reshape(grid_shape + (S, E)), jidx,
                             len(grid_shape))
    _assert_vgh(port, jax_vgh(corners, jm, jt, jmask, outlier))


def test_vgh_dense_centered():
    ps, strides, idx, t, m, mask = _setup((3, 3), 3, 64, seed=3)
    _, inv_ref, ref_msum = _jax_center(ps, (3, 3), idx, t, m, mask)
    port = unbinned_vgh_dense(_t(ps), strides, _t(idx), _t(t), _t(m),
                              _t(mask), inv_ref=_t(inv_ref),
                              ref_msum=ref_msum)
    jps, jidx, jt, jm, jmask = _jax_args(ps, idx, t, m, mask)
    _assert_vgh(port, jax_vgh_dense(jps, strides, jidx, jt, jm, jmask,
                                    inv_ref=jnp.asarray(inv_ref),
                                    ref_msum=ref_msum), ll_rtol=1e-10)


@pytest.mark.parametrize('outlier', [0.0, 1e-12])
def test_ll_dense_many_matches_per_candidate(outlier):
    """A candidates of one toy: the port's dense value against JAX's, and
    against the port's gather value candidate by candidate."""
    grid_shape, S, E, A = (3, 3, 3, 3), 6, 160, 9
    rng = np.random.default_rng(7)
    ps, strides, _, _, _, mask = _setup(grid_shape, S, E, seed=7,
                                        holes=outlier != 0)
    K = len(grid_shape)
    idxs = np.stack([rng.integers(0, g - 1, A) for g in grid_shape], axis=1)
    ts = rng.uniform(0, 1, (A, K))
    ms = rng.uniform(5, 50, (A, S))
    lls = unbinned_ll_dense_many(_t(ps), strides, _t(idxs), _t(ts), _t(ms),
                                 _t(mask), outlier_likelihood=outlier)
    ref = jax_ll_dense_many(jnp.asarray(ps), strides,
                            jnp.asarray(idxs, jnp.int32), jnp.asarray(ts),
                            jnp.asarray(ms), jnp.asarray(mask),
                            outlier_likelihood=outlier)
    np.testing.assert_allclose(lls.numpy(), np.asarray(ref), rtol=1e-12)
    grid = _t(ps).reshape(grid_shape + (S, E))
    for a in range(A):
        corners = torch.stack([
            grid[tuple(int(i) + int(c) for i, c in zip(idxs[a], bits))]
            for bits in np.ndindex(*(2,) * K)])
        one = unbinned_ll(corners, _t(ms[a]), _t(ts[a]), _t(mask), outlier)
        np.testing.assert_allclose(float(lls[a]), float(one), rtol=1e-12)


def test_ll_dense_many_centered_and_vgh_value_agree():
    """The vgh value and the A = 1 candidate value agree exactly enough for
    the Newton accept test (both centered the same way), and each matches
    its JAX twin."""
    ps, strides, idx, t, m, mask = _setup((3, 3, 3, 3), 6, 160, seed=11)
    _, inv_ref, ref_msum = _jax_center(ps, (3, 3, 3, 3), idx, t, m, mask)
    ll_v = unbinned_vgh_dense(_t(ps), strides, _t(idx), _t(t), _t(m),
                              _t(mask), inv_ref=_t(inv_ref),
                              ref_msum=ref_msum)[0]
    ll_m = unbinned_ll_dense_many(_t(ps), strides, _t(idx[None]),
                                  _t(t[None]), _t(m[None]), _t(mask),
                                  inv_ref=_t(inv_ref), ref_msum=ref_msum)[0]
    np.testing.assert_allclose(float(ll_v), float(ll_m), rtol=1e-10,
                               atol=1e-12)
    ref = jax_ll_dense_many(jnp.asarray(ps), strides,
                            jnp.asarray(idx[None], jnp.int32),
                            jnp.asarray(t[None]), jnp.asarray(m[None]),
                            jnp.asarray(mask), inv_ref=jnp.asarray(inv_ref),
                            ref_msum=ref_msum)[0]
    np.testing.assert_allclose(float(ll_m), float(ref), rtol=1e-10,
                               atol=1e-12)


def test_lane_batches_match_jax_toy_by_toy():
    """The port's lane-batched calls (lanes naming toys of a batch, one toy
    twice) against the JAX single-toy functions, centered, with the
    outlier floor."""
    B, S, E, A = 4, 3, 80, 5
    rng = np.random.default_rng(5)
    ps = rng.uniform(0.01, 0.5, (B, 9, S, E))
    ps[:, :, :, 7] = 0.0
    strides = (3, 1)
    lanes = np.array([2, 0, 0, 3])
    L = len(lanes)
    idx = rng.integers(0, 2, (L, 2))
    t = rng.uniform(0, 1, (L, 2))
    m = rng.uniform(5, 50, (L, S))
    mask = rng.uniform(size=(B, E)) > 0.1
    inv_ref = rng.uniform(0.5, 2.0, (B, E))
    ref_msum = rng.uniform(20, 60, L)
    idxs = rng.integers(0, 2, (L, A, 2))
    ts = rng.uniform(0, 1, (L, A, 2))
    ms = rng.uniform(5, 50, (L, A, S))
    vgh = unbinned_vgh_dense(_t(ps), strides, _t(idx), _t(t), _t(m),
                             _t(mask), 1e-12, _t(inv_ref), _t(ref_msum),
                             lanes=_t(lanes))
    many = unbinned_ll_dense_many(_t(ps), strides, _t(idxs), _t(ts), _t(ms),
                                  _t(mask), 1e-12, _t(inv_ref),
                                  _t(ref_msum), lanes=_t(lanes))
    for lane, toy in enumerate(lanes):
        jps, jidx, jt, jm, jmask = _jax_args(ps[toy], idx[lane], t[lane],
                                             m[lane], mask[toy])
        ref = jax_vgh_dense(jps, strides, jidx, jt, jm, jmask, 1e-12,
                            jnp.asarray(inv_ref[toy]), ref_msum[lane])
        _assert_vgh([v[lane] for v in vgh], ref, ll_rtol=1e-10)
        ref = jax_ll_dense_many(jps, strides,
                                jnp.asarray(idxs[lane], jnp.int32),
                                jnp.asarray(ts[lane]), jnp.asarray(ms[lane]),
                                jmask, 1e-12, jnp.asarray(inv_ref[toy]),
                                ref_msum[lane])
        np.testing.assert_allclose(many[lane].numpy(), np.asarray(ref),
                                   rtol=1e-10, atol=1e-12)


def test_dense_engine_end_to_end_matches_gather():
    """The dense engine, taken through the fitter's test hook, fits the
    same event sets to the same optima as the gather engine."""
    from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
    from blueice_tpu_torch.parallel import fitter
    from blueice_tpu_torch.parallel.toys import UnbinnedToyStudy
    from blueice_tpu_torch.test_helpers import conf_for_test

    np.random.seed(0)
    conf = conf_for_test(mc=True, events_per_day=150.,
                         n_events_for_pdf=int(2e4))
    lf = UnbinnedLogLikelihood(conf)
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    lf.prepare()

    gather = UnbinnedToyStudy(lf, device='cpu', engine='analytic')
    events = gather.simulate(13, 8)
    res_gather = gather.fit_events(events)
    assert not fitter._FORCE_DENSE_UNBINNED
    fitter._FORCE_DENSE_UNBINNED = True
    try:
        dense = UnbinnedToyStudy(lf, device='cpu', engine='analytic')
        res_dense = dense.fit_events(events)
        t_dense = dense._run_profile(events, 's0_rate_multiplier', 1.0,
                                     None)[0]
    finally:
        fitter._FORCE_DENSE_UNBINNED = False
    np.testing.assert_allclose(res_dense.max_ll, res_gather.max_ll,
                               rtol=1e-9, atol=1e-7)
    np.testing.assert_allclose(res_dense.x, res_gather.x, rtol=1e-6,
                               atol=1e-6)
    t_gather = gather._run_profile(events, 's0_rate_multiplier', 1.0,
                                   None)[0]
    np.testing.assert_allclose(t_dense, t_gather, rtol=1e-6, atol=1e-7)


def test_vgh_dense_grad_hess_vs_autodiff():
    """The closed forms against torch.func's gradient and Hessian of the
    dense value, and against the JAX package's."""
    ps, strides, idx, t, m, mask = _setup((3, 3), 3, 48, seed=5)
    S = len(m)

    def val(mt):
        return unbinned_ll_dense_many(_t(ps), strides, _t(idx[None]),
                                      mt[None, S:], mt[None, :S],
                                      _t(mask))[0]

    mt0 = _t(np.concatenate([m, t]))
    _, g, H = unbinned_vgh_dense(_t(ps), strides, _t(idx), _t(t), _t(m),
                                 _t(mask))
    np.testing.assert_allclose(torch.func.grad(val)(mt0).numpy(), g.numpy(),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(torch.func.hessian(val)(mt0).numpy(),
                               H.numpy(), rtol=1e-7, atol=1e-9)

    def jval(mt):
        return jax_ll_dense_many(jnp.asarray(ps), strides,
                                 jnp.asarray(idx[None], jnp.int32),
                                 mt[None, S:], mt[None, :S],
                                 jnp.asarray(mask))[0]
    jmt = jnp.asarray(np.concatenate([m, t]))
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jval)(jmt)),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(H.numpy(), np.asarray(jax.hessian(jval)(jmt)),
                               rtol=1e-7, atol=1e-9)
