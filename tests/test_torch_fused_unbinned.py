"""The port's unbinned kernel wrappers (their plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, vmapped over
toys: same numpy-made inputs, float64.

Both Pallas flavors are reached: the block kernels (G <= 16: G = 3, K = 1)
and the per-toy gather kernels (G = 25: K = 2 on 5 anchors), plus K = 0.
Each case runs with the outlier floor 0 and 1e-12, centered and uncentered,
with masked event tails and events whose summed density is 0 or negative,
on a subset of the toy batch in a non-trivial order (``lanes``). The port
takes E = 200 unpadded; the JAX side gets the same events padded to 256
(the TPU lane width) with zero densities and mask False.

Tolerances as tests/test_torch_fused.py: ll rtol 1e-10, g 1e-9, H 1e-8."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.ops import fused_unbinned as jfu
from blueice_tpu_torch.ops import fused_unbinned as fu

B, E, E_PAD, A = 5, 200, 256, 4
LANES = np.array([3, 0, 4])
# name: (anchor grid, S)
CASES = {'block': ((3,), 2), 'gather': ((5, 5), 3), 'constant': ((), 2)}


def _setup(case, outlier, centered, seed=0):
    grid, S = CASES[case]
    K = len(grid)
    G = int(np.prod(grid)) if K else 1
    rng = np.random.default_rng(seed + 7 * K + S)
    ps = rng.uniform(0.001, 0.4, (B, G, S, E))
    n_valid = rng.integers(E // 2, E - 10, B)
    mask = np.arange(E)[None, :] < n_valid[:, None]
    # Events whose summed density is 0 (all sources) or negative (one
    # source far below zero): valid with an outlier floor, masked without
    bad = [0, 1] if outlier else [E - 2, E - 1]
    ps[:, :, :, bad[0]] = 0.0
    ps[:, :, 0, bad[1]] = -50.0
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    L = len(LANES)
    idx = rng.integers(0, max(n - 1 for n in grid) if K else 1, (L, K))
    t = rng.uniform(0, 1, (L, K))
    m = rng.uniform(100, 2000, (L, S))
    cand = dict(idx=rng.integers(0, 2, (L, A, K)), t=rng.uniform(0, 1, (L, A, K)),
                m=rng.uniform(100, 2000, (L, A, S)))
    if centered:
        inv_ref = np.where(mask, rng.uniform(0.5, 2.0, (B, E)), 1.0)
        ref_msum = rng.uniform(500, 3000, B)
    else:
        inv_ref, ref_msum = np.ones((B, E)), np.zeros(B)
    return dict(ps=ps, mask=mask, strides=strides, idx=idx, t=t, m=m,
                cand=cand, inv_ref=inv_ref, ref_msum=ref_msum, G=G, K=K)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _pad(x, value):
    return np.concatenate(
        [x, np.full(x.shape[:-1] + (E_PAD - E,), value, x.dtype)], axis=-1)


def _jax_inputs(d, centered):
    """The lanes' toys, events padded to the lane width."""
    ps = jnp.asarray(_pad(d['ps'][LANES], 0.0))
    mask = jnp.asarray(_pad(d['mask'][LANES], False))
    inv_ref = (jnp.asarray(_pad(d['inv_ref'][LANES], 1.0)) if centered
               else None)
    return ps, mask, inv_ref, jnp.asarray(d['ref_msum'][LANES])


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("case", sorted(CASES))
def test_vgh_matches_pallas(case, outlier, centered):
    d = _setup(case, outlier, centered)
    K, strides = d['K'], d['strides']
    m = _t(d['m'])
    port = fu.unbinned_vgh_fused(
        _t(d['ps']), strides, _t(LANES, torch.int64), _t(d['idx'], torch.int64),
        _t(d['t']), m, _t(d['mask'], torch.bool), _t(d['inv_ref']),
        m.sum(-1) - _t(d['ref_msum'][LANES]), outlier)
    ps, mask, inv_ref, ref_msum = _jax_inputs(d, centered)

    def one(p, i, tv, mv, mk, ir, rs):
        return jfu.unbinned_vgh_fused(
            p, strides, [i[k] for k in range(K)], tv, mv, mk, outlier=outlier,
            interpret=True, inv_ref=ir, ref_msum=rs if centered else None)
    jfu._OP_CACHE.clear()
    ref = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0 if centered else None, 0))(
        ps, jnp.asarray(d['idx'], jnp.int32), jnp.asarray(d['t']),
        jnp.asarray(d['m']), mask, inv_ref, ref_msum)
    P = d['m'].shape[1] + K
    assert port[0].shape == (3,) and port[2].shape == (3, P, P)
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-10)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(port[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("outlier", [0.0, 1e-12])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ll_multi_matches_pallas(case, outlier, centered):
    d = _setup(case, outlier, centered, seed=1)
    K, strides, c = d['K'], d['strides'], d['cand']
    m = _t(c['m'])
    port = fu.unbinned_ll_fused_multi(
        _t(d['ps']), strides, _t(LANES, torch.int64),
        _t(c['idx'], torch.int64), _t(c['t']), m, _t(d['mask'], torch.bool),
        _t(d['inv_ref']), m.sum(-1) - _t(d['ref_msum'][LANES])[:, None],
        outlier)
    ps, mask, inv_ref, ref_msum = _jax_inputs(d, centered)

    def one(p, i, tv, mv, mk, ir, rs):
        return jfu.unbinned_ll_fused_multi(
            p, strides, i, tv, mv, mk, outlier=outlier, interpret=True,
            inv_ref=ir, ref_msum=rs if centered else None)
    jfu._OP_CACHE.clear()
    ref = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0 if centered else None, 0))(
        ps, jnp.asarray(c['idx'], jnp.int32), jnp.asarray(c['t']),
        jnp.asarray(c['m']), mask, inv_ref, ref_msum)
    assert port.shape == (3, A)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-10)


def test_plain_path_is_taken_for_cpu_tensors():
    """On CPU tensors the wrappers return exactly their plain versions and
    launch nothing; the plain versions read the lanes' toys in place."""
    d = _setup('gather', 1e-12, True)
    fu.reset_launch_counts()
    lanes = _t(LANES, torch.int64)
    m = _t(d['m'])
    args = (_t(d['ps']), d['strides'], lanes, _t(d['idx'], torch.int64),
            _t(d['t']), m, _t(d['mask'], torch.bool), _t(d['inv_ref']),
            m.sum(-1), 1e-12)
    for a, b in zip(fu.unbinned_vgh_fused(*args), fu.unbinned_vgh_plain(*args)):
        assert torch.equal(a, b)
    # lanes read in place == the same toys copied out first
    sub = list(args)
    sub[0], sub[2] = args[0][lanes].clone(), torch.arange(3)
    sub[6], sub[7] = args[6][lanes], args[7][lanes]
    for a, b in zip(fu.unbinned_vgh_plain(*args), fu.unbinned_vgh_plain(*sub)):
        assert torch.equal(a, b)
    c = d['cand']
    mc = _t(c['m'])
    cargs = (_t(d['ps']), d['strides'], lanes, _t(c['idx'], torch.int64),
             _t(c['t']), mc, _t(d['mask'], torch.bool), _t(d['inv_ref']),
             mc.sum(-1), 1e-12)
    assert torch.equal(fu.unbinned_ll_fused_multi(*cargs),
                       fu.unbinned_ll_plain(*cargs))
    assert fu.launch_counts() == {'unbinned_vgh_fused': 0,
                                  'unbinned_ll_fused_multi': 0}


def test_wrappers_reject_bad_inputs():
    d = _setup('block', 0.0, False)
    lanes = _t(LANES, torch.int64)
    m = _t(d['m'])
    good = [_t(d['ps']), d['strides'], lanes, _t(d['idx'], torch.int64),
            _t(d['t']), m, _t(d['mask'], torch.bool), _t(d['inv_ref']),
            m.sum(-1)]
    for pos, bad, match in ((5, m[:, :1], 'm must'),
                            (6, _t(d['mask']), 'mask must be bool'),
                            (2, lanes.to(torch.int32), 'lanes'),
                            (7, _t(d['inv_ref'], torch.float32), 'inv_ref'),
                            (0, _t(d['ps'])[0], 'ps must')):
        args = list(good)
        args[pos] = bad
        with pytest.raises(ValueError, match=match):
            fu.unbinned_vgh_fused(*args)
