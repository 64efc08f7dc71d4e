"""The port's Beeston-Barlow kernel wrappers (their plain versions on the
CPU) against the JAX package's Pallas kernels in interpret mode, both
flavors, vmapped over toys: same numpy-made inputs, float64. The JAX side
gets its bins padded to a multiple of 128 with empty bins (its kernels need
that); the port takes them unpadded.

The inputs reach every branch of the per-bin closed forms: an empty-MC bin
(N = 0), an inert bin (bb pmf 0), a U == 0 bin, empty data bins, and for
bb-lite a negative expectation (the penalty).

Tolerances: the gather flavor and the plain versions are the same float64
arithmetic in another order (ll rtol 1e-10, g rtol 1e-9, H rtol 1e-8 /
atol 1e-9 of the largest entry); the dense flavor combines corners with a
matmul, one more reordering (same tolerances hold in float64). The CUDA
kernels are checked against the same plain versions on the card
(tests/test_torch_cuda.py, and chip_smoke.py at the XENON shape).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.ops import fused as jfused
from blueice_tpu.ops import fused_bb as jfused_bb
from blueice_tpu.ops import fused_bb_lite as jfused_lite
from blueice_tpu_torch.ops import fused_bb, fused_bb_lite
from blueice_tpu_torch.ops.binned_vgh import corner_weight_tables
from blueice_tpu_torch.ops.fused import corner_ids

S, N, B, A, BB_I = 3, 100, 4, 3, 1


def _setup(K, seed=0):
    rng = np.random.default_rng(seed + 10 * K)
    grid = (3,) * K
    G = int(np.prod(grid)) if K else 1
    anchor = rng.uniform(0.01, 1.0, (G, S, N))
    anchor /= anchor.sum(-1, keepdims=True)
    nme = rng.uniform(0.5, 40.0, (G, N))
    nme[:, 5] = 0.0                                   # no MC statistics
    anchor[:, [s for s in range(S) if s != BB_I], 7] = 0.0   # U == 0
    anchor[:, BB_I, 9] = 0.0                          # inert bin (pw == 0)
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    observed = rng.poisson(3.0, (B, N)).astype(float)
    observed[:, :3] = 0.0
    m = rng.uniform(20.0, 200.0, (B, S))
    t = rng.random((B, K))
    idx = rng.integers(0, 2, (B, K))
    cand = dict(idx=rng.integers(0, 2, (B, A, K)), t=rng.random((B, A, K)),
                m=rng.uniform(20.0, 200.0, (B, A, S)))
    return anchor, nme, strides, idx, t, m, observed, cand


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _pad(x):
    return jnp.asarray(jfused.pad_bins(np.asarray(x)))


def _jax_vgh(mod_fn, extra, anchor, nme, strides, idx, t, m, observed,
             dense):
    K = len(strides)
    anchor_p, nme_p, obs_p = _pad(anchor), _pad(nme), _pad(observed)

    def one(i, tv, mv, obs):
        return mod_fn(anchor_p, nme_p, strides, [i[d] for d in range(K)], tv,
                      mv, obs, *extra, interpret=True, dense=dense)
    return jax.vmap(one)(jnp.asarray(idx, jnp.int32), jnp.asarray(t),
                         jnp.asarray(m), obs_p)


def _jax_ll(mod_fn, extra, anchor, nme, strides, cand, observed, dense):
    anchor_p, nme_p, obs_p = _pad(anchor), _pad(nme), _pad(observed)

    def one(i, tv, mv, obs):
        return mod_fn(anchor_p, nme_p, strides, i, tv, mv, obs, *extra,
                      interpret=True, dense=dense)
    return jax.vmap(one)(jnp.asarray(cand['idx'], jnp.int32),
                         jnp.asarray(cand['t']), jnp.asarray(cand['m']),
                         obs_p)


def _assert_vgh_close(port, ref):
    ll_p, g_p, H_p = (x.numpy() for x in port)
    ll_r, g_r, H_r = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(ll_p, ll_r, rtol=1e-10)
    np.testing.assert_allclose(g_p, g_r, rtol=1e-9,
                               atol=1e-12 * np.abs(g_r).max())
    np.testing.assert_allclose(H_p, H_r, rtol=1e-8,
                               atol=1e-9 * np.abs(H_r).max())


MODES = {
    'bb': (fused_bb.binned_bb_vgh_fused, fused_bb.binned_bb_ll_fused_multi,
           jfused_bb.binned_bb_vgh_fused, jfused_bb.binned_bb_ll_fused_multi,
           (BB_I,)),
    'bblite': (fused_bb_lite.binned_bblite_vgh_fused,
               fused_bb_lite.binned_bblite_ll_fused_multi,
               jfused_lite.binned_bblite_vgh_fused,
               jfused_lite.binned_bblite_ll_fused_multi, ()),
}


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("K", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_vgh_matches_pallas(mode, K, dense):
    vgh, _, jvgh, _, extra = MODES[mode]
    anchor, nme, strides, idx, t, m, observed, _ = _setup(K)
    port = vgh(_t(anchor), _t(nme), strides, _t(idx, torch.int64), _t(t),
               _t(m), _t(observed), *extra)
    assert port[0].shape == (B,) and port[2].shape == (B, S + K, S + K)
    _assert_vgh_close(port, _jax_vgh(jvgh, extra, anchor, nme, strides, idx,
                                     t, m, observed, dense))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("K", [0, 4])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ll_multi_matches_pallas(mode, K, dense):
    _, ll, _, jll, extra = MODES[mode]
    anchor, nme, strides, _, _, _, observed, cand = _setup(K)
    port = ll(_t(anchor), _t(nme), strides, _t(cand['idx'], torch.int64),
              _t(cand['t']), _t(cand['m']), _t(observed), *extra)
    assert port.shape == (B, A)
    np.testing.assert_allclose(
        port.numpy(), np.asarray(_jax_ll(jll, extra, anchor, nme, strides,
                                         cand, observed, dense)), rtol=1e-10)


def test_bb_kernel_totals_are_the_bin_sums():
    """The bb kernels take T from per-anchor totals; on the CPU the wrapper
    runs the plain version, which sums the morphed counts over the bins —
    the two agree because the totals are linear in the corner rows."""
    anchor, nme, strides, idx, t, m, observed, _ = _setup(2)
    nme_t = _t(nme)
    tot = fused_bb.anchor_totals(nme_t)
    np.testing.assert_allclose(tot.numpy(), nme.sum(-1), rtol=1e-15)
    w = corner_weight_tables(_t(t))[0]
    ids = corner_ids(strides, _t(idx, torch.int64), anchor.shape[0])
    morphed = (w[..., None] * nme_t[ids]).sum(1).sum(-1)
    np.testing.assert_allclose((w * tot[ids]).sum(-1).numpy(),
                               morphed.numpy(), rtol=1e-13)


def test_bblite_negative_expectation_penalty_matches_pallas():
    """An allow_negative source drives some bins below zero: the bb-lite
    kernels keep the reference's penalty in value and derivatives."""
    anchor, nme, strides, idx, t, m, observed, cand = _setup(1)
    anchor[:, 2, 20:30] = -0.05
    # Counts 0 or 1 there: with k >= 2 the floored log argument tiny/k is
    # a denormal, which XLA's CPU flushes to zero (-inf) and torch keeps
    # (ROADMAP queue 3, the deviance-floor denormal)
    observed[:, 20:30] = np.arange(10) % 2
    port = fused_bb_lite.binned_bblite_vgh_fused(
        _t(anchor), _t(nme), strides, _t(idx, torch.int64), _t(t), _t(m),
        _t(observed))
    assert float(port[0].max()) < -1e4                # the penalty engaged
    for dense in (False, True):
        _assert_vgh_close(port, _jax_vgh(
            jfused_lite.binned_bblite_vgh_fused, (), anchor, nme, strides,
            idx, t, m, observed, dense))
    lls = fused_bb_lite.binned_bblite_ll_fused_multi(
        _t(anchor), _t(nme), strides, _t(cand['idx'], torch.int64),
        _t(cand['t']), _t(cand['m']), _t(observed))
    np.testing.assert_allclose(lls.numpy(), np.asarray(_jax_ll(
        jfused_lite.binned_bblite_ll_fused_multi, (), anchor, nme, strides,
        cand, observed, False)), rtol=1e-10)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_path_is_taken_for_cpu_tensors(mode):
    """On CPU tensors the wrappers return exactly their plain versions and
    launch nothing."""
    module = fused_bb if mode == 'bb' else fused_bb_lite
    vgh, ll, _, _, extra = MODES[mode]
    plain_vgh, plain_ll = (
        (fused_bb.binned_bb_vgh_plain, fused_bb.binned_bb_ll_plain)
        if mode == 'bb' else (fused_bb_lite.binned_bblite_vgh_plain,
                              fused_bb_lite.binned_bblite_ll_plain))
    anchor, nme, strides, idx, t, m, observed, cand = _setup(2)
    module.reset_launch_counts()
    args = (_t(anchor), _t(nme), strides, _t(idx, torch.int64), _t(t),
            _t(m), _t(observed)) + extra
    for a, b in zip(vgh(*args), plain_vgh(*args)):
        assert torch.equal(a, b)
    cargs = (_t(anchor), _t(nme), strides, _t(cand['idx'], torch.int64),
             _t(cand['t']), _t(cand['m']), _t(observed)) + extra
    assert torch.equal(ll(*cargs), plain_ll(*cargs))
    assert not any(module.launch_counts().values())


def test_wrappers_reject_bad_inputs():
    anchor, nme, strides, idx, t, m, observed, _ = _setup(2)
    args = [_t(anchor), _t(nme), strides, _t(idx, torch.int64), _t(t),
            _t(m), _t(observed)]
    with pytest.raises(ValueError, match='nme'):
        fused_bb.binned_bb_vgh_fused(*(args[:1] + [_t(nme[:, :-1])]
                                       + args[2:]), BB_I)
    with pytest.raises(ValueError, match='nme'):
        fused_bb_lite.binned_bblite_vgh_fused(
            *(args[:1] + [_t(nme, torch.float32)] + args[2:]))
    with pytest.raises(ValueError, match='bb_i'):
        fused_bb.binned_bb_vgh_fused(*args, S)
