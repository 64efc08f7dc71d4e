"""The port's Beeston-Barlow modes against the JAX package, float64 on the
CPU, on the same numpy inputs:

* the per-bin closed forms (``bb_lambda``, ``bb_lam_parts``) on inputs that
  reach every branch: no MC (N = 0), inert (pw = 0), rate exactly 0, the
  U == 0 special root, and the general root on both sides of b = 0;
* the batched engines ``binned_bb_vgh/ll`` and ``binned_bblite_vgh/ll``, the
  compiled-path adjustments ``bb_single_adjust`` / ``bb_lite_logl`` and the
  roots;
* on the reduced XENON1T-style likelihood (12x10 bins, 3^4 anchors): the
  host likelihood ``lf(...)``, the compiled ``logl_with_data`` (built from
  the port's own likelihood and from the JAX likelihood through
  ``convert.state_from_reference``) against JAX ``build_logl``;
* the fitter's per-mode kernel routing.

Tolerances: the closed forms are the same float64 arithmetic in another
order (values rtol 1e-12, first derivatives 1e-10, second 1e-9, relative to
the largest entry where entries cancel); likelihood values rtol 1e-10.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.compile import build_logl as jax_build_logl
from blueice_tpu.examples.xenon_like import build_likelihood as jax_build
from blueice_tpu.likelihood import beeston_barlow_roots as jax_host_roots
from blueice_tpu.ops import bb_lite as jbb_lite
from blueice_tpu.ops import bb_vgh as jbb_vgh
from blueice_tpu.ops import beeston_barlow as jbeeston
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch.compile import build_logl
from blueice_tpu_torch.convert import (build_logl_from_state,
                                       state_from_reference)
from blueice_tpu_torch.examples import xenon_like
from blueice_tpu_torch.likelihood import (BinnedLogLikelihood,
                                          beeston_barlow_roots)
from blueice_tpu_torch.ops import bb_lite, bb_vgh, beeston_barlow
from blueice_tpu_torch.parallel import fitter, make_toy_fitter
from blueice_tpu_torch.utils import set_progress

SIZE = dict(n_cs1_bins=12, n_cs2_bins=10, livetime_days=30.0)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _branch_inputs(n=900, seed=0):
    """Per-bin (P, N, U, M, T, d) spanning every branch of the BB root."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(0, 2, n)
    N = rng.uniform(0, 50, n)
    U = rng.uniform(0, 5, n)
    M = rng.uniform(0.1, 3, n)
    T = rng.uniform(10, 100, n)
    d = rng.poisson(3.0, n).astype(float)
    U[:100] = 0.0                    # special root
    P[100:150] = 0.0                 # inert
    N[150:200] = 0.0                 # no MC statistics
    d[200:250] = 0.0                 # empty data
    M[250:280] = 0.0                 # rate exactly 0 (the dlam/dM limit)
    U[265:280] = 0.0
    U[300:400] = rng.uniform(50, 500, 100)        # b >= 0
    d[400:500] = rng.poisson(300.0, 100)          # b < 0
    return P, N, U, M, T, d


def test_branch_inputs_reach_every_branch():
    P, N, U, M, T, d = _branch_inputs()
    p = np.where(N > 0, M * P / np.where(N > 0, N, 1.0), 0.0)
    active = p > 0
    b = U * (p + 1.0) - p * (N + d)
    general = active & (U != 0)
    assert (active & (U == 0)).any() and (~active).any()
    assert (general & (b >= 0)).sum() > 50 and (general & (b < 0)).sum() > 50
    assert ((N > 0) & (P > 0) & (M == 0) & (U == 0)).any()
    assert ((N > 0) & (P > 0) & (M == 0) & (U != 0)).any()


def test_bb_lam_parts_matches_jax():
    ins = _branch_inputs()
    v = np.stack(ins[:5], axis=-1)
    lam_j, gam_j, om_j = (np.asarray(x) for x in jbb_vgh.bb_lam_vgh(
        jnp.asarray(v), jnp.asarray(ins[5])))
    lam_p, gam_p, om_p = (x.numpy() for x in bb_vgh.bb_lam_vgh(
        _t(v), _t(ins[5])))
    np.testing.assert_allclose(lam_p, lam_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(gam_p, gam_j, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(om_p, om_j, rtol=1e-9, atol=1e-11)
    lam = bb_vgh.bb_lambda(*(_t(x) for x in ins)).numpy()
    np.testing.assert_allclose(lam, np.asarray(jbb_vgh._lam_val(v, ins[5])),
                               rtol=1e-12, atol=1e-12)


def _corner_inputs(K, n_toys=2, S=3, N=40, seed=3):
    rng = np.random.default_rng(seed + K)
    C = 2 ** K
    cps = rng.uniform(0.01, 1.0, (n_toys, C, S, N))
    cnme = rng.uniform(0.5, 40.0, (n_toys, C, S, N))
    cnme[..., 5] = 0.0
    cps[:, :, [0, 2], 7] = 0.0       # U == 0 for bb source 1
    cps[:, :, 1, 9] = 0.0            # inert bin
    m = rng.uniform(5.0, 50.0, (n_toys, S))
    t = rng.random((n_toys, K))
    obs = rng.poisson(3.0, (n_toys, N)).astype(float)
    obs[:, :2] = 0.0
    return cps, cnme, m, t, obs


def _assert_vgh(port, ref):
    for p, r, tol in zip(port, ref, (1e-11, 1e-10, 1e-9)):
        np.testing.assert_allclose(p.numpy(), r, rtol=tol,
                                   atol=tol * 1e-2 * np.abs(r).max())


@pytest.mark.parametrize("K", [0, 1, 2, 3])
def test_binned_bb_engines_match_jax(K):
    cps, cnme, m, t, obs = _corner_inputs(K)
    args = tuple(_t(x) for x in (cps, cnme, m, t, obs))
    vgh = bb_vgh.binned_bb_vgh(*args, 1)
    ll = bb_vgh.binned_bb_ll(*args, 1)
    vgh_l = bb_lite.binned_bblite_vgh(*args)
    ll_l = bb_lite.binned_bblite_ll(*args)
    for i in range(cps.shape[0]):
        one = (cps[i], cnme[i], m[i], t[i], obs[i])
        _assert_vgh([x[i] for x in vgh],
                    [np.asarray(x) for x in jbb_vgh.binned_bb_vgh(*one, 1)])
        np.testing.assert_allclose(float(ll[i]),
                                   float(jbb_vgh.binned_bb_ll(*one, 1)),
                                   rtol=1e-11)
        _assert_vgh([x[i] for x in vgh_l],
                    [np.asarray(x) for x in jbb_lite.binned_bblite_vgh(*one)])
        np.testing.assert_allclose(float(ll_l[i]),
                                   float(jbb_lite.binned_bblite_ll(*one)),
                                   rtol=1e-11)


def test_compiled_path_adjustments_match_jax():
    rng = np.random.default_rng(5)
    S, N = 4, 60
    mus = rng.uniform(1, 30, S)
    pmfs = rng.uniform(0.01, 1, (S, N))
    pmfs /= pmfs.sum(-1, keepdims=True)
    nme = rng.uniform(0.5, 30, (S, N))
    nme[2, 4] = 0.0
    pmfs[[0, 1, 3], 6] = 0.0        # U == 0 for source 2
    obs = rng.poisson(2.0, N).astype(float)
    mus_p, pmfs_p = beeston_barlow.bb_single_adjust(
        _t(mus), _t(pmfs), _t(nme), _t(obs), 2)
    mus_j, pmfs_j = jbeeston.bb_single_adjust(mus, pmfs, nme, obs, 2)
    np.testing.assert_allclose(mus_p.numpy(), np.asarray(mus_j), rtol=1e-12)
    np.testing.assert_allclose(pmfs_p.numpy(), np.asarray(pmfs_j),
                               rtol=1e-12, atol=1e-15)
    for const in (True, False):
        np.testing.assert_allclose(
            float(bb_lite.bb_lite_logl(_t(mus), _t(pmfs), _t(nme), _t(obs),
                                       include_constant=const)),
            float(jbb_lite.bb_lite_logl(mus, pmfs, nme, obs,
                                        include_constant=const)),
            rtol=1e-12)
    np.testing.assert_allclose(
        bb_lite.bb_lite_logl_host(mus, pmfs, nme, obs),
        jbb_lite.bb_lite_logl_host(mus, pmfs, nme, obs), rtol=1e-13)
    a, p, U, d = nme[2], rng.uniform(0, 2, N), rng.uniform(0, 5, N), obs
    p[:5] = 0.0
    U[5:10] = 0.0
    with np.errstate(over='ignore'):   # root1 at p == 0: capped at -huge
        host = zip(beeston_barlow_roots(a, p, U, d),
                   jax_host_roots(a, p, U, d))
        for port, ref in host:
            np.testing.assert_allclose(port, ref, rtol=1e-13)
    for port, ref in zip(beeston_barlow.beeston_barlow_roots(a, p, U, d),
                         jbeeston.beeston_barlow_roots(a, p, U, d)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-13)


@pytest.fixture(scope='module', params=[True, 'bb_lite'],
                ids=['bb_single', 'bb_lite'])
def lfs(request):
    set_progress(False)
    jax_set_progress(False)
    bb = request.param
    jlf = jax_build('binned', bb=bb, **SIZE)
    tlf = xenon_like.build_likelihood('binned', bb=bb, **SIZE)
    jlf.set_data(jlf.base_model.simulate(rng=np.random.default_rng(7)))
    tlf.set_data(tlf.base_model.simulate(rng=np.random.default_rng(7)))
    return jlf, tlf


POINTS = [dict(),
          dict(wimp_rate_multiplier=2.0, band_shift=0.3),
          dict(efficiency=0.85, cs1_tilt=-0.5, band_width_scale=1.1),
          dict(er_rate_multiplier=0.8, nr_rate_multiplier=1.2,
               band_shift=-1.0)]


def test_host_builds_and_likelihood_match(lfs):
    jlf, tlf = lfs
    np.testing.assert_allclose(tlf._builds['n_model_events'][2],
                               jlf._builds['n_model_events'][2], rtol=1e-12)
    np.testing.assert_array_equal(tlf.data_events_per_bin.values,
                                  jlf.data_events_per_bin.values)
    for point in POINTS:
        np.testing.assert_allclose(tlf(**point), jlf(**point), rtol=1e-12)
    assert tlf(band_shift=5.0) == -float('inf')


@pytest.mark.parametrize("point", POINTS)
def test_compiled_logl_matches(lfs, point):
    """logl_with_data of the port (its own likelihood, and the JAX one read
    through convert.state_from_reference) against JAX build_logl, and the
    compiled value on the bound data against the host likelihood."""
    jlf, tlf = lfs
    jc = jax_build_logl(jlf)
    data = jlf.data_events_per_bin.values * 1.0 + 1.0
    ref = float(jc.logl_with_data(jc.params_from_kwargs(**point),
                                  jnp.asarray(data)))
    for c in (build_logl(tlf), build_logl_from_state(
            state_from_reference(jlf))):
        np.testing.assert_allclose(
            float(c.logl_with_data(c.params_from_kwargs(**point),
                                   torch.as_tensor(data))), ref, rtol=1e-10)
        np.testing.assert_allclose(float(c(**point)), tlf(**point),
                                   rtol=1e-10)
    c = build_logl(tlf)
    mode = tlf.model_statistical_uncertainty_handling
    assert (c.has_bb, c.has_bb_lite) == (mode == 'bb_single',
                                         mode == 'bb_lite')
    assert c.bb_source_i == (0 if mode == 'bb_single' else None)
    assert c.nme_tensor.shape == c.ps_tensor.shape


def _allow_negative_lf(mode):
    config = xenon_like.build_config(n_cs1_bins=5, n_cs2_bins=4,
                                     livetime_days=10.0)
    config['sources'][1]['allow_negative'] = True
    likelihood_config = {'model_statistical_uncertainty_handling': mode}
    if mode == 'bb_single':
        likelihood_config['bb_single_source'] = 'er'
    lf = BinnedLogLikelihood(config, likelihood_config=likelihood_config)
    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('nr')
    lf.prepare()
    return lf


@pytest.mark.parametrize("mode", ['bb_single', 'bb_lite'])
def test_fused_routing_per_mode(mode):
    """'auto' takes the kernels only where they compute the model: a
    bb_single model with an allow_negative source goes to 'analytic' (its
    kernels have no negative-expectation penalty); bb-lite keeps it."""
    set_progress(False)
    lf = _allow_negative_lf(mode)
    compiled = build_logl(lf, dtype=torch.float32)
    on_card = types.SimpleNamespace(**vars(compiled))
    on_card.device = torch.device('cuda')
    assert fitter._fused_eligible(on_card) == (mode == 'bb_lite')
    on_card.allowed_negative = np.zeros_like(compiled.allowed_negative)
    assert fitter._fused_eligible(on_card)
    # On the CPU 'auto' runs the closed form, which matches 'fused' (the
    # kernels' plain versions) for either mode
    counts = np.random.default_rng(1).poisson(
        compiled.expected_counts(compiled.defaults).numpy(), (3, 5, 4))
    fit_auto, _ = make_toy_fitter(build_logl(lf), max_iter=30)
    fit_fused, _ = make_toy_fitter(build_logl(lf), max_iter=30,
                                   engine='fused')
    np.testing.assert_allclose(fit_auto(counts)[1].numpy(),
                               fit_fused(counts)[1].numpy(), rtol=1e-12)


def test_mode_validation():
    config = xenon_like.build_config(n_cs1_bins=3, n_cs2_bins=3)
    with pytest.raises(ValueError, match='bb_single'):
        BinnedLogLikelihood(config, likelihood_config={
            'model_statistical_uncertainty_handling': 'bb_full'})
    lf = BinnedLogLikelihood(config, likelihood_config={
        'model_statistical_uncertainty_handling': 'bb_single'})
    lf.prepare()
    with pytest.raises(ValueError, match='bb_single_source'):
        build_logl(lf)
