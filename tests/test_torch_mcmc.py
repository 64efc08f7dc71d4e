"""Device MCMC of the port (``blueice_tpu_torch.parallel.mcmc``) against
the JAX package's, float64 on the CPU.

* ``make_device_log_prob`` against the JAX package's, vmapped, at 64
  walker points per model (binned, Gaussian unbinned, the small XENON
  example and a two-child Sum with a constraint), including points out of
  the shape bounds, on anchors and with negative rate multipliers: rtol
  1e-10, -inf at the same places.
* ``sample_stretch``: the moments of a 2-D Gaussian target (mean atol
  0.05, covariance atol 0.12, as the JAX package's test), the odd-walker
  refusal, and one seed giving one chain.
* ``bestfit_emcee_device`` on the JAX test's Gaussian model: medians within
  0.15 of the JAX package's ``bestfit_emcee_device`` and of
  ``bestfit_scipy`` (the two samplers' random streams differ, so they
  agree in distribution only); fixed parameters with errors; the jitter of
  a zero default; a typo'd fixed name.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu import composition as jcomp
from blueice_tpu.compile import cached_logl as jcached
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.parallel import mcmc as jmcmc
from blueice_tpu.test_helpers import conf_for_test as jconf
from blueice_tpu_torch import composition as tcomp
from blueice_tpu_torch.compile import cached_logl
from blueice_tpu_torch.exceptions import InvalidParameter
from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
from blueice_tpu_torch.parallel import mcmc
from blueice_tpu_torch.test_helpers import conf_for_test

from test_torch_inference import (JAX, PORT, _binned_pair, _sum_pair,
                                  _unbinned_pair, _xenon)
from test_torch_profile_grid_map import one_torch_thread  # noqa: F401


def _xenon_pair():
    jlf, tlf = _xenon(JAX), _xenon(PORT)
    events = jlf.base_model.simulate(rng=np.random.default_rng(2))
    jlf.set_data(events)
    tlf.set_data(events)
    return jlf, tlf


def _constrained_sum_pair():
    """The two-child Sum of test_torch_inference plus a correlated
    constraint on band_shift and the ER rate."""
    jsum, tsum = _sum_pair()
    names, mean, cov = (['band_shift', 'er_rate_multiplier'], [0.0, 1.0],
                        [[0.09, 0.012], [0.012, 0.0064]])
    return (jcomp.LogLikelihoodSum(jsum.likelihood_list + [
                jcomp.correlated_gaussian_constraint(names, mean, cov)]),
            tcomp.LogLikelihoodSum(tsum.likelihood_list + [
                tcomp.correlated_gaussian_constraint(names, mean, cov)]))


def _walkers(compiled, names, rng, n=64):
    """n walker points: rates spread around their defaults, a quarter of
    them negative; shape coordinates on a range 30% wider than the anchors
    (outside the bounds at the edges), every eighth point on anchors."""
    x = np.empty((n, len(names)))
    anchors = {}
    for c in getattr(compiled, 'children', None) or [compiled]:
        anchors.update(zip(c.shape_names, c.anchor_arrays or ()))
    for i, name in enumerate(names):
        d = float(compiled.defaults[name])
        if name in anchors:
            arr = np.asarray(anchors[name])
            pad = 0.3 * (arr[-1] - arr[0])
            x[:, i] = rng.uniform(arr[0] - pad, arr[-1] + pad, n)
            x[::8, i] = rng.choice(arr, len(x[::8]))
        else:
            x[:, i] = d * rng.uniform(0.5, 1.5, n)
            x[1::4, i] = -x[1::4, i] * rng.uniform(0.01, 0.2, len(x[1::4]))
    return x


@pytest.mark.parametrize('model', ['binned', 'unbinned', 'xenon', 'sum'])
def test_device_log_prob_matches(model):
    jlf, tlf = {'binned': _binned_pair, 'unbinned': _unbinned_pair,
                'xenon': _xenon_pair, 'sum': _constrained_sum_pair}[model]()
    tc = cached_logl(tlf, device='cpu')
    log_prob, names, guess = mcmc.make_device_log_prob(tc)
    jlog_prob, jnames, jguess = jmcmc.make_device_log_prob(jcached(jlf))
    assert names == jnames
    np.testing.assert_array_equal(guess, jguess)
    # the fixed-value variant routes the value as the JAX package's
    fixed = {names[-1]: float(guess[-1])}
    tfixed = mcmc.make_device_log_prob(tc, fixed)
    jfixed = jmcmc.make_device_log_prob(jcached(jlf), fixed)
    for (lp, nm, _), (jlp, jnm, _) in (((log_prob, names, guess),
                                        (jlog_prob, jnames, jguess)),
                                       (tfixed, jfixed)):
        x = _walkers(tc, nm, np.random.default_rng(len(nm)))
        port = lp(torch.as_tensor(x)).numpy()
        ref = np.asarray(jax.vmap(jlp)(jnp.asarray(x)))
        assert (np.isneginf(port) == np.isneginf(ref)).all()
        finite = np.isfinite(ref)
        assert finite.sum() >= 8 and (~finite).sum() >= 8
        np.testing.assert_allclose(port[finite], ref[finite], rtol=1e-10)
        # centered values: the same up to the data constant
        offset = port[finite] - lp.centered(torch.as_tensor(x)).numpy()[
            finite]
        np.testing.assert_allclose(offset, offset[0], rtol=1e-12)


def test_sample_stretch_gaussian_posterior():
    """On a known 2-D Gaussian target the sampled moments must match."""
    mean = torch.tensor([1.5, -0.5], dtype=torch.float64)
    prec = torch.tensor([[2.0, 0.3], [0.3, 1.0]], dtype=torch.float64)

    def log_prob(x):
        d = x - mean
        return -0.5 * ((d @ prec) * d).sum(-1)

    gen = torch.Generator().manual_seed(0)
    p0 = mean[None, :] + 0.1 * torch.randn((64, 2), generator=gen,
                                           dtype=torch.float64)
    chain, logps = mcmc.sample_stretch(log_prob, gen, p0, 1500)
    assert chain.shape == (64, 1500, 2) and logps.shape == (64, 1500)
    np.testing.assert_allclose(logps.numpy(), log_prob(chain).numpy(),
                               rtol=1e-12)
    samples = chain[:, 500:, :].reshape(-1, 2).numpy()
    cov = np.linalg.inv(prec.numpy())
    np.testing.assert_allclose(samples.mean(0), mean.numpy(), atol=0.05)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.12)


def test_sample_stretch_odd_walkers_rejected():
    with pytest.raises(ValueError, match="even"):
        mcmc.sample_stretch(lambda x: -(x ** 2).sum(-1),
                            torch.Generator().manual_seed(0),
                            torch.zeros((7, 2)), 10)


def test_sample_stretch_seed_repeats_the_chain():
    p0 = torch.randn((8, 3), generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    runs = [mcmc.sample_stretch(lambda x: -(x ** 2).sum(-1),
                                torch.Generator().manual_seed(5), p0, 50)
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    other = mcmc.sample_stretch(lambda x: -(x ** 2).sum(-1),
                                torch.Generator().manual_seed(6), p0, 50)
    assert not torch.equal(other[0], runs[0][0])


def _gauss_lf(pkg_lik, conf):
    c = conf(n_sources=2)
    c['sources'][1]['mu'] = 3.0
    lf = pkg_lik(c)
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    lf.prepare()
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(5)))
    return lf


@pytest.fixture(scope='module')
def gauss():
    return _gauss_lf(JaxUnbinned, jconf), _gauss_lf(UnbinnedLogLikelihood,
                                                    conf_for_test)


def test_device_emcee_matches_jax_and_scipy(gauss):
    jlf, tlf = gauss
    opts = dict(n_walkers=40, n_steps=300, n_burn_in=150, seed=3)
    res, ll = tlf.bestfit_emcee_device(device='cpu', **opts)
    jres, _ = jmcmc.bestfit_emcee_device(jlf, **opts)
    opt, ll_opt = tlf.bestfit_scipy()
    assert list(res) == list(jres) == ['s0_rate_multiplier', 'mu']
    for k in res:
        assert abs(res[k] - jres[k]) < 0.15, (k, res, jres)
        assert abs(res[k] - opt[k]) < 0.15, (k, res, opt)
    assert ll_opt - ll < 3.0
    np.testing.assert_allclose(ll, tlf(**res), rtol=1e-10)

    # out-of-bounds proposals (mu beyond its anchors) never enter the chain
    _, ll2, samples = tlf.bestfit_emcee_device(
        device='cpu', n_walkers=40, n_steps=200, n_burn_in=100, seed=7,
        return_samples=True)
    assert np.isfinite(ll2) and np.isfinite(samples).all()
    assert (samples[:, 1] >= -1.0).all() and (samples[:, 1] <= 1.0).all()


def test_device_emcee_fixed_and_errors(gauss):
    _, tlf = gauss
    res, ll, errs = tlf.bestfit_emcee_device(
        device='cpu', n_walkers=32, n_steps=200, n_burn_in=100, seed=1,
        return_errors=True, mu=0.0)
    assert list(res) == ['s0_rate_multiplier'] == list(errs)
    assert errs['s0_rate_multiplier'] > 0
    np.testing.assert_allclose(ll, tlf(mu=0.0, **res), rtol=1e-10)


def test_zero_default_parameter_is_actually_sampled(gauss):
    """mu's default is exactly 0: every walker would start there and never
    move without the additive jitter."""
    _, tlf = gauss
    _, _, samples = tlf.bestfit_emcee_device(
        device='cpu', n_walkers=32, n_steps=200, n_burn_in=100, seed=11,
        return_samples=True)
    assert samples[:, 1].std() > 1e-3


def test_device_emcee_rejects_unknown_parameters(gauss):
    _, tlf = gauss
    with pytest.raises(InvalidParameter, match="mu_typo"):
        tlf.bestfit_emcee_device(device='cpu', n_walkers=8, n_steps=4,
                                 n_burn_in=0, mu_typo=0.5)
    with pytest.raises(ValueError, match="nothing to sample"):
        mcmc.make_device_log_prob(cached_logl(tlf, device='cpu'),
                                  dict(s0_rate_multiplier=1.0, mu=0.0))


def test_device_emcee_reuses_its_runner():
    """The log_prob is cached on the compiled likelihood per (walkers,
    steps, fixed); a new dataset compiles anew."""
    tlf = _gauss_lf(UnbinnedLogLikelihood, conf_for_test)
    opts = dict(device='cpu', n_walkers=8, n_steps=5, n_burn_in=0)
    first = tlf.bestfit_emcee_device(**opts)
    compiled = cached_logl(tlf, device='cpu')
    runners = dict(compiled._mcmc_runners)
    assert tlf.bestfit_emcee_device(**opts) == first
    assert compiled._mcmc_runners == runners
    tlf.set_data(tlf.base_model.simulate(rng=np.random.default_rng(6)))
    assert cached_logl(tlf, device='cpu') is not compiled


def test_device_log_prob_of_an_ancillary_term_matches():
    """A dataset-free ancillary term alone, which no closed-form engine
    fits: the autodiff engine's value scores its walkers in one vmapped
    call, as the JAX package's vmapped log_prob scores them."""
    args = (['band_shift', 'er_rate_multiplier'], [0.0, 1.0],
            [[0.09, 0.012], [0.012, 0.0064]])
    jlp, jnames, _ = jmcmc.make_device_log_prob(
        jcached(jcomp.correlated_gaussian_constraint(*args)))
    lp, names, _ = mcmc.make_device_log_prob(cached_logl(
        tcomp.correlated_gaussian_constraint(*args), device='cpu'))
    assert names == jnames
    x = np.random.default_rng(0).normal([0.0, 1.0], [0.5, 0.2], (16, 2))
    np.testing.assert_allclose(lp(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.vmap(jlp)(jnp.asarray(x))),
                               rtol=1e-10)
