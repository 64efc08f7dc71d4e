"""Ensemble MCMC on the device: the affine-invariant stretch move (Goodman
& Weare 2010, the emcee algorithm) over a compiled likelihood.

Counterpart of :mod:`blueice_tpu.parallel.mcmc`. The JAX package runs the
chain as one scanned XLA program with the likelihood vmapped over the
walkers. Here the chain is a Python loop whose state (positions, log
probabilities, acceptances) stays on the device, and ``log_prob`` is
batched: one call scores a whole half-ensemble. On the card that call is
one launch of the fitter's value kernel (one dataset, n_walkers/2
candidates). Nothing in the loop reads a value back to the host. The host
sampler (:func:`blueice_tpu_torch.inference._stretch_move_sampler`) remains
the path for likelihoods that are not compiled.
"""

from collections import OrderedDict

import numpy as np
import torch

from ..exceptions import InvalidParameter
from .fitter import _data_constant, observed_data, x_space_ops

__all__ = ['sample_stretch', 'make_device_log_prob', 'bestfit_emcee_device']


def sample_stretch(log_prob, generator, p0, n_steps, a=2.0):
    """Run the stretch-move ensemble sampler on p0's device.

    Each step is two half-updates: every walker of one half proposes
    against a partner drawn from the other half, z = ((a-1)U+1)^2/a, and
    accepts on ``(n_dim-1) log z + lp_prop - lp``.

    :param log_prob: batched log probability, (W, n_dim) -> (W,).
    :param generator: torch.Generator on p0's device.
    :param p0: (n_walkers, n_dim) initial ensemble; n_walkers must be even.
    :param n_steps: chain length.
    :param a: stretch scale (emcee's default 2.0).
    :return: (chain (n_walkers, n_steps, n_dim), logp (n_walkers, n_steps)).
    """
    pos = torch.as_tensor(p0).clone()
    n_walkers, n_dim = pos.shape
    if n_walkers % 2:
        raise ValueError("stretch move needs an even walker count")
    half = n_walkers // 2
    dt, dev = pos.dtype, pos.device
    logp = log_prob(pos)
    chain = torch.empty((n_walkers, n_steps, n_dim), dtype=dt, device=dev)
    logps = torch.empty((n_walkers, n_steps), dtype=logp.dtype, device=dev)

    def uniform():
        return torch.rand(half, generator=generator, dtype=dt, device=dev)

    for step in range(n_steps):
        for lo, olo in ((0, half), (half, 0)):
            walk, wlp = pos[lo:lo + half], logp[lo:lo + half]
            z = ((a - 1.0) * uniform() + 1.0) ** 2 / a
            partners = torch.randint(0, half, (half,), generator=generator,
                                     device=dev)
            anchor = pos[olo:olo + half][partners]
            prop = anchor + z[:, None] * (walk - anchor)
            lp_prop = log_prob(prop)
            log_acc = (n_dim - 1) * torch.log(z) + lp_prop - wlp
            accept = torch.log(uniform()) < log_acc
            new_walk = torch.where(accept[:, None], prop, walk)
            new_lp = torch.where(accept, lp_prop, wlp)
            pos[lo:lo + half] = new_walk
            logp[lo:lo + half] = new_lp
        chain[:, step] = pos
        logps[:, step] = logp
    return chain, logps


def make_device_log_prob(compiled, fixed=None, engine='auto'):
    """(log_prob(x), names, guess) over the floating parameters of a
    compiled likelihood with bound data: the device twin of the host
    ``make_objective(minus=False)``.

    ``log_prob`` maps walkers (W, n) to float64 (W,) values equal to
    ``compiled.logl`` at each: -inf outside the shape bounds or at an
    unphysical expectation (masked after the value op, which scores such a
    walker at its clipped cell), the prior terms, and the data constant
    (unbinned: the centering offset), added once in float64.
    ``log_prob.centered`` gives the same values in the working dtype
    without that constant: the sampler's acceptance differences use it, so
    a float32 constant of ~1e4 never enters a difference.

    The values come from the fitter's value op (:func:`x_space_ops`: on the
    card the value kernel, one launch for all W walkers; ``engine``
    'analytic' takes the plain versions); for a likelihood no closed-form
    engine fits, the autodiff engine's value, vmapped over the walkers.
    """
    fixed = dict(fixed or {})
    unknown = set(fixed) - set(compiled.registered)
    if unknown:
        # Same contract as the host path (make_objective -> lf(**point)):
        # a typo'd conditional fit must not silently sample unconstrained
        raise InvalidParameter(
            "%s matches neither a rate nor a shape parameter of this "
            "likelihood" % sorted(unknown))
    names = [n for n in compiled.registered if n not in fixed]
    if not names:
        raise ValueError("nothing to sample: every parameter is fixed")
    guess = np.array([float(compiled.defaults[n]) for n in names])
    dt, dev = compiled.dtype, compiled.device
    value = x_space_ops(compiled, names, fixed, engine=engine)[0]
    data = observed_data(compiled)
    const = _data_constant(compiled, data)[0]

    def centered(x):
        x = torch.as_tensor(x, dtype=dt, device=dev)
        f, ok = value(x[None], data, x.new_zeros((1, 0)), domain=True)
        return torch.where(ok[0], -f[0], torch.full_like(f[0],
                                                         float('-inf')))

    def log_prob(x):
        return centered(x).double() + const
    log_prob.centered = centered
    return log_prob, names, guess


def bestfit_emcee_device(lf, n_walkers=40, n_steps=200, n_burn_in=100,
                         seed=0, return_errors=False, return_samples=False,
                         compiled=None, quiet=True, n_threads=1, device=None,
                         **fixed):
    """Drop-in twin of ``bestfit_emcee`` running the chain on the device
    through the compiled likelihood (requires prepare() + set_data()).
    ``quiet`` and ``n_threads`` are accepted for the host twin's signature
    and ignored; any other unknown keyword raises InvalidParameter, like
    the host path.

    Walkers start at a 0.95-1.05 multiplicative spread of the guesses,
    with an additive +-0.05 jitter on coordinates whose guess is exactly 0
    (affine-invariant proposals could never move them). ``seed=None``
    draws fresh entropy; the default 0 repeats the chain.

    :param device: the compile's device when ``compiled`` is None (None:
      the card, raising without CUDA; 'cpu' for the CPU).
    :return: ({param: median}, loglikelihood at the median point, from
      the same value op), plus errors (half the 16-84% range) or the
      post-burn-in samples when requested.
    """
    from scipy import stats
    from ..compile import cached_logl

    if compiled is None:
        # Version-token cache on lf (shared with bestfit_jax): repeated
        # calls on the same dataset must not rebuild the likelihood
        compiled = cached_logl(lf, device=device)
    cache = compiled.__dict__.setdefault('_mcmc_runners', {})
    ck = (int(n_walkers), int(n_steps), tuple(sorted(fixed.items())))
    if ck not in cache:
        cache[ck] = make_device_log_prob(compiled, fixed)
    log_prob, names, guess = cache[ck]
    n_dim = len(names)
    dt, dev = compiled.dtype, compiled.device

    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    spread = 0.95 + 0.1 * torch.rand((n_walkers, n_dim), generator=gen,
                                     dtype=dt, device=dev)
    p0 = spread * torch.as_tensor(guess, dtype=dt, device=dev)[None, :]
    degenerate = guess == 0
    if degenerate.any():
        jitter = 0.1 * torch.rand((n_walkers, n_dim), generator=gen,
                                  dtype=dt, device=dev) - 0.05
        p0 = torch.where(torch.as_tensor(degenerate, device=dev)[None, :],
                         p0 + jitter, p0)

    chain, _ = sample_stretch(log_prob.centered, gen, p0, n_steps)
    samples = chain[:, n_burn_in:, :].reshape(-1, n_dim).double().cpu()
    samples = samples.numpy()

    fit = np.median(samples, axis=0)
    fit_dict = OrderedDict((names[i], fit[i]) for i in range(n_dim))
    best_ll = float(log_prob(torch.as_tensor(fit[None], dtype=dt,
                                             device=dev))[0])

    if return_errors:
        lo, hi = np.percentile(samples, 100 * stats.norm.cdf([-1, 1]), axis=0)
        errs = OrderedDict((names[i], (hi[i] - lo[i]) / 2)
                           for i in range(n_dim))
        return fit_dict, best_ll, errs
    if return_samples:
        return fit_dict, best_ll, samples
    return fit_dict, best_ll
