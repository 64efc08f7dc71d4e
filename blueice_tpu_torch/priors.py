"""Prior log-pdf objects usable on host floats and on torch tensors.

Counterpart of :mod:`blueice_tpu.priors`: :class:`NormalPrior` and
:class:`UniformPrior` compute with numpy for plain python/numpy values and
with torch ops for tensors, so one likelihood carries them on the host path
and in the compiled torch likelihood alike. ``MultivariateNormalPrior`` is
not ported yet (ROADMAP queue 1 item 16c).
"""

import math

import numpy as np
import torch

__all__ = ['NormalPrior', 'UniformPrior']

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _is_host_value(x):
    """True for plain python/numpy values (computed with numpy)."""
    return isinstance(x, (int, float, np.generic, np.ndarray))


class NormalPrior:
    """Gaussian log-prior: callable on host floats (numpy) and on torch
    tensors, picklable, hashable by value."""

    kind = 'normal'

    def __init__(self, mu, sigma):
        self.mu = float(mu)
        self.sigma = float(sigma)

    def __call__(self, x):
        z = (x - self.mu) / self.sigma
        return -0.5 * z * z - math.log(self.sigma) - _LOG_SQRT_2PI

    def grad(self, x):
        """d/dx of the log prior."""
        return -(x - self.mu) / (self.sigma * self.sigma)

    def hess(self, x):
        """d2/dx2 of the log prior."""
        return torch.full_like(x, -1.0 / (self.sigma * self.sigma))

    def __repr__(self):
        return "NormalPrior(mu=%r, sigma=%r)" % (self.mu, self.sigma)

    def __eq__(self, other):
        return (isinstance(other, NormalPrior)
                and (self.mu, self.sigma) == (other.mu, other.sigma))

    def __hash__(self):
        return hash(('NormalPrior', self.mu, self.sigma))


class UniformPrior:
    """Flat log-prior inside [lo, hi], -inf outside. Hashable by value."""

    kind = 'uniform'

    def __init__(self, lo, hi):
        self.lo = float(lo)
        self.hi = float(hi)

    def __eq__(self, other):
        return (isinstance(other, UniformPrior)
                and (self.lo, self.hi) == (other.lo, other.hi))

    def __hash__(self):
        return hash(('UniformPrior', self.lo, self.hi))

    def __call__(self, x):
        if _is_host_value(x):
            inside = (np.asarray(x) >= self.lo) & (np.asarray(x) <= self.hi)
            out = np.where(inside, 0.0, -np.inf)
            return float(out) if np.ndim(x) == 0 else out
        inside = (x >= self.lo) & (x <= self.hi)
        return torch.where(inside, torch.zeros_like(x),
                           torch.full_like(x, -math.inf))

    def grad(self, x):
        """d/dx of the log prior: zero (flat inside, -inf outside)."""
        return torch.zeros_like(x)

    hess = grad

    def __repr__(self):
        return "UniformPrior(lo=%r, hi=%r)" % (self.lo, self.hi)


#: prior kind -> class, for rebuilding priors from (kind, numbers) state
PRIORS = {cls.kind: cls for cls in (NormalPrior, UniformPrior)}
