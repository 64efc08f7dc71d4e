"""Prior log-pdf objects usable on host floats and on torch tensors.

Counterpart of :mod:`blueice_tpu.priors`: :class:`NormalPrior` and
:class:`UniformPrior` compute with numpy for plain python/numpy values and
with torch ops for tensors, so one likelihood carries them on the host path
and in the compiled torch likelihood alike. :class:`MultivariateNormalPrior`
is the correlated constraint over several parameters that
:func:`blueice_tpu_torch.composition.correlated_gaussian_constraint` builds
on. :class:`TensorPrior` carries any other log-prior callable that computes
with torch tensors into the compiled likelihood.
"""

import math

import numpy as np
import torch

__all__ = ['NormalPrior', 'UniformPrior', 'MultivariateNormalPrior',
           'TensorPrior']

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


class MultivariateNormalPrior:
    """Joint Gaussian log-density over a vector of parameters, the
    correlated generalization of per-parameter :class:`NormalPrior`
    constraints.

    Callable on a plain vector (host numpy), on torch tensors, or on the
    OrderedDict a
    :class:`~blueice_tpu_torch.composition.LogAncillaryLikelihood` passes
    its func. The Cholesky factor is precomputed once; evaluation is
    one triangular solve. On tensors the parameters stack along a new last
    axis, so values of any common batch shape evaluate at once (and under
    ``torch.func.vmap``). Picklable and hashable by value.
    """

    def __init__(self, mean, cov):
        mean = np.asarray(mean, dtype=float).ravel()
        cov = np.asarray(cov, dtype=float)
        if cov.shape != (len(mean), len(mean)):
            raise ValueError("cov must be (%d, %d); got %s"
                             % (len(mean), len(mean), cov.shape))
        if not np.allclose(cov, cov.T, rtol=1e-10, atol=0):
            raise ValueError("cov must be symmetric")
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            raise ValueError("cov must be positive definite (Cholesky failed)")
        self.mean = mean
        self.cov = cov
        self._chol = chol
        self._log_norm = (-0.5 * len(mean) * math.log(2.0 * math.pi)
                          - float(np.sum(np.log(np.diag(chol)))))

    def __call__(self, x, **_ancillary_kwargs):
        # OrderedDict from LogAncillaryLikelihood: stack in parameter order
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)) and all(_is_host_value(v)
                                                for v in x):
            x = np.asarray(x, dtype=float)
        if _is_host_value(x):
            from scipy.linalg import solve_triangular
            z = solve_triangular(self._chol,
                                 np.asarray(x, dtype=float) - self.mean,
                                 lower=True)
            return float(-0.5 * np.dot(z, z) + self._log_norm)
        diff = (torch.stack(torch.broadcast_tensors(*x), dim=-1)
                if isinstance(x, (list, tuple)) else x)
        chol = torch.as_tensor(self._chol, dtype=diff.dtype,
                               device=diff.device)
        diff = diff - torch.as_tensor(self.mean, dtype=diff.dtype,
                                      device=diff.device)
        z = torch.linalg.solve_triangular(
            chol.expand(diff.shape[:-1] + chol.shape), diff[..., None],
            upper=False)[..., 0]
        return -0.5 * (z * z).sum(-1) + self._log_norm

    def __getstate__(self):
        return {'mean': self.mean, 'cov': self.cov}

    def __setstate__(self, state):
        self.__init__(state['mean'], state['cov'])

    def __repr__(self):
        return "MultivariateNormalPrior(mean=%s, cov=%s)" % (
            self.mean.tolist(), self.cov.tolist())

    def __eq__(self, other):
        return (isinstance(other, MultivariateNormalPrior)
                and np.array_equal(self.mean, other.mean)
                and np.array_equal(self.cov, other.cov))

    def __hash__(self):
        return hash(('MultivariateNormalPrior',
                     self.mean.tobytes(), self.cov.tobytes()))


class TensorPrior:
    """A user's log-prior callable in the compiled likelihood: it must
    compute elementwise with torch tensors (ordinary arithmetic or torch
    functions). Its derivatives, which the closed-form fit engines read,
    come from ``torch.func``."""

    kind = 'callable'

    def __init__(self, func):
        self.func = func
        try:
            out = func(torch.zeros((), dtype=torch.float64))
            if not torch.is_tensor(out):
                raise TypeError("returned %r, not a tensor" % (out,))
        except Exception as e:
            raise TypeError(
                "The log prior %r does not compute with torch tensors, so "
                "the likelihood cannot be compiled. Use NormalPrior / "
                "UniformPrior or a callable built from torch operations "
                "instead of e.g. a scipy.stats frozen logpdf (the host "
                "__call__ path still accepts those)." % (func,)) from e

    def __call__(self, x):
        return self.func(x)

    def grad(self, x):
        """d/dx of the log prior, element by element."""
        return torch.func.grad(lambda y: self.func(y).sum())(x)

    def hess(self, x):
        """d2/dx2 of the log prior, element by element."""
        return torch.func.grad(lambda y: self.grad(y).sum())(x)

    def __repr__(self):
        return "TensorPrior(%r)" % (self.func,)


#: prior kind -> class, for rebuilding priors from (kind, numbers) state
PRIORS = {cls.kind: cls for cls in (NormalPrior, UniformPrior, TensorPrior)}
