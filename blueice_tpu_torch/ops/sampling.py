"""Sampling from histogram templates on a torch device.

Counterpart of :mod:`blueice_tpu.ops.sampling`: a categorical draw over the
bins followed by a uniform draw inside the bin (the reference's
``Histdd.get_random``, blueice/source.py:248-264), with a fixed count so a
toy pipeline keeps static shapes. Randomness comes from an explicit
``torch.Generator`` where the JAX package takes a PRNG key.
"""

import torch

__all__ = ['sample_from_template', 'poisson_counts']


def sample_from_template(generator, weights, edges, n):
    """Sample ``n`` points from a histogram payload.

    :param generator: torch.Generator on the weights' device.
    :param weights: (*bins,) nonnegative per-bin weights (need not be
      normalized); bins with a weight that is not positive are never drawn.
    :param edges: list of k 1-d bin-edge arrays.
    :param n: number of points to draw.
    :return: (n, k) float64 coordinates, uniform within their bin.
    """
    weights = torch.as_tensor(weights)
    shape = weights.shape
    if len(edges) != len(shape) or any(
            torch.as_tensor(e).dim() != 1
            or torch.as_tensor(e).shape[0] != shape[d] + 1
            for d, e in enumerate(edges)):
        raise ValueError(
            "edges must be a list of %d 1-d arrays, one per weights axis, "
            "each one longer than its axis %s — got %s"
            % (len(shape), tuple(shape),
               [tuple(torch.as_tensor(e).shape) for e in edges]))
    dev = weights.device
    flat = weights.reshape(-1).to(torch.float64)
    flat = torch.where(flat > 0, flat, torch.zeros_like(flat))
    bin_i = torch.multinomial(flat, int(n), replacement=True,
                              generator=generator)
    multi, rest = [], bin_i
    for size in reversed(shape):
        multi.append(rest % size)
        rest = rest // size
    multi = multi[::-1]
    u = torch.rand((int(n), len(shape)), generator=generator,
                   dtype=torch.float64, device=dev)
    cols = []
    for d, e in enumerate(edges):
        e = torch.as_tensor(e, dtype=torch.float64, device=dev)
        lo, hi = e[multi[d]], e[multi[d] + 1]
        cols.append(lo + u[:, d] * (hi - lo))
    return torch.stack(cols, dim=-1)


def poisson_counts(generator, expected):
    """Poisson counts with mean ``expected`` (elementwise), drawn from
    ``generator`` (a single import point in the toy pipeline)."""
    expected = torch.as_tensor(expected)
    return torch.poisson(expected, generator=generator)
