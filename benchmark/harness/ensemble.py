"""The general generator of toy-ensemble traffic: a closed loop of calls,
each a batch of fresh Poisson datasets drawn by the harness itself.

A traffic file (``benchmark/traffic/<name>.json``) gives: ``kind``
(``closed_loop_ensemble``, the one this generator makes),
``toys_per_call`` (the batch), ``truth`` (parameters the datasets are
drawn at; the rest at the model's defaults), ``target`` and
``hypothesis`` (the profile-likelihood test each call runs) and
``check_toys`` (how many of the window's toys the reference judges, drawn
from the seed).

Every dataset comes from ``--seed`` and its call's index alone: call ``i``
draws ``torch.poisson`` of the reference's expected counts at the truth
with a generator seeded by a hash of (seed, i), so the datasets of a call
can be drawn again after the window, on the same device, bit for bit."""

import hashlib

import numpy as np
import torch

__all__ = ['Ensemble', 'stream_seed']

#: The call index of the warm-up call in set-up (never a window call)
WARM_CALL = -1


def stream_seed(seed, *keys):
    """A 63-bit seed made from ``seed`` and ``keys`` (any whole numbers or
    strings; ``seed`` may exceed 64 bits)."""
    text = '/'.join(str(k) for k in (seed,) + keys).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], 'little') >> 1


class Ensemble:
    """Datasets of a closed-loop ensemble: :meth:`counts` of call ``i`` is
    a (toys_per_call, *bins) float tensor on ``device``."""

    def __init__(self, traffic, expected, bin_shape, seed, device,
                 dtype=torch.float32):
        if traffic.get('kind') != 'closed_loop_ensemble':
            raise ValueError("this generator makes closed_loop_ensemble "
                             "traffic, not %r" % traffic.get('kind'))
        self.traffic = traffic
        self.toys = int(traffic['toys_per_call'])
        self.seed = seed
        self.device = torch.device(device)
        self.bin_shape = tuple(bin_shape)
        # the expectation as the datasets' type holds it, once
        self.rates = torch.as_tensor(expected, device=self.device).to(
            dtype).reshape(1, -1).expand(self.toys, -1).contiguous()

    def counts(self, call, rows=None):
        """The datasets of call ``call`` (all, or the ``rows``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, 'call', call))
        c = torch.poisson(self.rates, generator=gen)
        if rows is not None:
            c = c[torch.as_tensor(rows, device=self.device)]
        return c.reshape((c.shape[0],) + self.bin_shape)

    def sample(self, calls, sizes):
        """The (call, toy) pairs the reference judges: ``check_toys``
        distinct toys of the window's calls (``sizes``: each call's number
        of toys), drawn from the seed alone."""
        n = int(self.traffic['check_toys'])
        rng = np.random.default_rng(stream_seed(self.seed, 'sample'))
        ends = np.cumsum([0] + [int(k) for k in sizes])
        picked = rng.choice(ends[-1], size=min(n, ends[-1]), replace=False)
        out = []
        for i in sorted(int(i) for i in picked):
            c = int(np.searchsorted(ends, i, side='right') - 1)
            out.append((calls[c], i - int(ends[c])))
        return out
