"""The general generator of toy-ensemble traffic: a closed loop of calls,
each a batch of fresh datasets drawn by the harness itself.

A traffic file (``benchmark/traffic/<name>.json``) gives: ``kind``
(``closed_loop_ensemble``, the one this generator makes),
``toys_per_call`` (the batch), ``truth`` (parameters the datasets are
drawn at; the rest at the model's defaults), ``target`` and
``hypothesis`` (the profile-likelihood test each call runs) and
``check_toys`` (how many of the window's toys the reference judges, drawn
from the seed).

What one call's datasets are is the likelihood kind's: its reference's
``sampler`` gives the draw (binned: Poisson counts of the expected counts
at the truth), which the generator hands a generator seeded by a hash of
(seed, call) alone, so the datasets of a call can be drawn again after the
window, on the same device, bit for bit."""

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
    """Datasets of a closed-loop ensemble: :meth:`datasets` of call ``i``
    is ``draw(generator)``, the kind's ``toys_per_call`` datasets (opaque
    here) on ``device``."""

    def __init__(self, traffic, draw, seed, device):
        if traffic.get('kind') != 'closed_loop_ensemble':
            raise ValueError("this generator makes closed_loop_ensemble "
                             "traffic, not %r" % traffic.get('kind'))
        self.traffic = traffic
        self.draw = draw
        self.seed = seed
        self.device = torch.device(device)

    def datasets(self, call):
        """The datasets of call ``call``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, 'call', call))
        return self.draw(gen)

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
