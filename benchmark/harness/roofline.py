"""The yardstick of the kernels' roofline shares: the H100's peaks, the work
one kernel call must do by its contract, and the interposer that records
each call's work in a traced run.

``tree_flops``, ``work`` and ``bound`` and the peaks are frozen copies of
``blueice_tpu_torch/utils/roofline.py`` as it stood when the benchmark was
written, so that the program's later changes leave the yardstick alone. Bytes count each
input read once and each output written once; operations count the corner
combine (by the corner tree on a vgh call), the rate sum and the g / H
accumulation, and not the logarithm, division or Beeston-Barlow root, so the
bound is a lower bound of the time."""

import contextlib
import importlib

import numpy as np

__all__ = ['PEAKS', 'tree_flops', 'work', 'bound', 'BinnedCalls', 'share_pct',
           'installed']

#: NVIDIA's H100 SXM data sheet, dense, at the full 700 W power limit:
#: HBM3 bytes/s and float32 FLOP/s on the CUDA cores (the fit kernels use
#: no tensor cores).
PEAKS = {'h100-sxm': dict(hbm_bytes_s=3.35e12, fp32_flops_s=67e12)}


def tree_flops(K):
    """Float32 operations of the corner tree on one row of a cell's 2^K
    corners, to its value, its K differences and its K(K-1)/2 cross
    differences: 3 flops (a subtraction and an FMA) for each pair that the
    step on axis D halves. 93 at K = 4."""
    pairs = 0
    for D in range(K):
        after = K - 1 - D
        pairs += 2 ** D * (1 + after + after * (after - 1) // 2)
    return 3 * pairs


def work(kind, S, K, lead, row_floats, data_bytes, items, mc_rows=False):
    """(bytes, float32 operations) that one kernel call must move and do.

    :param kind: 'vgh' (ll, g and H at one point a toy) or 'value' (ll at
      A candidates a toy); ``lead`` (B,) or (B, A).
    :param row_floats: floats of the distinct corner rows the call reads.
    :param data_bytes: bytes of the per-toy data (the observed counts).
    :param items: bins summed over the call's toys and candidates.
    :param mc_rows: each corner also combines an MC-count row.
    """
    C = 2 ** K
    NP = K * (K - 1) // 2
    P = S + K
    NH = P * (P + 1) // 2
    R = S + (1 if mc_rows else 0)
    B = lead[0]
    calls = int(np.prod(lead))
    if kind == 'vgh':
        per = R * tree_flops(K) + 2 * S * (1 + K + NP)
        per += 2 * P + 2 * NH + P + 2 * S * K + 2 * NP
        tables = calls * (C * (1 + K + NP) + S) * 4
        out = B * (1 + P + P * P) * 4
    else:
        per = C * R * 2 + 2 * S
        tables = calls * (2 * C + S) * 4
        out = calls * 4
    return row_floats * 4 + data_bytes + tables + out, float(per) * items


def bound(bytes_, flops, chip='h100-sxm'):
    """(seconds, 'bytes' or 'operations'): the larger of bytes over the
    memory rate and operations over the CUDA cores' rate."""
    peaks = PEAKS[chip]
    t_mem = bytes_ / peaks['hbm_bytes_s']
    t_ops = flops / peaks['fp32_flops_s']
    return (t_mem, 'bytes') if t_mem >= t_ops else (t_ops, 'operations')


class BinnedCalls:
    """Interposes on one binned kernel wrapper of the port (called as
    ``wrapper(anchor, [mc_rows,] strides, idx, t, m, observed, ...)``) and,
    while :attr:`recording`, wraps each call in the span
    ``bench.wrapper.<name>`` and records its work: the lanes L, candidates
    A, (S, K, N) and, without waiting for the device, the count of distinct
    anchor rows its corners read (in the span ``bench.record``, whose
    kernels the trace leaves out). The fitters read the wrapper when they
    are built, so :meth:`install` comes before the study's first fit."""

    def __init__(self, module, name, contract, mc_rows=False):
        self.module_name, self.name = module, name
        self.contract, self.mc_rows = contract, mc_rows
        self.recording = False
        self.calls = []

    @property
    def span(self):
        return 'bench.wrapper.' + self.name

    def install(self):
        module = importlib.import_module(self.module_name)
        wrapper = getattr(module, self.name)
        off = 1 if self.mc_rows else 0
        import torch
        from torch.profiler import record_function

        def interposed(*args):
            if not self.recording:
                return wrapper(*args)
            with record_function(self.span):
                out = wrapper(*args)
            with record_function('bench.record'):
                anchor, strides, idx = args[0], args[1 + off], args[2 + off]
                G, S, N = anchor.shape
                K = len(strides)
                lead = tuple(idx.shape[:-1]) if K else tuple(
                    args[4 + off].shape[:-1])
                seen = torch.zeros(G, dtype=torch.bool, device=anchor.device)
                seen[_corner_ids(strides, idx, G).reshape(-1)] = True
                self.calls.append(dict(lead=lead, S=S, K=K, N=N,
                                       distinct=seen.sum()))
            return out
        interposed.launches = 0
        setattr(module, self.name, interposed)
        self._restore = (module, wrapper)

    def uninstall(self):
        module, wrapper = self._restore
        setattr(module, self.name, wrapper)

    def bounds_s(self):
        """Each recorded call's bound (s), in call order."""
        out = []
        for c in self.calls:
            lead, S, K, N = c['lead'], c['S'], c['K'], c['N']
            R = S + (1 if self.mc_rows else 0)
            L = lead[0]
            A = lead[1] if len(lead) > 1 else 1
            nbytes, flops = work(self.contract, S, K, lead,
                                 row_floats=R * int(c['distinct']) * N,
                                 data_bytes=L * N * 4, items=L * A * N,
                                 mc_rows=self.mc_rows)
            out.append(bound(nbytes, flops)[0])
        return out


def _corner_ids(strides, idx, G):
    """Flattened anchor ids (..., 2^K) of the corners around the lower
    corners ``idx`` (..., K) of a C-ordered grid with row ``strides``,
    clamped into [0, G - 1]."""
    import torch
    K = len(strides)
    st = torch.as_tensor([int(s) for s in strides], device=idx.device)
    offsets = torch.as_tensor(
        [sum(int(strides[k]) for k in range(K) if (c >> (K - 1 - k)) & 1)
         for c in range(2 ** K)], device=idx.device)
    base = (idx.to(torch.int64) * st).sum(-1)
    return torch.clamp(base[..., None] + offsets, 0, G - 1)


@contextlib.contextmanager
def installed(interposers):
    """The interposers installed for the block, put back after."""
    done = []
    try:
        for i in interposers:
            i.install()
            done.append(i)
        yield interposers
    finally:
        for i in reversed(done):
            i.uninstall()


def share_pct(run, calls):
    """100 x the summed bound of the traced window's calls recorded by
    ``calls`` (:class:`BinnedCalls`) over the summed device time of what
    they launched; None where the window made no such call."""
    if run.trace is None or not calls.calls:
        return None
    seconds = run.trace.wrapper_seconds(calls.name)
    if len(seconds) != len(calls.calls):
        raise RuntimeError("%s: %d recorded calls, %d traced spans"
                           % (calls.name, len(calls.calls), len(seconds)))
    spent = sum(seconds)
    if spent <= 0:
        return None
    return 100.0 * sum(calls.bounds_s()) / spent
