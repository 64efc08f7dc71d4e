"""The yardstick of the unbinned kernels' roofline shares: the interposer
that records the work of each call of the port's unbinned kernel wrappers
in a traced run, counted as ``harness/roofline.py`` counts the binned
calls, with its ``work``, ``bound`` and peaks.

What an unbinned call must move and do is frozen here from
``blueice_tpu_torch/utils/roofline.py`` (``row_events``) and
``chip_smoke.py`` (``call_work``) as they stood when this file was written:
each toy's densities are its own, so the rows read are the distinct (lane,
corner) pairs of the call, each over its lane's valid events only; the
per-toy data are the lanes' event masks (a byte an event slot) and their
valid events' inverse reference densities; the items summed are the valid
events times the candidates."""

import importlib

from .roofline import bound, work

__all__ = ['UnbinnedCalls', 'MODULE']

#: The port's module of the unbinned kernel wrappers
MODULE = 'blueice_tpu_torch.ops.fused_unbinned'


class UnbinnedCalls:
    """Interposes on one unbinned kernel wrapper of the port (called as
    ``wrapper(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
    outlier)``: ``unbinned_vgh_fused``, contract 'vgh', or
    ``unbinned_ll_fused_multi``, 'value') and, while :attr:`recording`,
    wraps each call in the span ``bench.wrapper.<name>`` and records its
    work: (S, K, E), the lanes L and candidates A, and, without waiting for
    the device, the valid events of the call's distinct (lane, corner)
    rows and of its lanes (in the span ``bench.record``, whose kernels
    the trace leaves out). A call's corner offsets are built once for
    each stride set. The fitters read the wrapper when they are built, so
    :meth:`install` comes before the study's first fit."""

    def __init__(self, name, contract):
        self.name, self.contract = name, contract
        self.recording = False
        self.calls = []
        self._offsets = {}

    @property
    def span(self):
        return 'bench.wrapper.' + self.name

    def _corner_offsets(self, strides, device):
        """(row strides (K,), corner offsets (2^K,)) of the anchor grid,
        on ``device``, made once a stride set."""
        import torch
        key = (tuple(int(s) for s in strides), str(device))
        if key not in self._offsets:
            K = len(key[0])
            self._offsets[key] = (
                torch.as_tensor(key[0], dtype=torch.int64, device=device),
                torch.as_tensor(
                    [sum(key[0][k] for k in range(K)
                         if (c >> (K - 1 - k)) & 1) for c in range(2 ** K)],
                    dtype=torch.int64, device=device))
        return self._offsets[key]

    def record(self, ps, strides, lanes, idx, mask):
        """Record one call's work from its arguments."""
        import torch
        G = ps.shape[1]
        L, K = lanes.shape[0], len(strides)
        A = idx.shape[1] if idx.dim() == 3 else 1
        st, offsets = self._corner_offsets(strides, ps.device)
        base = (idx.to(torch.int64) * st).sum(-1)
        ids = torch.clamp(base[..., None] + offsets, 0, G - 1).reshape(L, -1)
        valid = mask[lanes].sum(-1)
        seen = torch.zeros((L, G), dtype=torch.bool, device=ps.device)
        seen[torch.arange(L, device=ps.device)[:, None], ids] = True
        self.calls.append(dict(
            lead=(L,) if idx.dim() == 2 else (L, A), S=ps.shape[2], K=K,
            E=ps.shape[3], row_events=(seen.sum(-1) * valid).sum(),
            valid=valid.sum()))

    def install(self):
        from torch.profiler import record_function
        module = importlib.import_module(MODULE)
        wrapper = getattr(module, self.name)

        def interposed(*args):
            if not self.recording:
                return wrapper(*args)
            with record_function(self.span):
                out = wrapper(*args)
            with record_function('bench.record'):
                self.record(args[0], args[1], args[2], args[3], args[6])
            return out
        interposed.launches = 0
        setattr(module, self.name, interposed)
        self._restore = (module, wrapper)

    def uninstall(self):
        module, wrapper = self._restore
        setattr(module, self.name, wrapper)

    def work(self):
        """Each recorded call's (bytes, float32 operations), in call
        order."""
        out = []
        for c in self.calls:
            lead, S, K, E = c['lead'], c['S'], c['K'], c['E']
            L = lead[0]
            A = lead[1] if len(lead) > 1 else 1
            n_valid = int(c['valid'])
            out.append(work(self.contract, S, K, lead,
                            row_floats=S * int(c['row_events']),
                            data_bytes=L * E + 4 * n_valid,
                            items=A * n_valid))
        return out

    def bounds_s(self):
        """Each recorded call's bound (s), in call order."""
        return [bound(nbytes, flops)[0] for nbytes, flops in self.work()]
