"""Fused Barlow-Beeston-lite binned-likelihood kernels: hand-written CUDA
for Hopper, with their plain PyTorch versions beside them.

Counterpart of :mod:`blueice_tpu.ops.fused_bb_lite`. The JAX module has
four Pallas kernels for two contracts (gather and dense flavors of each);
the port has one CUDA kernel per contract, in ``csrc/fused_bb_lite.cu``:

* :func:`binned_bblite_vgh_fused` — ll, gradient and Hessian in (m, t) of
  the binned likelihood with one profiled scale per bin on the total
  expectation, gamma = (k + M) / (lam + M), per toy. Replaces
  ``_bblite_vgh_kernel`` and ``_bblite_vgh_kernel_dense``.
* :func:`binned_bblite_ll_fused_multi` — the same ll at A line-search
  candidates per toy. Replaces ``_bblite_ll_kernel`` and
  ``_bblite_ll_kernel_dense``.

Both read the pmf anchors (G, S, N) and the TOTAL MC-count anchor rows
(G, N), summed over sources by the caller. A wrapper runs the plain version
(:func:`binned_bblite_vgh_plain`, :func:`binned_bblite_ll_plain`) for CPU
tensors and for CUDA tensors launches its kernel or raises; each counts its
launches in ``launches``. The negative-expectation penalty is kept, so
``allow_negative`` models stay on the kernels.
"""

import ctypes
import functools
import os

import torch

from . import fused
from .bb_lite import bblite_ll_from_morphed, bblite_vgh_from_corners
from .binned_vgh import corner_weight_tables

__all__ = ['binned_bblite_vgh_fused', 'binned_bblite_ll_fused_multi',
           'binned_bblite_vgh_plain', 'binned_bblite_ll_plain',
           'binned_bblite_vgh_launcher', 'binned_bblite_ll_launcher',
           'load_library', 'launch_counts', 'reset_launch_counts']

SOURCE = os.path.join(fused.CSRC_DIR, 'fused_bb_lite.cu')


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the bb-lite kernel library; declare its C
    signatures. Raises without CUDA or without nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fused CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(fused.build_library(SOURCE))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.bt_bblite_vgh.argtypes = [i] * 4 + [p] * 12
    lib.bt_bblite_vgh.restype = i
    lib.bt_bblite_ll_multi.argtypes = [i] * 5 + [p] * 8
    lib.bt_bblite_ll_multi.restype = i
    return lib


def binned_bblite_vgh_plain(anchor, nme, strides, idx, t, m, observed):
    """Plain PyTorch version of :func:`binned_bblite_vgh_fused`: gather each
    toy's corner rows and run the closed form of
    :func:`blueice_tpu_torch.ops.bb_lite.bblite_vgh_from_corners`."""
    ids = fused.corner_ids(strides, idx, anchor.shape[0])       # (B, C)
    return bblite_vgh_from_corners(anchor[ids], nme[ids], m, t, observed)


def binned_bblite_vgh_launcher(anchor, nme, strides, idx, t, m, observed):
    """The CUDA side of :func:`binned_bblite_vgh_fused`, split in two (see
    :func:`blueice_tpu_torch.ops.fused.binned_vgh_launcher`): returns
    ``(launch, (ll, g, H))``."""
    B = idx.shape[0]
    G, S, N, K = fused._check_shapes(anchor, strides, idx, t, m, observed,
                                     (B,), nme=nme)
    fused._check_cuda(anchor, 'binned_bblite_vgh_fused')
    fused._check_kernel_inputs(anchor, K, S, (nme, m, observed))
    lib = load_library()
    P = S + K
    ids, w, wd, wx_pairs = fused.vgh_tables(strides, idx, t, G)
    ll = anchor.new_empty((B,))
    g = anchor.new_empty((B, P))
    H = anchor.new_empty((B, P, P))

    def launch():
        with torch.cuda.device(anchor.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.bt_bblite_vgh(
                S, K, N, B, anchor.data_ptr(), nme.data_ptr(),
                ids.data_ptr(), w.data_ptr(), wd.data_ptr(),
                wx_pairs.data_ptr(), m.data_ptr(), observed.data_ptr(),
                ll.data_ptr(), g.data_ptr(), H.data_ptr(), stream)
        fused._launch_check(code, 'bb-lite vgh')
        binned_bblite_vgh_fused.launches += 1
    return launch, (ll, g, H)


def binned_bblite_vgh_fused(anchor, nme, strides, idx, t, m, observed):
    """Barlow-Beeston-lite (ll, g, H) in (m, t) for a batch of toys.

    :param anchor: (G, S, N) pmf anchor templates, grid flattened in C order.
    :param nme: (G, N) TOTAL MC-count anchor rows (summed over sources).
    :param strides: K ints — anchor-grid row strides.
    :param idx: (B, K) integer lower-corner indices; t: (B, K) lerp weights;
      m: (B, S) rates; observed: (B, N) observed counts.
    :return: (ll (B,), g (B, S+K), H (B, S+K, S+K)).
    """
    if anchor.device.type == 'cpu':
        fused._check_shapes(anchor, strides, idx, t, m, observed,
                            (idx.shape[0],), nme=nme)
        return binned_bblite_vgh_plain(anchor, nme, strides, idx, t, m,
                                       observed)
    launch, out = binned_bblite_vgh_launcher(anchor, nme, strides, idx, t, m,
                                             observed)
    launch()
    return out


binned_bblite_vgh_fused.launches = 0


def binned_bblite_ll_plain(anchor, nme, strides, idx, t, m, observed):
    """Plain PyTorch version of :func:`binned_bblite_ll_fused_multi`: the
    morphed pmfs and total counts accumulate corner by corner, then the
    closed-form value."""
    ids = fused.corner_ids(strides, idx, anchor.shape[0])       # (B, A, C)
    w = corner_weight_tables(t)[0]                              # (B, A, C)
    P = Mn = None
    for c in range(ids.shape[-1]):
        term = w[..., c, None, None] * anchor[ids[..., c]]
        nterm = w[..., c, None] * nme[ids[..., c]]
        P = term if P is None else P + term
        Mn = nterm if Mn is None else Mn + nterm
    return bblite_ll_from_morphed(P, Mn, m, observed[:, None, :])


def binned_bblite_ll_launcher(anchor, nme, strides, idx, t, m, observed):
    """The CUDA side of :func:`binned_bblite_ll_fused_multi`, split in two:
    returns ``(launch, ll)``."""
    B, A = idx.shape[:2]
    G, S, N, K = fused._check_shapes(anchor, strides, idx, t, m, observed,
                                     (B, A), nme=nme)
    fused._check_cuda(anchor, 'binned_bblite_ll_fused_multi')
    fused._check_kernel_inputs(anchor, K, S, (nme, m, observed))
    lib = load_library()
    ids = fused.corner_ids(strides, idx, G).to(torch.int32).contiguous()
    w = corner_weight_tables(t)[0].contiguous()
    ll = anchor.new_empty((B, A))

    def launch():
        with torch.cuda.device(anchor.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.bt_bblite_ll_multi(
                S, K, N, B, A, anchor.data_ptr(), nme.data_ptr(),
                ids.data_ptr(), w.data_ptr(), m.data_ptr(),
                observed.data_ptr(), ll.data_ptr(), stream)
        fused._launch_check(code, 'bb-lite value')
        binned_bblite_ll_fused_multi.launches += 1
    return launch, ll


def binned_bblite_ll_fused_multi(anchor, nme, strides, idx, t, m, observed):
    """Barlow-Beeston-lite deviance-form LL at A parameter candidates per
    toy, each toy's candidates sharing its dataset.

    :param idx: (B, A, K) integer lower corners; t: (B, A, K) lerp weights;
      m: (B, A, S) rates; observed: (B, N); nme as for
      :func:`binned_bblite_vgh_fused`.
    :return: (B, A) log likelihoods (without the saturated-model constant).
    """
    if anchor.device.type == 'cpu':
        fused._check_shapes(anchor, strides, idx, t, m, observed,
                            tuple(idx.shape[:2]), nme=nme)
        return binned_bblite_ll_plain(anchor, nme, strides, idx, t, m,
                                      observed)
    launch, ll = binned_bblite_ll_launcher(anchor, nme, strides, idx, t, m,
                                           observed)
    launch()
    return ll


binned_bblite_ll_fused_multi.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {'binned_bblite_vgh_fused': binned_bblite_vgh_fused.launches,
            'binned_bblite_ll_fused_multi':
                binned_bblite_ll_fused_multi.launches}


def reset_launch_counts():
    binned_bblite_vgh_fused.launches = 0
    binned_bblite_ll_fused_multi.launches = 0
