"""Fused Beeston-Barlow (bb_single) binned-likelihood kernels: hand-written
CUDA for Hopper, with their plain PyTorch versions beside them.

Counterpart of :mod:`blueice_tpu.ops.fused_bb`. The JAX module has four
Pallas kernels for two contracts (gather and dense flavors of each); the
port has one CUDA kernel per contract, in ``csrc/fused_bb.cu``:

* :func:`binned_bb_vgh_fused` — ll, gradient and Hessian in (m, t) of the
  binned likelihood with source ``bb_i``'s per-bin expectation profiled by
  the closed-form Beeston-Barlow root, per toy. Replaces ``_bb_vgh_kernel``
  and ``_bb_vgh_kernel_dense``.
* :func:`binned_bb_ll_fused_multi` — the same ll at A line-search
  candidates per toy. Replaces ``_bb_ll_kernel`` and ``_bb_ll_kernel_dense``.

Both read the pmf anchors (G, S, N) and the finite source's MC-count anchor
rows (G, N). The kernels take the total MC count T = sum_n N_n from
per-anchor totals (:func:`anchor_totals`, summed in float64 by the
wrapper) combined with the corner weights; the plain versions
(:func:`binned_bb_vgh_plain`, :func:`binned_bb_ll_plain`) sum the morphed
counts over the bins. The two are equal in exact arithmetic. A wrapper runs
the plain version for CPU tensors and for CUDA tensors launches its kernel
or raises; each counts its launches in ``launches``.

The kernels have no negative-expectation penalty, like the reference's; the
fitter routes ``allow_negative`` models to its plain engine.
"""

import ctypes
import functools
import os

import torch

from . import fused
from .bb_vgh import bb_ll_from_morphed, bb_vgh_from_corners
from .binned_vgh import corner_weight_tables

__all__ = ['binned_bb_vgh_fused', 'binned_bb_ll_fused_multi',
           'binned_bb_vgh_plain', 'binned_bb_ll_plain', 'anchor_totals',
           'load_library', 'launch_counts', 'reset_launch_counts']

SOURCE = os.path.join(fused.CSRC_DIR, 'fused_bb.cu')


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the BB kernel library; declare its C
    signatures. Raises without CUDA or without nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fused CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(fused.build_library(SOURCE))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.bt_bb_vgh.argtypes = [i] * 5 + [p] * 13
    lib.bt_bb_vgh.restype = i
    lib.bt_bb_ll_multi.argtypes = [i] * 6 + [p] * 9
    lib.bt_bb_ll_multi.restype = i
    return lib


def anchor_totals(nme):
    """Per-anchor MC totals (G,) of count rows (G, N), summed in float64 and
    returned in ``nme``'s dtype."""
    return nme.to(torch.float64).sum(-1).to(nme.dtype).contiguous()


def _check_bb(anchor, nme, strides, idx, t, m, observed, bb_i, lead):
    G, S, N, K = fused._check_shapes(anchor, strides, idx, t, m, observed,
                                     lead, nme=nme)
    if not 0 <= int(bb_i) < S:
        raise ValueError("bb_i=%r is not a source index (S = %d)"
                         % (bb_i, S))
    return G, S, N, K


def binned_bb_vgh_plain(anchor, nme, strides, idx, t, m, observed, bb_i):
    """Plain PyTorch version of :func:`binned_bb_vgh_fused`: gather each
    toy's corner rows and run the closed form of
    :func:`blueice_tpu_torch.ops.bb_vgh.bb_vgh_from_corners` on the batch."""
    ids = fused.corner_ids(strides, idx, anchor.shape[0])       # (B, C)
    return bb_vgh_from_corners(anchor[ids], nme[ids], m, t, observed, bb_i)


def binned_bb_vgh_fused(anchor, nme, strides, idx, t, m, observed, bb_i):
    """Beeston-Barlow (ll, g, H) in (m, t) for a batch of toys, with each
    toy's corner rows gathered from the shared anchor tensors.

    :param anchor: (G, S, N) pmf anchor templates, grid flattened in C order.
    :param nme: (G, N) MC-count anchor rows of the finite source.
    :param strides: K ints — anchor-grid row strides.
    :param idx: (B, K) integer lower-corner indices; t: (B, K) lerp weights;
      m: (B, S) rates; observed: (B, N) observed counts.
    :param bb_i: index of the finite-MC source.
    :return: (ll (B,), g (B, S+K), H (B, S+K, S+K)).
    """
    B = idx.shape[0]
    G, S, N, K = _check_bb(anchor, nme, strides, idx, t, m, observed, bb_i,
                           (B,))
    if anchor.device.type == 'cpu':
        return binned_bb_vgh_plain(anchor, nme, strides, idx, t, m, observed,
                                   bb_i)
    if anchor.device.type != 'cuda':
        raise ValueError("binned_bb_vgh_fused runs on CPU or CUDA tensors, "
                         "got %s" % anchor.device)
    fused._check_kernel_inputs(anchor, K, S, (nme, m, observed))
    totals = anchor_totals(nme)
    lib = load_library()
    P = S + K
    ids, w, wd, wx_pairs = fused.vgh_tables(strides, idx, t, G)
    ll = anchor.new_empty((B,))
    g = anchor.new_empty((B, P))
    H = anchor.new_empty((B, P, P))
    with torch.cuda.device(anchor.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bt_bb_vgh(
            S, K, N, B, int(bb_i), anchor.data_ptr(), nme.data_ptr(),
            totals.data_ptr(), ids.data_ptr(), w.data_ptr(), wd.data_ptr(),
            wx_pairs.data_ptr(), m.data_ptr(), observed.data_ptr(),
            ll.data_ptr(), g.data_ptr(), H.data_ptr(), stream)
    fused._launch_check(code, 'bb vgh')
    binned_bb_vgh_fused.launches += 1
    return ll, g, H


binned_bb_vgh_fused.launches = 0


def binned_bb_ll_plain(anchor, nme, strides, idx, t, m, observed, bb_i):
    """Plain PyTorch version of :func:`binned_bb_ll_fused_multi`: the morphed
    pmfs and counts accumulate corner by corner (the (B, A, 2^K, S, N)
    corner block is never formed), then the closed-form value with T the
    sum of the morphed counts over the bins."""
    ids = fused.corner_ids(strides, idx, anchor.shape[0])       # (B, A, C)
    w = corner_weight_tables(t)[0]                              # (B, A, C)
    P = Nb = None
    for c in range(ids.shape[-1]):
        term = w[..., c, None, None] * anchor[ids[..., c]]
        nterm = w[..., c, None] * nme[ids[..., c]]
        P = term if P is None else P + term
        Nb = nterm if Nb is None else Nb + nterm
    return bb_ll_from_morphed(P, Nb, m, observed[:, None, :], bb_i)


def binned_bb_ll_fused_multi(anchor, nme, strides, idx, t, m, observed,
                             bb_i):
    """Beeston-Barlow deviance-form LL at A parameter candidates per toy,
    each toy's candidates sharing its dataset.

    :param idx: (B, A, K) integer lower corners; t: (B, A, K) lerp weights;
      m: (B, A, S) rates; observed: (B, N); nme, bb_i as for
      :func:`binned_bb_vgh_fused`.
    :return: (B, A) log likelihoods (without the saturated-model constant).
    """
    B, A = idx.shape[:2]
    G, S, N, K = _check_bb(anchor, nme, strides, idx, t, m, observed, bb_i,
                           (B, A))
    if anchor.device.type == 'cpu':
        return binned_bb_ll_plain(anchor, nme, strides, idx, t, m, observed,
                                  bb_i)
    if anchor.device.type != 'cuda':
        raise ValueError("binned_bb_ll_fused_multi runs on CPU or CUDA "
                         "tensors, got %s" % anchor.device)
    fused._check_kernel_inputs(anchor, K, S, (nme, m, observed))
    totals = anchor_totals(nme)
    lib = load_library()
    ids = fused.corner_ids(strides, idx, G).to(torch.int32).contiguous()
    w = corner_weight_tables(t)[0].contiguous()
    ll = anchor.new_empty((B, A))
    with torch.cuda.device(anchor.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.bt_bb_ll_multi(
            S, K, N, B, A, int(bb_i), anchor.data_ptr(), nme.data_ptr(),
            totals.data_ptr(), ids.data_ptr(), w.data_ptr(), m.data_ptr(),
            observed.data_ptr(), ll.data_ptr(), stream)
    fused._launch_check(code, 'bb value')
    binned_bb_ll_fused_multi.launches += 1
    return ll


binned_bb_ll_fused_multi.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {'binned_bb_vgh_fused': binned_bb_vgh_fused.launches,
            'binned_bb_ll_fused_multi': binned_bb_ll_fused_multi.launches}


def reset_launch_counts():
    binned_bb_vgh_fused.launches = 0
    binned_bb_ll_fused_multi.launches = 0
