"""Fused extended unbinned likelihood kernels: hand-written CUDA for Hopper,
with their plain PyTorch versions beside them.

Counterpart of :mod:`blueice_tpu.ops.fused_unbinned`. The JAX module has four
Pallas kernels for two contracts (a block flavor for anchor grids of at most
16 points and a per-toy gather flavor above); the port has one CUDA kernel
per contract, in ``csrc/fused_unbinned.cu``:

* :func:`unbinned_vgh_fused` — ll, gradient and Hessian in (m, t) of the
  extended unbinned likelihood, per toy. Replaces ``_uvgh_block_kernel`` and
  ``_uvgh_kernel``.
* :func:`unbinned_ll_fused_multi` — the same ll at A line-search candidates
  per toy, all sharing the toy's events. Replaces ``_ull_block_kernel`` and
  ``_ull_kernel``.

Unlike the binned kernels, the density tensor is per toy: ``ps`` (B, G, S, E)
holds every toy's scored events at every anchor point (grid flattened), and
a call works on the lanes ``lanes`` (L,) of that batch, which the kernel
reads itself, so a lane subset is never copied. ``mask`` and ``inv_ref``
(B, E) are indexed the same way. The value is the centered one:
``sum_e mask_e log(lam_eff_e * inv_ref_e) - moff`` with the caller's rate
term ``moff = sum m - ref_msum`` (see
:func:`blueice_tpu_torch.ops.unbinned_vgh.reference_center`); the event axis
takes any length (the TPU's 128-lane padding is not needed).

A wrapper runs the plain version (:func:`unbinned_vgh_plain`,
:func:`unbinned_ll_plain`) for CPU tensors and for CUDA tensors launches its
kernel or raises; each counts its launches in ``launches``.
"""

import ctypes
import functools
import os

import torch

from . import fused
from .binned_vgh import corner_weight_tables
from .unbinned_vgh import _log_sum, vgh_parts

__all__ = ['unbinned_vgh_fused', 'unbinned_ll_fused_multi',
           'unbinned_vgh_plain', 'unbinned_ll_plain', 'unbinned_vgh_launcher',
           'unbinned_ll_launcher', 'load_library',
           'launch_counts', 'reset_launch_counts']

SOURCE = os.path.join(fused.CSRC_DIR, 'fused_unbinned.cu')


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the unbinned kernel library; declare its C
    signatures. Raises without CUDA or without nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fused CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(fused.build_library(SOURCE))
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    lib.bt_unbinned_vgh.argtypes = [i] * 5 + [f] + [p] * 14
    lib.bt_unbinned_vgh.restype = i
    lib.bt_unbinned_ll_multi.argtypes = [i] * 6 + [f] + [p] * 10
    lib.bt_unbinned_ll_multi.restype = i
    return lib


def _check_shapes(ps, strides, lanes, idx, t, m, mask, inv_ref, moff, lead):
    """(B, G, S, E, K) of the inputs; raises on a shape, dtype or device the
    kernels would misread."""
    if ps.dim() != 4:
        raise ValueError("ps must be (B, G, S, E), got %s"
                         % (tuple(ps.shape),))
    B, G, S, E = ps.shape
    K = len(strides)
    L = lead[0]
    expect = {'lanes': (lanes, (L,)), 'idx': (idx, lead + (K,)),
              't': (t, lead + (K,)), 'm': (m, lead + (S,)),
              'mask': (mask, (B, E)), 'inv_ref': (inv_ref, (B, E)),
              'moff': (moff, lead)}
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(x.shape)))
    for name, x in (('t', t), ('m', m), ('inv_ref', inv_ref),
                    ('moff', moff)):
        if x.device != ps.device or x.dtype != ps.dtype:
            raise ValueError("%s must be %s on %s like ps, got %s on %s"
                             % (name, ps.dtype, ps.device, x.dtype, x.device))
    if mask.dtype != torch.bool or lanes.dtype != torch.int64:
        raise ValueError("mask must be bool and lanes int64, got %s and %s"
                         % (mask.dtype, lanes.dtype))
    if mask.device != ps.device or lanes.device != ps.device:
        raise ValueError("mask and lanes must be on %s like ps" % ps.device)
    return B, G, S, E, K


def unbinned_vgh_plain(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                       outlier=0.0):
    """Plain PyTorch version of :func:`unbinned_vgh_fused`: gather each
    lane's corner rows and run the closed form of
    :func:`blueice_tpu_torch.ops.unbinned_vgh.unbinned_vgh` on the batch."""
    ids = fused.corner_ids(strides, idx, ps.shape[1])             # (L, C)
    corners = ps[lanes[:, None], ids]                             # (L, C, S, E)
    log_sum, g, H = vgh_parts(corners, m, t, mask[lanes], outlier,
                              inv_ref[lanes])
    return log_sum - moff, g, H


def unbinned_vgh_launcher(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                          outlier=0.0):
    """The CUDA side of :func:`unbinned_vgh_fused`, split in two (see
    :func:`blueice_tpu_torch.ops.fused.binned_vgh_launcher`): returns
    ``(launch, (ll, g, H))``."""
    L = lanes.shape[0]
    B, G, S, E, K = _check_shapes(ps, strides, lanes, idx, t, m, mask,
                                  inv_ref, moff, (L,))
    if max(G * S * E, B * E) >= 2 ** 32:
        raise ValueError("the vgh kernel addresses a toy's (G, S, E) block "
                         "and the (B, E) mask and inv_ref with 32-bit "
                         "offsets: each takes fewer than 2^32 entries")
    fused._check_cuda(ps, 'unbinned_vgh_fused')
    fused._check_kernel_inputs(ps, K, S, (lanes, m, mask, inv_ref, moff))
    lib = load_library()
    P = S + K
    # wd and wx_pairs are passed and not read: the kernel takes the
    # differences by its corner tree (the C entry keeps its arguments)
    ids, w, wd, wx_pairs = fused.vgh_tables(strides, idx, t, G)
    ll = ps.new_empty((L,))
    g = ps.new_empty((L, P))
    H = ps.new_empty((L, P, P))

    def launch():
        with torch.cuda.device(ps.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.bt_unbinned_vgh(
                S, K, G, E, L, float(outlier), ps.data_ptr(),
                lanes.data_ptr(), ids.data_ptr(), w.data_ptr(),
                wd.data_ptr(), wx_pairs.data_ptr(), m.data_ptr(),
                mask.data_ptr(), inv_ref.data_ptr(), moff.data_ptr(),
                ll.data_ptr(), g.data_ptr(), H.data_ptr(), stream)
        fused._launch_check(code, 'unbinned vgh')
        unbinned_vgh_fused.launches += 1
    return launch, (ll, g, H)


def unbinned_vgh_fused(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                       outlier=0.0):
    """Centered extended-LL (ll, g, H) in (m, t) for lanes of a toy batch.

    :param ps: (B, G, S, E) per-toy per-event densities at every anchor
      point, grid flattened in C order.
    :param strides: K ints — anchor-grid row strides.
    :param lanes: (L,) int64 toys of this call (indices into B).
    :param idx: (L, K) integer lower-corner indices; t: (L, K) lerp weights;
      m: (L, S) rates.
    :param mask: (B, E) bool event validity; inv_ref: (B, E) inverse
      reference densities (ones: uncentered).
    :param moff: (L,) rate term of the value (sum m - ref_msum).
    :param outlier: density floor of events whose density is not positive.
    :return: (ll (L,), g (L, S+K), H (L, S+K, S+K)).
    """
    if ps.device.type == 'cpu':
        _check_shapes(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                      (lanes.shape[0],))
        return unbinned_vgh_plain(ps, strides, lanes, idx, t, m, mask,
                                  inv_ref, moff, outlier)
    launch, out = unbinned_vgh_launcher(ps, strides, lanes, idx, t, m, mask,
                                        inv_ref, moff, outlier)
    launch()
    return out


unbinned_vgh_fused.launches = 0


def unbinned_ll_plain(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                      outlier=0.0):
    """Plain PyTorch version of :func:`unbinned_ll_fused_multi`: the morphed
    densities accumulate corner by corner (so the (L, A, 2^K, S, E) corner
    block is never materialized), then the closed-form value."""
    ids = fused.corner_ids(strides, idx, ps.shape[1])             # (L, A, C)
    w = corner_weight_tables(t)[0]                                # (L, A, C)
    rows = lanes[:, None]
    P = None
    for c in range(ids.shape[-1]):
        term = w[..., c, None, None] * ps[rows, ids[..., c]]     # (L, A, S, E)
        P = term if P is None else P + term
    lam = torch.einsum('las,lase->lae', m, P)
    return _log_sum(lam, mask[lanes][:, None], outlier,
                    inv_ref[lanes][:, None]) - moff


def unbinned_ll_launcher(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                         outlier=0.0):
    """The CUDA side of :func:`unbinned_ll_fused_multi`, split in two:
    returns ``(launch, ll)``."""
    L, A = idx.shape[:2]
    B, G, S, E, K = _check_shapes(ps, strides, lanes, idx, t, m, mask,
                                  inv_ref, moff, (L, A))
    fused._check_cuda(ps, 'unbinned_ll_fused_multi')
    fused._check_kernel_inputs(ps, K, S, (lanes, m, mask, inv_ref, moff))
    lib = load_library()
    ids = fused.corner_ids(strides, idx, G).to(torch.int32).contiguous()
    w = corner_weight_tables(t)[0].contiguous()
    ll = ps.new_empty((L, A))

    def launch():
        with torch.cuda.device(ps.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.bt_unbinned_ll_multi(
                S, K, G, E, L, A, float(outlier), ps.data_ptr(),
                lanes.data_ptr(), ids.data_ptr(), w.data_ptr(),
                m.data_ptr(), mask.data_ptr(), inv_ref.data_ptr(),
                moff.data_ptr(), ll.data_ptr(), stream)
        fused._launch_check(code, 'unbinned value')
        unbinned_ll_fused_multi.launches += 1
    return launch, ll


def unbinned_ll_fused_multi(ps, strides, lanes, idx, t, m, mask, inv_ref,
                            moff, outlier=0.0):
    """Centered extended LL at A parameter candidates per lane, each lane's
    candidates sharing its toy's events.

    :param idx: (L, A, K) integer lower corners; t: (L, A, K) lerp weights;
      m: (L, A, S) rates; moff: (L, A); the rest as for
      :func:`unbinned_vgh_fused`.
    :return: (L, A) log likelihoods.
    """
    if ps.device.type == 'cpu':
        _check_shapes(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                      tuple(idx.shape[:2]))
        return unbinned_ll_plain(ps, strides, lanes, idx, t, m, mask,
                                 inv_ref, moff, outlier)
    launch, ll = unbinned_ll_launcher(ps, strides, lanes, idx, t, m, mask,
                                      inv_ref, moff, outlier)
    launch()
    return ll


unbinned_ll_fused_multi.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {'unbinned_vgh_fused': unbinned_vgh_fused.launches,
            'unbinned_ll_fused_multi': unbinned_ll_fused_multi.launches}


def reset_launch_counts():
    unbinned_vgh_fused.launches = 0
    unbinned_ll_fused_multi.launches = 0
