"""Fused binned-likelihood kernels: hand-written CUDA for Hopper, with their
plain PyTorch versions beside them.

Counterpart of :mod:`blueice_tpu.ops.fused`. The JAX module has four Pallas
kernels for two contracts (gather and dense flavors of each); the port has
one CUDA kernel per contract, in ``csrc/fused_binned.cu``:

* :func:`binned_vgh_fused` — ll, gradient and Hessian in (m, t) of the
  deviance-form binned Poisson likelihood, per toy. Replaces ``_vgh_kernel``
  and ``_vgh_kernel_dense``.
* :func:`binned_ll_fused_multi` — the same ll at A line-search candidates
  per toy, all sharing the toy's dataset. Replaces ``_ll_kernel`` and
  ``_ll_kernel_dense``.

Both take the toy batch as a written-out leading dimension (the JAX entries'
``vmap`` axis) and the unpadded bin axis. A wrapper runs the plain version
(:func:`binned_vgh_plain`, :func:`binned_ll_plain`: the batched closed form of
:mod:`blueice_tpu_torch.ops.binned_vgh`) for CPU tensors, and for CUDA
tensors launches its kernel or raises. Each wrapper counts its launches in a
plain integer attribute, ``launches``. Its CUDA side is a ``*_launcher``
function (checks, tables and outputs, once) and the ``launch()`` it returns,
so a timer can time the launch alone.

The kernels build at first use with ``nvcc`` for ``sm_90a`` into
``build/blueice_tpu_torch/`` beside the package and load with ``ctypes``;
nothing is imported or built when this module is imported.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .binned_vgh import (corner_weight_tables, corner_offsets, binned_vgh,
                         _ll_from_P)

__all__ = ['binned_vgh_fused', 'binned_ll_fused_multi', 'binned_vgh_plain',
           'binned_ll_plain', 'binned_vgh_launcher', 'binned_ll_launcher',
           'corner_ids', 'build_library', 'build_libraries',
           'load_library', 'launch_counts', 'reset_launch_counts',
           'MAX_SOURCES', 'MAX_SHAPE_AXES']

#: Instantiated kernel range: S in 1..MAX_SOURCES, K in 0..MAX_SHAPE_AXES
MAX_SOURCES = 8
MAX_SHAPE_AXES = 4

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
SOURCE = os.path.join(CSRC_DIR, 'fused_binned.cu')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'blueice_tpu_torch')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']


def _find_nvcc():
    nvcc = shutil.which('nvcc')
    if nvcc is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        nvcc = '/usr/local/cuda/bin/nvcc'
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the fused CUDA kernels build on a machine with "
            "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def build_library(source=SOURCE):
    """Compile one ``csrc/*.cu`` source into a shared library (once per
    version of the source and the headers beside it, which it includes: the
    file name carries their hash) and return its path. The compiler's
    ``-Xptxas -v`` report is kept beside it (``.log``)."""
    digest = hashlib.sha1()
    headers = sorted(glob.glob(os.path.join(os.path.dirname(source),
                                            '*.cuh')))
    for path in [source] + headers:
        with open(path, 'rb') as f:
            digest.update(f.read())
    name = os.path.splitext(os.path.basename(source))[0]
    lib_path = os.path.join(BUILD_DIR, 'lib%s_%s.so'
                            % (name, digest.hexdigest()[:12]))
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = '%s.%d.%d.tmp' % (lib_path, os.getpid(), threading.get_ident())
    cmd = [_find_nvcc()] + NVCC_FLAGS + ['-o', tmp, source]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    with open(lib_path[:-3] + '.log', 'w') as f:
        f.write(' '.join(cmd) + '\n' + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on %s (exit %d):\n%s"
                           % (source, proc.returncode, proc.stderr[-4000:]))
    os.replace(tmp, lib_path)
    return lib_path


def build_libraries(sources):
    """Build several sources at once, one nvcc process each, all started
    together; returns their library paths."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(build_library, sources))


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernel library; declare its C
    signatures. Raises without CUDA or without nvcc."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fused CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(build_library())
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.bt_binned_vgh.argtypes = [i] * 4 + [p] * 11
    lib.bt_binned_vgh.restype = i
    lib.bt_binned_ll_multi.argtypes = [i] * 5 + [p] * 7
    lib.bt_binned_ll_multi.restype = i
    return lib


def corner_ids(strides, idx, G):
    """Flattened-grid ids (..., 2^K) of the corner templates around lower
    corners ``idx`` (..., K), clamped into [0, G-1] like the JAX dense
    flavor clamps them."""
    K = len(strides)
    if K == 0:
        return torch.zeros(tuple(idx.shape[:-1]) + (1,), dtype=torch.int64,
                           device=idx.device)
    key = (tuple(int(s) for s in strides), idx.device)
    if key not in _CORNER_TABLES:
        # made once per grid and device: a copy from host memory would
        # wait for the device at every call
        _CORNER_TABLES[key] = (
            torch.as_tensor(key[0], device=idx.device),
            torch.as_tensor(corner_offsets(strides), device=idx.device))
    stride_t, offsets = _CORNER_TABLES[key]
    base = (idx.to(torch.int64) * stride_t).sum(-1)
    return torch.clamp(base[..., None] + offsets, 0, G - 1)


#: (strides, device) -> (strides tensor, corner offsets tensor)
_CORNER_TABLES = {}


def vgh_tables(strides, idx, t, G):
    """The vgh kernels' per-toy corner tables, contiguous: ids (B, 2^K)
    int32, w (B, 2^K), wd (B, K, 2^K) and the cross-pair second-derivative
    weights (B, K(K-1)/2, 2^K), pairs (d, e), d < e, in row-major order."""
    K = len(strides)
    ids = corner_ids(strides, idx, G).to(torch.int32)
    w, wd, wx = corner_weight_tables(t)
    pairs = [(d, e) for d in range(K) for e in range(d + 1, K)]
    wx_pairs = (torch.stack([wx[:, d, e] for d, e in pairs], dim=1)
                if pairs else wx.new_zeros((t.shape[0], 0, w.shape[-1])))
    return tuple(x.contiguous() for x in (ids, w, wd, wx_pairs))


def _check_shapes(anchor, strides, idx, t, m, observed, lead, nme=None):
    """(G, S, N, K) of the kernels' inputs; raises on a shape, dtype or
    device the kernels would misread. ``nme`` is the (G, N) MC-count rows
    of the Beeston-Barlow kernels."""
    if anchor.dim() != 3:
        raise ValueError("anchor must be (G, S, N), got %s"
                         % (tuple(anchor.shape),))
    G, S, N = anchor.shape
    K = len(strides)
    expect = {'idx': (idx, lead + (K,)), 't': (t, lead + (K,)),
              'm': (m, lead + (S,)), 'observed': (observed, lead[:1] + (N,))}
    floats = [('t', t), ('m', m), ('observed', observed)]
    if nme is not None:
        expect['nme'] = (nme, (G, N))
        floats.append(('nme', nme))
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, shape, tuple(x.shape)))
    for name, x in floats:
        if x.device != anchor.device or x.dtype != anchor.dtype:
            raise ValueError("%s must be %s on %s like the anchor tensor, "
                             "got %s on %s" % (name, anchor.dtype,
                                               anchor.device, x.dtype,
                                               x.device))
    return G, S, N, K


def _check_kernel_inputs(anchor, K, S, tensors):
    """The kernels take contiguous float32 CUDA tensors in their
    instantiated (S, K) range; anything else raises."""
    if anchor.dtype != torch.float32:
        raise TypeError("the CUDA kernels take float32, got %s" % anchor.dtype)
    if not 1 <= S <= MAX_SOURCES or not 0 <= K <= MAX_SHAPE_AXES:
        raise ValueError("the CUDA kernels are instantiated for 1 <= S <= %d "
                         "and 0 <= K <= %d, got S=%d, K=%d"
                         % (MAX_SOURCES, MAX_SHAPE_AXES, S, K))
    for x in (anchor,) + tuple(tensors):
        if not x.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")


def _check_cuda(x, name):
    if x.device.type != 'cuda':
        raise ValueError("%s runs on CPU or CUDA tensors, got %s"
                         % (name, x.device))


def _launch_check(code, what):
    if code != 0:
        raise RuntimeError("%s kernel launch failed: %s" % (
            what, 'unsupported (S, K)' if code == -1 else
            'CUDA error %d' % code))


def binned_vgh_plain(anchor, strides, idx, t, m, observed):
    """Plain PyTorch version of :func:`binned_vgh_fused`: gather each toy's
    corner templates and run the closed form of
    :func:`blueice_tpu_torch.ops.binned_vgh.binned_vgh` on the batch."""
    G = anchor.shape[0]
    ids = corner_ids(strides, idx, G)                   # (B, C)
    return binned_vgh(anchor[ids], m, t, observed)


def binned_vgh_launcher(anchor, strides, idx, t, m, observed):
    """The CUDA side of :func:`binned_vgh_fused`, split in two: checks the
    inputs, builds the corner tables and allocates the outputs once, and
    returns ``(launch, (ll, g, H))``, where each ``launch()`` launches the
    kernel into those outputs (and counts it). The roofline timers time
    ``launch`` alone."""
    B = idx.shape[0]
    G, S, N, K = _check_shapes(anchor, strides, idx, t, m, observed, (B,))
    _check_cuda(anchor, 'binned_vgh_fused')
    _check_kernel_inputs(anchor, K, S, (m, observed))
    if anchor.numel() >= 2 ** 32:
        raise ValueError("the vgh kernel addresses the anchor tensor with "
                         "32-bit offsets: it takes fewer than 2^32 floats")
    lib = load_library()
    P = S + K
    ids, w, wd, wx_pairs = vgh_tables(strides, idx, t, G)
    ll = anchor.new_empty((B,))
    g = anchor.new_empty((B, P))
    H = anchor.new_empty((B, P, P))

    def launch():
        with torch.cuda.device(anchor.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.bt_binned_vgh(
                S, K, N, B, anchor.data_ptr(), ids.data_ptr(), w.data_ptr(),
                wd.data_ptr(), wx_pairs.data_ptr(), m.data_ptr(),
                observed.data_ptr(), ll.data_ptr(), g.data_ptr(),
                H.data_ptr(), stream)
        _launch_check(code, 'vgh')
        binned_vgh_fused.launches += 1
    return launch, (ll, g, H)


def binned_vgh_fused(anchor, strides, idx, t, m, observed):
    """Deviance-form (ll, g, H) in (m, t) for a batch of toys, with each
    toy's corner templates gathered from the shared anchor tensor.

    :param anchor: (G, S, N) anchor templates, grid flattened in C order.
    :param strides: K ints — anchor-grid row strides.
    :param idx: (B, K) integer lower-corner indices per axis.
    :param t: (B, K) lerp weights.
    :param m: (B, S) rates.
    :param observed: (B, N) observed counts.
    :return: (ll (B,), g (B, S+K), H (B, S+K, S+K)).
    """
    if anchor.device.type == 'cpu':
        _check_shapes(anchor, strides, idx, t, m, observed, (idx.shape[0],))
        return binned_vgh_plain(anchor, strides, idx, t, m, observed)
    launch, out = binned_vgh_launcher(anchor, strides, idx, t, m, observed)
    launch()
    return out


binned_vgh_fused.launches = 0


def binned_ll_plain(anchor, strides, idx, t, m, observed):
    """Plain PyTorch version of :func:`binned_ll_fused_multi`: the morphed
    templates accumulate corner by corner (so the (B, A, 2^K, S, N) corner
    block is never materialized), then the closed-form value."""
    G = anchor.shape[0]
    ids = corner_ids(strides, idx, G)                   # (B, A, C)
    w = corner_weight_tables(t)[0]                      # (B, A, C)
    P = None
    for c in range(ids.shape[-1]):
        term = w[..., c, None, None] * anchor[ids[..., c]]
        P = term if P is None else P + term
    return _ll_from_P(P, m, observed[:, None, :])


def binned_ll_launcher(anchor, strides, idx, t, m, observed):
    """The CUDA side of :func:`binned_ll_fused_multi`, split as
    :func:`binned_vgh_launcher`: returns ``(launch, ll)``."""
    B, A = idx.shape[:2]
    G, S, N, K = _check_shapes(anchor, strides, idx, t, m, observed, (B, A))
    _check_cuda(anchor, 'binned_ll_fused_multi')
    _check_kernel_inputs(anchor, K, S, (m, observed))
    lib = load_library()
    ids = corner_ids(strides, idx, G).to(torch.int32).contiguous()
    w = corner_weight_tables(t)[0].contiguous()
    ll = anchor.new_empty((B, A))

    def launch():
        with torch.cuda.device(anchor.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.bt_binned_ll_multi(
                S, K, N, B, A, anchor.data_ptr(), ids.data_ptr(),
                w.data_ptr(), m.data_ptr(), observed.data_ptr(),
                ll.data_ptr(), stream)
        _launch_check(code, 'value')
        binned_ll_fused_multi.launches += 1
    return launch, ll


def binned_ll_fused_multi(anchor, strides, idx, t, m, observed):
    """Deviance-form LL at A parameter candidates per toy, each toy's
    candidates sharing its dataset.

    :param idx: (B, A, K) integer lower corners; t: (B, A, K) lerp weights;
      m: (B, A, S) rates; observed: (B, N).
    :return: (B, A) log likelihoods (without the saturated-model constant).
    """
    if anchor.device.type == 'cpu':
        _check_shapes(anchor, strides, idx, t, m, observed, tuple(
            idx.shape[:2]))
        return binned_ll_plain(anchor, strides, idx, t, m, observed)
    launch, ll = binned_ll_launcher(anchor, strides, idx, t, m, observed)
    launch()
    return ll


binned_ll_fused_multi.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {'binned_vgh_fused': binned_vgh_fused.launches,
            'binned_ll_fused_multi': binned_ll_fused_multi.launches}


def reset_launch_counts():
    binned_vgh_fused.launches = 0
    binned_ll_fused_multi.launches = 0
