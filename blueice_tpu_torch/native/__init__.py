"""The native (C++) histogram filler of the template build, loaded with
ctypes.

Counterpart of :mod:`blueice_tpu.native`. The device path is the port's
CUDA kernels; what remains on the host is the template build, histogramming
millions of Monte-Carlo events per anchor model. That loop runs in C++
(``fasthist.cpp``, the package's own copy), compiled at first use with
``g++ -O3 -march=native -shared -fPIC`` into ``build/blueice_tpu_torch/``
beside the package (the kernels' build directory), the library's name keyed
by the source's hash and the CPU's identity. Without a compiler it falls
back to ``numpy.histogramdd``, which has the same semantics, and says so at
warning level; :func:`available` tells which.
"""

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

__all__ = ['histogram_nd', 'available']

log = logging.getLogger('blueice_tpu_torch.native')

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'fasthist.cpp')
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build',
                         'blueice_tpu_torch')
_LIB = None
_TRIED = False


def _cpu_identity():
    """A short digest of this machine's ISA: a -march=native library built
    on one host must not be loaded by a host with other CPU features (an
    illegal instruction in the middle of a template build)."""
    import platform
    ident = platform.machine()
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('flags', 'Features')):
                    ident += line
                    break
    except OSError:
        pass
    return hashlib.sha1(ident.encode()).hexdigest()[:8]


def library_path():
    """Where the library of this source and this CPU is built."""
    with open(_SRC, 'rb') as f:
        src_hash = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, 'fasthist_%s_%s.so'
                        % (src_hash, _cpu_identity()))


def _build_and_load():
    """Compile fasthist.cpp (once per source and CPU) and load it."""
    lib_path = library_path()
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp_path = lib_path + '.tmp.%d' % os.getpid()
        cmd = ['g++', '-O3', '-march=native', '-shared', '-fPIC',
               '-o', tmp_path, _SRC]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, lib_path)

    lib = ctypes.CDLL(lib_path)
    lib.hist_nd.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double)]
    lib.hist_nd.restype = None
    if lib.fasthist_abi_version() != 1:
        raise RuntimeError("fasthist ABI version %d, expected 1"
                           % lib.fasthist_abi_version())
    return lib


def _get_lib():
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_and_load()
        except Exception as e:     # any failure -> numpy fallback
            log.warning("native histogram filler unavailable (%s); "
                        "filling with numpy.histogramdd", e)
            _LIB = None
    return _LIB


def available():
    """Whether the C++ filler is built and loaded (else numpy fills)."""
    return _get_lib() is not None


def _is_uniform(edges):
    if len(edges) < 3:
        return True
    d = np.diff(edges)
    return bool(np.all(np.abs(d - d[0]) <= 1e-12 * np.abs(d[0])))


def histogram_nd(sample, edges, weights=None):
    """N-dim histogram with numpy.histogramdd semantics (native when
    possible): left edges inclusive, the last bin's right edge too,
    out-of-range and NaN events dropped.

    :param sample: (n_events, ndim) coordinates.
    :param edges: list of ndim 1-d bin-edge arrays.
    :param weights: optional (n_events,) weights.
    :return: ndarray of bin counts, shape (len(e)-1 for e in edges).
    """
    sample = np.ascontiguousarray(np.asarray(sample, dtype=np.float64))
    if sample.ndim == 1:
        sample = sample[:, None]
    ndim = sample.shape[1]
    if len(edges) != ndim:
        raise ValueError("Got %d edge arrays for %d sample dimensions"
                         % (len(edges), ndim))
    if weights is not None and len(weights) != sample.shape[0]:
        # numpy raises here too; the C++ path would read out of bounds
        raise ValueError("weights has length %d, expected %d"
                         % (len(weights), sample.shape[0]))
    lib = _get_lib()
    if lib is None or ndim > 16:
        h, _ = np.histogramdd(sample, bins=edges, weights=weights)
        return h

    edges = [np.ascontiguousarray(np.asarray(e, dtype=np.float64))
             for e in edges]
    edges_flat = np.concatenate(edges)
    offsets = np.zeros(ndim + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(e) for e in edges])
    uniform = np.array([_is_uniform(e) for e in edges], dtype=np.uint8)
    out = np.zeros([len(e) - 1 for e in edges], dtype=np.float64)

    w_ptr = None
    if weights is not None:
        weights = np.ascontiguousarray(np.asarray(weights, dtype=np.float64))
        w_ptr = weights.ctypes.data_as(ctypes.c_void_p)

    lib.hist_nd(
        sample.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(sample.shape[0]), ctypes.c_int32(ndim),
        edges_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        uniform.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w_ptr,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
