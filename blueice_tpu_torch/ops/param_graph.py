"""The parameter graph of the closed-form fits as two hand-written CUDA
kernels (``csrc/param_graph.cu``):

* :func:`graph_fwd` — from the optimizer's u (L, n), or a lane's
  candidates (L, A, n), to the likelihood kernels' inputs: lower anchor
  cells ``idx``, lerp weights ``t``, rates ``m`` and the summed log prior
  (and x = Transform(u) where asked), one launch;
* :func:`graph_chain` — the gradient and Hessian in u from the
  likelihood's (g, H) in (m, t), one launch.

Their PyTorch twin is :class:`~blueice_tpu_torch.parallel.fitter._ParamGraph`
itself (``cells``, ``values``, ``chain``), which runs everywhere these
kernels do not and which the card tests hold them to; the graph chooses
between the two once, when it is built. The kernels read a table of the
graph, :class:`GraphTables`, built once from the fit's parameter routing
(where each parameter comes from: a floating coordinate, a runtime-fixed
column or a constant) and copied once to the card.

The library builds at first use with ``nvcc`` (:func:`fused.build_library`)
and loads with ``ctypes``; nothing is built when this module is imported.
Each wrapper counts its launches in ``launches`` (:func:`launch_counts`,
:func:`reset_launch_counts`, as the other ops modules).
"""

import ctypes
import functools
import math
import os

import numpy as np
import torch

from ..priors import _LOG_SQRT_2PI
from . import fused

__all__ = ['GraphTables', 'build_tables', 'compact_columns', 'slot_names',
           'graph_fwd', 'graph_chain', 'graph_fwd_launcher',
           'graph_chain_launcher', 'load_library', 'launch_counts',
           'reset_launch_counts', 'FLOATING', 'RUNTIME', 'CONSTANT', 'MAX_K',
           'MAX_S', 'MAX_N', 'MAX_ANCHORS', 'MAX_PRIORS']

SOURCE = os.path.join(fused.CSRC_DIR, 'param_graph.cu')

#: The kernels' range (instantiated S and K) and the table's capacities
MAX_K, MAX_S = 4, 8
MAX_N, MAX_ANCHORS, MAX_PRIORS = 32, 256, 32
#: Slot offsets: the K shape parameters, the S rate multipliers, the S
#: efficiencies, the live time and the prior terms
SLOT_SHAPE = 0
SLOT_RATE = SLOT_SHAPE + MAX_K
SLOT_EFF = SLOT_RATE + MAX_S
SLOT_LIVE = SLOT_EFF + MAX_S
SLOT_PRIOR = SLOT_LIVE + 1
N_SLOTS = SLOT_PRIOR + MAX_PRIORS

#: Where a parameter's value comes from (:meth:`_Routing.source_of`)
FLOATING, RUNTIME, CONSTANT = 0, 1, 2

_I, _F = ctypes.c_int32, ctypes.c_float


class _Desc(ctypes.Structure):
    """The kernels' ``GraphDesc``, field for field."""
    _fields_ = [('S', _I), ('K', _I), ('n', _I), ('R', _I), ('G', _I),
                ('n_prior', _I), ('has_live', _I),
                ('stride', _I * MAX_K), ('n_anchor', _I * MAX_K),
                ('anchor_off', _I * MAX_K),
                ('tkind', _I * MAX_N), ('tlo', _F * MAX_N),
                ('thi', _F * MAX_N),
                ('src_kind', _I * N_SLOTS), ('src_pos', _I * N_SLOTS),
                ('src_val', _F * N_SLOTS),
                ('cpos', _I * (MAX_K + MAX_S)), ('t_c', _I * MAX_K),
                ('rate_c', _I * MAX_S), ('eff_c', _I * MAX_S),
                ('prior_c', _I * MAX_PRIORS),
                ('inv_base', _F),
                ('prior_mu', _F * MAX_PRIORS), ('prior_inv', _F * MAX_PRIORS),
                ('prior_log', _F * MAX_PRIORS),
                ('prior_inv2', _F * MAX_PRIORS),
                ('prior_hess', _F * MAX_PRIORS),
                ('log_sqrt_2pi', _F), ('anchors', _F * MAX_ANCHORS)]


class GraphTables:
    """A parameter graph's tables for the kernels: ``desc`` (the host
    ``GraphDesc``), its device copy, the (G, S) mus anchor rates and the
    shapes (S, K, n floating coordinates, R runtime-fixed values). Built by
    :func:`build_tables`."""

    def __init__(self, desc, mus, device):
        self.desc = desc
        self.S, self.K, self.n, self.R = desc.S, desc.K, desc.n, desc.R
        self.mus = mus
        # one copy, now: a copy from host memory at a call would wait
        self.desc_dev = torch.frombuffer(bytearray(desc),
                                         dtype=torch.uint8).to(device)


def slot_names(graph):
    """Each slot of the tables with the parameter it reads, as (slot,
    name): the K shape parameters, the S rate multipliers, the S
    efficiencies (None: none), the live time (None: the model has no live
    time) and the prior terms."""
    base = getattr(graph.compiled, 'base_livetime', None)
    return ([(SLOT_SHAPE + k, nm) for k, nm in enumerate(graph.shape_names)]
            + [(SLOT_RATE + s, nm) for s, nm in enumerate(graph.rate_names)]
            + [(SLOT_EFF + s, nm) for s, nm in enumerate(graph.eff_names)]
            + [(SLOT_LIVE, 'livetime_days' if base is not None else None)]
            + [(SLOT_PRIOR + p, nm)
               for p, (nm, _) in enumerate(graph.compiled.prior_terms)])


def compact_columns(graph):
    """The distinct floating coordinates (columns of u) the graph reads, in
    slot order: the chain kernel's coordinates, of which its lane's group
    holds at most S + K."""
    out = []
    for _, nm in slot_names(graph):
        kind, where = graph.routing.source_of(nm)
        if kind == FLOATING and where not in out:
            out.append(where)
    return out


def build_tables(graph, n, R):
    """:class:`GraphTables` of a :class:`~..parallel.fitter._ParamGraph`
    with ``n`` floating coordinates and ``R`` runtime-fixed values, from
    its routing, transform, anchors, priors and live time. Raises
    ValueError for a graph the tables cannot hold, which
    :func:`~..parallel.fitter._graph_kernel_eligible` never admits."""
    K, S = graph.K, graph.S
    arrs = [np.asarray(a, dtype=np.float32)
            for a in graph.compiled.anchor_arrays]
    priors = graph.compiled.prior_terms
    compact = compact_columns(graph)
    if not (1 <= K <= MAX_K and 1 <= S <= MAX_S and n <= MAX_N
            and len(priors) <= MAX_PRIORS
            and sum(len(a) for a in arrs) <= MAX_ANCHORS
            and len(compact) <= S + K):
        raise ValueError(
            "the graph outruns the kernels' tables: K = %d, S = %d, %d "
            "floating coordinates (%d read), %d anchors, %d prior terms"
            % (K, S, n, len(compact), sum(len(a) for a in arrs),
               len(priors)))
    d = _Desc()
    d.S, d.K, d.n, d.R, d.G = S, K, n, R, graph.G
    d.n_prior = len(priors)
    base = getattr(graph.compiled, 'base_livetime', None)
    d.has_live = int(base is not None)
    # the c_float fields round what they are given; a reciprocal is taken
    # in float32, as PyTorch's CUDA division by a Python scalar takes it
    d.inv_base = float(np.float32(1.0) / np.float32(base or 1.0))
    off = 0
    for k, a in enumerate(arrs):
        d.stride[k] = graph.strides[k]
        d.n_anchor[k], d.anchor_off[k] = len(a), off
        d.anchors[off:off + len(a)] = [float(v) for v in a]
        off += len(a)
    tr = graph.transform
    for j in range(n):
        d.tkind[j] = int(tr.kinds_np[j])
        d.tlo[j], d.thi[j] = tr.lo_safe_np[j], tr.hi_safe_np[j]
    for i, nm in slot_names(graph):
        kind, where = graph.routing.source_of(nm)
        d.src_kind[i] = kind
        if kind == CONSTANT:
            d.src_val[i] = where
        else:
            d.src_pos[i] = where

    def column(nm):
        """nm's compact coordinate, or -1 where it does not float."""
        kind, where = graph.routing.source_of(nm)
        return compact.index(where) if kind == FLOATING else -1

    for k, nm in enumerate(graph.shape_names):
        d.t_c[k] = column(nm)
    for s in range(S):
        d.rate_c[s] = column(graph.rate_names[s])
        d.eff_c[s] = column(graph.eff_names[s])
    for p, (nm, pr) in enumerate(priors):
        d.prior_c[p] = column(nm)
        d.prior_mu[p] = pr.mu
        d.prior_inv[p] = float(np.float32(1.0) / np.float32(pr.sigma))
        d.prior_log[p] = math.log(pr.sigma)
        d.prior_inv2[p] = float(np.float32(1.0)
                                / np.float32(pr.sigma * pr.sigma))
        d.prior_hess[p] = -1.0 / (pr.sigma * pr.sigma)
    d.log_sqrt_2pi = _LOG_SQRT_2PI
    for a in range(MAX_K + MAX_S):
        d.cpos[a] = compact[a] if a < len(compact) else -1
    mus = graph.mus_flat.to(torch.float32).contiguous()
    return GraphTables(d, mus, graph.compiled.device)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernels' library; declare its C
    signatures and check the table's layout against the library's."""
    if not torch.cuda.is_available():
        raise RuntimeError("the parameter-graph kernels need a CUDA device")
    lib = ctypes.CDLL(fused.build_library(SOURCE))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.bt_graph_desc_bytes.argtypes = []
    lib.bt_graph_desc_bytes.restype = i
    lib.bt_graph_fwd.argtypes = [i] * 4 + [p] * 10
    lib.bt_graph_fwd.restype = i
    lib.bt_graph_chain.argtypes = [i] * 3 + [p] * 8
    lib.bt_graph_chain.restype = i
    if lib.bt_graph_desc_bytes() != ctypes.sizeof(_Desc):
        raise RuntimeError("GraphDesc is %d bytes in the library, %d here"
                           % (lib.bt_graph_desc_bytes(),
                              ctypes.sizeof(_Desc)))
    return lib


def _check(tables, u, fv, lead):
    if u.device.type != 'cuda' or u.dtype != torch.float32:
        raise ValueError("the parameter-graph kernels take float32 CUDA "
                         "tensors, got %s on %s" % (u.dtype, u.device))
    if u.shape[-1] != tables.n or tuple(fv.shape) != (lead, tables.R):
        raise ValueError("u must be (L, [A,] %d) and fv (L, %d), got %s and "
                         "%s" % (tables.n, tables.R, tuple(u.shape),
                                 tuple(fv.shape)))
    if not (u.is_contiguous() and fv.is_contiguous()):
        raise ValueError("the parameter-graph kernels take contiguous "
                         "tensors")


def graph_fwd_launcher(tables, u, fv, want_x=False):
    """The CUDA side of :func:`graph_fwd`, split as the likelihood
    wrappers' launchers: checks and outputs once, and ``(launch, (idx, t,
    m, prior, x))``, each ``launch()`` a launch into those outputs (counted
    in ``graph_fwd.launches``)."""
    L = u.shape[0]
    _check(tables, u, fv, L)
    lead = tuple(u.shape[:-1])
    rows = int(np.prod(lead))
    K, S = tables.K, tables.S
    idx = torch.empty(lead + (K,), dtype=torch.int64, device=u.device)
    t = u.new_empty(lead + (K,))
    m = u.new_empty(lead + (S,))
    prior = u.new_empty(lead)
    x = u.new_empty(u.shape) if want_x else None
    lib = load_library()

    def launch():
        with torch.cuda.device(u.device):
            code = lib.bt_graph_fwd(
                S, K, rows, rows // L if L else 1,
                tables.desc_dev.data_ptr(), u.data_ptr(), fv.data_ptr(),
                tables.mus.data_ptr(), idx.data_ptr(), t.data_ptr(),
                m.data_ptr(), prior.data_ptr(),
                None if x is None else x.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        fused._launch_check(code, 'graph_fwd')
        graph_fwd.launches += 1
    return launch, (idx, t, m, prior, x)


def graph_fwd(tables, u, fv, want_x=False):
    """The graph at u (L, n) or at candidates u (L, A, n), each lane's
    runtime-fixed values fv (L, R): ``(idx, t, m, prior, x)``, idx (..., K)
    int64, t (..., K), m (..., S), prior (...), contiguous, the tensors the
    likelihood wrappers take; x (..., n) with ``want_x``, else None."""
    launch, out = graph_fwd_launcher(tables, u, fv, want_x)
    launch()
    return out


graph_fwd.launches = 0


def graph_chain_launcher(tables, u, fv, g_mt, H_mt):
    """The CUDA side of :func:`graph_chain`, split as
    :func:`graph_fwd_launcher`: ``(launch, (g, H))``."""
    L = u.shape[0]
    _check(tables, u, fv, L)
    P = tables.S + tables.K
    if (tuple(g_mt.shape) != (L, P) or tuple(H_mt.shape) != (L, P, P)
            or g_mt.dtype != torch.float32 or H_mt.dtype != torch.float32
            or not (g_mt.is_contiguous() and H_mt.is_contiguous())):
        raise ValueError("g_mt and H_mt must be contiguous float32 (L, %d) "
                         "and (L, %d, %d)" % (P, P, P))
    n = tables.n
    g = u.new_empty((L, n))
    H = u.new_empty((L, n, n))
    lib = load_library()

    def launch():
        with torch.cuda.device(u.device):
            code = lib.bt_graph_chain(
                tables.S, tables.K, L, tables.desc_dev.data_ptr(),
                u.data_ptr(), fv.data_ptr(), tables.mus.data_ptr(),
                g_mt.data_ptr(), H_mt.data_ptr(), g.data_ptr(), H.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        fused._launch_check(code, 'graph_chain')
        graph_chain.launches += 1
    return launch, (g, H)


def graph_chain(tables, u, fv, g_mt, H_mt):
    """The gradient (L, n) and Hessian (L, n, n) in u of -(ll + prior)
    from the likelihood's g_mt (L, S + K) and H_mt (L, S + K, S + K) in
    (m, t), at u (L, n) with fv (L, R): :meth:`_ParamGraph.chain`'s
    result."""
    launch, out = graph_chain_launcher(tables, u, fv, g_mt, H_mt)
    launch()
    return out


graph_chain.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {'graph_fwd': graph_fwd.launches,
            'graph_chain': graph_chain.launches}


def reset_launch_counts():
    graph_fwd.launches = 0
    graph_chain.launches = 0
