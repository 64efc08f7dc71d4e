"""The Newton step of :func:`~..parallel.fitter.minimize_newton` as two
hand-written CUDA kernels (``csrc/newton_step.cu``), one on either
side of the step's value call:

* :func:`newton_cands` — from each lane's (g, H) and the fit's state, every
  damped solve of the step (the Newton step, each snap candidate's reduced
  system, the active set) and the line-search candidates (L, A, n), one
  launch;
* :func:`newton_accept` — from the candidates' values, the winner, the
  gain-ratio damping, the stop rule and the polish entry, written straight
  into the fit's batch state at the lanes, one launch.

Their PyTorch twin is the fitter's own step
(:func:`~blueice_tpu_torch.parallel.fitter._step_candidates` and
:func:`~blueice_tpu_torch.parallel.fitter._step_update`), which runs
everywhere these kernels do not and which the card tests hold them to; the
fit chooses between the two once, when it starts, by its device
(:func:`~blueice_tpu_torch.parallel.fitter._step_kernel_eligible`). The
kernels read a table of the step, :class:`StepTable`, built once a fit from
its kink coordinates, jumps and snap anchors on the host and copied to the
card once. They take any n: up to ``REGISTER_N`` a lane lives in
registers, past it in a workspace each launcher allocates on the card.

The library builds at first use with ``nvcc`` (:func:`fused.build_library`)
and loads with ``ctypes``; nothing is built when this module is imported.
Each wrapper counts its launches in ``launches`` (:func:`launch_counts`,
:func:`reset_launch_counts`, as the other ops modules).
"""

import ctypes
import functools
import os

import numpy as np
import torch

from . import fused

__all__ = ['StepTable', 'build_table', 'newton_cands', 'newton_accept',
           'newton_cands_launcher', 'newton_accept_launcher', 'load_library',
           'launch_counts', 'reset_launch_counts', 'ALPHAS', 'REGISTER_N']

SOURCE = os.path.join(fused.CSRC_DIR, 'newton_step.cu')

#: The Newton step's line-search fractions, the first candidates of a step
ALPHAS = (1.0, 0.4, 0.1)
#: The largest n whose lanes the kernels hold in registers (one
#: instantiation each); past it they take any n with a workspace on the card
REGISTER_N = 16

#: The kernels' dtype codes
_DTYPES = {torch.float32: 0, torch.float64: 1}


class StepTable:
    """A fit's step for the kernels: the n floating coordinates, the n_drop
    kink coordinates (the drop directions) ``drop_coord``, the ``jumps``,
    the snapped coordinates ``snap_coord`` with their u-space ``anchors``
    (``snap_off`` delimits each one's), the line-search fractions
    ``alphas`` and the A candidates a lane; ``tab`` the same numbers as the
    kernels read them, one float64 tensor on the fit's device (the
    fractions, the kink coordinates, the jumps, the snapped coordinates,
    the offsets, the anchors). Built by :func:`build_table`."""

    def __init__(self, n, drop_coord, jumps, snap_coord, snap_off, anchors,
                 device):
        self.n, self.alphas = n, ALPHAS
        self.drop_coord, self.jumps = drop_coord, jumps
        self.snap_coord, self.snap_off = snap_coord, snap_off
        self.anchors = anchors
        self.n_drop, self.n_jump = len(drop_coord), len(jumps)
        self.n_snap = len(snap_coord)
        self.A = (len(ALPHAS) + self.n_drop * (1 + self.n_jump) + self.n_snap
                  + (1 if self.n_snap else 0))
        self.tab = torch.tensor(
            self.alphas + drop_coord + jumps + snap_coord + snap_off
            + anchors, dtype=torch.float64, device=device)


def build_table(n, kink_coords, kink_jumps, snaps, device='cpu'):
    """:class:`StepTable` of a step over ``n`` coordinates, its table on
    ``device``: its kink coordinates (the drop directions, in order), its
    jumps and its snaps ((coordinate, u-space anchors) pairs, in order).
    Raises ValueError for n < 1, a coordinate outside 0..n-1 or a snap
    without anchors."""
    coords = [int(c) for c in kink_coords] + [int(c) for c, _ in snaps]
    anchors = [np.asarray(a, dtype=float).ravel() for _, a in snaps]
    if n < 1 or any(not 0 <= c < n for c in coords) \
            or any(a.size == 0 for a in anchors):
        raise ValueError(
            "no Newton step over n = %d coordinates with kink coordinates "
            "%s and snaps at %s of %s anchors"
            % (n, list(kink_coords), [c for c, _ in snaps],
               [a.size for a in anchors]))
    offsets = np.concatenate([[0], np.cumsum([a.size for a in anchors])])
    return StepTable(
        n, tuple(int(c) for c in kink_coords),
        tuple(float(j) for j in kink_jumps),
        tuple(int(c) for c, _ in snaps), tuple(int(o) for o in offsets),
        tuple(float(v) for a in anchors for v in a), device)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernels' library; declare its C
    signatures and check its register range against ``REGISTER_N``."""
    if not torch.cuda.is_available():
        raise RuntimeError("the Newton-step kernels need a CUDA device")
    lib = ctypes.CDLL(fused.build_library(SOURCE))
    i, p, dbl, ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_double, \
        ctypes.c_longlong
    lib.bt_newton_max_register_n.argtypes = []
    lib.bt_newton_max_register_n.restype = i
    for name in ('bt_newton_cands_ws', 'bt_newton_accept_ws'):
        getattr(lib, name).argtypes = [i]
        getattr(lib, name).restype = ll
    lib.bt_newton_cands.argtypes = [i] * 7 + [p] * 9
    lib.bt_newton_cands.restype = i
    lib.bt_newton_accept.argtypes = ([i] * 5 + [p] * 5 + [dbl] * 2 + [ll]
                                     + [p] * 12)
    lib.bt_newton_accept.restype = i
    if lib.bt_newton_max_register_n() != REGISTER_N:
        raise RuntimeError("the library holds n <= %d in registers, this "
                           "module expects %d"
                           % (lib.bt_newton_max_register_n(), REGISTER_N))
    return lib


def _workspace(entries, L, like):
    """The kernel's workspace at n past ``REGISTER_N`` (``entries`` a lane),
    else None."""
    return like.new_empty(entries * L) if entries else None


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch_check(code, what):
    if code != 0:
        raise RuntimeError("%s kernel launch failed: %s" % (
            what, 'unsupported n or dtype' if code == -1 else
            'CUDA error %d' % code))


def _check(what, x, shape, dtype, device):
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            "%s must be a contiguous %s tensor of shape %s on %s, got %s %s "
            "on %s" % (what, dtype, tuple(shape), device, x.dtype,
                       tuple(x.shape), x.device))


def _check_lanes(table, lanes, u, g, H):
    if u.device.type != 'cuda' or u.dtype not in _DTYPES:
        raise ValueError("the Newton-step kernels take float32 or float64 "
                         "CUDA tensors, got %s on %s" % (u.dtype, u.device))
    n, L = table.n, lanes.shape[0]
    _check('the table', table.tab, (table.tab.numel(),), torch.float64,
           u.device)
    _check('lanes', lanes, (L,), torch.int64, u.device)
    _check('u', u, (u.shape[0], n), u.dtype, u.device)
    _check('g', g, (L, n), u.dtype, u.device)
    _check('H', H, (L, n, n), u.dtype, u.device)
    return n, L


def newton_cands_launcher(table, lanes, u, lam, g, H):
    """The CUDA side of :func:`newton_cands`, split as the likelihood
    wrappers' launchers: checks and output once, and ``(launch, cands)``,
    each ``launch()`` a launch into ``cands`` (counted in
    ``newton_cands.launches``)."""
    n, L = _check_lanes(table, lanes, u, g, H)
    _check('lam', lam, (u.shape[0],), u.dtype, u.device)
    cands = u.new_empty((L, table.A, n))
    lib = load_library()
    code_dt = _DTYPES[u.dtype]
    ws = _workspace(lib.bt_newton_cands_ws(n), L, u)

    def launch():
        with torch.cuda.device(u.device):
            code = lib.bt_newton_cands(
                code_dt, n, L, table.n_drop, table.n_jump, table.n_snap,
                table.A, table.tab.data_ptr(), lanes.data_ptr(),
                u.data_ptr(), lam.data_ptr(), g.data_ptr(), H.data_ptr(),
                cands.data_ptr(), _ptr(ws),
                torch.cuda.current_stream().cuda_stream)
        _launch_check(code, 'newton_cands')
        newton_cands.launches += 1
    return launch, cands


def newton_cands(table, lanes, u, lam, g, H):
    """The step's candidates (L, A, n) at the lanes ``lanes`` (L,) int64 of
    the fit's state u (B, n) and lam (B,), from the lanes' gradient g (L, n)
    and Hessian H (L, n, n): :func:`~..parallel.fitter._step_candidates`'s
    result."""
    launch, cands = newton_cands_launcher(table, lanes, u, lam, g, H)
    launch()
    return cands


newton_cands.launches = 0


def newton_accept_launcher(table, lanes, fs, cands, g, H, state, tol, ftol,
                           polish):
    """The CUDA side of :func:`newton_accept`, split as
    :func:`newton_cands_launcher`: ``(launch, state)``."""
    u, f, lam, nu, it, done, stall, pc, rounds, improved = state
    n, L = _check_lanes(table, lanes, u, g, H)
    B, dt, dev = u.shape[0], u.dtype, u.device
    _check('fs', fs, (L, table.A), dt, dev)
    _check('cands', cands, (L, table.A, n), dt, dev)
    for what, x in (('f', f), ('lam', lam), ('nu', nu)):
        _check(what, x, (B,), dt, dev)
    for what, x in (('it', it), ('stall', stall), ('pc', pc),
                    ('rounds', rounds)):
        _check(what, x, (B,), torch.int64, dev)
    for what, x in (('done', done), ('improved', improved)):
        _check(what, x, (B,), torch.bool, dev)
    lib = load_library()
    code_dt = _DTYPES[dt]
    ws = _workspace(lib.bt_newton_accept_ws(n), L, u)

    def launch():
        with torch.cuda.device(dev):
            code = lib.bt_newton_accept(
                code_dt, n, L, table.A, table.n_drop, lanes.data_ptr(),
                fs.data_ptr(), cands.data_ptr(), g.data_ptr(), H.data_ptr(),
                float(tol), float(ftol), int(polish), u.data_ptr(),
                f.data_ptr(), lam.data_ptr(), nu.data_ptr(), it.data_ptr(),
                done.data_ptr(), stall.data_ptr(), pc.data_ptr(),
                rounds.data_ptr(), improved.data_ptr(), _ptr(ws),
                torch.cuda.current_stream().cuda_stream)
        _launch_check(code, 'newton_accept')
        newton_accept.launches += 1
    return launch, state


def newton_accept(table, lanes, fs, cands, g, H, state, tol, ftol, polish):
    """Accept each lane's best candidate (the first least of its values fs
    (L, A), non-finite as +inf) or not, and write the step's result into
    the fit's batch state at the lanes: ``state`` = (u (B, n), f, lam, nu,
    it, done, stall, pc, rounds, improved), every one (B,) after u, it,
    stall, pc and rounds int64, done and improved bool; rounds is read
    only. :func:`~..parallel.fitter._step_update`'s result, scattered."""
    launch, _ = newton_accept_launcher(table, lanes, fs, cands, g, H, state,
                                       tol, ftol, polish)
    launch()


newton_accept.launches = 0


def launch_counts():
    """{wrapper name: kernel launches since the last reset}."""
    return {'newton_cands': newton_cands.launches,
            'newton_accept': newton_accept.launches}


def reset_launch_counts():
    newton_cands.launches = 0
    newton_accept.launches = 0
