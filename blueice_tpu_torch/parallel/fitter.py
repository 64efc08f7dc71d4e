"""Batched damped-Newton maximum-likelihood fits of a compiled binned or
unbinned likelihood.

Counterpart of :mod:`blueice_tpu.parallel.fitter` (the closed-form paths).
The JAX package writes one fit and vmaps it; here the toy batch is a
written-out leading dimension, and ``lax.while_loop`` becomes a Python loop
over iterations with a per-lane active mask: a lane that has converged (or
used up ``max_iter``) freezes — its u, f and iteration count stop — and each
iteration runs the Newton body on the lanes in Newton mode and the polish
body on the lanes in polish mode (the JAX version runs both bodies on every
lane and selects). The loop ends when no lane is active.

Bounds are enforced by smooth reparameterization (log for one-sided rate
multipliers, scaled logistic for two-sided shape parameters), as MINUIT
does, so the Newton steps live in an unconstrained space u.

The likelihood's (ll, g, H) in the natural (m, t) coordinates comes from the
closed form (``engine='analytic'``: the kernels' plain versions) or the
fused CUDA kernels (``engine='fused'``: :mod:`blueice_tpu_torch.ops.fused`,
for the Beeston-Barlow modes :mod:`~blueice_tpu_torch.ops.fused_bb` and
:mod:`~blueice_tpu_torch.ops.fused_bb_lite`, and for the extended unbinned
likelihood :mod:`~blueice_tpu_torch.ops.fused_unbinned`), and is chained to
u through the tiny parameter graph with its first and second derivatives in
closed form; where the likelihood runs on the CUDA kernels, that graph does
too (:mod:`~blueice_tpu_torch.ops.param_graph`: one launch from u to the
kernels' inputs, one for the chain rule).

An unbinned fit's data is each toy's per-event density tensor at every
anchor point, (B, G, S, E), with its event mask and the per-toy centering
data of :func:`unbinned_center`; the kernels read a lane's toy through an
index tensor, so no lane subset of that tensor is ever copied.

A compiled LogLikelihoodSum fits on the Sum engine
(:func:`_make_sum_analytic_parts`): each binned child's (value, g, H)
chained to the joint u space through its own parameter graph, which
routes only the joint parameters the child declares, weighted by the
sum's weights; a dataset-free child (an ancillary constraint) by
``torch.func`` over its logl. Its data is a tuple, one count tensor per
child. On the card each binned child takes the engine it would take on
its own: the CUDA kernels where they take the model. A log-morphed model
(``template_interpolation='log'``) runs the closed forms of
:func:`~blueice_tpu_torch.ops.binned_vgh.binned_vgh_log`: the kernels
bake in the linear lerp.
"""

from collections import OrderedDict

import numpy as np
import torch

from ..exceptions import NoOpimizationNecessary
from ..ops import (fused, fused_bb, fused_bb_lite, fused_unbinned,
                   newton_step, param_graph)
from ..ops.binned_vgh import (_ll_from_P, binned_vgh_log,
                              corner_weight_tables, log_morph_from_lerp)
from ..ops.interp import cell_index, clip
from ..ops.unbinned_vgh import reference_center
from ..utils.progress import count, trace, traced

__all__ = ['Transform', 'make_transform', 'minimize_newton',
           'make_toy_fitter', 'check_fixed_in_bounds', 'unbinned_center',
           'tree_map', 'observed_data', 'x_space_ops', 'fit_single',
           'make_batch_fitter']


def tree_map(fn, data, *rest):
    """``fn`` over the leaves of a binned dataset: one count tensor, or a
    compiled Sum's tuple of them, one per child (``rest``: datasets of the
    same structure, passed alongside)."""
    if isinstance(data, (tuple, list)):
        return tuple(fn(*leaves) for leaves in zip(data, *rest))
    return fn(data, *rest)


class Transform:
    """Smooth bijection between the optimizer's unconstrained space u and the
    bounded parameter space x, applied per coordinate (last axis)."""

    # kinds: 0 identity, 1 log (x = lo + exp(u)), 2 logistic in (lo, hi),
    # 3 mirrored log (x = hi - exp(-u), upper bound only)
    def __init__(self, kinds, los, his):
        self.kinds_np = np.asarray(kinds)
        self.los_np = np.asarray(los, dtype=float)
        self.his_np = np.asarray(his, dtype=float)
        # Infinite bounds get finite placeholders: every branch below is
        # evaluated for every coordinate, and an infinite unselected branch
        # would poison derivatives
        self.lo_safe_np = np.where(np.isfinite(self.los_np), self.los_np, 0.0)
        self.hi_safe_np = np.where(np.isfinite(self.his_np), self.his_np,
                                   self.lo_safe_np + 1.0)

    def _consts(self, like):
        """(kinds, lo, hi) as tensors of ``like``'s dtype and device, made
        once per dtype and device: a copy from host memory would wait for
        the device at every call."""
        key = (like.dtype, like.device)
        cache = self.__dict__.setdefault('_const_cache', {})
        if key not in cache:
            def t(a):
                return torch.as_tensor(a, dtype=like.dtype,
                                       device=like.device)
            cache[key] = (torch.as_tensor(self.kinds_np, device=like.device),
                          t(self.lo_safe_np), t(self.hi_safe_np))
        return cache[key]

    def to_x(self, u):
        kinds, lo, hi = self._consts(u)
        x_log = lo + torch.exp(u)
        x_logistic = lo + (hi - lo) * torch.sigmoid(u)
        x_mirror = hi - torch.exp(-u)
        return torch.where(kinds == 0, u,
                           torch.where(kinds == 1, x_log,
                                       torch.where(kinds == 2, x_logistic,
                                                   x_mirror)))

    def derivs(self, u):
        """(dx/du, d2x/du2) per coordinate."""
        kinds, lo, hi = self._consts(u)
        eu, emu = torch.exp(u), torch.exp(-u)
        sig = torch.sigmoid(u)
        ds = (hi - lo) * sig * (1.0 - sig)
        one = torch.ones_like(u)
        d1 = torch.where(kinds == 0, one, torch.where(
            kinds == 1, eu, torch.where(kinds == 2, ds, emu)))
        d2 = torch.where(kinds == 0, 0 * one, torch.where(
            kinds == 1, eu, torch.where(kinds == 2, ds * (1.0 - 2.0 * sig),
                                        -emu)))
        return d1, d2

    def to_u(self, x):
        kinds, lo, hi = self._consts(x)
        eps = 1e-12
        u_log = torch.log(torch.clamp(x - lo, min=eps))
        frac = torch.clamp((x - lo) / (hi - lo), 1e-9, 1 - 1e-9)
        u_logistic = torch.log(frac) - torch.log1p(-frac)
        u_mirror = -torch.log(torch.clamp(hi - x, min=eps))
        return torch.where(kinds == 0, x,
                           torch.where(kinds == 1, u_log,
                                       torch.where(kinds == 2, u_logistic,
                                                   u_mirror)))

    def to_u_np(self, x):
        """Host-numpy :meth:`to_u` for one-time setup values."""
        x = np.asarray(x, dtype=float)
        lo, hi = self.lo_safe_np, self.hi_safe_np
        u_log = np.log(np.maximum(x - lo, 1e-12))
        frac = np.clip((x - lo) / (hi - lo), 1e-9, 1 - 1e-9)
        u_logistic = np.log(frac) - np.log1p(-frac)
        u_mirror = -np.log(np.maximum(hi - x, 1e-12))
        return np.where(self.kinds_np == 0, x,
                        np.where(self.kinds_np == 1, u_log,
                                 np.where(self.kinds_np == 2, u_logistic,
                                          u_mirror)))

    def to_u_coord(self, i, x):
        """u values of coordinate ``i`` at the given x values (host numpy)."""
        kind = int(self.kinds_np[i])
        lo = float(self.los_np[i])
        x = np.asarray(x, dtype=float)
        if kind == 0:
            return x
        if kind == 1:
            return np.log(np.maximum(x - lo, 1e-12))
        hi = float(self.his_np[i])
        if kind == 3:
            return -np.log(np.maximum(hi - x, 1e-12))
        frac = np.clip((x - lo) / (hi - lo), 1e-9, 1 - 1e-9)
        return np.log(frac) - np.log1p(-frac)


def check_fixed_in_bounds(compiled, fixed):
    """Raise ValueError for any fixed/hypothesis value outside its
    parameter's bounds: the closed-form engines only evaluate inside the
    anchor range, so out-of-range values must be rejected on the host rather
    than silently clamped onto the grid edge."""
    for pname, value in (fixed or {}).items():
        lo, hi = compiled.bounds.get(pname, (None, None))
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue
        if (lo is not None and v < lo) or (hi is not None and v > hi):
            raise ValueError(
                "Fixed value %s=%g is outside the parameter's allowed range "
                "(%s, %s)" % (pname, v, lo, hi))


def make_transform(bounds_list):
    """Build a Transform from a list of (lo, hi) tuples (None == unbounded)."""
    kinds, los, his = [], [], []
    for lo, hi in bounds_list:
        lo = -np.inf if lo is None else float(lo)
        hi = np.inf if hi is None else float(hi)
        if np.isneginf(lo) and np.isposinf(hi):
            kinds.append(0)
        elif np.isposinf(hi):
            kinds.append(1)
        elif np.isneginf(lo):
            kinds.append(3)
        else:
            kinds.append(2)
        los.append(lo)
        his.append(hi)
    return Transform(np.array(kinds), np.array(los), np.array(his))


def _solve_spd_small(A, b):
    """Solve A x = b for a batch of tiny symmetric systems (..., n, n).

    Closed forms for n <= 3; Cholesky for n <= 16, where an indefinite
    (non-positive-definite) matrix gives NaN — the signal every caller routes
    to the scaled-steepest-descent rescue, as the JAX twin's unrolled
    Cholesky gives NaN there; LU beyond."""
    n = A.shape[-1]
    if n == 1:
        return b / A[..., 0, 0:1]
    if n == 2:
        det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        x0 = (A[..., 1, 1] * b[..., 0] - A[..., 0, 1] * b[..., 1]) / det
        x1 = (A[..., 0, 0] * b[..., 1] - A[..., 1, 0] * b[..., 0]) / det
        return torch.stack([x0, x1], dim=-1)
    if n == 3:
        a = [[A[..., i, j] for j in range(3)] for i in range(3)]
        c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
        c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2]
        c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
        det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02
        c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2]
        c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0]
        c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1]
        c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1]
        c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2]
        c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0]
        bb = [b[..., i] for i in range(3)]
        x0 = (c00 * bb[0] + c10 * bb[1] + c20 * bb[2]) / det
        x1 = (c01 * bb[0] + c11 * bb[1] + c21 * bb[2]) / det
        x2 = (c02 * bb[0] + c12 * bb[1] + c22 * bb[2]) / det
        return torch.stack([x0, x1, x2], dim=-1)
    if n <= 16:
        # the batched factor and solve copy to and from the host, and wait
        with trace('sync'):
            L, info = torch.linalg.cholesky_ex(A)
            x = torch.cholesky_solve(b[..., None], L)[..., 0]
    else:
        x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info == 0)[..., None], x,
                       torch.full_like(x, float('nan')))


@traced('newton.solve')
def _damped_solve(H, g, lam):
    """-(H + lam * diag(max(|diag H|, 1e-10)))^-1 g, with its scale d."""
    d = torch.clamp(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)),
                    min=1e-10)
    return -_solve_spd_small(H + torch.diag_embed(lam[:, None] * d), g), d


def _all_finite(x):
    return torch.isfinite(x).all(dim=-1, keepdim=True)


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _nonzero(mask):
    """The indices of ``mask``'s true entries: a host sync, since
    ``torch.nonzero`` waits for the device to size its output."""
    with trace('sync'):
        return torch.nonzero(mask).flatten()


def _step_kernel_eligible(device, dtype):
    """Whether a fit's Newton steps run as the CUDA kernels of
    :mod:`~blueice_tpu_torch.ops.newton_step`: on every CUDA device, for
    any number of coordinates; the PyTorch step (:func:`_step_candidates`,
    :func:`_step_update`) on the CPU. Raises ValueError for a fit on a
    CUDA device in a dtype the kernels do not take (float32, float64)."""
    if torch.device(device).type != 'cuda':
        return False
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("the Newton step on a CUDA device takes float32 or "
                         "float64, got %s" % dtype)
    return True


class _StepConsts:
    """The PyTorch step's constant tensors of a fit over ``n`` coordinates:
    the identity, the drop directions (the kink coordinates' rows of it),
    the line-search fractions, the jumps and the snaps (coordinate,
    u-space anchors tensor)."""

    def __init__(self, n, kink_coords, kink_jumps, snaps, dt, dev):
        self.eye = torch.eye(n, dtype=dt, device=dev)
        self.drop_dirs = (self.eye[list(kink_coords)] if kink_coords
                          else torch.zeros((0, n), dtype=dt, device=dev))
        self.n_drop = self.drop_dirs.shape[0]
        self.alphas = torch.tensor(newton_step.ALPHAS, dtype=dt, device=dev)
        self.jumps = torch.tensor(list(kink_jumps), dtype=dt, device=dev)
        self.snaps = [(ci, torch.as_tensor(a, dtype=dt, device=dev))
                      for ci, a in snaps]


def _step_candidates(c, u, g, H, lam):
    """The Newton step's line-search candidates (L, A, n) at u (L, n), from
    the lanes' finite gradient g (L, n) and Hessian H (L, n, n) and their
    damping lam (L,): the damped Newton step at 3 fractions, with each kink
    coordinate dropped, the jumps along each kink coordinate, each snap
    coordinate onto its nearest anchor and, with snaps, the active-set
    step. ``c``: the fit's :class:`_StepConsts`."""
    n, dev = u.shape[1], u.device
    du, d = _damped_solve(H, g, lam)
    du = torch.where(_all_finite(du), du,
                     -g / (torch.clamp(lam, min=1.0)[:, None] * d))
    # Ascent proposals of an indefinite damped Hessian become a
    # curvature-scaled steepest-descent step
    du = torch.where(((g * du).sum(-1) > 0)[:, None],
                     -g / (d * (1.0 + lam)[:, None]), du)

    cands = [u[:, None, :] + c.alphas[None, :, None] * du[:, None, :],
             u[:, None, :] + du[:, None, :] * (1.0 - c.drop_dirs)[None]]
    if c.jumps.numel():
        cands.append((u[:, None, None, :] + c.jumps[None, :, None, None]
                      * c.drop_dirs[None, None, :, :]).reshape(
                          u.shape[0], -1, n))
    if c.snaps:
        # Second-order snap: coordinate ci onto its nearest anchor, the
        # rest from the reduced Newton system under that displacement
        rows = torch.arange(u.shape[0], device=dev)
        act = torch.ones_like(u)
        for ci, au in c.snaps:
            dist = torch.abs(au[None, :] - u[:, ci:ci + 1])
            nearest = au[torch.argmin(dist, dim=1)]
            delta = nearest - u[:, ci]
            mask = 1.0 - c.eye[ci]
            gm = (g + H[:, :, ci] * delta[:, None]) * mask
            Hm = (H * (mask[:, None] * mask[None, :])
                  + torch.outer(c.eye[ci], c.eye[ci]))
            du_s, _ = _damped_solve(Hm, gm, lam)
            du_s = torch.where(_all_finite(du_s), du_s,
                               torch.zeros_like(du_s))
            cand = u + du_s
            cand[rows, ci] = nearest
            cands.append(cand[:, None, :])
            at_anchor = dist.min(dim=1).values < 1e-6
            act = act * torch.where(at_anchor[:, None], mask[None],
                                    torch.ones_like(mask)[None])
        # Active-set candidate: freeze every at-anchor kink coordinate
        ga = g * act
        Ha = H * (act[:, :, None] * act[:, None, :]) + torch.diag_embed(
            1.0 - act)
        du_a, _ = _damped_solve(Ha, ga, lam)
        du_a = torch.where(_all_finite(du_a), du_a, torch.zeros_like(du_a))
        cands.append((u + du_a * act)[:, None, :])
    return torch.cat(cands, dim=1)


def _pick_best(fs, cands):
    """Each lane's first least candidate of values fs (L, A), non-finite
    as +inf: (index, value, candidate)."""
    fs = torch.where(torch.isfinite(fs), fs,
                     torch.full_like(fs, float('inf')))
    best = torch.argmin(fs, dim=1)
    rows = torch.arange(cands.shape[0], device=cands.device)
    return best, fs[rows, best], cands[rows, best]


def _step_update(g, H, u, fval, lam, nu, it, stall, rounds, best, f_try,
                 u_try, n_drop, tol, ftol, polish):
    """The Newton step's result at its lanes from the winning candidate
    (index ``best``, value ``f_try``, point ``u_try``): accept it or not,
    the Nielsen gain-ratio damping, the stop rule and the polish entry."""
    du_eff = u_try - u
    accept = torch.isfinite(f_try) & (f_try < fval)
    # Nielsen gain-ratio damping schedule
    predicted = -((g * du_eff).sum(-1)
                  + 0.5 * (du_eff * (H @ du_eff[:, :, None])[:, :, 0])
                  .sum(-1))
    rho = (fval - f_try) / torch.where(predicted > 0, predicted,
                                       torch.ones_like(predicted))
    good = accept & (predicted > 0)
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_new = torch.clamp(
        torch.where(good, lam * shrink,
                    torch.where(accept, lam, lam * nu)), 1e-12, 1e10)
    nu_new = torch.where(accept, torch.full_like(nu, 2.0),
                         torch.clamp(nu * 2.0, max=64.0))
    u_new = torch.where(accept[:, None], u_try, u)
    f_new = torch.where(accept, f_try, fval)

    gnorm = torch.abs(g).max(dim=-1).values
    step = torch.abs(u_new - u).max(dim=-1).values
    fdelta = fval - f_new
    stall_new = torch.where(fdelta > ftol, torch.zeros_like(stall),
                            stall + 1)
    undamped = (best == 0) | ((best >= 3) & (best < 3 + n_drop))
    converged = ((gnorm < tol)
                 | (accept & (step < 1e-14))
                 | (accept & (fdelta <= ftol) & (lam < 1e-2)
                    & undamped & (it > 3))
                 | (lam_new > 1e8)
                 | (stall_new >= 4))
    enter_polish = converged & (rounds < polish)
    return dict(u=u_new, f=f_new, lam=lam_new, nu=nu_new, it=it + 1,
                done=converged & ~enter_polish,
                stall=torch.where(converged, torch.zeros_like(stall),
                                  stall_new),
                pc_enter=enter_polish)


@traced('newton.fit')
def minimize_newton(f_many, vgh, u0, max_iter=60, tol=1e-8, ftol=None,
                    init_damping=1e-3, polish=4, kink_coords=None,
                    kink_jumps=(0.3, -0.3, 0.1, -0.1), snap_anchors=None):
    """Minimize a batch of smooth objectives with Levenberg-damped Newton
    steps, one lane per toy.

    Same algorithm, stop rules and line-search candidates as the JAX twin
    (see its docstring): gradient inf-norm < tol, or an accepted undamped
    Newton step whose f-decrease is below ftol (default 1e-3 in float32,
    1e-10 in float64), or the damping/stall safeguards; a converged lane
    then polishes one coordinate per iteration (up to ``polish`` sweeps)
    and resumes Newton if a sweep improved f.

    The Newton step runs as two CUDA kernels
    (:mod:`~blueice_tpu_torch.ops.newton_step`, one launch before the
    step's value call and one after, which writes the lanes' state) on a
    CUDA device, and as the PyTorch ops of :func:`_step_candidates` and
    :func:`_step_update` on the CPU (:func:`_step_kernel_eligible`). Chosen
    once, here.

    :param f_many: f_many(lanes, cands) -> (L, A) objective values at
      candidates ``cands`` (L, A, n) of the lanes ``lanes`` (L,) (an index
      tensor into the batch).
    :param vgh: vgh(lanes, u) -> (value (L,), gradient (L, n), Hessian
      (L, n, n)) at u (L, n).
    :param u0: (B, n) start points.
    :param snap_anchors: optional list, parallel to ``kink_coords``, of
      u-space anchor positions (snap-to-anchor candidates; None for a
      coordinate without).
    :return: (u_min (B, n), f_min (B,), n_iters (B,)).
    """
    B, n = u0.shape
    count('newton.lanes_started', B)
    dt, dev = u0.dtype, u0.device
    if ftol is None:
        ftol = 1e-3 if dt == torch.float32 else 1e-10
    kink_coords = tuple(range(n)) if kink_coords is None \
        else tuple(kink_coords)
    kink_jumps = tuple(kink_jumps)
    snaps = ([] if snap_anchors is None else
             [(ci, np.asarray(a)) for ci, a in zip(kink_coords, snap_anchors)
              if a is not None])
    table = consts = None
    # rows of eye picked by a host list, and tables copied from host lists:
    # each copy waits for the device
    with trace('sync'):
        eye = torch.eye(n, dtype=dt, device=dev)
        if _step_kernel_eligible(dev, dt):
            table = newton_step.build_table(n, kink_coords, kink_jumps,
                                            snaps, dev)
        else:
            consts = _StepConsts(n, kink_coords, kink_jumps, snaps, dt, dev)
        polish_steps = torch.tensor(
            [0.3, -0.3, 0.1, -0.1, 0.03, -0.03, 0.01, -0.01, 3e-3, -3e-3,
             1e-3, -1e-3, 3e-4, -3e-4, 1e-4, -1e-4, 3e-5, -3e-5, 1e-5,
             -1e-5], dtype=dt, device=dev)

    def best_of(lanes, cands):
        with trace('newton.value'):
            fs = f_many(lanes, cands)
        return _pick_best(fs, cands)

    def newton_step_torch(lanes, u, fval, lam, nu, it, stall, rounds):
        count('newton.step_torch')
        with trace('newton.vgh'):
            _, g, H = vgh(lanes, u)
        g, H = _finite_or_zero(g), _finite_or_zero(H)
        cands = _step_candidates(consts, u, g, H, lam)
        best, f_try, u_try = best_of(lanes, cands)
        return _step_update(g, H, u, fval, lam, nu, it, stall, rounds, best,
                            f_try, u_try, consts.n_drop, tol, ftol, polish)

    def newton_step_kernels(lanes):
        """The step on the kernels, its result written into the batch
        state at ``lanes``."""
        count('newton.step_kernel')
        with trace('newton.vgh'):
            _, g, H = vgh(lanes, u[lanes])
        g, H = g.contiguous(), H.contiguous()
        cands = newton_step.newton_cands(table, lanes, u, lam, g, H)
        with trace('newton.value'):
            fs = f_many(lanes, cands)
        newton_step.newton_accept(
            table, lanes, fs.contiguous(), cands, g, H,
            (u, f, lam, nu, it, done, stall, pc, rounds, improved), tol,
            ftol, polish)

    def polish_step(lanes, u, fval, lam, nu, pc, rounds, improved):
        e = eye[torch.clamp(pc, 0, n - 1)]
        cands = u[:, None, :] + polish_steps[None, :, None] * e[:, None, :]
        _, f_best, u_best = best_of(lanes, cands)
        better = f_best < fval
        improved = improved | (f_best < fval - ftol * 0.1)
        last = pc + 1 >= n
        resume = last & improved
        return dict(u=torch.where(better[:, None], u_best, u),
                    f=torch.where(better, f_best, fval),
                    lam=torch.where(resume, torch.full_like(lam, init_damping),
                                    lam),
                    nu=torch.where(resume, torch.full_like(nu, 2.0), nu),
                    finished=last & ~improved,
                    pc=torch.where(last, torch.full_like(pc, -1), pc + 1),
                    rounds=rounds + last.to(rounds.dtype),
                    improved=improved & ~last)

    all_lanes = torch.arange(B, device=dev)
    u = u0.clone(memory_format=torch.contiguous_format)
    with trace('newton.value'):
        f = f_many(all_lanes, u[:, None, :])[:, 0].contiguous()
    lam = torch.full((B,), init_damping, dtype=dt, device=dev)
    nu = torch.full((B,), 2.0, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    stall = torch.zeros(B, dtype=torch.int64, device=dev)
    pc = torch.full((B,), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    improved = torch.zeros(B, dtype=torch.bool, device=dev)

    for _ in range(max_iter):
        with trace('newton.iter'):
            with trace('newton.select'):
                active = ~done & (it < max_iter)
                in_polish = pc >= 0
                lanes_n = _nonzero(active & ~in_polish)
                lanes_p = _nonzero(active & in_polish)
            if lanes_n.numel() == 0 and lanes_p.numel() == 0:
                break
            count('newton.iterations')
            count('newton.lanes_stepped', lanes_n.numel() + lanes_p.numel())
            if lanes_n.numel() and table is not None:
                with trace('newton.step'):
                    newton_step_kernels(lanes_n)
            elif lanes_n.numel():
                L = lanes_n
                with trace('newton.step'):
                    out = newton_step_torch(L, u[L], f[L], lam[L], nu[L],
                                            it[L], stall[L], rounds[L])
                with trace('newton.scatter'):
                    u[L], f[L], lam[L], nu[L] = (out['u'], out['f'],
                                                 out['lam'], out['nu'])
                    it[L], done[L], stall[L] = (out['it'], out['done'],
                                                out['stall'])
                    pc[L] = torch.where(out['pc_enter'],
                                        torch.zeros_like(pc[L]), pc[L])
                    # a host scalar's write copies it, and waits
                    with trace('sync'):
                        improved[L] = False
            if lanes_p.numel():
                L = lanes_p
                with trace('newton.polish'):
                    out = polish_step(L, u[L], f[L], lam[L], nu[L], pc[L],
                                      rounds[L], improved[L])
                with trace('newton.scatter'):
                    u[L], f[L], lam[L], nu[L] = (out['u'], out['f'],
                                                 out['lam'], out['nu'])
                    it[L] = it[L] + 1
                    done[L] = done[L] | out['finished']
                    stall.index_fill_(0, L, 0)
                    pc[L], rounds[L], improved[L] = (out['pc'], out['rounds'],
                                                     out['improved'])
    return u, f, it


def _floating_setup(compiled, fixed, guess=None):
    """Floating parameter names, their transform, and the initial x vector."""
    fixed = dict(fixed or {})
    unknown = set(fixed) - set(compiled.param_names)
    if unknown:
        raise ValueError("Unknown fixed parameters: %s" % sorted(unknown))
    registered = set(compiled.registered)
    names = [p for p in compiled.param_names
             if p not in fixed and p in registered]
    if not names:
        raise NoOpimizationNecessary(
            "There are no parameters to fit, no optimization is necessary")
    transform = make_transform([compiled.bounds[p] for p in names])
    guess = dict(guess or {})
    x0 = np.array([float(guess.get(p, compiled.defaults[p])) for p in names])
    return names, fixed, transform, x0


def _grid_dims(compiled):
    """(K shape params, S sources, G flattened anchor-grid size, n_bins;
    None for an unbinned likelihood)."""
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    G = int(np.prod([len(a) for a in compiled.anchor_arrays])) if K else 1
    n_bins = (int(np.prod(compiled.ps_tensor.shape[K + 1:]))
              if compiled.is_binned else None)
    return K, S, G, n_bins


def _fused_eligible(compiled):
    """Whether the CUDA kernels take this model: their instantiated range
    and type, and per mode what they compute. The bb_single kernels carry no
    negative-expectation penalty (as the reference's), so a bb_single model
    with an allow_negative source is not eligible; the plain and bb-lite
    kernels keep the penalty. A log-morphed model is not eligible: the
    kernels bake in the linear lerp. The unbinned kernels take any event
    count (no memory budget, unlike the TPU's VMEM rule)."""
    K, S, _, _ = _grid_dims(compiled)
    return (compiled.device.type == 'cuda'
            and compiled.dtype == torch.float32
            and 1 <= S <= fused.MAX_SOURCES
            and 0 <= K <= fused.MAX_SHAPE_AXES
            and not compiled.log_morph
            and not (compiled.has_bb and compiled.allowed_negative.any()))


def _analytic_supported(compiled):
    """The closed-form binned engine's models: a binned likelihood on a
    dense global anchor grid (or without shape parameters); a log-morphed
    one without a Beeston-Barlow mode (whose engines lerp linearly)."""
    return bool(compiled.is_binned and compiled.ps_tensor is not None
                and compiled.anchor_arrays is not None
                and not (compiled.log_morph
                         and (compiled.has_bb or compiled.has_bb_lite)))


def _sum_analytic_supported(compiled):
    """The Sum engine's models: a compiled LogLikelihoodSum whose every
    dataset child is itself closed-form binned (:func:`_analytic_supported`),
    with at least one such child; dataset-free children (ancillary
    constraints) ride along through ``torch.func``."""
    children = getattr(compiled, 'children', None)
    if not children:
        return False
    data_children = [c for c in children if c.has_data]
    return bool(data_children) and all(
        getattr(c, 'children', None) is None and _analytic_supported(c)
        for c in data_children)


def _engine_family(compiled):
    """'sum', 'binned' or 'unbinned': the closed-form engine that fits
    ``compiled``; 'ad' for what the JAX package fits only with its
    autodiff engine (:func:`_make_ad_parts`): a LogLikelihoodReParam (no
    anchor grid in its new parameters), a LogLikelihoodSum with an
    unbinned, re-parametrised or nested child, log template morphing with
    a Beeston-Barlow mode, a dataset-free term on its own, and
    source-wise morphing (no global anchor grid)."""
    if getattr(compiled, 'children', None) is not None:
        return 'sum' if _sum_analytic_supported(compiled) else 'ad'
    if _analytic_supported(compiled):
        return 'binned'
    if compiled.is_binned is False and compiled.anchor_arrays is not None:
        return 'unbinned'
    return 'ad'


def _tie_slope(v, lo, hi):
    """d/dv of ``clip(v, lo, hi)`` as JAX differentiates ``jnp.clip``
    (``minimum(maximum(v, lo), hi)``): 1 inside, 0 outside, 0.5 exactly on
    a bound."""
    one = torch.ones_like(v)
    f1 = torch.where(v > lo, one, torch.where(v == lo, 0.5 * one, 0 * one))
    vl = torch.clamp(v, min=lo)
    f2 = torch.where(vl < hi, one, torch.where(vl == hi, 0.5 * one, 0 * one))
    return f1 * f2


class _Routing:
    """Each parameter's value in a fit: the floating coordinate of x, the
    runtime-fixed value, the build-time fixed value or the default, in that
    order. ``routed``: for a child of a compiled Sum, the set of joint names
    the child declares; a joint parameter outside it, floating, fixed or
    runtime-fixed, keeps the child's default there (the host Sum's
    routing). None routes everything."""

    def __init__(self, defaults, names, fixed, runtime_fixed=(), routed=None):
        def routes(nm):
            return routed is None or nm in routed
        self.defaults = defaults
        self.name_pos = {nm: i for i, nm in enumerate(names) if routes(nm)}
        self.rt_pos = {nm: i for i, nm in enumerate(runtime_fixed)
                       if routes(nm)}
        self.fixed = {k: v for k, v in fixed.items() if routes(k)}

    def value_of(self, nm, x, fv):
        """Parameter ``nm`` as a tensor of x's batch shape (None: ones)."""
        kind, where = self.source_of(nm)
        if kind == param_graph.FLOATING:
            return x[..., where]
        if kind == param_graph.RUNTIME:
            return fv[..., where]
        return torch.full(x.shape[:-1], where, dtype=x.dtype,
                          device=x.device)

    def source_of(self, nm):
        """Where :meth:`value_of` reads ``nm`` (and the parameter-graph
        kernels' tables, which mirror it): (FLOATING, its column of x),
        (RUNTIME, its column of fv) or (CONSTANT, its value); None reads as
        the constant 1."""
        if nm is None:
            return param_graph.CONSTANT, 1.0
        if nm in self.name_pos:
            return param_graph.FLOATING, self.name_pos[nm]
        if nm in self.rt_pos:
            return param_graph.RUNTIME, self.rt_pos[nm]
        v = self.fixed[nm] if nm in self.fixed else self.defaults[nm]
        return param_graph.CONSTANT, float(v)


#: Test hook: keep every parameter graph on its PyTorch ops, read when a
#: graph is built (:class:`_ParamGraph`); for tests and the A/B of the two.
_FORCE_TORCH_GRAPH = False


def _graph_kernel_eligible(graph, n, use_fused):
    """Whether ``graph``, a :class:`_ParamGraph` over ``n`` floating
    coordinates, runs as the CUDA kernels of
    :mod:`~blueice_tpu_torch.ops.param_graph`: where the likelihood ops are
    the CUDA kernel wrappers (``use_fused`` on a CUDA device), in float32,
    1 <= K <= 4 and 1 <= S <= 8 (the kernels' range), every prior term
    Normal, and the graph within the kernels' tables: at most 32 floating
    coordinates, 256 anchors over all axes and 32 prior terms, and at most
    S + K distinct floating coordinates read
    (:func:`~blueice_tpu_torch.ops.param_graph.compact_columns`)."""
    compiled, K, S = graph.compiled, graph.K, graph.S
    priors = compiled.prior_terms
    pg = param_graph
    return bool(use_fused and compiled.device.type == 'cuda'
                and compiled.dtype == torch.float32
                and 1 <= K <= pg.MAX_K and 1 <= S <= pg.MAX_S
                and all(getattr(pr, 'kind', None) == 'normal'
                        for _, pr in priors)
                and n <= pg.MAX_N and len(priors) <= pg.MAX_PRIORS
                and sum(len(a) for a in compiled.anchor_arrays)
                <= pg.MAX_ANCHORS
                and len(pg.compact_columns(graph)) <= S + K)


class _ParamGraph:
    """The tiny graph from the optimizer's u vector to the likelihood's
    natural parameters: rates m (S), lerp weights t (K) and the summed log
    prior, with its first and second derivatives in closed form.

    x = Transform(u) per coordinate; t_d = clip((clip(z_d) - lo_d) / w_d)
    is piecewise linear in the shape parameter z_d; the rates
    m_s = mus_s(t) R_s E_s are the mus anchor tensor lerped at t (multilinear)
    times the rate multiplier R_s and, for sources that apply one, the
    efficiency E_s, both linear in x. ``fv`` (..., R) holds the
    runtime-fixed values, aligned with ``runtime_fixed``. ``routed``: for a
    child of a compiled Sum, the joint names it declares (see
    :class:`_Routing`).

    Where the likelihood ops are the CUDA kernel wrappers (``use_fused`` on
    a CUDA device) and the model is in the graph kernels' range
    (:func:`_graph_kernel_eligible`), :meth:`evaluate` and :meth:`gradient`
    run as two hand-written kernels
    (:mod:`~blueice_tpu_torch.ops.param_graph`, ``kernel`` their tables);
    elsewhere as the PyTorch ops of
    :meth:`cells`, :meth:`values` and :meth:`chain`. Chosen once, here.
    """

    def __init__(self, compiled, names, fixed, transform, runtime_fixed=(),
                 routed=None, use_fused=False):
        dt, dev = compiled.dtype, compiled.device
        self.compiled, self.transform = compiled, transform
        self.routing = _Routing(compiled.defaults, names, fixed,
                                runtime_fixed, routed)
        self.shape_names = list(compiled.shape_names)
        self.rate_names = list(compiled.rate_names)
        self.K = K = len(self.shape_names)
        self.S = S = len(self.rate_names)
        n = len(names)
        self.name_pos = self.routing.name_pos
        grid_shape = tuple(len(a) for a in compiled.anchor_arrays)
        G = int(np.prod(grid_shape)) if K else 1
        self.strides = tuple(int(np.prod(grid_shape[d + 1:]))
                             for d in range(K))
        self.arrs = [torch.as_tensor(a, dtype=dt, device=dev)
                     for a in compiled.anchor_arrays]
        self.mus_flat = compiled.mus_tensor.reshape(G, S)
        self.eff_names = [compiled.eff_names[s]
                          if compiled.apply_eff[s]
                          and compiled.eff_names[s] in self.shape_names
                          else None for s in range(S)]
        self.G = G

        # Constant selectors: which floating coordinate each t_d, R_s and
        # E_s is (zero rows where the parameter is fixed)
        def selector(rows):
            out = torch.zeros((len(rows), n), dtype=dt, device=dev)
            for r, nm in enumerate(rows):
                if nm in self.name_pos:
                    out[r, self.name_pos[nm]] = 1.0
            return out
        self.sel_t = selector(self.shape_names)                  # (K, n)
        self.sel_rate = selector(self.rate_names)                # (S, n)
        self.sel_eff = selector(self.eff_names)                  # (S, n)
        self.d2F = (self.sel_rate[:, :, None] * self.sel_eff[:, None, :]
                    + self.sel_eff[:, :, None] * self.sel_rate[:, None, :])
        self.floating_priors = [(self.name_pos[nm], pr)
                                for nm, pr in compiled.prior_terms
                                if nm in self.name_pos]
        # The tables the graph's and the kernels' calls read, made now: a
        # copy from host memory later would wait for the device at a call
        # (the device MCMC chain runs without a host sync)
        transform._consts(self.sel_t)
        fused.corner_ids(self.strides,
                         torch.zeros((1, K), dtype=torch.int64, device=dev),
                         G)
        corner_weight_tables(torch.zeros((1, K), dtype=dt, device=dev))
        self.strict = torch.as_tensor(~compiled.allowed_negative,
                                      device=dev)
        self.kernel = None
        if not _FORCE_TORCH_GRAPH \
                and _graph_kernel_eligible(self, n, use_fused):
            self.kernel = param_graph.build_tables(self, n,
                                                   len(runtime_fixed))

    def evaluate(self, u, fv, derivs=False, want_x=False):
        """The graph at u (L, n), or at candidates u (L, A, n), with each
        lane's runtime-fixed values fv (L, R): ``(idx, t, m, prior, x,
        parts)``, idx, t and m contiguous, the likelihood ops' inputs. On
        the kernels x is None without ``want_x``, and parts None; on the
        PyTorch ops ``parts`` holds, with ``derivs``, what :meth:`gradient`
        reads."""
        if self.kernel is not None:
            count('graph.kernel')
            with trace('graph.values'):
                idx, t, m, prior, x = param_graph.graph_fwd(
                    self.kernel, u, fv, want_x)
            return idx, t, m, prior, x, None
        count('graph.torch')
        if u.dim() == 3:
            fv = fv[:, None, :].expand(u.shape[:2] + fv.shape[-1:])
        x, idx, lo, width, musc = self.cells(u, fv)
        out = self.values(x, fv, lo, width, musc, derivs=derivs)
        m, t, prior = out[:3]
        parts = (x, musc, t, out[3]) if derivs else None
        return idx, t.contiguous(), m.contiguous(), prior, x, parts

    def gradient(self, u, fv, parts, g_mt, H_mt):
        """(g, H) in u of -(ll + prior) at u (L, n) from the likelihood's
        (g, H) in (m, t) (:meth:`chain`); ``parts`` from
        :meth:`evaluate` with ``derivs``."""
        if self.kernel is not None:
            with trace('graph.chain'):
                return param_graph.graph_chain(self.kernel, u, fv, g_mt,
                                               H_mt)
        x, musc, t, rest = parts
        return self.chain(u, x, fv, musc, t, rest, g_mt, H_mt)

    def value_of(self, nm, x, fv):
        """Parameter ``nm`` as a tensor of x's batch shape."""
        return self.routing.value_of(nm, x, fv)

    @traced('graph.cells')
    def cells(self, u, fv):
        """(x, idx (..., K) lower anchor-cell indices, lo and width (..., K)
        of those cells, mus corners (..., 2^K, S)) — piecewise constant in u
        (zero derivative)."""
        x = self.transform.to_x(u)
        batch = x.shape[:-1]
        if self.K == 0:
            empty = torch.zeros(batch + (0,), dtype=x.dtype, device=x.device)
            return (x, empty.long(), empty, empty,
                    self.live(self.mus_flat.expand(batch + (1, self.S)), x,
                              fv))
        zs = [self.value_of(sp, x, fv) for sp in self.shape_names]
        idx = torch.stack([cell_index(a, clip(z, a[0], a[-1]))
                           for a, z in zip(self.arrs, zs)], dim=-1)
        lo = torch.stack([a[idx[..., d]] for d, a in enumerate(self.arrs)], -1)
        hi = torch.stack([a[idx[..., d] + 1]
                          for d, a in enumerate(self.arrs)], -1)
        return (x, idx, lo, hi - lo,
                self.live(self.mus_flat[fused.corner_ids(self.strides, idx,
                                                         self.G)], x, fv))

    def live(self, musc, x, fv):
        """The mus corners (..., C, S) scaled by the live time over the
        base live time, for a likelihood compiled with
        ``include_livetime`` (a fit never floats it, so the factor is a
        constant of the fit)."""
        base = getattr(self.compiled, 'base_livetime', None)
        if base is None:
            return musc
        scale = self.value_of('livetime_days', x, fv) / base
        return musc * scale[..., None, None]

    @traced('graph.values')
    def values(self, x, fv, lo, width, musc, derivs=False):
        """(m (..., S), t (..., K), prior (...)), plus with ``derivs`` the
        slopes dt_d/dz_d (..., K) JAX's clip derivatives give."""
        batch = x.shape[:-1]
        nb = len(batch)
        ts, slopes = [], []
        for d, (a, sp) in enumerate(zip(self.arrs, self.shape_names)):
            z = self.value_of(sp, x, fv)
            zc = clip(z, a[0], a[-1])
            y = (zc - lo[..., d]) / width[..., d]
            ts.append(clip(y, 0.0, 1.0))
            if derivs:
                slopes.append(_tie_slope(z, a[0], a[-1])
                              * _tie_slope(y, 0.0, 1.0) / width[..., d])
        # Rates: the mus anchor tensor lerped axis by axis at t (the JAX
        # twin's morph_templates), times multipliers and efficiencies
        corner = musc.reshape(batch + (2,) * self.K + (self.S,))
        for t in ts:
            tb = t.reshape(t.shape + (1,) * (corner.dim() - nb - 1))
            corner = ((1.0 - tb) * corner.select(nb, 0)
                      + tb * corner.select(nb, 1))
        R = torch.stack([self.value_of(rn, x, fv) for rn in self.rate_names],
                        dim=-1)
        E = torch.stack([self.value_of(en, x, fv) for en in self.eff_names],
                        dim=-1)
        m = corner * R * E
        prior = torch.zeros(batch, dtype=x.dtype, device=x.device)
        for pname, pr in self.compiled.prior_terms:
            prior = prior + pr(self.value_of(pname, x, fv))
        t = (torch.stack(ts, dim=-1) if ts
             else torch.zeros(batch + (0,), dtype=x.dtype, device=x.device))
        if not derivs:
            return m, t, prior
        slope = (torch.stack(slopes, dim=-1) if slopes
                 else torch.zeros_like(t))
        return m, t, prior, (corner, R, E, slope)

    @traced('graph.chain')
    def chain(self, u, x, fv, musc, t, parts, g_mt, H_mt):
        """Negated gradient and Hessian in u of -(ll + prior), from the
        likelihood's (g, H) in (m, t) and this graph's closed-form first and
        second derivatives (the JAX twin's jacfwd/hessian of mt_of_u)."""
        mus, R, E, slope = parts
        S, K = self.S, self.K
        w, wd, wx = corner_weight_tables(t)
        dmus_dt = torch.einsum('ldc,lcs->lsd', wd, musc)          # (L, S, K)
        d2mus_dt = torch.einsum('ldec,lcs->lsde', wx, musc)       # (L, S, K, K)
        dt_dx = slope[:, :, None] * self.sel_t[None]              # (L, K, n)
        dmus = torch.einsum('lsd,ldn->lsn', dmus_dt, dt_dx)       # (L, S, n)
        d2mus = torch.einsum('lsde,ldj,lek->lsjk', d2mus_dt, dt_dx, dt_dx)
        F = R * E
        dF = (self.sel_rate[None] * E[:, :, None]
              + R[:, :, None] * self.sel_eff[None])               # (L, S, n)
        J_m = dmus * F[:, :, None] + mus[:, :, None] * dF
        H_m = (d2mus * F[:, :, None, None]
               + dmus[:, :, :, None] * dF[:, :, None, :]
               + dF[:, :, :, None] * dmus[:, :, None, :]
               + mus[:, :, None, None] * self.d2F[None])          # (L, S, n, n)
        J = torch.cat([J_m, dt_dx], dim=1)                        # (L, M, n)

        pg = torch.zeros_like(x)
        ph = torch.zeros_like(x)
        for j, pr in self.floating_priors:
            pg[:, j] = pg[:, j] + pr.grad(x[:, j])
            ph[:, j] = ph[:, j] + pr.hess(x[:, j])
        G = torch.einsum('lmn,lm->ln', J, g_mt) + pg
        Q = (J.transpose(1, 2) @ H_mt @ J
             + torch.einsum('ls,lsjk->ljk', g_mt[:, :S], H_m)
             + torch.diag_embed(ph))
        d1, d2 = self.transform.derivs(u)
        g = -(d1 * G)
        H = -(d1[:, :, None] * d1[:, None, :] * Q + torch.diag_embed(d2 * G))
        return g, H


def _likelihood_ops(compiled, G, S, n_bins, use_fused):
    """(vgh_op, ll_op), each called as op(anchor, strides, idx, t, m, data),
    for the likelihood's finite-MC-statistics mode: the CUDA kernel
    wrappers with ``use_fused`` (their plain versions for CPU tensors),
    else the plain versions directly.

    The Beeston-Barlow ops also read MC-count anchor rows (G, N), made once
    from the float64 host payload: bb_single the finite source's rows,
    bb-lite the rows summed over sources."""
    if not (compiled.has_bb or compiled.has_bb_lite):
        if use_fused:
            return fused.binned_vgh_fused, fused.binned_ll_fused_multi
        return fused.binned_vgh_plain, fused.binned_ll_plain

    nme = compiled.nme_tensor_host.reshape(G, S, n_bins)
    if compiled.has_bb_lite:
        rows = nme.sum(axis=1)
        vgh, ll = ((fused_bb_lite.binned_bblite_vgh_fused,
                    fused_bb_lite.binned_bblite_ll_fused_multi) if use_fused
                   else (fused_bb_lite.binned_bblite_vgh_plain,
                         fused_bb_lite.binned_bblite_ll_plain))
        extra = ()
    else:
        rows = nme[:, compiled.bb_source_i]
        vgh, ll = ((fused_bb.binned_bb_vgh_fused,
                    fused_bb.binned_bb_ll_fused_multi) if use_fused
                   else (fused_bb.binned_bb_vgh_plain,
                         fused_bb.binned_bb_ll_plain))
        extra = (compiled.bb_source_i,)
    rows = torch.as_tensor(rows, dtype=compiled.dtype,
                           device=compiled.device).contiguous()

    def vgh_op(anchor, strides, idx, t, m, data):
        return vgh(anchor, rows, strides, idx, t, m, data, *extra)

    def ll_op(anchor, strides, idx, t, m, data):
        return ll(anchor, rows, strides, idx, t, m, data, *extra)
    return vgh_op, ll_op


def _log_morph_ops(compiled, G, S):
    """(vgh_op, ll_op) of a log-morphed model, called as the ops of
    :func:`_likelihood_ops`: the closed forms of geometric template
    morphing on each lane's corners of the log anchor tensor and of the
    per-anchor masses (float64 host masses, in the working dtype). The
    value op lerps candidate by candidate, corner by corner, so the
    (B, A, 2^K, S, N) corner block is never materialized."""
    masses = torch.as_tensor(compiled.masses_host.reshape(G, S),
                             dtype=compiled.dtype, device=compiled.device)

    def vgh_op(anchor, strides, idx, t, m, data):
        ids = fused.corner_ids(strides, idx, G)
        return binned_vgh_log(anchor[ids], masses[ids], m, t, data)

    def ll_op(anchor, strides, idx, t, m, data):
        ids = fused.corner_ids(strides, idx, G)              # (B, A, C)
        w = corner_weight_tables(t)[0]                       # (B, A, C)
        L = M = 0
        for c in range(ids.shape[-1]):
            L = L + w[..., c, None, None] * anchor[ids[..., c]]
            M = M + w[..., c, None] * masses[ids[..., c]]
        return _ll_from_P(log_morph_from_lerp(L, M)[0], m, data[:, None, :])
    return vgh_op, ll_op


def _make_analytic_parts(compiled, names, fixed, transform, use_fused,
                         runtime_fixed=(), routed=None):
    """(value_many(u_cands, data, fv), vgh(u, data, fv)) computing the
    negated objective from the closed-form (m, t)-derivatives chained through
    the parameter graph: transforms, rate morphing, efficiencies, priors.

    ``use_fused`` routes the heavy (ll, g, H) and value ops to the CUDA
    kernel wrappers (their plain versions on the CPU); otherwise to those
    plain versions directly (see :func:`_likelihood_ops`). A log-morphed
    model takes :func:`_log_morph_ops` (no kernel). ``routed``: see
    :class:`_Routing`.
    """
    K, S, G, n_bins = _grid_dims(compiled)
    anchor = compiled.ps_tensor.reshape(G, S, n_bins).contiguous()
    graph = _ParamGraph(compiled, names, fixed, transform, runtime_fixed,
                        routed, use_fused=use_fused)
    if compiled.log_morph:
        if use_fused:
            raise ValueError(
                "the fused CUDA kernels bake in linear template morphing; "
                "log-morphed (template_interpolation='log') models use "
                "engine='analytic'")
        vgh_op, ll_op = _log_morph_ops(compiled, G, S)
    else:
        vgh_op, ll_op = _likelihood_ops(compiled, G, S, n_bins, use_fused)

    def value_many(u_cands, data, fv, domain=False):
        """Objective at candidates u_cands (L, A, n), data (L, N), fv (L, R)
        — one value-kernel launch for the line search / polish batch; with
        ``domain`` also where the compiled logl is finite there
        (:func:`_in_domain`)."""
        idx, t, m, prior, x, _ = graph.evaluate(u_cands, fv, want_x=domain)
        lls = ll_op(anchor, graph.strides, idx, t, m, data)
        if domain:
            fvA = fv[:, None, :].expand(u_cands.shape[:2] + fv.shape[-1:])
            return -(lls + prior), _in_domain(graph, x, fvA, m)
        return -(lls + prior)

    def vgh(u, data, fv):
        idx, t, m, prior, _, parts = graph.evaluate(u, fv, derivs=True)
        ll, g_mt, H_mt = vgh_op(anchor, graph.strides, idx, t, m, data)
        g, H = graph.gradient(u, fv, parts, g_mt, H_mt)
        return -(ll + prior), g, H

    return value_many, vgh


def _ancillary_parts(compiled, names, fixed, transform, runtime_fixed=(),
                     routed=None):
    """(value_many, vgh) of a dataset-free child of a Sum: the negated logl
    of its routed parameters at u, any batch shape; (g, H) by
    ``torch.func`` (``vmap`` of ``grad`` and ``hessian`` over the lanes).
    Its func must be differentiable torch arithmetic, without ``.item()``
    or branches on values."""
    from torch.func import grad, hessian, vmap
    routing = _Routing(compiled.defaults, names, fixed, runtime_fixed, routed)

    def objective(u, fv):
        x = transform.to_x(u)
        return -compiled.logl({p: routing.value_of(p, x, fv)
                               for p in compiled.param_names})

    def value_many(u_cands, data, fv, domain=False):
        out = objective(u_cands, fv[:, None, :].expand(
            u_cands.shape[:2] + fv.shape[-1:]))
        return (out, torch.ones_like(out, dtype=torch.bool)) if domain \
            else out

    def vgh(u, data, fv):
        return (objective(u, fv), vmap(grad(objective))(u, fv),
                vmap(hessian(objective))(u, fv))
    return value_many, vgh


def _make_sum_analytic_parts(compiled, names, fixed, transform, engine,
                             runtime_fixed=()):
    """(value_many(u_cands, data, fv), vgh(u, data, fv)) of a compiled
    LogLikelihoodSum: the weighted sum of its children's, each chained to
    the joint u space through its own routed parameter graph; ``data`` is
    the tuple of per-child count tensors (L, N_i) (empty for a dataset-free
    child). Each binned child takes the CUDA kernels with ``engine`` 'fused'
    and, with 'auto', where they take it on its own
    (:func:`_fused_eligible`); 'analytic' keeps every child on the plain
    versions."""
    entries = []
    for c, w, routed in zip(compiled.children, compiled.child_weights,
                            compiled.child_routed):
        if c.has_data:
            use_fused = (engine == 'fused'
                         or (engine == 'auto' and _fused_eligible(c)))
            parts = _make_analytic_parts(c, names, fixed, transform,
                                         use_fused, runtime_fixed, routed)
        else:
            parts = _ancillary_parts(c, names, fixed, transform,
                                     runtime_fixed, routed)
        entries.append((w,) + parts)

    def value_many(u_cands, data, fv, domain=False):
        if not domain:
            return sum(w * vm(u_cands, d, fv)
                       for (w, vm, _), d in zip(entries, data))
        outs = [vm(u_cands, d, fv, domain=True)
                for (_, vm, _), d in zip(entries, data)]
        ok = outs[0][1]
        for _, child_ok in outs[1:]:
            ok = ok & child_ok
        return sum(w * v for (w, _, _), (v, _) in zip(entries, outs)), ok

    def vgh(u, data, fv):
        outs = [[w * x for x in vg(u, d, fv)]
                for (w, _, vg), d in zip(entries, data)]
        return tuple(sum(parts) for parts in zip(*outs))
    return value_many, vgh


def _sum_snap_anchors(compiled, names, kink_coords, transform):
    """u-space snap candidates of a Sum's shape coordinates: the union of
    the anchors of the children each routes to (the joint objective's kinks
    are there), or None when a coordinate has none."""
    per_coord = []
    for ci in kink_coords:
        nm = names[ci]
        vals = [np.asarray(c.anchor_arrays[list(c.shape_names).index(nm)])
                for c, routed in zip(compiled.children,
                                     compiled.child_routed)
                if nm in routed and c.anchor_arrays
                and nm in c.shape_names]
        if not vals:
            return None
        per_coord.append(transform.to_u_coord(
            ci, np.unique(np.concatenate(vals))))
    return per_coord


def _snap_anchors(compiled, names, kink_coords, transform):
    """u-space snap candidates of the shape coordinates of a likelihood
    with its own anchors (``shape_anchor_arrays``), or of a ReParam's
    wrapped one for the parameters it passes through (its new parameters
    have none: None there); None without any.

    The JAX package snaps only on a global anchor grid. Here a
    source-wise build and a ReParam snap too: a shape parameter's kinks
    are at its anchors whichever sources morph over it or whatever
    parameters a transform puts in front, and without the snaps a
    XENON-style source-wise fit took five times the iterations and a
    XENON ReParam fit stopped 4e-3 below the optimum at a kink."""
    leaf = getattr(compiled, 'child', compiled)
    arrays = getattr(leaf, 'shape_anchor_arrays', None)
    if not arrays:
        return None
    shape_idx = {nm: d for d, nm in enumerate(leaf.shape_names)}
    out = [transform.to_u_coord(ci, arrays[shape_idx[names[ci]]])
           if names[ci] in shape_idx else None for ci in kink_coords]
    return out if any(a is not None for a in out) else None


def _reference_point(compiled):
    """(m0 (S,), idx0 (K,), t0 (K,)) of the centering reference: every
    parameter at its default, whatever the fit's guesses or fixed values,
    so that every fit of a toy (free, conditional, refined) shares it."""
    dt, dev = compiled.dtype, compiled.device
    m0 = compiled.rates(dict(compiled.defaults))
    idx0, t0 = [], []
    for d, sp in enumerate(compiled.shape_names):
        arr = np.asarray(compiled.anchor_arrays[d], dtype=float)
        z = float(np.clip(float(compiled.defaults[sp]), arr[0], arr[-1]))
        i = int(np.clip(np.searchsorted(arr, z, side='right') - 1,
                        0, len(arr) - 2))
        idx0.append(i)
        t0.append(float(np.clip((z - arr[i]) / (arr[i + 1] - arr[i]),
                                0.0, 1.0)))
    return (m0, torch.as_tensor(idx0, dtype=torch.int64, device=dev),
            torch.as_tensor(t0, dtype=dt, device=dev))


#: toys per step of :func:`unbinned_center` (bounds the corner block's memory)
CENTER_CHUNK = 64


def unbinned_center(compiled, ps, mask):
    """Per-toy centering data of an unbinned toy batch, computed once per
    event set and shared by every fit of those toys:
    ``(inv_ref (B, E), ref_msum (B,), ref_ll (B,) float64)`` at the
    default parameters (see
    :func:`blueice_tpu_torch.ops.unbinned_vgh.reference_center`). Without
    the centering, float32 loses the profile statistic at a few thousand
    events per toy.

    :param ps: (B, G, S, E) per-toy per-event densities at every anchor,
      or for a source-wise build a tuple of per-source (B, G_s, E).
    :param mask: (B, E) bool event validity.
    """
    if compiled.source_wise is not None:
        return _source_wise_center(compiled, ps, mask)
    K = len(compiled.shape_names)
    B, G, S, E = ps.shape
    grid = tuple(len(a) for a in compiled.anchor_arrays)
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    m0, idx0, t0 = _reference_point(compiled)
    ids0 = fused.corner_ids(strides, idx0, G)                     # (C,)
    parts = []
    for b0 in range(0, B, CENTER_CHUNK):
        sl = slice(b0, min(B, b0 + CENTER_CHUNK))
        n = sl.stop - sl.start
        parts.append(reference_center(
            ps[sl][:, ids0], m0.expand(n, S), t0.expand(n, K), mask[sl],
            compiled.outlier_likelihood))
    inv_ref, ref_msum, ref_ll = (torch.cat(p) for p in zip(*parts))
    return inv_ref.contiguous(), ref_msum, ref_ll


def _source_wise_center(compiled, ps, mask):
    """:func:`unbinned_center` of a source-wise build: each toy's per-event
    densities at the defaults, every source morphed at its own slice of
    the shape point (``compiled._event_densities``, vmapped over toys)."""
    from torch.func import vmap
    defaults = dict(compiled.defaults)
    w0 = compiled._weights(compiled._clipped_zs(defaults)[0])
    m0 = compiled.rates(defaults)
    B, S = mask.shape[0], len(compiled.rate_names)
    dens = vmap(lambda d: compiled._event_densities(d, w0))
    parts = []
    for b0 in range(0, B, CENTER_CHUNK):
        sl = slice(b0, min(B, b0 + CENTER_CHUNK))
        n = sl.stop - sl.start
        P0 = dens(tuple(p[sl] for p in ps))                   # (n, S, E)
        parts.append(reference_center(
            P0[:, None], m0.expand(n, S), m0.new_zeros((n, 0)), mask[sl],
            compiled.outlier_likelihood))
    inv_ref, ref_msum, ref_ll = (torch.cat(p) for p in zip(*parts))
    return inv_ref.contiguous(), ref_msum, ref_ll


#: Test hook: route every closed-form unbinned fit to the dense engine
#: (:mod:`blueice_tpu_torch.ops.unbinned_dense`). The JAX package takes that
#: engine on its TPU backend, where the per-toy tensor outgrows the Pallas
#: kernels' VMEM; the card has no such budget, so ``engine='auto'`` keeps
#: the unbinned kernels and the dense engine is reached only through this
#: hook, read when a fitter is built: for tests and the engine A/B.
_FORCE_DENSE_UNBINNED = False


def _dense_unbinned_ops():
    """(vgh_op, ll_op) of the dense engine in the kernel wrappers' calling
    convention, whose rate argument is ``moff = sum m - ref_msum``. The
    dense ops take ``ref_msum`` itself: they are given ``sum m`` (a rate
    term of exactly 0, so they return the log term alone) and ``moff`` is
    subtracted from their ll, as the wrappers do."""
    from ..ops.unbinned_dense import unbinned_vgh_dense, unbinned_ll_dense_many

    def vgh_op(ps, strides, rows, idx, t, m, mask, inv_ref, moff, outlier):
        ll, g, H = unbinned_vgh_dense(ps, strides, idx, t, m, mask, outlier,
                                      inv_ref, m.sum(-1), lanes=rows)
        return ll - moff, g, H

    def ll_op(ps, strides, rows, idx, t, m, mask, inv_ref, moff, outlier):
        return unbinned_ll_dense_many(ps, strides, idx, t, m, mask, outlier,
                                      inv_ref, m.sum(-1), lanes=rows) - moff
    return vgh_op, ll_op


def _make_unbinned_parts(compiled, names, fixed, transform, use_fused,
                         runtime_fixed=()):
    """(value_many(u_cands, data, rows, fv), vgh(u, data, rows, fv)) of the
    negated extended unbinned objective, centered. ``data`` is (ps
    (B, G, S, E), mask (B, E), center) and ``rows`` (L,) the toys of the
    lanes: the ops read ``ps[rows]`` in place.

    ``use_fused`` routes the (ll, g, H) and value ops to the CUDA kernel
    wrappers (their plain versions on the CPU); otherwise to the plain
    versions, the closed forms of :mod:`blueice_tpu_torch.ops.unbinned_vgh`.
    With the test hook :data:`_FORCE_DENSE_UNBINNED` set, both go to the
    dense engine instead, on any device.
    """
    graph = _ParamGraph(compiled, names, fixed, transform, runtime_fixed,
                        use_fused=use_fused and not _FORCE_DENSE_UNBINNED)
    outlier = compiled.outlier_likelihood
    if _FORCE_DENSE_UNBINNED:
        vgh_op, ll_op = _dense_unbinned_ops()
    elif use_fused:
        vgh_op = fused_unbinned.unbinned_vgh_fused
        ll_op = fused_unbinned.unbinned_ll_fused_multi
    else:
        vgh_op = fused_unbinned.unbinned_vgh_plain
        ll_op = fused_unbinned.unbinned_ll_plain

    def value_many(u_cands, data, rows, fv, domain=False):
        ps, mask, (inv_ref, ref_msum, _) = data
        idx, t, m, prior, x, _ = graph.evaluate(u_cands, fv, want_x=domain)
        moff = (m.sum(-1) - ref_msum[rows][:, None]).contiguous()
        lls = ll_op(ps, graph.strides, rows, idx, t, m, mask, inv_ref, moff,
                    outlier)
        if domain:
            fvA = fv[:, None, :].expand(u_cands.shape[:2] + fv.shape[-1:])
            return -(lls + prior), _in_domain(graph, x, fvA, m)
        return -(lls + prior)

    def vgh(u, data, rows, fv):
        ps, mask, (inv_ref, ref_msum, _) = data
        idx, t, m, prior, _, parts = graph.evaluate(u, fv, derivs=True)
        moff = (m.sum(-1) - ref_msum[rows]).contiguous()
        ll, g_mt, H_mt = vgh_op(ps, graph.strides, rows, idx, t, m, mask,
                                inv_ref, moff, outlier)
        g, H = graph.gradient(u, fv, parts, g_mt, H_mt)
        return -(ll + prior), g, H

    return value_many, vgh


def _leaf_kind(compiled):
    """'sum', 'reparam', 'ancillary', 'unbinned' or 'binned': how a
    compiled likelihood holds its dataset (see :func:`_ad_lanes`)."""
    if getattr(compiled, 'children', None) is not None:
        return 'sum'
    if getattr(compiled, 'child', None) is not None:
        return 'reparam'
    if not compiled.has_data:
        return 'ancillary'
    return 'binned' if compiled.is_binned else 'unbinned'


def _ad_device(compiled, data):
    """A dataset on the compiled likelihood's device: a Sum's tuple of its
    children's, a ReParam its child's, an unbinned likelihood's ``(ps,
    mask, center)`` as given, a count tensor (B, *bins) as (B, n_bins) in
    the working dtype."""
    kind = _leaf_kind(compiled)
    if kind == 'sum':
        return tuple(_ad_device(c, d)
                     for c, d in zip(compiled.children, data))
    if kind == 'reparam':
        return _ad_device(compiled.child, data)
    if kind == 'unbinned':
        return data
    d = torch.as_tensor(data, dtype=compiled.dtype, device=compiled.device)
    return d.reshape(d.shape[0], -1)


def _ad_batch(compiled, data):
    """The toy count B of a dataset (:func:`_ad_device`)."""
    kind = _leaf_kind(compiled)
    if kind == 'sum':
        return _ad_batch(compiled.children[0], data[0])
    if kind == 'reparam':
        return _ad_batch(compiled.child, data)
    return (data[1] if kind == 'unbinned' else data).shape[0]


def _ad_lanes(compiled, data, idx):
    """The toys ``idx`` (L,) of a dataset, in its structure; an unbinned
    likelihood's become ``(ps, mask, (inv_ref, ref_msum))`` (ps a tensor,
    or per-source tensors of a source-wise build)."""
    kind = _leaf_kind(compiled)
    if kind == 'sum':
        return tuple(_ad_lanes(c, d, idx)
                     for c, d in zip(compiled.children, data))
    if kind == 'reparam':
        return _ad_lanes(compiled.child, data, idx)
    if kind == 'unbinned':
        ps, mask, center = data
        return (tree_map(lambda p: p[idx], ps), mask[idx],
                (center[0][idx], center[1][idx]))
    return data[idx]


def _ad_logl(compiled, params, data):
    """The log likelihood of one toy's dataset (:func:`_ad_lanes`, one
    lane) without its data constant: binned, the deviance-centered
    Poisson sum; unbinned, centered at the toy's reference
    (:func:`unbinned_center`). Pure tensor arithmetic, for ``torch.func``."""
    kind = _leaf_kind(compiled)
    if kind == 'sum':
        return sum(w * _ad_logl(c, compiled._child_params(params, i), d)
                   for i, (c, w, d) in enumerate(zip(
                       compiled.children, compiled.child_weights, data)))
    if kind == 'reparam':
        return _ad_logl(compiled.child, compiled._child_params(params), data)
    if kind == 'ancillary':
        return compiled.logl(params)
    if kind == 'unbinned':
        ps, mask, center = data
        return compiled.logl_with_data(params, ps, mask, center=center)
    return compiled.logl_with_data(params, data, include_constant=False)


def _data_constant(compiled, data):
    """(B,) float64: what :func:`_ad_logl` leaves out of each toy's log
    likelihood, the weighted sum over a Sum's children: binned, the
    data constant; unbinned, the reference value ``ref_ll``."""
    kind = _leaf_kind(compiled)
    if kind == 'sum':
        return sum(w * _data_constant(c, d) for c, w, d in zip(
            compiled.children, compiled.child_weights, data))
    if kind == 'reparam':
        return _data_constant(compiled.child, data)
    if kind == 'ancillary':
        return torch.zeros(data.shape[0], dtype=torch.float64,
                           device=data.device)
    if kind == 'unbinned':
        return data[2][2]
    return compiled.data_constant(data.to(torch.float64), batch_dims=1)


def _has_unbinned_leaf(compiled):
    kind = _leaf_kind(compiled)
    if kind == 'sum':
        return any(_has_unbinned_leaf(c) for c in compiled.children)
    if kind == 'reparam':
        return _has_unbinned_leaf(compiled.child)
    return kind == 'unbinned'


#: lanes per ``torch.func.vmap`` chunk of the autodiff engine: bounds the
#: forward-over-reverse Hessian's tangent copies of the intermediates
AD_CHUNK = 64


def _make_ad_parts(compiled, names, fixed, transform, runtime_fixed=()):
    """(value_many(u_cands, data, fv, domain=False), vgh(u, data, fv)) of
    the autodiff engine: the negated :func:`_ad_logl` of the parameters at
    u, ``data`` the lanes' datasets (:func:`_ad_lanes`, one lane a row);
    the value vmapped over lanes and candidates, (g, H) by ``torch.func``
    (``vmap`` over the lanes of ``jacfwd`` of ``grad``: forward over
    reverse), in chunks of :data:`AD_CHUNK` lanes. A point where the
    compiled logl is -inf (out of the shape bounds, unphysical) scores
    +inf; ``domain`` also returns where it is finite."""
    from torch.func import grad_and_value, jacfwd, vmap
    routing = _Routing(compiled.defaults, names, fixed, runtime_fixed)
    # the transform's tables, made outside the transforms that read them
    transform._consts(torch.zeros((), dtype=compiled.dtype,
                                  device=compiled.device))

    def objective(u, data, fv):
        x = transform.to_x(u)
        return -_ad_logl(compiled, {p: routing.value_of(p, x, fv)
                                    for p in compiled.param_names}, data)

    def g_aux(u, data, fv):
        g, f = grad_and_value(objective)(u, data, fv)
        return g, (g, f)

    # Under forward-mode AD a 0-d tensor times a Python float is float64
    # (the scalar terms: the prior, the penalty), so the outputs are cast
    # back to the working dtype
    dt = compiled.dtype

    def value_many(u_cands, data, fv, domain=False):
        per_lane = vmap(objective, in_dims=(0, None, None))
        out = vmap(per_lane, chunk_size=AD_CHUNK)(u_cands, data, fv).to(dt)
        return (out, torch.isfinite(out)) if domain else out

    def vgh(u, data, fv):
        H, (g, f) = vmap(jacfwd(g_aux, has_aux=True),
                         chunk_size=AD_CHUNK)(u, data, fv)
        return f.to(dt), g.to(dt), H.to(dt)
    return value_many, vgh


def make_toy_fitter(compiled, fixed=None, guess=None, max_iter=60, tol=1e-8,
                    engine='auto', runtime_fixed=(), polish=4,
                    kink_jumps=None):
    """Build the batched fit ``fit(data, fixed_values=None, x0=None,
    lanes=None) -> (x (B, n_floating), max_ll (B,), n_iter (B,))`` for toy
    count tensors ``data`` (B, *bins) of a binned likelihood (a compiled
    Sum: a tuple of them, one per child, (B, 0) for a dataset-free child),
    or for an unbinned one ``data = (ps (B, G, S, E), mask (B, E),
    center)`` with ``center = unbinned_center(compiled, ps, mask)``;
    ``lanes`` fits only those toys of the batch.

    :param engine: 'analytic' runs the closed form in plain torch;
      'fused' the CUDA kernels (their plain versions for CPU tensors);
      'ad' the autodiff engine (:func:`_make_ad_parts`) on any model;
      'auto' takes 'fused' on a CUDA device for every model the kernels
      take (float32, 1 <= S <= 8, K <= 4, linear morphing, and no
      allow_negative source under bb_single, whose kernels have no
      negative-expectation penalty; every unbinned model in that range, at
      any event count) and 'analytic' elsewhere; for a Sum, child by child;
      'ad' for what no closed form fits (:func:`_engine_family`). An 'ad'
      fit's data: binned counts, a Sum's tuple of its children's
      datasets, a ReParam its child's, an unbinned likelihood's ``(ps,
      mask, center)`` (a source-wise build: ps a tuple of per-source
      (B, G_s, E) tensors, :func:`unbinned_center` of them).
    :param runtime_fixed: parameter names fixed at call time; their values
      arrive as ``fixed_values`` ((R,) or (B, R), aligned with this list).
    :param kink_jumps: in-loop escape steps along each shape coordinate, or
      None for the JAX package's measured default (on for <= 2 shape
      coordinates, off above).
    :return: (fit, floating names list)
    """
    if engine not in ('auto', 'analytic', 'fused', 'ad'):
        raise NotImplementedError(
            "engine=%r is not ported (the JAX package's 'pallas' engine is "
            "the port's 'fused'); use 'analytic', 'fused', 'ad' or 'auto'"
            % (engine,))
    runtime_fixed = list(runtime_fixed)
    fixed = dict(fixed or {})
    check_fixed_in_bounds(compiled, fixed)
    for rname in runtime_fixed:
        fixed.setdefault(rname, compiled.defaults[rname])  # placeholder
    dt, dev = compiled.dtype, compiled.device
    is_sum = getattr(compiled, 'children', None) is not None

    def fixed_batch(fixed_values, B):
        if not torch.is_tensor(fixed_values):
            fixed_values = np.asarray(
                [] if fixed_values is None else fixed_values, dtype=float)
        fv = torch.as_tensor(fixed_values, dtype=dt, device=dev)
        R = len(runtime_fixed)
        return fv.reshape(fv.numel() // R if R else 1, R).expand(
            B, R).contiguous()

    def batch_of(data, lanes):
        """(data on the device, toys of the fit (L,) or None, L): binned
        counts (B, *bins), or a Sum's tuple of them, are indexed at
        ``lanes``; unbinned data is (ps, mask, center), read in place at
        ``lanes``."""
        if compiled.is_binned:
            def rows(d):
                d = torch.as_tensor(d, dtype=dt, device=dev)
                d = d.reshape(d.shape[0], -1)
                if lanes is not None:
                    d = d[torch.as_tensor(lanes, device=dev)]
                return d.contiguous()
            data = tree_map(rows, data)
            return data, None, (data[0] if is_sum else data).shape[0]
        ps, mask, center = data
        if lanes is None:
            return data, torch.arange(ps.shape[0], device=dev), ps.shape[0]
        rows = torch.as_tensor(lanes, dtype=torch.int64, device=dev)
        return data, rows, rows.shape[0]

    unbinned_leaf = _has_unbinned_leaf(compiled)

    def ad_batch(data, lanes):
        """(data on the device, its toys of the fit (L,), L)."""
        data = _ad_device(compiled, data)
        rows = (torch.arange(_ad_batch(compiled, data), device=dev)
                if lanes is None else
                torch.as_tensor(lanes, dtype=torch.int64, device=dev))
        return data, rows, rows.shape[0]

    def total_ll(fval, const):
        """max_ll from the minimized objective: float64 with an unbinned
        term (its reference value), else the working dtype."""
        ll = -fval.to(torch.float64) + const
        return ll if unbinned_leaf else ll.to(dt)

    try:
        names, fixed, transform, x0 = _floating_setup(compiled, fixed, guess)
    except NoOpimizationNecessary:
        base = dict(compiled.defaults)
        base.update(fixed)

        def fit_fixed(data, fixed_values=None, x0=None, lanes=None):
            data, rows, B = ad_batch(data, lanes)
            fv = fixed_batch(fixed_values, B)

            def one(d, f):
                return _ad_logl(compiled, dict(base, **{
                    r: f[i] for i, r in enumerate(runtime_fixed)}), d)
            lls = torch.func.vmap(one)(_ad_lanes(compiled, data, rows), fv)
            return (torch.zeros((B, 0), dtype=dt, device=dev),
                    total_ll(-lls, _data_constant(compiled, data)[rows]),
                    torch.zeros(B, dtype=torch.int64, device=dev))
        return fit_fixed, []

    family = 'ad' if engine == 'ad' else _engine_family(compiled)
    if family == 'ad':
        kernel_models = []
    elif family == 'sum':
        kernel_models = [c for c in compiled.children if c.has_data]
    else:
        kernel_models = [compiled]
        if engine == 'auto':
            engine = 'fused' if _fused_eligible(compiled) else 'analytic'
    if engine == 'fused' and dev.type == 'cuda' \
            and not all(_fused_eligible(c) for c in kernel_models):
        raise ValueError("engine='fused' on CUDA needs float32 and a model "
                         "in the kernels' range (1 <= S <= %d, K <= %d; "
                         "linear morphing; no allow_negative source under "
                         "bb_single)"
                         % (fused.MAX_SOURCES, fused.MAX_SHAPE_AXES))

    u0 = torch.as_tensor(transform.to_u_np(x0), dtype=dt, device=dev)
    kink_coords = tuple(i for i, nm in enumerate(names)
                        if nm in compiled.shape_names)
    if kink_jumps is None:
        kink_jumps = ((0.3, -0.3, 0.1, -0.1) if len(kink_coords) <= 2
                      else ())
    snap_anchors = None
    if kink_coords and getattr(compiled, 'children', None) is not None:
        snap_anchors = _sum_snap_anchors(compiled, names, kink_coords,
                                         transform)
    elif kink_coords:
        snap_anchors = _snap_anchors(compiled, names, kink_coords, transform)
    if family == 'ad':
        value_many, vgh = _make_ad_parts(compiled, names, fixed, transform,
                                         runtime_fixed)

        def fit_ad(data, fixed_values=None, x0=None, lanes=None):
            data, rows, B = ad_batch(data, lanes)
            fv = fixed_batch(fixed_values, B)
            u_start = (u0.expand(B, -1) if x0 is None else
                       transform.to_u(torch.as_tensor(x0, dtype=dt,
                                                      device=dev)))
            u, fval, it = minimize_newton(
                lambda L, c: value_many(
                    c, _ad_lanes(compiled, data, rows[L]), fv[L]),
                lambda L, v: vgh(v, _ad_lanes(compiled, data, rows[L]),
                                 fv[L]),
                u_start.contiguous(), max_iter=max_iter, tol=tol,
                polish=polish, kink_coords=kink_coords,
                kink_jumps=kink_jumps, snap_anchors=snap_anchors)
            return (transform.to_x(u),
                    total_ll(fval, _data_constant(compiled, data)[rows]), it)
        return fit_ad, names
    if family == 'sum':
        value_many, vgh = _make_sum_analytic_parts(
            compiled, names, fixed, transform, engine,
            runtime_fixed=runtime_fixed)
    else:
        make_parts = (_make_analytic_parts if family == 'binned'
                      else _make_unbinned_parts)
        value_many, vgh = make_parts(
            compiled, names, fixed, transform, use_fused=(engine == 'fused'),
            runtime_fixed=runtime_fixed)

    def fit(data, fixed_values=None, x0=None, lanes=None):
        """Fit a batch: binned counts (B, *bins) (a Sum: a tuple, one per
        child), or unbinned ``(ps (B, G, S, E), mask (B, E),
        unbinned_center(...))``; with ``lanes`` only those toys of the
        batch. Returns (x (L, n), max_ll (L,), n_iter (L,)); an unbinned
        max_ll is float64 (the centered optimum plus the float64 reference
        value)."""
        data, rows, B = batch_of(data, lanes)
        fv = fixed_batch(fixed_values, B)
        u_start = (u0.expand(B, -1) if x0 is None else
                   transform.to_u(torch.as_tensor(x0, dtype=dt, device=dev)))
        if compiled.is_binned:
            const = compiled.data_constant(data, batch_dims=1)

            def f_many(L, c):
                return value_many(c, tree_map(lambda d: d[L], data), fv[L])

            def vgh_l(L, v):
                return vgh(v, tree_map(lambda d: d[L], data), fv[L])
        else:
            const = data[2][2][rows]
            f_many = lambda L, c: value_many(c, data, rows[L], fv[L])  # noqa
            vgh_l = lambda L, v: vgh(v, data, rows[L], fv[L])          # noqa
        u, fval, it = minimize_newton(
            f_many, vgh_l, u_start.contiguous(), max_iter=max_iter, tol=tol,
            polish=polish, kink_coords=kink_coords, kink_jumps=kink_jumps,
            snap_anchors=snap_anchors)
        return transform.to_x(u), -fval.to(const.dtype) + const, it

    return fit, names


def observed_data(compiled):
    """The fitters' data of the dataset bound to ``compiled``, as a batch of
    one lane: binned, its counts (1, N); a Sum, the tuple of its
    children's, (1, 0) for a dataset-free child; a ReParam, its child's;
    unbinned, ``(ps (1, G, S, E), mask (1, E), unbinned_center(...))``
    from the bound per-event densities (source-wise: ps a tuple of
    per-source (1, G_s, E)), every event valid. Made once per compiled
    likelihood (each dataset has its own,
    :func:`blueice_tpu_torch.compile.cached_logl`)."""
    cached = compiled.__dict__.get('_observed_data')
    if cached is None:
        cached = compiled._observed_data = _observed(compiled)
    return cached


def _observed(compiled):
    kind = _leaf_kind(compiled)
    if kind == 'sum':
        return tuple(_observed(c) for c in compiled.children)
    if kind == 'reparam':
        return _observed(compiled.child)
    if kind == 'ancillary':
        return torch.zeros((1, 0), dtype=compiled.dtype,
                           device=compiled.device)
    bound = compiled.data if kind == 'binned' else compiled.ps_tensor
    if bound is None:
        raise RuntimeError("No data bound: call set_data() before compiling")
    if kind == 'binned':
        return bound.reshape(1, -1)
    if compiled.source_wise is not None:
        E = bound[0].shape[-1]
        ps = tuple(p.reshape(1, -1, E).contiguous() for p in bound)
    else:
        S, E = bound.shape[-2:]
        ps = bound.reshape(1, -1, S, E).contiguous()
    mask = torch.ones((1, E), dtype=torch.bool, device=compiled.device)
    return ps, mask, unbinned_center(compiled, ps, mask)


def _in_domain(graph, x, fv, m):
    """Where the compiled logl of ``graph``'s likelihood is not -inf, as
    :meth:`~blueice_tpu_torch.compile.CompiledLogLikelihood.logl_with_data`
    decides: every shape parameter within its bounds and the expectations
    ``m`` (..., S) (:meth:`_ParamGraph.values` at the clipped shape point)
    physical. x (..., n) -> (...) bool."""
    c = graph.compiled
    ok = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    for sp in graph.shape_names:
        z = graph.value_of(sp, x, fv)
        lo, hi = c.bounds[sp]
        ok = ok & (z >= lo) & (z <= hi)
    ok = ok & (m < float('inf')).all(-1)
    if not c.allowed_negative.any():
        return ok & (m >= 0).all(-1)
    return ok & (m.sum(-1) >= 0) & ~((m < 0) & graph.strict).any(-1)


def x_space_ops(compiled, names, fixed=None, runtime_fixed=(),
                engine='auto'):
    """The fit engine's ops of ``compiled`` in the floating parameters x
    themselves (an identity :class:`Transform`, u = x), so the clip slopes
    are the ones :meth:`_ParamGraph.values` matches to JAX's derivatives:
    ``(value(x (L, A, n), data, fv (L, R), domain=False) -> (L, A),
    vgh(x (L, n), data, fv) -> (f, g, H))``.

    ``value`` and ``f`` are the negated objective the fitters minimize:
    without the binned data constant, and for an unbinned likelihood
    centered (:func:`unbinned_center`); g and H are its gradient and
    Hessian in x. With ``domain``, ``value`` also returns where the
    compiled logl is finite (:func:`_in_domain`): the ops score a point
    out of the shape bounds at its clipped cell, so a caller masks those
    candidates after. ``data`` is one of the fitters' datasets, lane i of
    an unbinned one on toy i. The ops are the fitter's own: the CUDA
    kernel wrappers where ``engine`` takes them (as
    :func:`make_toy_fitter`), the plain versions elsewhere, and the
    autodiff engine for what no closed form fits (:func:`_engine_family`)
    or with ``engine='ad'``; there ``value`` is -inf-aware by itself (a
    point out of the domain scores +inf)."""
    family = 'ad' if engine == 'ad' else _engine_family(compiled)
    runtime_fixed = list(runtime_fixed)
    fixed = dict(fixed or {})
    for rname in runtime_fixed:
        fixed.setdefault(rname, compiled.defaults[rname])  # placeholder
    identity = make_transform([(None, None)] * len(names))
    if family == 'ad':
        value_ad, vgh_ad = _make_ad_parts(compiled, names, fixed, identity,
                                          runtime_fixed)

        def lanes_of(x, data):
            data = _ad_device(compiled, data)
            return _ad_lanes(compiled, data,
                             torch.arange(x.shape[0], device=x.device))

        def value(x, data, fv, domain=False):
            return value_ad(x, lanes_of(x, data), fv, domain)

        def vgh(x, data, fv):
            return vgh_ad(x, lanes_of(x, data), fv)
        return value, vgh
    if family == 'sum':
        return _make_sum_analytic_parts(compiled, names, fixed, identity,
                                        engine, runtime_fixed)
    use_fused = engine == 'fused' or (engine == 'auto'
                                      and _fused_eligible(compiled))
    if family == 'binned':
        return _make_analytic_parts(compiled, names, fixed, identity,
                                    use_fused, runtime_fixed)
    value_rows, vgh_rows = _make_unbinned_parts(
        compiled, names, fixed, identity, use_fused, runtime_fixed)

    def lanes(x):
        return torch.arange(x.shape[0], device=x.device)

    def value(x, data, fv, domain=False):
        return value_rows(x, data, lanes(x), fv, domain)

    def vgh(x, data, fv):
        return vgh_rows(x, data, lanes(x), fv)
    return value, vgh


def fit_single(compiled, fixed=None, guess=None, return_errors=True,
               max_iter=250, tol=1e-8):
    """Fit the dataset bound to a compiled likelihood, as a batch of one
    lane (:func:`observed_data`).

    :return: ({name: bestfit, name_error: parabolic error}, max
      loglikelihood), the bestfit_* return convention. The errors are
      sqrt(diag(inv(H))), H the Hessian in x of the negated logl at the
      optimum, from the fitter's own vgh op (:func:`x_space_ops`: on the
      card the vgh kernel).

    Fixed-parameter values enter at run time, so the conditional fits of an
    interval scan share one fitter, cached on the compiled likelihood per
    fixed-name set, guess, ``max_iter``, ``tol`` and ``return_errors``. The
    generous default budget serves ridge-shaped many-nuisance profiles
    (XENON-style), which use ~150-200 damped-Newton and polish iterations.
    """
    fixed = dict(fixed or {})
    unknown = set(fixed) - set(compiled.param_names)
    if unknown:
        raise ValueError("Unknown fixed parameters: %s" % sorted(unknown))
    fixed_names = tuple(sorted(fixed))
    cache = compiled.__dict__.setdefault('_fit_single_cache', {})
    key = (fixed_names, tuple(sorted((guess or {}).items())), max_iter, tol,
           return_errors)
    if key not in cache:
        fit, names = make_toy_fitter(compiled, guess=guess, max_iter=max_iter,
                                     tol=tol, runtime_fixed=fixed_names)
        vgh = (x_space_ops(compiled, names, runtime_fixed=fixed_names)[1]
               if names and return_errors else None)
        cache[key] = (fit, names, vgh) if names else None
    if cache[key] is None:
        return {}, float(compiled(**fixed))

    fit, names, vgh = cache[key]
    data = observed_data(compiled)
    fv = torch.as_tensor([[float(fixed[n]) for n in fixed_names]],
                         dtype=compiled.dtype, device=compiled.device)
    x, ll, _ = fit(data, fv)
    x_host = x[0].double().cpu().numpy()
    results = OrderedDict((name, float(x_host[i]))
                          for i, name in enumerate(names))
    if return_errors:
        H = vgh(x, data, fv)[2][0].double().cpu().numpy()
        try:
            errs = np.sqrt(np.clip(np.diag(np.linalg.inv(H)), 0, None))
        except np.linalg.LinAlgError:
            errs = np.full(len(names), np.nan)
        for i, name in enumerate(names):
            results[name + '_error'] = float(errs[i])
    return results, float(ll[0])


def make_batch_fitter(compiled, fixed=None, guess=None, max_iter=60, tol=1e-8):
    """A batched fitter over toy datasets:
    ``fit(data_batch, mask_batch=None) -> (x (B, n), max_ll (B,), n_iter
    (B,))``, and the floating names. ``data_batch``: binned counts
    (B, *bins) (a Sum: a tuple, one per child); unbinned, the per-event
    densities (B, G, S, E) with the event mask (B, E) (None: every event
    valid). The batch is the fitter's own leading axis."""
    fit_toys, names = make_toy_fitter(compiled, fixed, guess, max_iter, tol)
    dt, dev = compiled.dtype, compiled.device

    def fit(data_batch, mask_batch=None):
        if _leaf_kind(compiled) != 'unbinned':
            return fit_toys(data_batch)
        if compiled.source_wise is not None:
            ps = tuple(torch.as_tensor(p, dtype=dt, device=dev).contiguous()
                       for p in data_batch)
            B, E = ps[0].shape[0], ps[0].shape[-1]
        else:
            ps = torch.as_tensor(data_batch, dtype=dt,
                                 device=dev).contiguous()
            B, E = ps.shape[0], ps.shape[-1]
        mask = (torch.ones((B, E), dtype=torch.bool, device=dev)
                if mask_batch is None else
                torch.as_tensor(mask_batch, dtype=torch.bool,
                                device=dev).contiguous())
        return fit_toys((ps, mask, unbinned_center(compiled, ps, mask)))
    return fit, names
