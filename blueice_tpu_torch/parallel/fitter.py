"""Batched damped-Newton maximum-likelihood fits of a compiled binned
likelihood.

Counterpart of :mod:`blueice_tpu.parallel.fitter` (the binned closed-form
path). The JAX package writes one fit and vmaps it; here the toy batch is a
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
and for the Beeston-Barlow modes :mod:`~blueice_tpu_torch.ops.fused_bb` and
:mod:`~blueice_tpu_torch.ops.fused_bb_lite`), and is chained to u through
the tiny parameter graph with its first and second derivatives in closed
form.
"""

import numpy as np
import torch

from ..exceptions import NoOpimizationNecessary
from ..ops import fused, fused_bb, fused_bb_lite
from ..ops.binned_vgh import corner_weight_tables
from ..ops.interp import cell_index, clip

__all__ = ['Transform', 'make_transform', 'minimize_newton',
           'make_toy_fitter', 'check_fixed_in_bounds']


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
        def t(a):
            return torch.as_tensor(a, dtype=like.dtype, device=like.device)
        return (torch.as_tensor(self.kinds_np, device=like.device),
                t(self.lo_safe_np), t(self.hi_safe_np))

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
        L, info = torch.linalg.cholesky_ex(A)
        x = torch.cholesky_solve(b[..., None], L)[..., 0]
    else:
        x, info = torch.linalg.solve_ex(A, b)
    return torch.where((info == 0)[..., None], x,
                       torch.full_like(x, float('nan')))


def _damped_solve(H, g, lam):
    """-(H + lam * diag(max(|diag H|, 1e-10)))^-1 g, with its scale d."""
    d = torch.clamp(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)),
                    min=1e-10)
    return -_solve_spd_small(H + torch.diag_embed(lam[:, None] * d), g), d


def _all_finite(x):
    return torch.isfinite(x).all(dim=-1, keepdim=True)


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

    :param f_many: f_many(lanes, cands) -> (L, A) objective values at
      candidates ``cands`` (L, A, n) of the lanes ``lanes`` (L,) (an index
      tensor into the batch).
    :param vgh: vgh(lanes, u) -> (value (L,), gradient (L, n), Hessian
      (L, n, n)) at u (L, n).
    :param u0: (B, n) start points.
    :param snap_anchors: optional list, parallel to ``kink_coords``, of
      u-space anchor positions (snap-to-anchor candidates).
    :return: (u_min (B, n), f_min (B,), n_iters (B,)).
    """
    B, n = u0.shape
    dt, dev = u0.dtype, u0.device
    eye = torch.eye(n, dtype=dt, device=dev)
    if ftol is None:
        ftol = 1e-3 if dt == torch.float32 else 1e-10
    if kink_coords is None:
        kink_coords = tuple(range(n))
        drop_dirs = eye
    else:
        kink_coords = tuple(kink_coords)
        drop_dirs = (eye[list(kink_coords)] if kink_coords
                     else torch.zeros((0, n), dtype=dt, device=dev))
    n_drop = drop_dirs.shape[0]
    alphas = torch.tensor([1.0, 0.4, 0.1], dtype=dt, device=dev)
    jumps = torch.tensor(list(kink_jumps), dtype=dt, device=dev)
    snaps = ([] if snap_anchors is None else
             [(ci, torch.as_tensor(np.asarray(a), dtype=dt, device=dev))
              for ci, a in zip(kink_coords, snap_anchors)])
    polish_steps = torch.tensor(
        [0.3, -0.3, 0.1, -0.1, 0.03, -0.03, 0.01, -0.01, 3e-3, -3e-3, 1e-3,
         -1e-3, 3e-4, -3e-4, 1e-4, -1e-4, 3e-5, -3e-5, 1e-5, -1e-5],
        dtype=dt, device=dev)

    def best_of(lanes, cands):
        fs = f_many(lanes, cands)
        fs = torch.where(torch.isfinite(fs), fs,
                         torch.full_like(fs, float('inf')))
        best = torch.argmin(fs, dim=1)
        rows = torch.arange(cands.shape[0], device=dev)
        return best, fs[rows, best], cands[rows, best]

    def newton_step(lanes, u, fval, lam, nu, it, stall, rounds):
        _, g, H = vgh(lanes, u)
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        H = torch.where(torch.isfinite(H), H, torch.zeros_like(H))
        du, d = _damped_solve(H, g, lam)
        du = torch.where(_all_finite(du), du,
                         -g / (torch.clamp(lam, min=1.0)[:, None] * d))
        # Ascent proposals of an indefinite damped Hessian become a
        # curvature-scaled steepest-descent step
        du = torch.where(((g * du).sum(-1) > 0)[:, None],
                         -g / (d * (1.0 + lam)[:, None]), du)

        cands = [u[:, None, :] + alphas[None, :, None] * du[:, None, :],
                 u[:, None, :] + du[:, None, :] * (1.0 - drop_dirs)[None]]
        if jumps.numel():
            cands.append((u[:, None, None, :] + jumps[None, :, None, None]
                          * drop_dirs[None, None, :, :]).reshape(
                              u.shape[0], -1, n))
        if snaps:
            # Second-order snap: coordinate ci onto its nearest anchor, the
            # rest from the reduced Newton system under that displacement
            rows = torch.arange(u.shape[0], device=dev)
            act = torch.ones_like(u)
            for ci, au in snaps:
                dist = torch.abs(au[None, :] - u[:, ci:ci + 1])
                nearest = au[torch.argmin(dist, dim=1)]
                delta = nearest - u[:, ci]
                mask = 1.0 - eye[ci]
                gm = (g + H[:, :, ci] * delta[:, None]) * mask
                Hm = (H * (mask[:, None] * mask[None, :])
                      + torch.outer(eye[ci], eye[ci]))
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
            du_a = torch.where(_all_finite(du_a), du_a,
                               torch.zeros_like(du_a))
            cands.append((u + du_a * act)[:, None, :])
        best, f_try, u_try = best_of(lanes, torch.cat(cands, dim=1))
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
    u = u0.clone()
    f = f_many(all_lanes, u[:, None, :])[:, 0]
    lam = torch.full((B,), init_damping, dtype=dt, device=dev)
    nu = torch.full((B,), 2.0, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    stall = torch.zeros(B, dtype=torch.int64, device=dev)
    pc = torch.full((B,), -1, dtype=torch.int64, device=dev)
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    improved = torch.zeros(B, dtype=torch.bool, device=dev)

    for _ in range(max_iter):
        active = ~done & (it < max_iter)
        in_polish = pc >= 0
        lanes_n = torch.nonzero(active & ~in_polish).flatten()
        lanes_p = torch.nonzero(active & in_polish).flatten()
        if lanes_n.numel() == 0 and lanes_p.numel() == 0:
            break
        if lanes_n.numel():
            L = lanes_n
            out = newton_step(L, u[L], f[L], lam[L], nu[L], it[L], stall[L],
                              rounds[L])
            u[L], f[L], lam[L], nu[L] = out['u'], out['f'], out['lam'], out['nu']
            it[L], done[L], stall[L] = out['it'], out['done'], out['stall']
            pc[L] = torch.where(out['pc_enter'], torch.zeros_like(pc[L]), pc[L])
            improved[L] = False
        if lanes_p.numel():
            L = lanes_p
            out = polish_step(L, u[L], f[L], lam[L], nu[L], pc[L], rounds[L],
                              improved[L])
            u[L], f[L], lam[L], nu[L] = out['u'], out['f'], out['lam'], out['nu']
            it[L] = it[L] + 1
            done[L] = done[L] | out['finished']
            stall[L] = 0
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
    """(K shape params, S sources, G flattened anchor-grid size, n_bins)."""
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    ps = compiled.ps_tensor
    G = int(np.prod(ps.shape[:K])) if K else 1
    n_bins = int(np.prod(ps.shape[K + 1:]))
    return K, S, G, n_bins


def _fused_eligible(compiled):
    """Whether the CUDA kernels take this model: their instantiated range
    and type, and per mode what they compute. The bb_single kernels carry no
    negative-expectation penalty (as the reference's), so a bb_single model
    with an allow_negative source is not eligible; the plain and bb-lite
    kernels keep the penalty."""
    K, S, _, _ = _grid_dims(compiled)
    return (compiled.device.type == 'cuda'
            and compiled.dtype == torch.float32
            and 1 <= S <= fused.MAX_SOURCES
            and 0 <= K <= fused.MAX_SHAPE_AXES
            and not (compiled.has_bb and compiled.allowed_negative.any()))


def _tie_slope(v, lo, hi):
    """d/dv of ``clip(v, lo, hi)`` as JAX differentiates ``jnp.clip``
    (``minimum(maximum(v, lo), hi)``): 1 inside, 0 outside, 0.5 exactly on
    a bound."""
    one = torch.ones_like(v)
    f1 = torch.where(v > lo, one, torch.where(v == lo, 0.5 * one, 0 * one))
    vl = torch.clamp(v, min=lo)
    f2 = torch.where(vl < hi, one, torch.where(vl == hi, 0.5 * one, 0 * one))
    return f1 * f2


class _ParamGraph:
    """The tiny graph from the optimizer's u vector to the likelihood's
    natural parameters: rates m (S), lerp weights t (K) and the summed log
    prior, with its first and second derivatives in closed form.

    x = Transform(u) per coordinate; t_d = clip((clip(z_d) - lo_d) / w_d)
    is piecewise linear in the shape parameter z_d; the rates
    m_s = mus_s(t) R_s E_s are the mus anchor tensor lerped at t (multilinear)
    times the rate multiplier R_s and, for sources that apply one, the
    efficiency E_s, both linear in x. ``fv`` (..., R) holds the
    runtime-fixed values, aligned with ``runtime_fixed``.
    """

    def __init__(self, compiled, names, fixed, transform, runtime_fixed=()):
        dt, dev = compiled.dtype, compiled.device
        self.compiled, self.transform, self.fixed = compiled, transform, fixed
        self.shape_names = list(compiled.shape_names)
        self.rate_names = list(compiled.rate_names)
        self.K = K = len(self.shape_names)
        self.S = S = len(self.rate_names)
        n = len(names)
        self.name_pos = {nm: i for i, nm in enumerate(names)}
        self.rt_pos = {nm: i for i, nm in enumerate(runtime_fixed)}
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

    def value_of(self, nm, x, fv):
        """Parameter ``nm`` as a tensor of x's batch shape."""
        if nm is None:
            return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
        if nm in self.name_pos:
            return x[..., self.name_pos[nm]]
        if nm in self.rt_pos:
            return fv[..., self.rt_pos[nm]]
        v = self.fixed[nm] if nm in self.fixed else self.compiled.defaults[nm]
        return torch.full(x.shape[:-1], float(v), dtype=x.dtype,
                          device=x.device)

    def cells(self, u, fv):
        """(x, idx (..., K) lower anchor-cell indices, lo and width (..., K)
        of those cells, mus corners (..., 2^K, S)) — piecewise constant in u
        (zero derivative)."""
        x = self.transform.to_x(u)
        batch = x.shape[:-1]
        if self.K == 0:
            empty = torch.zeros(batch + (0,), dtype=x.dtype, device=x.device)
            return (x, empty.long(), empty, empty,
                    self.mus_flat.expand(batch + (1, self.S)))
        zs = [self.value_of(sp, x, fv) for sp in self.shape_names]
        idx = torch.stack([cell_index(a, clip(z, a[0], a[-1]))
                           for a, z in zip(self.arrs, zs)], dim=-1)
        lo = torch.stack([a[idx[..., d]] for d, a in enumerate(self.arrs)], -1)
        hi = torch.stack([a[idx[..., d] + 1]
                          for d, a in enumerate(self.arrs)], -1)
        return (x, idx, lo, hi - lo,
                self.mus_flat[fused.corner_ids(self.strides, idx, self.G)])

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


def _make_analytic_parts(compiled, names, fixed, transform, use_fused,
                         runtime_fixed=()):
    """(value_many(u_cands, data, fv), vgh(u, data, fv)) computing the
    negated objective from the closed-form (m, t)-derivatives chained through
    the parameter graph: transforms, rate morphing, efficiencies, priors.

    ``use_fused`` routes the heavy (ll, g, H) and value ops to the CUDA
    kernel wrappers (their plain versions on the CPU); otherwise to those
    plain versions directly (see :func:`_likelihood_ops`).
    """
    K, S, G, n_bins = _grid_dims(compiled)
    anchor = compiled.ps_tensor.reshape(G, S, n_bins).contiguous()
    graph = _ParamGraph(compiled, names, fixed, transform, runtime_fixed)
    vgh_op, ll_op = _likelihood_ops(compiled, G, S, n_bins, use_fused)

    def value_many(u_cands, data, fv):
        """Objective at candidates u_cands (L, A, n), data (L, N), fv (L, R)
        — one value-kernel launch for the line search / polish batch."""
        fvA = fv[:, None, :].expand(u_cands.shape[:2] + fv.shape[-1:])
        x, idx, lo, width, musc = graph.cells(u_cands, fvA)
        m, t, prior = graph.values(x, fvA, lo, width, musc)
        lls = ll_op(anchor, graph.strides, idx, t.contiguous(),
                    m.contiguous(), data)
        return -(lls + prior)

    def vgh(u, data, fv):
        x, idx, lo, width, musc = graph.cells(u, fv)
        m, t, prior, parts = graph.values(x, fv, lo, width, musc,
                                          derivs=True)
        ll, g_mt, H_mt = vgh_op(anchor, graph.strides, idx, t.contiguous(),
                                m.contiguous(), data)
        g, H = graph.chain(u, x, fv, musc, t, parts, g_mt, H_mt)
        return -(ll + prior), g, H

    return value_many, vgh


def make_toy_fitter(compiled, fixed=None, guess=None, max_iter=60, tol=1e-8,
                    engine='auto', runtime_fixed=(), polish=4,
                    kink_jumps=None):
    """Build the batched fit ``fit(data, fixed_values=None, x0=None)
    -> (x (B, n_floating), max_ll (B,), n_iter (B,))`` for toy count tensors
    ``data`` (B, *bins).

    :param engine: 'analytic' runs the closed form in plain torch;
      'fused' the CUDA kernels (their plain versions for CPU tensors);
      'auto' takes 'fused' on a CUDA device for every model the kernels
      take (float32, 1 <= S <= 8, K <= 4, and no allow_negative source
      under bb_single, whose kernels have no negative-expectation penalty)
      and 'analytic' elsewhere.
    :param runtime_fixed: parameter names fixed at call time; their values
      arrive as ``fixed_values`` ((R,) or (B, R), aligned with this list).
    :param kink_jumps: in-loop escape steps along each shape coordinate, or
      None for the JAX package's measured default (on for <= 2 shape
      coordinates, off above).
    :return: (fit, floating names list)
    """
    if engine not in ('auto', 'analytic', 'fused'):
        raise NotImplementedError(
            "engine=%r is not ported (the autodiff engine is ROADMAP queue 1 "
            "item 16); use 'analytic', 'fused' or 'auto'" % (engine,))
    runtime_fixed = list(runtime_fixed)
    fixed = dict(fixed or {})
    check_fixed_in_bounds(compiled, fixed)
    for rname in runtime_fixed:
        fixed.setdefault(rname, compiled.defaults[rname])  # placeholder
    dt, dev = compiled.dtype, compiled.device
    if engine == 'auto':
        engine = 'fused' if _fused_eligible(compiled) else 'analytic'
    if engine == 'fused' and dev.type == 'cuda' \
            and not _fused_eligible(compiled):
        raise ValueError("engine='fused' on CUDA needs float32 and a model "
                         "in the kernels' range (1 <= S <= %d, K <= %d; no "
                         "allow_negative source under bb_single)"
                         % (fused.MAX_SOURCES, fused.MAX_SHAPE_AXES))

    def as_batch(data):
        data = torch.as_tensor(data, dtype=dt, device=dev)
        return data.reshape(data.shape[0], -1).contiguous()

    def fixed_batch(fixed_values, B):
        if not torch.is_tensor(fixed_values):
            fixed_values = np.asarray(
                [] if fixed_values is None else fixed_values, dtype=float)
        fv = torch.as_tensor(fixed_values, dtype=dt, device=dev)
        R = len(runtime_fixed)
        return fv.reshape(fv.numel() // R if R else 1, R).expand(
            B, R).contiguous()

    try:
        names, fixed, transform, x0 = _floating_setup(compiled, fixed, guess)
    except NoOpimizationNecessary:
        base = dict(compiled.defaults)
        base.update(fixed)

        def fit_fixed(data, fixed_values=None, x0=None):
            data = torch.as_tensor(data, dtype=dt, device=dev)
            fv = fixed_batch(fixed_values, data.shape[0])
            lls = []
            for b in range(data.shape[0]):
                p = dict(base)
                p.update({r: fv[b, i] for i, r in enumerate(runtime_fixed)})
                lls.append(compiled.logl_with_data(p, data[b]))
            return (torch.zeros((data.shape[0], 0), dtype=dt, device=dev),
                    torch.stack(lls),
                    torch.zeros(data.shape[0], dtype=torch.int64, device=dev))
        return fit_fixed, []

    u0 = torch.as_tensor(transform.to_u_np(x0), dtype=dt, device=dev)
    kink_coords = tuple(i for i, nm in enumerate(names)
                        if nm in compiled.shape_names)
    if kink_jumps is None:
        kink_jumps = ((0.3, -0.3, 0.1, -0.1) if len(kink_coords) <= 2
                      else ())
    snap_anchors = None
    if kink_coords:
        shape_idx = {nm: d for d, nm in enumerate(compiled.shape_names)}
        snap_anchors = [
            transform.to_u_coord(
                ci, np.asarray(compiled.anchor_arrays[shape_idx[names[ci]]]))
            for ci in kink_coords]
    value_many, vgh = _make_analytic_parts(
        compiled, names, fixed, transform, use_fused=(engine == 'fused'),
        runtime_fixed=runtime_fixed)

    def fit(data, fixed_values=None, x0=None):
        data = as_batch(data)
        B = data.shape[0]
        fv = fixed_batch(fixed_values, B)
        const = compiled.data_constant(data, batch_dims=1)
        u_start = (u0.expand(B, -1) if x0 is None else
                   transform.to_u(torch.as_tensor(x0, dtype=dt, device=dev)))
        u, fval, it = minimize_newton(
            lambda L, c: value_many(c, data[L], fv[L]),
            lambda L, v: vgh(v, data[L], fv[L]),
            u_start.contiguous(), max_iter=max_iter, tol=tol, polish=polish,
            kink_coords=kink_coords, kink_jumps=kink_jumps,
            snap_anchors=snap_anchors)
        return transform.to_x(u), -fval + const, it

    return fit, names
