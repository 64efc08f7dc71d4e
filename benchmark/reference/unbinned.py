"""Plain PyTorch reference of an extended unbinned likelihood of Gaussian
blob sources, and of its profile fits, worked out from a configuration file
alone.

It imports neither JAX nor the program under test, nor the binned
reference: the templates, the density at an event, the anchor-grid
morphing, the rates, the constraints and the fits are written out here
again from the configuration's definition (``configs/unbinned_xenon.json``
says what each key means).

* :class:`UnbinnedModel` holds the anchor payloads (per anchor point: each
  source's density per bin and its expected events), scores event sets
  (:meth:`~UnbinnedModel.score`: every anchor's density at every event) and
  evaluates the log likelihood of a batch of lanes, each at its own
  parameter point, toy and anchor cell.
* :func:`profile_fits` maximises it per toy, free and with the target
  fixed, in every anchor cell (the morph is piecewise multilinear: inside a
  cell the likelihood is smooth, across a cell face it has a kink), by a
  projected Newton method with the cell as its box, and keeps each fit's
  best cell.

The log likelihood is the program's: ``-sum_s mu_s + sum over the toy's
valid events of log sum_s mu_s p_s(event)`` (no ``log n!``, as blueice's
``UnbinnedLogLikelihood`` leaves it out), an event whose summed density is
not positive scoring ``outlier_likelihood`` in its place, plus each normal
constraint's full log density ``-z^2 / 2 - log sigma - log(2 pi) / 2``. The
program reports the same total: its fits run centred on each toy's value at
the defaults and add that back in float64, so no centring appears here.

The reference computes in float64. ``storage=torch.bfloat16`` makes the
lower-precision control: the anchor payloads rounded to bfloat16, every
operation in float32.

As the unbinned likelihood kind (``benchmark/README.md``, "Adding a
likelihood kind") it gives the harness :func:`build`, the event sets of one
call (:func:`sampler`: a Poisson count of events a toy, each in a bin drawn
by its expected count at the truth, uniform inside it) and the judged rows
of them as the reference's data (:func:`take`, :func:`join`).
"""

import itertools
import math

import numpy as np
import torch

__all__ = ['UnbinnedModel', 'profile_fits', 'maximize', 'build', 'sampler',
           'take', 'join']

#: The blob source's shape settings and the response key that scales each;
#: any other shape parameter must be the efficiency, which scales the rates
#: of the sources that apply it
BLOB_SETTINGS = {'band_shift': 'band_shift_response',
                 'band_width_scale': 'width_response',
                 'cs1_tilt': 'tilt_response'}
BLOB_BASE = {'band_shift': 0.0, 'band_width_scale': 1.0, 'cs1_tilt': 0.0}
#: Bytes of a block's scored densities and its lanes' gathered corner
#: densities (the autograd Hessian keeps a few tensors of that size besides)
BLOCK_BYTES = 2 ** 30


def blob_density(source, settings, centers, volumes):
    """(density per bin, fraction of the blob inside the space) of a
    correlated 2D Gaussian blob whose position and width move with the
    shape settings through the source's responses: each bin's mass (the
    density at its centre times its volume), normalised over the space,
    over the bin's volume."""
    x, y = np.meshgrid(*centers, indexing='ij')
    mx, my = source['blob_mean']
    sx, sy = source['blob_sigma']
    rho = source['blob_corr']
    my = my + settings['band_shift'] * source['band_shift_response']
    sy = sy * (1.0 + (settings['band_width_scale'] - 1.0)
               * source['width_response'])
    mx = mx + settings['cs1_tilt'] * source['tilt_response']
    dx = (x - mx) / sx
    dy = (y - my) / sy
    norm = 1.0 / (2 * np.pi * sx * sy * np.sqrt(1 - rho ** 2))
    dens = norm * np.exp(-(dx ** 2 - 2 * rho * dx * dy + dy ** 2)
                         / (2 * (1 - rho ** 2)))
    mass = dens * volumes
    total = mass.sum()
    return mass / total / volumes, min(float(total), 1.0)


class UnbinnedModel:
    """The configuration's extended unbinned likelihood on ``device``.

    Parameters are addressed by the program's names:
    ``<source>_rate_multiplier`` for each rate parameter, then the shape
    parameters, in the configuration's order (:attr:`names`)."""

    def __init__(self, config, device='cpu', storage=torch.float64):
        if config.get('likelihood') != 'unbinned':
            raise ValueError("the reference takes unbinned likelihoods")
        if config.get('source_model') != 'gaussian_blob':
            raise ValueError("unknown source model %r"
                             % config.get('source_model'))
        if config.get('pdf_interpolation_method', 'linear') != 'linear':
            raise ValueError("the reference interpolates 'linear' only")
        if config.get('statistical_uncertainty') is not None:
            raise ValueError("an unbinned likelihood has no finite-MC "
                             "adjustment")
        if len(config['analysis_space']) != 2:
            raise ValueError("the blob sources span a 2D space")
        self.device = torch.device(device)
        self.storage = storage
        self.dtype = (torch.float64 if storage == torch.float64
                      else torch.float32)
        edges = [np.linspace(float(lo), float(hi), int(n) + 1)
                 for _, lo, hi, n in config['analysis_space']]
        self.bin_shape = tuple(len(e) - 1 for e in edges)
        centers = [0.5 * (e[1:] + e[:-1]) for e in edges]
        volumes = np.multiply.outer(*[np.diff(e) for e in edges])
        sources = config['sources']
        S = len(sources)
        livetime = float(config['livetime_days'])
        self.n_max = int(config['n_max'])
        self.outlier = float(config['outlier_likelihood'])

        self.rate_names = ['%s_rate_multiplier' % r['source']
                           for r in config['rate_parameters']]
        shapes = config['shape_parameters']
        self.shape_names = [p['name'] for p in shapes]
        self.names = self.rate_names + self.shape_names
        R, K = len(self.rate_names), len(shapes)
        eff = config.get('efficiency_parameter')
        for p in shapes:
            if p['name'] not in BLOB_SETTINGS and p['name'] != eff:
                raise ValueError("shape parameter %r is neither a blob "
                                 "setting nor the efficiency" % p['name'])
        self.anchors = [np.asarray(p['anchors'], dtype=float) for p in shapes]
        base = {p['name']: float(p['base']) for p in shapes}

        # the anchor grid in C order: every source's density per bin and
        # its expected events
        grid = list(itertools.product(*self.anchors))
        G, N = len(grid), int(np.prod(self.bin_shape))
        dens = np.empty((G, S, N))
        mus = np.empty((G, S))
        for g, point in enumerate(grid):
            settings = dict(BLOB_BASE)
            settings.update(base)
            settings.update(zip(self.shape_names, point))
            for s, src in enumerate(sources):
                d, frac = blob_density(src, settings, centers, volumes)
                dens[g, s] = d.ravel()
                mus[g, s] = float(src['events_per_day']) * livetime * frac

        def stored(a):
            t = torch.as_tensor(a, dtype=torch.float64, device=self.device)
            return t.to(storage).to(self.dtype)
        self.dens = stored(dens)                            # (G, S, N)
        self.mus = stored(mus)                              # (G, S)
        self.S, self.N, self.G, self.R, self.K = S, N, G, R, K

        def f64(a):
            return torch.as_tensor(a, dtype=torch.float64, device=self.device)
        self._edges = [f64(e) for e in edges]
        self._centers = [f64(c) for c in centers]
        self._volumes = f64(volumes.ravel())
        self._bin_strides = [self.bin_shape[1], 1]

        # which parameter multiplies each source's rate
        rate_of = {r['source']: i for i, r in enumerate(
            config['rate_parameters'])}
        self.rate_index = [rate_of.get(s['name'], -1) for s in sources]
        self.eff_index = (R + self.shape_names.index(eff)
                          if eff in self.shape_names else -1)
        self.apply_eff = [bool(s.get('apply_efficiency', False))
                          for s in sources]
        self.priors = []
        for i, r in enumerate(config['rate_parameters']):
            if r.get('normal_prior'):
                self.priors.append((i,) + tuple(r['normal_prior']))
        for k, p in enumerate(shapes):
            if p.get('normal_prior'):
                self.priors.append((R + k,) + tuple(p['normal_prior']))
        self.defaults = np.array([1.0] * R + [base[n]
                                              for n in self.shape_names])
        self.lo = np.array([0.0] * R + [a[0] for a in self.anchors])
        self.hi = np.array([np.inf] * R + [a[-1] for a in self.anchors])
        self._anchor_t = [torch.as_tensor(a, dtype=self.dtype,
                                          device=self.device)
                          for a in self.anchors]
        # a cell's corners: per corner, its offset from the lower corner's
        # flat anchor id, and which axes it takes the upper anchor on
        sizes = [len(a) for a in self.anchors]
        strides = [int(np.prod(sizes[k + 1:])) for k in range(K)]
        bits = list(itertools.product((0, 1), repeat=K))
        self._upper = torch.as_tensor(bits, dtype=torch.bool,
                                      device=self.device).reshape(-1, K)
        self._offsets = torch.as_tensor(
            [sum(b * st for b, st in zip(c, strides)) for c in bits],
            dtype=torch.int64, device=self.device)
        self._grid_strides = torch.as_tensor(strides, dtype=torch.int64,
                                             device=self.device)

    # -- the density at an event --------------------------------------------

    def score(self, coords):
        """(T, G, S, E) density of each anchor's sources at the events
        ``coords`` (T, E, 2), every slot (the likelihood applies the mask):
        per axis the two bin centres around the event, the coordinate
        clipped to the outermost centres, and the four centres' densities
        weighted multilinearly."""
        coords = torch.as_tensor(coords, dtype=torch.float64,
                                 device=self.device)
        T, E = coords.shape[:2]
        lower, frac = [], []
        for d, c in enumerate(self._centers):
            x = torch.clamp(coords[..., d], c[0], c[-1]).contiguous()
            i = torch.clamp(torch.searchsorted(c, x, right=True) - 1,
                            0, len(c) - 2)
            lower.append(i)
            frac.append((x - c[i]) / (c[i + 1] - c[i]))
        out = None
        for o0, o1 in itertools.product((0, 1), repeat=2):
            flat = ((lower[0] + o0) * self._bin_strides[0]
                    + (lower[1] + o1) * self._bin_strides[1]).reshape(-1)
            w = ((frac[0] if o0 else 1 - frac[0])
                 * (frac[1] if o1 else 1 - frac[1])).to(self.dtype)
            term = self.dens[:, :, flat].reshape(self.G, self.S, T, E) * w
            out = term if out is None else out + term
        return out.permute(2, 0, 1, 3)

    # -- the likelihood -----------------------------------------------------

    def cells_of(self, X):
        """(L, K) anchor cells that hold the points X (L, P): the lower
        anchor's index, the last cell for a point on the last anchor."""
        cols = []
        for k, a in enumerate(self._anchor_t):
            x = X[:, self.R + k].to(a.dtype).contiguous()
            c = torch.searchsorted(a, x, right=True) - 1
            cols.append(torch.clamp(c, 0, len(a) - 2))
        if not cols:
            return torch.zeros((X.shape[0], 0), dtype=torch.int64,
                               device=X.device)
        return torch.stack(cols, -1)

    def corners(self, X, C):
        """(ids (L, 2^K), weights (L, 2^K)): the flat anchor ids of the
        corners of the cells C around the points X, and each corner's
        morph weight, linear in each shape parameter inside the cell."""
        L = X.shape[0]
        ids = ((C * self._grid_strides).sum(-1, keepdim=True)
               + self._offsets)
        w = torch.ones((L, len(self._offsets)), dtype=X.dtype,
                       device=X.device)
        for k, a in enumerate(self._anchor_t):
            c = C[:, k]
            t = ((X[:, self.R + k] - a[c]) / (a[c + 1] - a[c]))[:, None]
            w = w * torch.where(self._upper[:, k], t, 1 - t)
        return ids, w

    def rates(self, X, ids, w):
        """(L, S) expected events of each source at the points X: the
        corners' expectations morphed, times the rate multipliers and the
        efficiency where a source applies it."""
        M = torch.einsum('lc,lcs->ls', w, self.mus[ids])
        mult = []
        for s in range(self.S):
            m = (X[:, self.rate_index[s]] if self.rate_index[s] >= 0
                 else torch.ones_like(X[:, 0]))
            if self.apply_eff[s] and self.eff_index >= 0:
                m = m * X[:, self.eff_index]
            mult.append(m)
        return M * torch.stack(mult, -1)

    def loglik(self, X, C, scored, mask, toy):
        """(L,) float64 log likelihood of each lane at X (L, P) in the
        cells C, lane l on the toy ``toy[l]`` of the toys' anchor densities
        ``scored`` (T, G, S, E) (:meth:`score`) and valid events ``mask``
        (T, E)."""
        ids, w = self.corners(X, C)
        m = self.rates(X, ids, w)
        P = torch.einsum('lc,lcse->lse', w, scored[toy[:, None], ids])
        lam = torch.einsum('ls,lse->le', m, P)
        lam = torch.where(lam > 0, lam, torch.full_like(lam, self.outlier))
        logs = torch.where(mask[toy], torch.log(lam), torch.zeros_like(lam))
        ll = logs.sum(-1) - m.sum(-1)
        for i, mu, s in self.priors:
            z = (X[:, i] - mu) / s
            ll = ll - 0.5 * z * z - math.log(s) - 0.5 * math.log(2 * math.pi)
        return ll.to(torch.float64)

    def expected(self, X):
        """(L, N) expected events per bin at the points X (L, P)."""
        ids, w = self.corners(X, self.cells_of(X))
        m = self.rates(X, ids, w)
        P = torch.einsum('lc,lcsn->lsn', w, self.dens[ids])
        return torch.einsum('ls,lsn->ln', m, P) * self._volumes.to(P.dtype)

    def loglik_at(self, x, data):
        """(T,) float64 log likelihood at points x (T, P) of the event sets
        ``data`` (:func:`take`: coords (T, E, 2), mask (T, E)), each in the
        cell that holds it."""
        coords, mask = data
        mask = torch.as_tensor(mask, device=self.device)
        X = torch.as_tensor(np.asarray(x, dtype=float), dtype=self.dtype,
                            device=self.device)
        out = []
        with torch.no_grad():
            for b in self.blocks(X.shape[0], coords.shape[1], 1):
                toy = torch.arange(b.stop - b.start, device=self.device)
                out.append(self.loglik(X[b], self.cells_of(X[b]),
                                       self.score(coords[b]),
                                       mask[b], toy))
        return torch.cat(out).cpu().numpy()

    def blocks(self, T, E, lanes):
        """Slices of T toys of E event slots, ``lanes`` lanes a toy, each
        block's scored densities and its lanes' gathered corners within
        :data:`BLOCK_BYTES`."""
        row = self.S * E * torch.finfo(self.dtype).bits // 8
        per_toy = row * (self.G + lanes * len(self._offsets))
        per = max(1, BLOCK_BYTES // per_toy)
        return [slice(i, min(T, i + per)) for i in range(0, T, per)]


# -- the fits ---------------------------------------------------------------

def _value_grad_hess(value, X, lanes, free):
    X = X.detach().requires_grad_(True)
    f = value(X, lanes)
    g, = torch.autograd.grad(f.sum(), X, create_graph=True)
    rows = []
    for p in range(X.shape[1]):
        if bool(free[:, p].any()):
            h, = torch.autograd.grad(g[:, p].sum(), X, retain_graph=True)
        else:
            h = torch.zeros_like(X)
        rows.append(h)
    H = torch.stack(rows, 1)
    return f.detach(), g.detach(), H.detach()


#: Newton iterations a lane may take, and the predicted rise under which
#: it stops (log-likelihood units; float64 resolves ~1e-12 at |ll| ~ 4e3)
MAX_ITER = 100
TOL = 1e-10


def maximize(value, X0, free, lo, hi):
    """Projected Newton ascent of each lane's log likelihood
    ``value(X, lanes)`` ((len(lanes),) at the points X of those lanes)
    inside its box [lo, hi] (L, P), over its free coordinates ``free`` (L,
    P) bool: a coordinate at a face with its gradient pointing out is held;
    the others take the Newton step of their block (eigenvalues of -H
    floored, so a non-concave block still ascends), cut by halves until the
    value rises. A lane stops when the predicted rise falls under
    :data:`TOL` or no step raises its value. Returns (x, f, iterations)."""
    X = torch.minimum(torch.maximum(X0, lo), hi)
    L, P = X.shape
    every = torch.arange(L, device=X.device)
    f, g, H = _value_grad_hess(value, X, every, free)
    iters = torch.zeros(L, dtype=torch.int64, device=X.device)
    active = torch.ones(L, dtype=torch.bool, device=X.device)
    eye = torch.eye(P, dtype=X.dtype, device=X.device)
    for _ in range(MAX_ITER):
        span = torch.clamp(hi - lo, max=1.0)
        at_lo = (X <= lo + 1e-12 * span) & (g < 0)
        at_hi = (X >= hi - 1e-12 * span) & (g > 0)
        F = free & ~at_lo & ~at_hi
        Ff = F.to(X.dtype)
        gF = g * Ff
        M = -H * Ff[:, :, None] * Ff[:, None, :] + eye * (1 - Ff)[:, :, None]
        M = 0.5 * (M + M.transpose(1, 2))
        ev, V = torch.linalg.eigh(M.to(torch.float64))
        floor = torch.clamp(ev.abs().amax(-1, keepdim=True) * 1e-12,
                            min=1e-300)
        ev = torch.where(ev > floor, ev, ev.abs() + floor)
        step = (V @ ((V.transpose(1, 2) @ gF.to(torch.float64)[..., None])
                     / ev[..., None]))[..., 0].to(X.dtype) * Ff
        pred = (gF * step).sum(-1).to(torch.float64)
        active &= pred > TOL
        if not bool(active.any()):
            break
        idx = torch.nonzero(active)[:, 0]
        alpha = torch.ones(len(idx), dtype=X.dtype, device=X.device)
        accepted = torch.zeros(len(idx), dtype=torch.bool, device=X.device)
        X_new = X[idx].clone()
        for _ls in range(40):
            todo = torch.nonzero(~accepted)[:, 0]
            if len(todo) == 0:
                break
            j = idx[todo]
            Xt = torch.minimum(torch.maximum(
                X[j] + alpha[todo, None] * step[j], lo[j]), hi[j])
            with torch.no_grad():
                ft = value(Xt, j)
            ok = ft > f[j]
            X_new[todo[ok]] = Xt[ok]
            accepted[todo[ok]] = True
            alpha[todo[~ok]] *= 0.5
        # a lane that no step raises is at its optimum to rounding
        active[idx[~accepted]] = False
        moved = idx[accepted]
        if len(moved) == 0:
            break
        X[moved] = X_new[accepted]
        iters[moved] += 1
        fm, gm, Hm = _value_grad_hess(value, X[moved], moved, free[moved])
        f[moved], g[moved], H[moved] = fm, gm, Hm
    return X, f, iters


def profile_fits(model, data, target, hypothesis, x_judged=None):
    """The free and the conditional (``target`` fixed at ``hypothesis``)
    maximum of each toy's log likelihood. Each fit starts in every anchor
    cell twice, at the default point moved into the cell and at the cell's
    centre, and keeps its best end. ``x_judged`` (T, 2, P), the points that
    a program under judgement returned for the two fits, adds one more
    start each, in its own cell: the ascent from it can only rise, so the
    maximum is never below the value there.

    ``data``: (coords (T, E, 2), mask (T, E)) (:func:`take`). Returns dict
    of numpy arrays: x_free (T, P), ll_free (T,), x_cond (T, P) (the
    target at the hypothesis), ll_cond, t = max(2 (ll_free - ll_cond),
    0)."""
    dev, dt = model.device, model.dtype
    coords, mask = data
    mask = torch.as_tensor(mask, device=dev)
    T, P = coords.shape[0], len(model.names)
    cells = list(itertools.product(*[range(len(a) - 1)
                                     for a in model.anchors]))
    n_c = len(cells)
    ti = model.names.index(target)
    R = model.R
    # per fit: every cell from the corner and from the centre, then the
    # judged point
    n_s = 2 * n_c + (0 if x_judged is None else 1)
    per_toy = 2 * n_s
    cell_t = torch.as_tensor(cells, dtype=torch.int64,
                             device=dev).reshape(n_c, -1)
    lo0 = torch.as_tensor(model.lo, dtype=dt, device=dev)
    hi0 = torch.as_tensor(model.hi, dtype=dt, device=dev)
    x_def = torch.as_tensor(model.defaults, dtype=dt, device=dev)
    out = {k: [] for k in ('x_free', 'll_free', 'x_cond', 'll_cond')}
    for blk in model.blocks(T, coords.shape[1], per_toy):
        scored = model.score(coords[blk])                   # (nt, G, S, E)
        m_toys = mask[blk]
        nt = scored.shape[0]
        # lanes: toy-major, then fit (free, conditional), then start
        toy = torch.arange(nt, device=dev).repeat_interleave(per_toy)
        fit = torch.arange(2, device=dev).repeat_interleave(n_s).repeat(nt)
        X0 = x_def.repeat(len(toy), 1)
        C = cell_t.repeat(2, 1)
        if x_judged is not None:
            xj = torch.as_tensor(np.asarray(x_judged)[blk], dtype=dt,
                                 device=dev)                # (nt, 2, P)
            C = torch.cat([C.repeat(nt * 2, 1).reshape(nt, 2, 2 * n_c, -1),
                           model.cells_of(xj.reshape(-1, P)).reshape(
                               nt, 2, 1, -1)], 2).reshape(len(toy), -1)
            X0.reshape(nt, 2, n_s, P)[:, :, -1] = xj
        else:
            C = C.repeat(nt * 2, 1)
        centre = torch.zeros(n_s, dtype=torch.bool, device=dev)
        centre[n_c:2 * n_c] = True
        centre = centre.repeat(2 * nt)
        lo, hi = lo0.repeat(len(toy), 1), hi0.repeat(len(toy), 1)
        for k, a in enumerate(model._anchor_t):
            lo[:, R + k] = a[C[:, k]]
            hi[:, R + k] = a[C[:, k] + 1]
            X0[centre, R + k] = 0.5 * (lo[centre, R + k] + hi[centre, R + k])
        free = torch.ones_like(X0, dtype=torch.bool)
        cond = fit == 1
        X0[cond, ti] = float(hypothesis)
        lo[cond, ti] = float(hypothesis)
        hi[cond, ti] = float(hypothesis)
        free[cond, ti] = False

        def value(X, lanes):
            return model.loglik(X, C[lanes], scored, m_toys, toy[lanes])
        X, f, _ = maximize(value, X0, free, lo, hi)
        f = f.reshape(nt, 2, n_s)
        best = f.argmax(-1)                                 # (nt, 2)
        Xr = X.reshape(nt, 2, n_s, P)
        ar = torch.arange(nt, device=dev)
        for j, key in enumerate(('free', 'cond')):
            out['x_' + key].append(Xr[ar, j, best[:, j]].to(
                torch.float64).cpu().numpy())
            out['ll_' + key].append(f[ar, j, best[:, j]].cpu().numpy())
    res = {k: np.concatenate(v) for k, v in out.items()}
    res['t'] = np.maximum(2.0 * (res['ll_free'] - res['ll_cond']), 0.0)
    return res


# -- the unbinned kind's draws and data -------------------------------------

def build(config, device='cpu', storage=torch.float64):
    """The reference model of a configuration file (:class:`UnbinnedModel`)."""
    return UnbinnedModel(config, device, storage=storage)


def sampler(model, truth, toys, device, dtype):
    """The draw of one call's event sets at the point ``truth`` (P,) in
    :attr:`~UnbinnedModel.names` order: ``draw(generator)`` gives
    ``(coords (toys, n_max, 2) float64, mask (toys, n_max) bool, bins
    (toys, n_max, 2) int64)`` on ``device``. A toy's count of events is
    Poisson in the expected total, clipped at ``n_max``; every slot's bin
    is drawn by the expected events per bin (inverse of their float64
    cumulative sum) and its point uniform inside the bin; the slots past
    the count are masked out. ``dtype`` (the program's) is not used: the
    coordinates are float64 whatever the program computes in."""
    device = torch.device(device)
    X = torch.as_tensor(np.asarray(truth, dtype=float)[None],
                        dtype=torch.float64, device=model.device)
    with torch.no_grad():
        per_bin = torch.clamp(model.expected(X)[0].to(torch.float64), min=0)
    cdf = torch.cumsum(per_bin, 0).to(device)
    total = cdf[-1]
    edges = [e.to(device) for e in model._edges]
    n1 = model.bin_shape[1]
    n_max = model.n_max
    slots = torch.arange(n_max, device=device)

    def draw(generator):
        n = torch.poisson(total.expand(toys).contiguous(),
                          generator=generator)
        mask = slots[None, :] < torch.clamp(n, max=n_max)[:, None]
        u = torch.rand((toys, n_max), generator=generator,
                       dtype=torch.float64, device=device)
        flat = torch.clamp(torch.searchsorted(cdf, u * total, right=True),
                           max=cdf.shape[0] - 1)
        bins = torch.stack([flat // n1, flat % n1], -1)
        v = torch.rand((toys, n_max, 2), generator=generator,
                       dtype=torch.float64, device=device)
        coords = torch.stack(
            [e[bins[..., d]] + v[..., d] * (e[bins[..., d] + 1]
                                            - e[bins[..., d]])
             for d, e in enumerate(edges)], -1)
        return coords, mask, bins
    return draw


def take(datasets, rows):
    """The event sets ``rows`` of one call's as the reference's data:
    (coords (len(rows), n_max, 2) float64, mask (len(rows), n_max))."""
    coords, mask, _ = datasets
    idx = torch.as_tensor(rows, device=coords.device)
    return coords[idx].double(), mask[idx]


def join(parts):
    """The reference's data of several :func:`take` parts, in order."""
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
