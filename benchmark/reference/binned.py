"""Plain PyTorch reference of a binned template likelihood and of its
profile fits, worked out from a configuration file alone.

It imports neither JAX nor the program under test: the templates, the
anchor-grid morphing, the rates, the constraints, the Beeston-Barlow
adjustment and the fits are written out here again from the configuration's
definition (the configuration files under ``benchmark/configs/`` say what
each key means).

* :class:`BinnedModel` holds the anchor payloads (per anchor point: each
  source's pmf over the bins, its expected events, and the MC counts behind
  the finite-statistics source) and evaluates the log likelihood of a batch
  of lanes, each at its own parameter point, dataset and anchor cell.
* :func:`profile_fits` maximises it per dataset, free and with the target
  fixed, in every anchor cell (the morph is piecewise multilinear: inside a
  cell the likelihood is smooth, across a cell face it has a kink), by a
  projected Newton method with the cell as its box, and keeps each fit's
  best cell. The optimum may lie on a face (a kink): the box then holds it.

The reference computes in float64. ``storage=torch.bfloat16`` makes the
lower-precision control: the anchor payloads rounded to bfloat16, every
operation in float32.

As the binned likelihood kind (``benchmark/README.md``, "Adding a likelihood
kind") it also gives the harness :func:`build`, the datasets of one call
(:func:`sampler`: Poisson counts per bin at the truth) and the judged rows
of them as the reference's data (:func:`take`, :func:`join`).
"""

import itertools
import math

import numpy as np
import torch

__all__ = ['BinnedModel', 'profile_fits', 'BLOB_SETTINGS', 'build',
           'sampler', 'take', 'join']

#: The blob source's shape settings and the response key that scales each
#: (see the configuration files); any other shape parameter must be the
#: efficiency, which scales the rates of the sources that apply it.
BLOB_SETTINGS = {'band_shift': 'band_shift_response',
                 'band_width_scale': 'width_response',
                 'cs1_tilt': 'tilt_response'}
BLOB_BASE = {'band_shift': 0.0, 'band_width_scale': 1.0, 'cs1_tilt': 0.0}


def _edges(axis):
    name, lo, hi, n = axis
    return name, np.linspace(float(lo), float(hi), int(n) + 1)


def blob_pmf(source, settings, centers, volumes):
    """(pmf over the bins, fraction of the density inside the space) of a
    correlated 2D Gaussian blob whose position and width move with the
    shape settings through the source's responses."""
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
    return mass / total, min(float(total), 1.0)


class BinnedModel:
    """The configuration's binned likelihood on ``device``.

    Parameters are addressed by the program's names:
    ``<source>_rate_multiplier`` for each rate parameter, then the shape
    parameters, in the configuration's order (:attr:`names`)."""

    def __init__(self, config, device='cpu', storage=torch.float64):
        if config.get('likelihood') != 'binned':
            raise ValueError("the reference takes binned likelihoods")
        if config.get('source_model') != 'gaussian_blob':
            raise ValueError("unknown source model %r"
                             % config.get('source_model'))
        self.device = torch.device(device)
        self.storage = storage
        self.dtype = (torch.float64 if storage == torch.float64
                      else torch.float32)
        names, edges = zip(*[_edges(a) for a in config['analysis_space']])
        self.bin_shape = tuple(len(e) - 1 for e in edges)
        centers = [0.5 * (e[1:] + e[:-1]) for e in edges]
        widths = [np.diff(e) for e in edges]
        volumes = np.multiply.outer(*widths) if len(widths) == 2 else widths[0]
        sources = config['sources']
        self.source_names = [s['name'] for s in sources]
        S = len(sources)
        livetime = float(config['livetime_days'])

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
        self.base = {p['name']: float(p['base']) for p in shapes}

        # the anchor grid in C order: every source's pmf, rate and MC counts
        grid = list(itertools.product(*self.anchors))
        G, N = len(grid), int(np.prod(self.bin_shape))
        pmf = np.empty((G, S, N))
        mus = np.empty((G, S))
        mc = np.empty((G, S, N))
        for g, point in enumerate(grid):
            settings = dict(BLOB_BASE)
            settings.update(self.base)
            settings.update(zip(self.shape_names, point))
            for s, src in enumerate(sources):
                p, frac = blob_pmf(src, settings, centers, volumes)
                pmf[g, s] = p.ravel()
                mus[g, s] = float(src['events_per_day']) * livetime * frac
                mc[g, s] = np.maximum(p.ravel() * float(src['n_mc_events']),
                                      1e-3)

        bb = config.get('statistical_uncertainty')
        self.bb_i = None
        if bb is not None:
            if bb.get('mode') != 'bb_single':
                raise ValueError("the reference takes bb_single only")
            self.bb_i = self.source_names.index(bb['source'])

        def stored(a):
            t = torch.as_tensor(a, dtype=torch.float64, device=self.device)
            return t.to(storage).to(self.dtype)
        self.pmf = stored(pmf.reshape(G, S * N))
        self.mus = stored(mus)
        self.mc = None if self.bb_i is None else stored(mc[:, self.bb_i])
        self.S, self.N, self.G, self.R, self.K = S, N, G, R, K

        # which parameter multiplies each source's rate
        rate_of = {r['source']: i for i, r in enumerate(
            config['rate_parameters'])}
        self.rate_index = [rate_of.get(n, -1) for n in self.source_names]
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
        self.defaults = np.array([1.0] * R + [self.base[n]
                                              for n in self.shape_names])
        self.lo = np.array([0.0] * R + [a[0] for a in self.anchors])
        self.hi = np.array([np.inf] * R + [a[-1] for a in self.anchors])
        self._anchor_t = [torch.as_tensor(a, dtype=self.dtype,
                                          device=self.device)
                          for a in self.anchors]

    # -- the likelihood ---------------------------------------------------

    def cells_of(self, X):
        """(L, K) anchor cells that hold the points X (L, P): the lower
        anchor's index, the last cell for a point on the last anchor."""
        cols = []
        for k, a in enumerate(self._anchor_t):
            x = X[:, self.R + k].to(a.dtype).contiguous()
            c = torch.searchsorted(a, x, right=True) - 1
            cols.append(torch.clamp(c, 0, len(a) - 2))
        return torch.stack(cols, -1)

    def weights(self, X, C):
        """(L, G) morph weights of the points X inside the cells C: per axis
        the two anchors of the cell, linear in the parameter inside it."""
        W = None
        for k, a in enumerate(self._anchor_t):
            c = C[:, k]
            lo, hi = a[c], a[c + 1]
            t = (X[:, self.R + k] - lo) / (hi - lo)
            n = len(a)
            wk = ((1 - t)[:, None] * torch.nn.functional.one_hot(c, n)
                  + t[:, None] * torch.nn.functional.one_hot(c + 1, n))
            W = wk if W is None else (W[:, :, None] * wk[:, None, :]).reshape(
                W.shape[0], -1)
        if W is None:
            W = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
        return W

    def expected(self, X, C, counts=None):
        """(L, N) expected counts per bin of the lanes; where the model has
        a finite-statistics source and ``counts`` (L, N) are given, that
        source Beeston-Barlow-adjusted to them."""
        W = self.weights(X, C)
        L = X.shape[0]
        M = W @ self.mus                                    # (L, S)
        P = (W @ self.pmf).reshape(L, self.S, self.N)       # (L, S, N)
        mult = []
        for s in range(self.S):
            m = (X[:, self.rate_index[s]] if self.rate_index[s] >= 0
                 else torch.ones_like(X[:, 0]))
            if self.apply_eff[s] and self.eff_index >= 0:
                m = m * X[:, self.eff_index]
            mult.append(m)
        q = M * torch.stack(mult, -1)
        if self.bb_i is None or counts is None:
            return torch.einsum('ls,lsn->ln', q, P)
        i = self.bb_i
        others = torch.ones(self.S, dtype=q.dtype, device=q.device)
        others[i] = 0
        u = torch.einsum('ls,lsn->ln', q * others, P)
        a = W @ self.mc                                     # (L, N)
        n_mc = a.sum(-1, keepdim=True)
        p_cal = q[:, i:i + 1] / n_mc
        w_cal = torch.where(a > 0, P[:, i] / torch.where(a > 0, a, 1) * n_mc,
                            torch.zeros_like(a))
        p = torch.where(w_cal > 0, w_cal * p_cal, torch.ones_like(a))
        A = bb_root(a, p, u, counts)
        A = torch.where(u == 0, (counts + a) / (1 + p_cal), A)
        A = torch.where(w_cal > 0, A, torch.zeros_like(A))
        return u + A * w_cal * p_cal

    def loglik(self, X, C, counts, const):
        """(L,) log likelihood of each lane: the Poisson terms in deviance
        form plus ``const`` (L,) (:meth:`data_constant`, float64), plus the
        normal constraints."""
        mu = self.expected(X, C, counts)
        d = counts
        ratio = torch.where(d > 0, mu / torch.where(d > 0, d, 1),
                            torch.ones_like(mu))
        dev = torch.xlogy(d, ratio) - (mu - d)
        ll = dev.sum(-1)
        for i, m, s in self.priors:
            z = (X[:, i] - m) / s
            ll = ll - 0.5 * z * z - math.log(s) - 0.5 * math.log(2 * math.pi)
        return ll.to(torch.float64) + const

    @staticmethod
    def data_constant(counts):
        """(L,) the parameter-free part of each lane's Poisson log
        likelihood, sum of d log d - d - lgamma(d + 1), in float64."""
        d = counts.to(torch.float64)
        return (torch.xlogy(d, d) - d - torch.lgamma(d + 1)).sum(-1)

    def loglik_at(self, x, counts):
        """(L,) float64 log likelihood at points x (L, P) of datasets counts
        (L, N), each in the cell that holds it."""
        X = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        d = torch.as_tensor(counts, device=self.device).to(self.dtype)
        with torch.no_grad():
            return self.loglik(X, self.cells_of(X), d,
                               self.data_constant(d)).cpu().numpy()


def bb_root(a, p, U, d):
    """The non-negative root x of p(p+1) x^2 + (U(p+1) - p(a+d)) x - U a = 0,
    the Beeston-Barlow profiled MC expectation of one bin (MC counts a,
    data/MC ratio p, other sources' expectation U, data d), in the form
    without cancellation for either sign of the linear coefficient."""
    A2 = p * (p + 1)
    b = U * (p + 1) - p * (a + d)
    s = torch.sqrt(b * b + 4 * A2 * U * a)
    pos = b >= 0
    num = torch.where(pos, 2 * U * a, s - b)
    den = torch.where(pos, b + s, 2 * A2)
    return num / torch.where(den > 0, den, torch.ones_like(den))


# -- the fits ---------------------------------------------------------------

def _value_grad_hess(model, X, C, d, const, free):
    X = X.detach().requires_grad_(True)
    f = model.loglik(X, C, d, const)
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
#: Lanes (toys x fits x starts) fitted together: bounds the autograd
#: graph's memory (~10 GB on the card at the XENON shape)
LANES_PER_BLOCK = 2048


def maximize(model, X0, C, d, const, free, lo, hi):
    """Projected Newton ascent of each lane's log likelihood inside its box
    [lo, hi] (L, P), over its free coordinates ``free`` (L, P) bool: a
    coordinate at a face with its gradient pointing out is held; the others
    take the Newton step of their block (eigenvalues of -H floored, so a
    non-concave block still ascends), cut by halves until the value rises.
    A lane stops when the predicted rise falls under :data:`TOL` or no
    step raises its value. Returns (x, f, iterations)."""
    X = torch.minimum(torch.maximum(X0, lo), hi)
    L, P = X.shape
    f, g, H = _value_grad_hess(model, X, C, d, const, free)
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
                ft = model.loglik(Xt, C[j], d[j], const[j])
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
        fm, gm, Hm = _value_grad_hess(model, X[moved], C[moved], d[moved],
                                      const[moved], free[moved])
        f[moved], g[moved], H[moved] = fm, gm, Hm
    return X, f, iters


def profile_fits(model, counts, target, hypothesis, x_judged=None):
    """The free and the conditional (``target`` fixed at ``hypothesis``)
    maximum of each dataset's log likelihood. Each fit starts in every
    anchor cell twice, at the default point moved into the cell and at the
    cell's centre (near an anchor the Beeston-Barlow likelihood has sharp
    features that hold an ascent from the corner), and keeps its best end.
    ``x_judged`` (T, 2, P), the points that a program under judgement
    returned for the two fits, adds one more start each, in its own cell:
    the ascent from it can only rise, so the maximum is never below the
    value there.

    ``counts``: (T, N). Returns dict of numpy arrays: x_free (T, P),
    ll_free (T,), x_cond (T, P) (the target at the hypothesis), ll_cond,
    t = max(2 (ll_free - ll_cond), 0)."""
    dev, dt = model.device, model.dtype
    counts = torch.as_tensor(counts, device=dev).to(dt).reshape(
        -1, model.N)
    T, P = counts.shape[0], len(model.names)
    cells = list(itertools.product(*[range(len(a) - 1)
                                     for a in model.anchors]))
    n_c = len(cells)
    ti = model.names.index(target)
    R = model.R
    # per fit: every cell from the corner and from the centre, then the
    # judged point
    n_s = 2 * n_c + (0 if x_judged is None else 1)
    per_toy = 2 * n_s
    per_block = max(1, LANES_PER_BLOCK // per_toy)
    cell_t = torch.as_tensor(cells, dtype=torch.int64,
                             device=dev).reshape(n_c, -1)
    lo0 = torch.as_tensor(model.lo, dtype=dt, device=dev)
    hi0 = torch.as_tensor(model.hi, dtype=dt, device=dev)
    x_def = torch.as_tensor(model.defaults, dtype=dt, device=dev)
    out = {k: [] for k in ('x_free', 'll_free', 'x_cond', 'll_cond')}
    for b0 in range(0, T, per_block):
        d_toys = counts[b0:b0 + per_block]
        nt = d_toys.shape[0]
        # lanes: toy-major, then fit (free, conditional), then start
        toy = torch.arange(nt, device=dev).repeat_interleave(per_toy)
        fit = torch.arange(2, device=dev).repeat_interleave(n_s).repeat(nt)
        X0 = x_def.repeat(len(toy), 1)
        C = cell_t.repeat(2, 1)
        if x_judged is not None:
            xj = torch.as_tensor(np.asarray(x_judged)[b0:b0 + nt],
                                 dtype=dt, device=dev)          # (nt, 2, P)
            C = torch.cat([C.repeat(nt * 2, 1).reshape(nt, 2, 2 * n_c, -1),
                           model.cells_of(xj.reshape(-1, P)).reshape(
                               nt, 2, 1, -1)], 2).reshape(len(toy), -1)
            X0.reshape(nt, 2, n_s, P)[:, :, -1] = xj
        else:
            C = C.repeat(nt * 2, 1)
        centre = torch.zeros(n_s, dtype=torch.bool, device=dev)
        centre[n_c:2 * n_c] = True
        centre = centre.repeat(2 * nt)
        d = d_toys[toy]
        const = model.data_constant(d_toys)[toy]
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
        X, f, _ = maximize(model, X0, C, d, const, free, lo, hi)
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


# -- the binned kind's draws and data ---------------------------------------

def build(config, device='cpu', storage=torch.float64):
    """The reference model of a configuration file (:class:`BinnedModel`)."""
    return BinnedModel(config, device, storage=storage)


def sampler(model, truth, toys, device, dtype):
    """The draw of one call's datasets: ``draw(generator)`` gives ``toys``
    Poisson datasets, a (toys, *bins) tensor in ``dtype`` on ``device``, of
    the expected counts at the point ``truth`` (P,) in :attr:`names`
    order."""
    device = torch.device(device)
    X = torch.as_tensor(np.asarray(truth, dtype=float)[None],
                        dtype=torch.float64, device=model.device)
    expected = model.expected(X, model.cells_of(X))[0]
    # the expectation as the datasets' type holds it, once
    rates = torch.as_tensor(expected, device=device).to(dtype).reshape(
        1, -1).expand(toys, -1).contiguous()
    shape = (toys,) + model.bin_shape

    def draw(generator):
        return torch.poisson(rates, generator=generator).reshape(shape)
    return draw


def take(datasets, rows):
    """The datasets ``rows`` of one call's as the reference's data: (len
    (rows), N) float64 counts."""
    idx = torch.as_tensor(rows, device=datasets.device)
    return datasets[idx].reshape(len(rows), -1).double()


def join(parts):
    """The reference's data of several :func:`take` parts, in order."""
    return torch.cat(parts)
