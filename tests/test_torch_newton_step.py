"""The Newton step's two CUDA kernels (``ops/newton_step.py``,
``csrc/newton_step.cu``) and the rule that picks them.

On the CPU: the rule (the kernels on every CUDA device, in float32 or
float64, for any number of coordinates, kinks, jumps and snaps; the PyTorch
step on the CPU; a clear error for another dtype on the card or a
coordinate outside the fit), the table's layout decoded on the host
against the PyTorch step's candidates, the ``newton.step_torch`` count of
the CPU path, and the kernel path's wiring (lanes, write-back, counters)
with the PyTorch step standing in for the two kernels.

On the card (marker ``cuda``; ``python -m pytest
tests/test_torch_newton_step.py -m cuda --noconftest``; this file imports
no jax): the kernels against the PyTorch step on synthetic batches at n =
1, 2, 3, 4, 5, 8 and 16 (a lane in registers) and 17 and 20 (a lane in the
workspace, where the PyTorch step solves by LU) in float32 and float64,
with and without kinks, jumps and snaps, past the old fixed table (10
jumps, 300 anchors), indefinite and singular Hessians, non-finite g, H and
values, ties among the values; then 4,096-toy binned and unbinned profiles
with the kernels and with the PyTorch step. Tolerances: the candidates
within 1e-4 (float32) or 1e-10 (float64) of each lane's largest
|candidate| (the solves' sums run in another order; everything around them
rounds as the PyTorch ops do), the rescue branch's candidates equal; the
accept kernel's integer and boolean state, u and f equal, lam within 1e-5
(float32) or 1e-12 (float64) relative (the predicted decrease's sums).
"""

import numpy as np
import pytest
import torch

from blueice_tpu_torch.examples import xenon_like
from blueice_tpu_torch.ops import newton_step
from blueice_tpu_torch.parallel import BinnedToyStudy, UnbinnedToyStudy
from blueice_tpu_torch.parallel import fitter
from blueice_tpu_torch.utils import progress, set_progress

TARGET = 'wimp_rate_multiplier'
TINY = dict(n_cs1_bins=4, n_cs2_bins=3, livetime_days=5.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device('cuda')


def _snaps(n, coords, rng, k=3):
    """(coordinate, sorted u-space anchors) for each of ``coords``."""
    return [(c, np.sort(rng.normal(0.0, 1.0, k)) + 0.01 * np.arange(k))
            for c in coords]


#: Steps a fit can take: (n, kink coordinates, jumps, snapped coordinates,
#: anchors a snap)
STEPS = {'n1': (1, (0,), (0.3, -0.3, 0.1, -0.1), (0,), 3),
         'n2_jumps': (2, (0, 1), (0.3, -0.3, 0.1, -0.1), (), 3),
         'n3_snaps': (3, (0, 2), (0.3, -0.3), (0, 2), 3),
         'n4_snap': (4, (1, 3), (0.1, -0.1), (3,), 3),
         'n5_plain': (5, (), (), (), 3),
         'n8_xenon': (8, (4, 5, 6, 7), (), (4, 5, 6, 7), 3),
         'n16': (16, tuple(range(0, 16, 3)), (0.1,), (3, 9), 3),
         'n17': (17, tuple(range(0, 17, 4)), (0.1, -0.1), (4, 16), 3),
         'n20_plain': (20, (), (), (), 3),
         'wide': (6, tuple(range(6)), tuple(0.05 * (i + 1) for i in range(10)),
                  tuple(range(6)), 50)}


def _step(case, seed=0):
    n, kinks, jumps, snapped, k = STEPS[case]
    return n, kinks, jumps, _snaps(n, snapped, np.random.default_rng(seed),
                                   k)


# -- the rule and the table, on the CPU ---------------------------------------

@pytest.mark.parametrize("case,expected", [
    ('card', True), ('card_float64', True), ('n1', True), ('n16', True),
    ('cpu', False), ('n17', True), ('float16', 'raises'), ('jumps9', True),
    ('anchors257', True), ('coord_outside', 'raises')])
def test_the_rule_keeps_the_torch_step_outside_the_kernels_range(case,
                                                                 expected):
    """The kernels' range is every fit on the card: the PyTorch step runs
    on the CPU alone, and a fit on the card the kernels cannot take (a
    dtype but float32 and float64, a kink or snap coordinate outside the
    fit) raises rather than run elsewhere."""
    n, kinks, jumps, snaps = _step('n8_xenon')
    device, dtype = 'cuda', torch.float32
    if case == 'card_float64':
        dtype = torch.float64
    if case == 'cpu':
        device = 'cpu'
    if case == 'float16':
        dtype = torch.float16
    if case in ('n1', 'n16', 'n17'):
        n = int(case[1:])
        kinks = tuple(range(n))
        snaps = []
    if case == 'jumps9':
        jumps = tuple(0.1 * (i + 1) for i in range(9))
    if case == 'anchors257':
        snaps = [(4, np.linspace(-1.0, 1.0, 257))]
    if case == 'coord_outside':
        kinks = kinks + (n,)
    if case == 'float16':
        with pytest.raises(ValueError, match="takes float32 or float64"):
            fitter._step_kernel_eligible(device, dtype)
        return
    assert fitter._step_kernel_eligible(device, dtype) is (expected
                                                          is not False)
    if expected == 'raises':
        with pytest.raises(ValueError, match="no Newton step over"):
            newton_step.build_table(n, kinks, jumps, snaps)
    elif expected:
        table = newton_step.build_table(n, kinks, jumps, snaps)
        assert (table.n, table.n_drop, table.n_jump) == (n, len(kinks),
                                                         len(jumps))
        assert table.snap_off[-1] == sum(len(a) for _, a in snaps)


def _diagonal_batch(n, snaps, L, seed):
    """u (L, n) with some snapped coordinates on an anchor, g (L, n), a
    positive diagonal H (L, n, n) and lam (L,), float64."""
    rng = np.random.default_rng(seed)
    u = rng.normal(0.0, 1.0, (L, n))
    for c, a in snaps:
        rows = rng.random(L) < 0.4
        u[rows, c] = rng.choice(a, size=rows.sum())
    g = rng.normal(0.0, 2.0, (L, n))
    h = rng.uniform(0.5, 5.0, (L, n))
    lam = 10.0 ** rng.uniform(-6, 1, L)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    return t(u), t(g), torch.diag_embed(t(h)), t(lam)


def _layout(d):
    """The table ``d``'s candidates as the kernels write them, one entry each,
    in order: ``('alpha', fraction)``, ``('drop', coordinate)``, ``('jump',
    step, coordinate)``, ``('snap', coordinate, anchors)``, ``('active',)``
    (``csrc/newton_step.cu`` newton_cands_kernel)."""
    drops = list(d.drop_coord[:d.n_drop])
    out = [('alpha', a) for a in d.alphas]
    out += [('drop', c) for c in drops]
    out += [('jump', j, c) for j in d.jumps[:d.n_jump] for c in drops]
    out += [('snap', d.snap_coord[s],
             list(d.anchors[d.snap_off[s]:d.snap_off[s + 1]]))
            for s in range(d.n_snap)]
    if d.n_snap:
        out.append(('active',))
    return out


def _decoded(table, u, g, H, lam):
    """The candidates (L, A, n) a table's layout names, computed on the host
    from its numbers alone, for a diagonal positive H: the Newton step is
    -g / (h (1 + lam)) coordinate by coordinate, and so is each reduced
    system's, with a snapped or frozen coordinate's step 0."""
    u, g, lam = u.numpy(), g.numpy(), lam.numpy()[:, None]
    h = np.diagonal(H.numpy(), axis1=1, axis2=2)
    du = -g / (h * (1.0 + lam))
    act = np.ones_like(u)
    out = []
    for entry in _layout(table):
        kind = entry[0]
        if kind == 'alpha':
            out.append(u + entry[1] * du)
        elif kind == 'drop':
            c = u + du
            c[:, entry[1]] = u[:, entry[1]]
            out.append(c)
        elif kind == 'jump':
            c = u.copy()
            c[:, entry[2]] += entry[1]
            out.append(c)
        elif kind == 'snap':
            ci, anchors = entry[1], np.asarray(entry[2])
            dist = np.abs(anchors[None, :] - u[:, ci:ci + 1])
            c = u + du
            c[:, ci] = anchors[np.argmin(dist, axis=1)]
            out.append(c)
            act[dist.min(axis=1) < 1e-6, ci] = 0.0
        else:
            out.append(u + du * act)
    return np.stack(out, axis=1)


@pytest.mark.parametrize("case", list(STEPS))
def test_the_table_layout_decodes_to_the_torch_steps_candidates(case):
    n, kinks, jumps, snaps = _step(case, seed=1)
    table = newton_step.build_table(n, kinks, jumps, snaps)
    consts = fitter._StepConsts(n, kinks, jumps, snaps, torch.float64,
                                torch.device('cpu'))
    u, g, H, lam = _diagonal_batch(n, snaps, 64, seed=2)
    cands = fitter._step_candidates(consts, u, g, H, lam)
    assert cands.shape == (64, table.A, n)
    assert len(_layout(table)) == table.A
    assert table.n_drop == consts.n_drop == len(kinks)
    np.testing.assert_allclose(cands.numpy(), _decoded(table, u, g, H, lam),
                               rtol=1e-12, atol=1e-12)


def test_the_tables_numbers():
    n, kinks, jumps, snaps = _step('n3_snaps')
    d = newton_step.build_table(n, kinks, jumps, snaps)
    assert (d.n, d.n_drop, d.n_jump, d.n_snap) == (3, 2, 2, 2)
    assert d.A == 3 + 2 * (1 + 2) + 2 + 1
    assert list(d.alphas) == list(newton_step.ALPHAS)
    assert list(d.drop_coord[:2]) == [0, 2]
    assert list(d.jumps[:2]) == [0.3, -0.3]
    assert list(d.snap_coord[:2]) == [0, 2]
    assert list(d.snap_off[:3]) == [0, 3, 6]
    assert list(d.anchors[:6]) == list(snaps[0][1]) + list(snaps[1][1])
    # the kernels' table on the device: the same numbers in that order
    assert d.tab.dtype == torch.float64 and d.tab.device.type == 'cpu'
    assert d.tab.tolist() == (list(newton_step.ALPHAS) + [0, 2, 0.3, -0.3]
                              + [0, 2] + [0, 3, 6] + list(snaps[0][1])
                              + list(snaps[1][1]))
    # no kinks: the three fractions and nothing else
    assert newton_step.build_table(4, (), (0.3,), []).A == 3


@pytest.fixture(scope='module')
def xenon_lf():
    set_progress(False)
    return xenon_like.build_likelihood('binned', **TINY)


def _traced_profile(study, seed=2, n_toys=6):
    progress.take()
    progress.set_tracing(True)
    try:
        out = study.profile_ts(seed, n_toys, TARGET, 1.0)
    finally:
        progress.set_tracing(False)
    return out, progress.take()


def test_the_cpu_path_counts_each_step(xenon_lf):
    """``newton.step_torch`` once per Newton step (each ``newton.step``
    span), ``newton.solve`` inside them; no ``newton.step_kernel`` on the
    CPU."""
    _, got = _traced_profile(BinnedToyStudy(xenon_lf, device='cpu',
                                            max_iter=20))
    steps = sum(s.name == 'newton.step' for s in got['spans'])
    assert steps > 0
    assert got['counters']['newton.step_torch'] == steps
    assert 'newton.step_kernel' not in got['counters']
    assert any(s.name == 'newton.solve' for s in got['spans'])


def _stand_ins(monkeypatch):
    """The kernel path on the CPU: the rule admits every fit, and the two
    wrappers are the PyTorch step at the lanes (``newton_cands``) and its
    result scattered into the batch state (``newton_accept``), the
    contract the kernels keep."""
    def consts(table, like):
        snaps = [(e[1], np.asarray(e[2])) for e in _layout(table)
                 if e[0] == 'snap']
        return fitter._StepConsts(
            table.n, list(table.drop_coord[:table.n_drop]),
            list(table.jumps[:table.n_jump]), snaps, like.dtype, like.device)

    def cands(table, lanes, u, lam, g, H):
        assert lanes.dtype == torch.int64 and g.is_contiguous()
        return fitter._step_candidates(
            consts(table, u), u[lanes], fitter._finite_or_zero(g),
            fitter._finite_or_zero(H), lam[lanes])

    def accept(table, lanes, fs, cands, g, H, state, tol, ftol, polish):
        u, f, lam, nu, it, done, stall, pc, rounds, improved = state
        L = lanes
        g, H = fitter._finite_or_zero(g), fitter._finite_or_zero(H)
        best, f_try, u_try = fitter._pick_best(fs, cands)
        out = fitter._step_update(g, H, u[L], f[L], lam[L], nu[L], it[L],
                                  stall[L], rounds[L], best, f_try, u_try,
                                  table.n_drop, tol, ftol, polish)
        u[L], f[L], lam[L], nu[L] = out['u'], out['f'], out['lam'], out['nu']
        it[L], done[L], stall[L] = out['it'], out['done'], out['stall']
        pc[L] = torch.where(out['pc_enter'], torch.zeros_like(pc[L]), pc[L])
        improved[L] = False

    monkeypatch.setattr(fitter, '_step_kernel_eligible', lambda *a: True)
    monkeypatch.setattr(newton_step, 'newton_cands', cands)
    monkeypatch.setattr(newton_step, 'newton_accept', accept)


@pytest.mark.parametrize("unbinned", [False, True])
def test_the_kernel_path_writes_back_what_the_torch_step_scatters(
        xenon_lf, monkeypatch, unbinned):
    """Profiles on the kernel path, the PyTorch step standing in for the
    kernels, equal the PyTorch path's bit for bit: the lanes, the state the
    accept kernel writes and the polish lanes' write-back are wired as the
    PyTorch path's scatter. Each step is counted ``newton.step_kernel``,
    and the kernel path enters no ``newton.scatter`` but the polish
    lanes'."""
    if unbinned:
        lf = xenon_like.build_likelihood('unbinned', livetime_days=0.2)
        make = lambda: UnbinnedToyStudy(lf, device='cpu',  # noqa: E731
                                        max_iter=20)
    else:
        make = lambda: BinnedToyStudy(xenon_lf, device='cpu',  # noqa: E731
                                      max_iter=20)
    (t_ref, free_ref, _), got_ref = _traced_profile(make(), n_toys=5)
    _stand_ins(monkeypatch)
    (t, free, _), got = _traced_profile(make(), n_toys=5)
    assert np.array_equal(np.asarray(t), np.asarray(t_ref))
    assert np.array_equal(free.n_iter, free_ref.n_iter)
    steps = sum(s.name == 'newton.step' for s in got['spans'])
    assert steps == got_ref['counters']['newton.step_torch'] > 0
    assert got['counters']['newton.step_kernel'] == steps
    assert 'newton.step_torch' not in got['counters']
    scatters = sum(s.name == 'newton.scatter' for s in got['spans'])
    assert scatters == sum(s.name == 'newton.polish' for s in got['spans'])


# -- the kernels on the card --------------------------------------------------

#: Lanes of a synthetic batch by what their Hessian is
KINDS = ('spd', 'indefinite', 'singular', 'nonfinite')


def _batch(n, snaps, dtype, device, L=512, seed=0):
    """A synthetic step at L lanes of a batch of 2 L: lanes ``lanes`` (every
    other row, reversed), the state u and lam, and per lane g and H by
    ``KINDS`` (cycled): SPD; indefinite (a negative diagonal entry that the
    damping does not lift); singular (a zero row and column); SPD with a
    non-finite entry in g and one in H. Some snapped coordinates sit on an
    anchor."""
    rng = np.random.default_rng(seed)
    B = 2 * L
    u = rng.normal(0.0, 1.0, (B, n))
    for c, a in snaps:
        rows = rng.random(B) < 0.3
        u[rows, c] = rng.choice(a, size=rows.sum())
    lam = 10.0 ** rng.uniform(-6, 0, B)
    g = rng.normal(0.0, 3.0, (L, n))
    M = rng.normal(0.0, 1.0, (L, n, n))
    H = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    kind = np.arange(L) % len(KINDS)
    for i in np.flatnonzero(kind == 1):
        j = rng.integers(n)
        H[i, j, j] = -50.0 * n
    for i in np.flatnonzero(kind == 2):
        j = rng.integers(n)
        H[i, j, :] = H[i, :, j] = 0.0
    for i in np.flatnonzero(kind == 3):
        g[i, rng.integers(n)] = [np.nan, np.inf, -np.inf][i % 3]
        H[i, rng.integers(n), rng.integers(n)] = [np.inf, np.nan][i % 2]

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device).contiguous()
    lanes = t(np.arange(B)[::2][::-1].copy(), torch.int64)
    return lanes, t(u), t(lam), t(g), t(H), kind


def _lane_gap(a, b):
    """Each lane's largest |a - b| over its largest |b| (at least 1)."""
    scale = b.abs().flatten(1).max(1).values.clamp(min=1.0)
    return ((a - b).abs().flatten(1).max(1).values / scale)


def _cands_both(case, dtype, device, seed=0):
    n, kinks, jumps, snaps = _step(case, seed)
    table = newton_step.build_table(n, kinks, jumps, snaps, device)
    consts = fitter._StepConsts(n, kinks, jumps, snaps, dtype, device)
    lanes, u, lam, g, H, kind = _batch(n, snaps, dtype, device, seed=seed)
    got = newton_step.newton_cands(table, lanes, u, lam, g, H)
    ref = fitter._step_candidates(consts, u[lanes], fitter._finite_or_zero(g),
                                  fitter._finite_or_zero(H), lam[lanes])
    torch.cuda.synchronize()
    return table, consts, (lanes, u, lam, g, H, kind), got, ref


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(STEPS))
def test_the_candidates_kernel_matches_the_torch_step(cuda_device, case,
                                                      dtype):
    table, _, (lanes, u, lam, g, H, kind), got, ref = _cands_both(
        case, dtype, cuda_device)
    assert got.shape == ref.shape == (lanes.shape[0], table.A, table.n)
    assert torch.isfinite(got).all() and torch.isfinite(ref).all()
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    gap = _lane_gap(got, ref)
    assert float(gap.max()) <= tol, float(gap.max())
    # indefinite lanes (4 <= n <= 16: the Cholesky factor fails in both)
    # take the rescue, which both form op by op: their Newton candidates
    # agree bit for bit
    if 4 <= table.n <= newton_step.REGISTER_N:
        rescue = torch.as_tensor(kind == 1, device=cuda_device)
        assert torch.equal(got[rescue, :3], ref[rescue, :3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ['n2_jumps', 'n3_snaps', 'n8_xenon', 'n16',
                                  'n17', 'wide'])
def test_the_accept_kernel_matches_the_torch_step(cuda_device, case, dtype):
    """The same candidates and values through both: values with ties,
    NaN, +inf and -inf entries and all-non-finite rows; a state with every
    stop rule's inputs spread (iterations, stalls, polish rounds, damping
    from 1e-12 to 1e9)."""
    table, _, (lanes, u, lam, g, H, _), cands, _ = _cands_both(
        case, dtype, cuda_device, seed=3)
    rng = np.random.default_rng(4)
    L, B, A = lanes.shape[0], u.shape[0], table.A
    dev = cuda_device

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=dev).contiguous()
    f = rng.normal(0.0, 1.0, B)
    fs = f[lanes.cpu().numpy()][:, None] + rng.normal(0.0, 1e-2, (L, A))
    fs[:, 0] += np.where(rng.random(L) < 0.3, -1e-5, 0.0)
    for i in range(0, L, 7):
        fs[i, rng.integers(A)] = fs[i, rng.integers(A)] = fs[i].min() - 0.01
    for i in range(1, L, 5):
        fs[i, rng.integers(A)] = [np.nan, np.inf, -np.inf][i % 3]
    fs[2::11] = np.nan
    state = [u.clone(), t(f), t(10.0 ** rng.uniform(-12, 9, B)),
             t(2.0 ** rng.integers(1, 7, B)),
             t(rng.integers(0, 7, B), torch.int64),
             t(np.zeros(B, bool), torch.bool),
             t(rng.integers(0, 5, B), torch.int64),
             t(-np.ones(B), torch.int64),
             t(rng.integers(0, 6, B), torch.int64),
             t(rng.random(B) < 0.5, torch.bool)]
    fs = t(fs)
    tol, ftol, polish = 1e-8, (1e-3 if dtype == torch.float32 else 1e-10), 4
    ref = [x.clone() for x in state]
    newton_step.newton_accept(table, lanes, fs, cands, g, H, state, tol,
                              ftol, polish)
    u_r, f_r, lam_r, nu_r, it_r, done_r, stall_r, pc_r, rounds_r, imp_r = ref
    Lx = lanes
    gs, Hs = fitter._finite_or_zero(g), fitter._finite_or_zero(H)
    best, f_try, u_try = fitter._pick_best(fs, cands)
    out = fitter._step_update(gs, Hs, u_r[Lx], f_r[Lx], lam_r[Lx], nu_r[Lx],
                              it_r[Lx], stall_r[Lx], rounds_r[Lx], best,
                              f_try, u_try, table.n_drop, tol, ftol, polish)
    u_r[Lx], f_r[Lx], lam_r[Lx], nu_r[Lx] = (out['u'], out['f'], out['lam'],
                                             out['nu'])
    it_r[Lx], done_r[Lx], stall_r[Lx] = out['it'], out['done'], out['stall']
    pc_r[Lx] = torch.where(out['pc_enter'], torch.zeros_like(pc_r[Lx]),
                           pc_r[Lx])
    imp_r[Lx] = False
    torch.cuda.synchronize()
    names = ('u', 'f', 'lam', 'nu', 'it', 'done', 'stall', 'pc', 'rounds',
             'improved')
    for name, a, b in zip(names, state, ref):
        if name == 'lam':
            rtol = 1e-5 if dtype == torch.float32 else 1e-12
            assert torch.allclose(a, b, rtol=rtol, atol=0.0), name
        else:
            assert torch.equal(a, b), name
    # the mix exercised every branch
    assert out['done'].any() and out['pc_enter'].any()
    assert (out['f'] < f_r.new_tensor(f)[Lx]).any()
    assert (~torch.isfinite(f_try)).any()


def _profiles(monkeypatch, make, seed, n_toys):
    """t and the iteration counts of one profile on the kernels and one on
    the PyTorch step (the rule refusing every fit), on the same toys."""
    out = {}
    for kernels in (True, False):
        if not kernels:
            monkeypatch.setattr(fitter, '_step_kernel_eligible',
                                lambda *a: False)
        before = newton_step.newton_cands.launches
        t, free, cond = make().profile_ts(seed, n_toys, TARGET, 1.0)
        torch.cuda.synchronize()
        assert (newton_step.newton_cands.launches > before) is kernels
        out[kernels] = (np.asarray(t),
                        np.concatenate([free.n_iter, cond.n_iter]))
    return out[True], out[False]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ['binned', 'unbinned'])
def test_profiles_on_the_kernels_match_the_torch_step(cuda_device,
                                                      monkeypatch, kind):
    """A 4,096-toy profile of the full xenon model (binned) or the unbinned
    XENON model at 3 live days, on the step kernels and on the PyTorch
    step, the same toys. The two solve in other orders, so a fit's Newton
    path may take another step and stop elsewhere within its float32 stop
    rule: t within 2e-3 for at least 99.5% of the toys, the mean iteration
    count within 2%."""
    set_progress(False)
    if kind == 'binned':
        lf = xenon_like.build_likelihood('binned')
        make = lambda: BinnedToyStudy(lf)  # noqa: E731
    else:
        lf = xenon_like.build_likelihood('unbinned', livetime_days=3.0)
        make = lambda: UnbinnedToyStudy(lf)  # noqa: E731
    (t_k, it_k), (t_p, it_p) = _profiles(monkeypatch, make, 11, 4096)
    assert np.isfinite(t_k).all()
    share = np.mean(np.abs(t_k - t_p) <= 2e-3)
    assert share >= 0.995, share
    assert abs(it_k.mean() / it_p.mean() - 1) <= 0.02

