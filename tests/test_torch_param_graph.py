"""The parameter graph's two CUDA kernels (``ops/param_graph.py``,
``csrc/param_graph.cu``) and the rule that picks them.

On the CPU: the rule (the CUDA kernel wrappers on a CUDA device, float32,
1 <= K <= 4, 1 <= S <= 8, Normal priors; the PyTorch graph for everything
else), the kernels' tables against the fit's parameter routing for every
kind of parameter, and the ``graph.torch`` count of the CPU path.

On the card (marker ``cuda``; ``python -m pytest
tests/test_torch_param_graph.py -m cuda --noconftest``; this file imports no
jax): the kernels against the PyTorch graph at the same u, on synthetic
graphs over K = 1-4 and S = 1-8 (every transform kind, fixed, runtime-fixed
and efficiency-routed parameters, the live time, priors on fixed
parameters, z on an anchor, on each clip bound and off the grid) and on the
xenon, xenon_bb, bb-lite, unbinned, include-livetime and Sum-child models;
then 4,096-toy xenon and xenon_bb profiles with the kernels and with the
PyTorch graph. Tolerances: idx equal; t, m and the prior within 1e-6 of
their scale (the forward kernel rounds as the PyTorch ops do); g and H
within 1e-5 of each lane's largest entry (other summation orders).
"""

import types

import numpy as np
import pytest
import torch

from blueice_tpu_torch.compile import build_logl
from blueice_tpu_torch.examples import xenon_like
from blueice_tpu_torch.ops import param_graph
from blueice_tpu_torch.parallel import BinnedToyStudy, fitter
from blueice_tpu_torch.priors import NormalPrior, UniformPrior
from blueice_tpu_torch.utils import progress, set_progress

TARGET = 'wimp_rate_multiplier'
TINY = dict(n_cs1_bins=4, n_cs2_bins=3, livetime_days=5.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device('cuda')


def _stub(device='cuda', dtype=torch.float32, K=4, S=6, prior=NormalPrior,
          anchors=None, mus=None, base_livetime=None, apply_eff=None,
          seed=0):
    """What the graph reads of a compiled likelihood: S sources
    ``r0_rate_multiplier``..., K shape parameters ``z0``... (the last one
    the efficiency of the sources ``apply_eff`` marks), their anchors
    (sorted, 2-5 a parameter) and the mus anchor tensor."""
    rng = np.random.default_rng(seed)
    shape_names = ['z%d' % k for k in range(K)]
    rate_names = ['r%d_rate_multiplier' % s for s in range(S)]
    if anchors is None:
        anchors = [np.sort(rng.normal(0, 1, rng.integers(2, 6)))
                   for _ in range(K)]
        anchors = [a + np.arange(len(a)) * 0.05 for a in anchors]
    grid = tuple(len(a) for a in anchors)
    if mus is None:
        mus = rng.uniform(0.5, 20.0, grid + (S,))
    if apply_eff is None:
        apply_eff = np.arange(S) % 2 == 1
    defaults = dict({nm: 1.0 for nm in rate_names},
                    **{nm: float(np.mean(a))
                       for nm, a in zip(shape_names, anchors)})
    bounds = dict({nm: (0.0, np.inf) for nm in rate_names},
                  **{nm: (float(a[0]), float(a[-1]))
                     for nm, a in zip(shape_names, anchors)})
    if base_livetime is not None:
        defaults['livetime_days'] = base_livetime
        bounds['livetime_days'] = (0.0, np.inf)
    priors = [(nm, prior(1.0, 0.1 + 0.05 * i))
              for i, nm in enumerate(rate_names[1::2])]
    priors += [(nm, prior(float(np.mean(a)), 0.5))
               for nm, a in zip(shape_names, anchors)]
    dev = torch.device(device)
    return types.SimpleNamespace(
        device=dev, dtype=dtype, shape_names=shape_names,
        rate_names=rate_names, anchor_arrays=[np.asarray(a) for a in anchors],
        mus_tensor=torch.as_tensor(mus, dtype=dtype, device=dev),
        eff_names=[shape_names[-1] if K else None] * S,
        apply_eff=np.asarray(apply_eff),
        prior_terms=priors, defaults=defaults, bounds=bounds,
        allowed_negative=np.zeros(S, bool), base_livetime=base_livetime,
        param_names=rate_names + shape_names)


# -- the rule and the tables, on the CPU --------------------------------------

#: the tables' capacities, each one past (``param_graph.MAX_N``,
#: ``MAX_ANCHORS``, ``MAX_PRIORS`` and S + K floating coordinates read)
CAPACITY = ('n33', 'anchors257', 'priors33', 'coords')


def _rule_graph(case):
    """A graph of a stub for the rule's ``case``, on the CPU; its compiled
    stub then said to be on the card unless the case is 'cpu'."""
    kw = {'float64': dict(dtype=torch.float64),
          'uniform': dict(prior=UniformPrior), 'K0': dict(K=0),
          'S9': dict(S=9),
          'anchors257': dict(K=1, anchors=[np.linspace(-1.0, 1.0, 257)])}
    stub = _stub(device='cpu', **kw.get(case, {}))
    names = list(stub.param_names)
    if case == 'n33':
        names += ['w%d' % i for i in range(33 - len(names))]
    if case == 'coords':
        # a prior on a floating parameter the rates and shapes do not read:
        # S + K + 1 coordinates
        names.append('w0')
        stub.prior_terms.append(('w0', NormalPrior(0.0, 1.0)))
    if case == 'priors33':
        stub.prior_terms = [(stub.rate_names[0], NormalPrior(1.0, 0.1))] * 33
    transform = fitter.make_transform([stub.bounds.get(nm, (None, None))
                                       for nm in names])
    graph = fitter._ParamGraph(stub, names, {}, transform)
    if case != 'cpu':
        stub.device = torch.device('cuda')
    return graph, len(names)


@pytest.mark.parametrize("case,expected", [
    ('card', True), ('cpu', False), ('float64', False), ('uniform', False),
    ('K0', False), ('S9', False), ('analytic', False)]
    + [(case, False) for case in CAPACITY])
def test_the_rule_keeps_the_torch_graph_outside_the_kernels_range(case,
                                                                   expected):
    graph, n = _rule_graph(case)
    assert fitter._graph_kernel_eligible(graph, n, case != 'analytic') \
        is expected
    if case in CAPACITY:
        # the tables refuse what the rule refuses, rather than run a part
        with pytest.raises(ValueError, match="outruns the kernels' tables"):
            param_graph.build_tables(graph, n, 0)


@pytest.fixture(scope='module')
def xenon_lf():
    set_progress(False)
    return xenon_like.build_likelihood('binned', **TINY)


def test_a_cpu_fitter_keeps_the_torch_graph(xenon_lf):
    compiled = build_logl(xenon_lf, device='cpu', dtype=torch.float32)
    names, fixed, transform, _ = fitter._floating_setup(compiled, {})
    for use_fused in (False, True):
        graph = fitter._ParamGraph(compiled, names, fixed, transform,
                                   use_fused=use_fused)
        assert graph.kernel is None


def _decode(tables, slot, x, fv):
    """A slot of the kernels' tables read as the kernels read it."""
    d = tables.desc
    kind, pos = d.src_kind[slot], d.src_pos[slot]
    if kind == param_graph.FLOATING:
        return x[..., pos]
    if kind == param_graph.RUNTIME:
        return fv[..., pos]
    assert kind == param_graph.CONSTANT
    return torch.full(x.shape[:-1], d.src_val[slot], dtype=x.dtype)


def _check_tables(graph, n, R):
    tables = param_graph.build_tables(graph, n, R)
    d = tables.desc
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(1.0, 0.3, (5, n)), dtype=torch.float32)
    fv = torch.as_tensor(rng.normal(1.0, 0.3, (5, R)), dtype=torch.float32)
    slots = ([(param_graph.SLOT_SHAPE + k, nm)
              for k, nm in enumerate(graph.shape_names)]
             + [(param_graph.SLOT_RATE + s, nm)
                for s, nm in enumerate(graph.rate_names)]
             + [(param_graph.SLOT_EFF + s, nm)
                for s, nm in enumerate(graph.eff_names)]
             + [(param_graph.SLOT_PRIOR + p, nm)
                for p, (nm, _) in enumerate(graph.compiled.prior_terms)])
    live = getattr(graph.compiled, 'base_livetime', None) is not None
    slots.append((param_graph.SLOT_LIVE, 'livetime_days' if live else None))
    for slot, nm in slots:
        assert torch.equal(_decode(tables, slot, x, fv),
                           graph.value_of(nm, x, fv)), nm
    # the compact coordinates: each floating parameter's column, once
    cpos = [c for c in d.cpos if c >= 0]
    assert len(set(cpos)) == len(cpos) <= graph.S + graph.K
    for slots_c, first, count in ((d.t_c, param_graph.SLOT_SHAPE, graph.K),
                                  (d.rate_c, param_graph.SLOT_RATE, graph.S),
                                  (d.eff_c, param_graph.SLOT_EFF, graph.S)):
        for i in range(count):
            floating = d.src_kind[first + i] == param_graph.FLOATING
            assert (slots_c[i] >= 0) == floating
            if floating:
                assert cpos[slots_c[i]] == d.src_pos[first + i]
    tr = graph.transform
    assert list(d.tkind[:n]) == [int(k) for k in tr.kinds_np]
    assert list(d.tlo[:n]) == [float(np.float32(v)) for v in tr.lo_safe_np]
    assert list(d.stride[:graph.K]) == list(graph.strides)
    assert d.has_live == int(live)
    return tables


@pytest.mark.parametrize("case", ['floating', 'runtime_fixed', 'fixed',
                                  'routed', 'livetime'])
def test_the_tables_route_every_parameter_as_the_fit_does(xenon_lf, case):
    """Each slot of the kernels' tables against ``_Routing.value_of``:
    floating parameters, a runtime-fixed one (the conditional fit's), a
    build-time fixed one, defaults (unregistered rates), a Sum child's
    routed-away parameters and ``livetime_days``."""
    compiled = build_logl(xenon_lf, device='cpu', dtype=torch.float32,
                          include_livetime=case == 'livetime')
    fixed = {'fixed': {'er_rate_multiplier': 1.2, 'cs1_tilt': 0.3},
             'livetime': {'livetime_days': 4.0}}.get(case, {})
    runtime_fixed = ([TARGET, 'band_shift'] if case == 'runtime_fixed'
                     else [])
    fixed = dict(fixed, **{r: compiled.defaults[r] for r in runtime_fixed})
    names, fixed, transform, _ = fitter._floating_setup(compiled, fixed)
    routed = (set(names) - {'nr_rate_multiplier', 'band_width_scale'}
              if case == 'routed' else None)
    graph = fitter._ParamGraph(compiled, names, fixed, transform,
                               runtime_fixed, routed)
    tables = _check_tables(graph, len(names), len(runtime_fixed))
    d = tables.desc
    kinds = [d.src_kind[param_graph.SLOT_RATE + s] for s in range(graph.S)]
    if case == 'routed':
        nr = graph.rate_names.index('nr_rate_multiplier')
        assert kinds[nr] == param_graph.CONSTANT
        assert d.src_kind[param_graph.SLOT_SHAPE + 1] == param_graph.CONSTANT
    if case == 'runtime_fixed':
        assert kinds[graph.rate_names.index(TARGET)] == param_graph.RUNTIME
        assert d.src_kind[param_graph.SLOT_SHAPE] == param_graph.RUNTIME
    if case == 'livetime':
        assert d.src_kind[param_graph.SLOT_LIVE] == param_graph.CONSTANT
        assert d.src_val[param_graph.SLOT_LIVE] == 4.0
        assert d.inv_base == float(np.float32(1.0)
                                   / np.float32(compiled.base_livetime))


@pytest.mark.parametrize("K,S", [(1, 2), (2, 8), (4, 6)])
def test_the_tables_of_synthetic_graphs(K, S):
    stub = _stub(device='cpu', K=K, S=S, base_livetime=2.5, seed=K + S)
    runtime_fixed = ['r1_rate_multiplier']
    fixed = {'r0_rate_multiplier': 1.5, 'r1_rate_multiplier': 1.0}
    names = [nm for nm in stub.param_names if nm not in fixed]
    transform = fitter.make_transform([stub.bounds[nm] for nm in names])
    graph = fitter._ParamGraph(stub, names, fixed, transform, runtime_fixed)
    _check_tables(graph, len(names), 1)


def test_the_cpu_path_counts_each_graph_call(xenon_lf):
    """``graph.torch`` once per graph call, a value call's or a vgh's; no
    ``graph.kernel`` on the CPU."""
    study = BinnedToyStudy(xenon_lf, device='cpu', max_iter=20)
    progress.take()
    progress.set_tracing(True)
    try:
        study.profile_ts(2, 6, TARGET, 1.0)
    finally:
        progress.set_tracing(False)
    got = progress.take()
    calls = sum(s.name in ('newton.value', 'newton.vgh')
                for s in got['spans'])
    assert calls > 0
    assert got['counters']['graph.torch'] == calls
    assert 'graph.kernel' not in got['counters']


def _smoke():
    import runpy
    from pathlib import Path
    return runpy.run_path(str(Path(__file__).resolve().parents[1]
                               / 'chip_smoke.py'))


def test_chip_smoke_records_every_graph_kernel_call(xenon_lf, monkeypatch):
    """chip_smoke.py's recorder of the graph's kernel calls (what it holds
    to the PyTorch graph and times on the card), run on the CPU with the
    PyTorch graph standing in for the kernels: one record a graph call (the
    ``graph.kernel`` count), a chain record a vgh call, inputs and outputs
    cloned, the outputs those of the PyTorch graph at the recorded inputs,
    and ``_ParamGraph`` put back after."""
    smoke = _smoke()

    def fwd(tables, u, fv, want_x=False):
        with smoke['torch_ops'](tables.graph) as graph:
            idx, t, m, prior, x, _ = graph.evaluate(u, fv)
        return idx, t, m, prior, x if want_x else None

    def chain(tables, u, fv, g_mt, H_mt):
        with smoke['torch_ops'](tables.graph) as graph:
            parts = graph.evaluate(u, fv, derivs=True)[5]
            return graph.gradient(u, fv, parts, g_mt, H_mt)
    monkeypatch.setattr(fitter, '_graph_kernel_eligible', lambda *a: True)
    monkeypatch.setattr(param_graph, 'build_tables',
                        lambda graph, n, R: types.SimpleNamespace(graph=graph))
    monkeypatch.setattr(param_graph, 'graph_fwd', fwd)
    monkeypatch.setattr(param_graph, 'graph_chain', chain)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a: None)
    methods = (fitter._ParamGraph.evaluate, fitter._ParamGraph.gradient)
    study = BinnedToyStudy(xenon_lf, device='cpu', max_iter=20)
    progress.take()
    progress.set_tracing(True)
    try:
        fwd_calls, chain_calls = smoke['record_graph_calls'](
            lambda: study.profile_ts(2, 4, TARGET, 1.0))
    finally:
        progress.set_tracing(False)
    got = progress.take()
    assert (fitter._ParamGraph.evaluate, fitter._ParamGraph.gradient) \
        == methods
    assert len(fwd_calls) == got['counters']['graph.kernel'] > 0
    assert len(chain_calls) == sum(s.name == 'newton.vgh'
                                   for s in got['spans']) > 0
    assert any(u.dim() == 3 for _, u, _, _, _, _ in fwd_calls)
    for graph, u, fv, _, want_x, out in fwd_calls:
        with smoke['torch_ops'](graph):
            ref = graph.evaluate(u, fv)
        for a, b in zip(out[:4], ref[:4]):
            assert torch.equal(a, b)
        assert (out[4] is not None) == want_x
    for graph, u, fv, g_mt, H_mt, (g, H) in chain_calls:
        assert g.shape == u.shape and H.shape == u.shape + u.shape[-1:]
        with smoke['torch_ops'](graph):
            parts = graph.evaluate(u, fv, derivs=True)[5]
            ref_g, ref_H = graph.gradient(u, fv, parts, g_mt, H_mt)
        assert torch.equal(g, ref_g) and torch.equal(H, ref_H)


@pytest.mark.parametrize("case", ['equal', 'shifted', 'one_lane', 'scale',
                                  'inf'])
def test_chip_smoke_graph_gap(case):
    """chip_smoke.py's measure of a graph kernel's gap to the PyTorch graph:
    relative to the largest entry, to each lane's, or to a given scale of
    each lane; a kernel that is not finite where the PyTorch graph is
    fails."""
    smoke = _smoke()
    b = torch.tensor([[1.0, -200.0], [0.5, 0.25]])
    a = b.clone()
    if case == 'shifted':
        a[0, 1] += 2e-3
    if case == 'one_lane':
        a[1, 0] += 1e-3
    if case == 'inf':
        a[1, 1] = float('inf')
        with pytest.raises(AssertionError, match='finite'):
            smoke['graph_gap']('x', a, b)
        return
    if case == 'scale':
        a[1, 0] += 1e-3
        assert smoke['graph_gap']('x', a, b, scale=torch.tensor(
            [1.0, 50.0])) == pytest.approx(2e-5, rel=1e-3)
        return
    gap, lane_gap = (smoke['graph_gap']('x', a, b),
                     smoke['graph_gap']('x', a, b, per_lane=True))
    expected = {'equal': (0.0, 0.0), 'shifted': (1e-5, 1e-5),
                'one_lane': (5e-6, 2e-3)}[case]
    assert gap == pytest.approx(expected[0], rel=1e-3)
    assert lane_gap == pytest.approx(expected[1], rel=1e-3)


# -- the kernels on the card --------------------------------------------------

def _rel_to_lane_max(a, b):
    scale = b.abs().flatten(1).max(1).values.clamp(min=1e-30)
    return float(((a - b).abs().flatten(1).max(1).values / scale).max())


def _close(a, b, rtol=1e-6):
    scale = float(b.abs().max()) if b.numel() else 0.0
    assert float((a - b).abs().max()) <= rtol * max(scale, 1e-30), (
        float((a - b).abs().max()), scale)


def _graphs(compiled, names, fixed, transform, runtime_fixed=(),
            routed=None):
    kern = fitter._ParamGraph(compiled, names, fixed, transform,
                              runtime_fixed, routed, use_fused=True)
    plain = fitter._ParamGraph(compiled, names, fixed, transform,
                               runtime_fixed, routed)
    assert kern.kernel is not None and plain.kernel is None
    return kern, plain


def _compare(kern, plain, u, fv, A=5, seed=0):
    """The forward kernel on u (L, n) and on candidates around it (L, A, n),
    x included, and the chain kernel at u with a random symmetric H_mt,
    against the PyTorch graph."""
    rng = np.random.default_rng(seed)
    L, n = u.shape
    cands = (u[:, None, :] + torch.as_tensor(
        rng.normal(0, 0.3, (L, A, n)), dtype=u.dtype, device=u.device))
    cands[:, 0] = u
    for point in (u, cands):
        got = kern.evaluate(point, fv, want_x=True)
        ref = plain.evaluate(point, fv)
        assert torch.equal(got[0], ref[0])
        for a, b in zip(got[1:5], ref[1:5]):
            assert a.shape == b.shape and a.is_contiguous()
            _close(a, b)
    _, _, _, _, _, parts = plain.evaluate(u, fv, derivs=True)
    P = kern.S + kern.K
    g_mt = torch.as_tensor(rng.normal(0, 10, (L, P)), dtype=u.dtype,
                           device=u.device)
    h = rng.normal(0, 10, (L, P, P))
    H_mt = torch.as_tensor(h + h.transpose(0, 2, 1), dtype=u.dtype,
                           device=u.device)
    g, H = kern.gradient(u, fv, None, g_mt, H_mt)
    rg, rH = plain.gradient(u, fv, parts, g_mt, H_mt)
    assert _rel_to_lane_max(g, rg) < 1e-5
    assert _rel_to_lane_max(H, rH) < 1e-5


def _synthetic_u(stub, names, transform, shape_rows, L, rng, device):
    """Random u, then rows with each identity-transformed shape coordinate
    on an anchor, on each clip bound and off the grid."""
    u = rng.normal(0, 1.2, (L, len(names)))
    for k, nm in enumerate(stub.shape_names):
        if nm not in names:
            continue
        j = names.index(nm)
        a = stub.anchor_arrays[k]
        if transform.kinds_np[j] == 0:
            special = list(a) + [a[0] - 0.7, a[-1] + 0.7, a[0], a[-1]]
            rows = rng.choice(L, size=min(L, shape_rows), replace=False)
            u[rows, j] = rng.choice(special, size=len(rows))
    return torch.as_tensor(u, dtype=torch.float32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [1, 3, 6, 8])
def test_the_kernels_match_the_torch_graph_on_synthetic_graphs(cuda_device,
                                                               K, S):
    """Every transform kind, a fixed rate with a prior, a runtime-fixed
    rate, efficiency-routed rates and the live time."""
    stub = _stub(device=cuda_device, K=K, S=S, base_livetime=2.5, seed=K * S)
    rng = np.random.default_rng(K * 10 + S)
    runtime_fixed = ['r0_rate_multiplier']
    fixed = {'r0_rate_multiplier': 1.0, 'r1_rate_multiplier': 0.8,
             'livetime_days': 3.0}
    names = [nm for nm in stub.param_names if nm not in fixed]
    rate_bounds = [(None, None), (-1.0, None), (-1.0, 4.0), (None, 4.0)]
    bounds = []
    for i, nm in enumerate(names):
        if nm in stub.shape_names:
            a = stub.anchor_arrays[stub.shape_names.index(nm)]
            bounds.append((None, None) if i % 2 == 0
                          else (a[0] - 0.5, a[-1] + 0.5))
        else:
            bounds.append(rate_bounds[i % 4])
    transform = fitter.make_transform(bounds)
    kern, plain = _graphs(stub, names, fixed, transform, runtime_fixed)
    L = 257
    u = _synthetic_u(stub, names, transform, 128, L, rng, cuda_device)
    fv = torch.as_tensor(rng.uniform(0.5, 2.0, (L, 1)), dtype=torch.float32,
                         device=cuda_device)
    _compare(kern, plain, u, fv, seed=K + S)


def _model(kind):
    set_progress(False)
    small = dict(n_cs1_bins=10, n_cs2_bins=8)
    if kind == 'unbinned':
        return xenon_like.build_likelihood('unbinned', livetime_days=3.0)
    if kind == 'sum':
        from blueice_tpu_torch import composition
        runs = [xenon_like.build_likelihood('binned', livetime_days=days,
                                            **small)
                for days in (32.1, 246.7)]
        return composition.LogLikelihoodSum(runs + [
            composition.correlated_gaussian_constraint(
                ['band_shift', 'band_width_scale'], [0.0, 1.0],
                [[0.09, 0.012], [0.012, 0.0064]])])
    bb = {'xenon': False, 'xenon_bb': True, 'bblite': 'bb_lite',
          'livetime': False}[kind]
    return xenon_like.build_likelihood('binned', bb=bb, **small)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ['xenon', 'xenon_bb', 'bblite', 'unbinned',
                                  'livetime', 'sum'])
def test_the_kernels_match_the_torch_graph_on_the_models(cuda_device, kind):
    """Each model's graph with the conditional fit's runtime-fixed signal
    rate; the Sum's first child through its routing; the include-livetime
    model with the live time fixed off its base."""
    compiled = build_logl(_model(kind), device=cuda_device,
                          include_livetime=kind == 'livetime')
    fixed = {TARGET: 1.0}
    if kind == 'livetime':
        fixed['livetime_days'] = 200.0
    names, fixed, transform, x0 = fitter._floating_setup(compiled, fixed)
    routed = None
    if kind == 'sum':
        compiled, routed = compiled.children[0], compiled.child_routed[0]
    kern, plain = _graphs(compiled, names, fixed, transform, [TARGET],
                          routed)
    rng = np.random.default_rng(3)
    L = 300
    u = torch.as_tensor(transform.to_u_np(x0)[None]
                        + rng.normal(0, 0.8, (L, len(names))),
                        dtype=torch.float32, device=cuda_device)
    fv = torch.as_tensor(rng.uniform(0.0, 3.0, (L, 1)), dtype=torch.float32,
                         device=cuda_device)
    _compare(kern, plain, u, fv, seed=4)


@pytest.mark.cuda
@pytest.mark.parametrize("bb", [False, True])
def test_profiles_with_the_kernels_match_the_torch_graph(cuda_device, bb):
    """A 4,096-toy profile of the full xenon (or xenon_bb) model with the
    graph's kernels and with its PyTorch ops, on the same toys. The two
    round differently (the chain's sums), so a fit's Newton path may take
    another step and stop elsewhere within its float32 stop rule (an
    accepted step that gains less than ftol = 1e-3): each max_ll is fixed
    to about 1e-3, t = 2 (free - conditional) to about 4e-3. So: t within
    4e-3 for at least 99% of the toys, the median t within 2e-3, the mean
    iteration count within 1%; and each path bit-identical on a rerun.
    The two stop apart at random, so the mean signed gap in t is about 0
    (on the H100: -2.5e-5 for xenon and 4.7e-6 for xenon_bb, standard
    errors 4.8e-5 and 1.1e-5); a steady shift of the kernels' t, which the
    limits above let through below 4e-3, fails its bound of 2e-4."""
    set_progress(False)
    lf = xenon_like.build_likelihood('binned', bb=bb)
    out = {}
    try:
        for force in (False, True):
            fitter._FORCE_TORCH_GRAPH = force
            study = BinnedToyStudy(lf)
            before = param_graph.graph_fwd.launches
            runs = [study.profile_ts(11, 4096, TARGET, 1.0) for _ in (0, 1)]
            torch.cuda.synchronize()
            assert (param_graph.graph_fwd.launches > before) is not force
            (t, free, cond), (t2, _, _) = runs
            assert np.array_equal(np.asarray(t), np.asarray(t2))
            out[force] = (np.asarray(t), np.concatenate([free.n_iter,
                                                         cond.n_iter]))
    finally:
        fitter._FORCE_TORCH_GRAPH = False
    (t_k, it_k), (t_p, it_p) = out[False], out[True]
    assert np.isfinite(t_k).all()
    assert np.mean(np.abs(t_k - t_p) <= 4e-3) >= 0.99
    assert abs(np.median(t_k) - np.median(t_p)) <= 2e-3
    gap = t_k - t_p
    assert abs(gap.mean()) <= 2e-4, (gap.mean(), gap.std())
    assert abs(it_k.mean() / it_p.mean() - 1) <= 0.01
