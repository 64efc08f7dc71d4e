"""The unbinned likelihood kind (``reference/unbinned.py``,
``harness/systems/unbinned.py``) against the port on the CPU, at a small
size of the configurations' source model: three blob sources, two shape
parameters on 3 anchors each (one the efficiency), 10 x 12 bins, about 61
events a toy. The reference's likelihood equals the port's host
likelihood, its fits give the program's check numbers inside the cell's
limits, its draw follows the expectation, the bfloat16 control fails the
cell's limits, a small cell runs correct through the harness, untraced and
traced, and the unbinned roofline interposer counts the rows the port's
own counting counts."""

import json
import shutil

import numpy as np
import pytest
import torch
from scipy import stats

from blueice_tpu_torch.parallel.toys import UnbinnedToyStudy

from benchmark.harness import check, ensemble, faults, runner
from benchmark.harness.systems import unbinned as system
from benchmark.harness.unbinned_roofline import UnbinnedCalls
from benchmark.reference import unbinned as reference
from conftest import TINY_CONFIG

CELL = 'tiny_unbinned.tiny_mix'
TARGET = 'wimp_rate_multiplier'
#: The new per-layer metrics, and those of them the CPU can read (the
#: others need the card's timeline or its kernels)
NEW_METRICS = ('glue_idle_pct.score', 'score_share_pct',
               'vgh_roofline_pct.unbinned', 'value_roofline_pct.unbinned')


def tiny_unbinned_config():
    """:data:`conftest.TINY_CONFIG`'s sources and shapes as an unbinned
    likelihood over 10 x 12 bins, 0.1 live days (61.0 expected events in
    the space), with the toy study's own ``n_max`` rule's 118 slots."""
    cfg = json.loads(json.dumps(TINY_CONFIG))
    cfg.update(name='tiny_unbinned', likelihood='unbinned',
               livetime_days=0.1, n_max=118,
               pdf_interpolation_method='linear', outlier_likelihood=1e-12,
               analysis_space=[["cs1", 0.0, 100.0, 10],
                               ["log10_cs2", 1.0, 4.0, 12]])
    return cfg


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    cfg = tiny_unbinned_config()
    lf, study = system.build_study(cfg, 'cpu', str(tmp_path_factory.mktemp(
        'cache')), dtype=torch.float64)
    return cfg, lf, study, reference.build(cfg, 'cpu')


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(model, toys, seed, truth=None):
    draw = reference.sampler(model, model.defaults if truth is None
                             else truth, toys, 'cpu', torch.float32)
    return draw(torch.Generator().manual_seed(seed))


def _points(model, n, seed):
    rng = np.random.default_rng(seed)
    x = np.tile(model.defaults, (n, 1))
    x[:, :model.R] *= rng.uniform(0.5, 1.5, (n, model.R))
    for k, a in enumerate(model.anchors):
        x[:, model.R + k] = rng.uniform(a[0], a[-1], n)
    x[0, model.R:] = [a[1] for a in model.anchors]      # on the middle anchors
    x[1, model.R:] = [a[-1] for a in model.anchors]     # on the last anchors
    return x


def _host_events(coords, mask):
    n = int(mask.sum())
    ev = np.zeros(n, dtype=[('cs1', float), ('log10_cs2', float),
                            ('source', int)])
    ev['cs1'] = coords[mask, 0].numpy()
    ev['log10_cs2'] = coords[mask, 1].numpy()
    return ev


def test_model_expects_the_ports_events(pair):
    cfg, lf, study, model = pair
    X = torch.as_tensor(model.defaults[None])
    mus = model.rates(X, *model.corners(X, model.cells_of(X)))[0]
    np.testing.assert_allclose(mus.numpy(), lf.base_model.expected_events(),
                               rtol=1e-12)
    mu = float(mus.sum())
    assert int(mu + 6 * np.sqrt(mu + 1) + 10) == cfg['n_max'] == study.n_max


@pytest.mark.parametrize('events', ['drawn', 'anywhere'])
def test_likelihood_matches_the_port(pair, events):
    """The reference's float64 log likelihood at random points of random
    event sets equals the port's host ``UnbinnedLogLikelihood`` (its
    ``set_data``, then ``lf(**params)``) to 1e-9 relative: both are float64
    sums of the same terms, apart in their order of addition only (~1e-13).
    ``anywhere``: events uniform over the whole space, edges and corners
    included, where the density is clipped beyond the outermost centres."""
    cfg, lf, study, model = pair
    T = 8
    if events == 'drawn':
        coords, mask, _ = _draw(model, T, 11)
    else:
        gen = torch.Generator().manual_seed(12)
        u = torch.rand((T, 40, 2), generator=gen, dtype=torch.float64)
        coords = torch.stack([100 * u[..., 0], 1 + 3 * u[..., 1]], -1)
        coords[:, :4] = torch.tensor([[0.0, 1.0], [100.0, 4.0], [0.0, 4.0],
                                      [100.0, 1.0]], dtype=torch.float64)
        mask = torch.rand((T, 40), generator=gen) < 0.8
        mask[:, :4] = True
    x = _points(model, T, 13)
    mine = model.loglik_at(x, (coords, mask))
    port = []
    for i in range(T):
        lf.set_data(_host_events(coords[i], mask[i]))
        port.append(lf(**dict(zip(model.names, x[i].tolist()))))
    np.testing.assert_allclose(mine, port, rtol=1e-9)


def _judged(pair, toys, seed, dtype):
    """The check's numbers of the port's float32 profile (the cell's dtype)
    on toys drawn as the cell draws them, judged as a run judges them."""
    cfg, lf, _, model = pair
    study = UnbinnedToyStudy(lf, n_max=cfg['n_max'], dtype=dtype,
                             device='cpu')
    events = _draw(model, toys, seed)
    t, free, cond = study._run_profile(events, TARGET, 1.0, None)
    fixed = {TARGET: 1.0}
    prog = dict(
        x_free=check.full_points(free.names, free.x, model.names, fixed),
        x_cond=check.full_points(cond.names, cond.x, model.names, fixed),
        ll_free=free.max_ll, ll_cond=cond.max_ll, t=t)
    data = reference.take(events, list(range(toys)))
    return check.judge(reference, model, data, prog, TARGET, 1.0)


def test_profile_fits_inside_the_cells_limits(pair, one_thread):
    """The port's float32 profile of 12 toys, judged against the
    reference's fits, passes the cell's limits; in float64 its fits reach
    the reference's maxima (the free fit's to 1e-6, as a float64 Newton
    fit stops within its tolerance)."""
    numbers, det = _judged(pair, 12, 21, torch.float32)
    ok, lines = check.verdict(numbers, runner.load_cell(
        'unbinned_xenon.ensemble')[4])
    assert ok, lines
    numbers, det = _judged(pair, 12, 21, torch.float64)
    assert numbers['ll_eval_gap'] < 1e-9
    assert np.all(det['fit_gap'] < 1e-6), det['fit_gap']


def test_draw_follows_the_expectation(pair):
    """2,000 toys on a fixed seed: the mean count within 3 sigma of the
    expected total, the valid events' bins by a chi-square test against
    the expected events per bin (p > 1e-3), every point inside its bin and
    the mask the count's first slots."""
    cfg, lf, study, model = pair
    T = 2000
    truth = model.defaults.copy()
    truth[0] = 3.0                                      # wimp x 3
    coords, mask, bins = _draw(model, T, 31, truth)
    expected = model.expected(torch.as_tensor(truth[None]))[0]
    mu = float(expected.sum())
    counts = mask.sum(-1).double()
    assert abs(float(counts.mean()) - mu) < 3 * np.sqrt(mu / T)
    assert (mask == (torch.arange(cfg['n_max'])[None]
                     < counts[:, None])).all()
    flat = bins[..., 0] * model.bin_shape[1] + bins[..., 1]
    seen = torch.bincount(flat[mask], minlength=model.N).double()
    exp = expected / mu * seen.sum()
    keep = exp > 5
    chi2 = float((((seen - exp) ** 2 / exp)[keep]).sum())
    assert stats.chi2.sf(chi2, int(keep.sum()) - 1) > 1e-3
    for d, e in enumerate(model._edges):
        assert (coords[..., d] >= e[bins[..., d]]).all()
        assert (coords[..., d] < e[bins[..., d] + 1]).all()
    assert coords.dtype == torch.float64 and bins.dtype == torch.int64


def test_same_seed_same_event_sets(pair):
    model = pair[3]
    a, b = _draw(model, 4, 2 ** 40 + 1), _draw(model, 4, 2 ** 40 + 1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], _draw(model, 4, 2 ** 40 + 2)[0])


def test_control_fails_the_limits():
    """Two toys drawn as the cell draws them (from a call of 8: the cell's
    own batch does not fit a test run on the CPU), fitted by the bfloat16
    control and judged as a run judges them, fail ``ll_eval_gap`` or
    ``t_eval_gap``."""
    cx = runner.prepare('unbinned_xenon.ensemble', 'cpu')
    ref = cx.kind.reference
    traffic = dict(cx.traffic, toys_per_call=8)
    ens = ensemble.Ensemble(traffic, ref.sampler(
        cx.model, cx.model.defaults, 8, 'cpu', cx.dtype), 2 ** 31 + 3, 'cpu')
    data = ref.take(ens.datasets(0), [0, 1])
    control = ref.build(cx.config, 'cpu', storage=torch.bfloat16)
    ctrl = ref.profile_fits(control, data, cx.target, cx.hypothesis)
    numbers = check.judge(ref, cx.model, data, ctrl, cx.target,
                          cx.hypothesis)[0]
    ok, lines = check.verdict(numbers, cx.limits)
    assert (numbers['ll_eval_gap'] > cx.limits['ll_eval_gap']
            or numbers['t_eval_gap'] > cx.limits['t_eval_gap']), lines


def _add_cell(checkout, traced_metrics=False):
    """The small unbinned configuration as a cell of the checkout, under
    the checkout's ``tiny_mix`` (12 toys a call, 8 judged), with the
    unbinned cell's limits; ``traced_metrics``: the new per-layer metrics
    report in it too."""
    bench = checkout / 'benchmark'
    cfg = tiny_unbinned_config()
    (bench / 'configs' / 'tiny_unbinned.json').write_text(json.dumps(cfg))
    shutil.copy(bench / 'limits' / 'unbinned_xenon.ensemble.json',
                bench / 'limits' / (CELL + '.json'))
    spec = json.loads((checkout / 'BENCHMARK.json').read_text())
    spec['configs'].append({'name': 'tiny_unbinned', 'source': 'test',
                            'file': 'benchmark/configs/tiny_unbinned.json',
                            'reduced': [], 'why': 'test'})
    spec['workloads'].append({'name': CELL, 'config': 'tiny_unbinned',
                              'traffic': 'tiny_mix', 'chips': 1,
                              'why': 'test'})
    for m in spec['per_layer']:
        if traced_metrics and m['name'] in NEW_METRICS:
            m['workloads'].append(CELL)
    (checkout / 'BENCHMARK.json').write_text(json.dumps(spec))


@pytest.mark.parametrize('traced', [False, True], ids=['untraced', 'traced'])
def test_small_cell_runs_correct(checkout, traced):
    """The small unbinned cell through the harness's run, as
    ``benchmark/run.py`` runs a cell: correct, every toy finite; traced,
    the share of the window in the study's scoring and centring comes out
    of the program's spans on the CPU, and the metrics that need the
    card's timeline or its kernels stay out of the line."""
    _add_cell(checkout, traced_metrics=True)
    result, lines = runner.run_cell(CELL, 2 ** 33 + 41, 0.5, traced,
                                    device='cpu', root=str(checkout))
    assert result['correct'], lines
    assert result['attempted'] > 0 and result['failed'] == 0
    assert result['judged_toys'] == 8
    if not traced:
        assert set(result['metrics']) == {'toys_per_s', 'setup_s'}
        return
    assert set(result['metrics']) == {'score_share_pct'}
    assert 0 < result['metrics']['score_share_pct']['value'] < 100


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
def test_small_cell_fails_a_broken_path(checkout, fault):
    _add_cell(checkout)
    result, lines = runner.run_cell(CELL, 2 ** 32 + 43, 0.0, False,
                                    device='cpu', root=str(checkout),
                                    study_hook=faults.FAULTS[fault])
    assert result['seconds']['calls'] == 1
    assert not result['correct'], lines


def _kernel_args(seed, B=6, G=9, S=3, E=20, L=4, A=None):
    """Random inputs of the unbinned wrappers on a 3 x 3 anchor grid."""
    gen = torch.Generator().manual_seed(seed)
    lead = (L,) if A is None else (L, A)
    ps = torch.rand((B, G, S, E), generator=gen) + 0.01
    idx = torch.randint(0, 2, lead + (2,), generator=gen)
    t = torch.rand(lead + (2,), generator=gen)
    m = torch.rand(lead + (S,), generator=gen) * 10
    mask = torch.rand((B, E), generator=gen) < 0.7
    inv_ref = torch.ones((B, E))
    lanes = torch.randperm(B, generator=gen)[:L]
    moff = m.sum(-1)
    return (ps, (3, 1), lanes, idx, t, m, mask, inv_ref, moff, 1e-12)


@pytest.mark.parametrize('contract', ['vgh', 'value'])
def test_unbinned_calls_count_the_ports_rows(contract):
    """Each recorded call's rows are the port's own count
    (``utils.roofline.row_events`` over the call's corner ids and its
    lanes' valid events), its bound the frozen ``work`` of them, and the
    corner offsets are built once for the stride set."""
    from blueice_tpu_torch.ops import fused, fused_unbinned
    from blueice_tpu_torch.utils.roofline import row_events
    from benchmark.harness.roofline import bound, work
    name = ('unbinned_vgh_fused' if contract == 'vgh'
            else 'unbinned_ll_fused_multi')
    calls = UnbinnedCalls(name, contract)
    calls.install()
    try:
        calls.recording = True
        for seed in (1, 2):
            args = _kernel_args(seed, A=None if contract == 'vgh' else 5)
            getattr(fused_unbinned, name)(*args)
    finally:
        calls.recording = False
        calls.uninstall()
    assert getattr(fused_unbinned, name).__name__ == name
    assert len(calls.calls) == 2 and len(calls._offsets) == 1
    for c, seed, b in zip(calls.calls, (1, 2), calls.bounds_s()):
        args = _kernel_args(seed, A=None if contract == 'vgh' else 5)
        ps, strides, lanes, idx, mask = (args[0], args[1], args[2], args[3],
                                         args[6])
        valid = mask[lanes].sum(-1)
        ids = fused.corner_ids(strides, idx, ps.shape[1])
        L, A = lanes.shape[0], (1 if contract == 'vgh' else idx.shape[1])
        rows = row_events(ids.reshape(L, -1), valid)
        assert int(c['row_events']) == rows
        assert int(c['valid']) == int(valid.sum())
        nbytes, flops = work(contract, 3, 2, tuple(idx.shape[:-1]),
                             row_floats=3 * rows,
                             data_bytes=L * 20 + 4 * int(valid.sum()),
                             items=A * int(valid.sum()))
        assert b == bound(nbytes, flops)[0] > 0
