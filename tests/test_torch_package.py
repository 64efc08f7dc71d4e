"""Package-level properties of the port: it imports neither jax nor the JAX
package, its kernels never launch on CPU tensors, CUDA-only requests fail
loudly without CUDA, and what is not ported yet says so."""

import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import blueice_tpu_torch
from blueice_tpu_torch.device import resolve
from blueice_tpu_torch.examples.xenon_like import build_config, build_likelihood
from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
from blueice_tpu_torch.ops import fused, fused_bb, fused_unbinned
from blueice_tpu_torch.parallel import (BinnedToyStudy, UnbinnedToyStudy,
                                        make_toy_fitter)
from blueice_tpu_torch.utils import set_progress

SIZE = dict(n_cs1_bins=6, n_cs2_bins=5, livetime_days=30.0)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        blueice_tpu_torch.__path__, 'blueice_tpu_torch.'))


def test_imports_without_jax():
    """Every module imports in a process where jax and blueice_tpu cannot
    be imported at all."""
    modules = _modules()
    assert {'blueice_tpu_torch.composition', 'blueice_tpu_torch.morphers',
            'blueice_tpu_torch.ops.fused', 'blueice_tpu_torch.ops.fused_unbinned',
            'blueice_tpu_torch.ops.unbinned_vgh',
            'blueice_tpu_torch.test_helpers',
            'blueice_tpu_torch.utils.roofline'} <= set(modules)
    assert {'blueice_tpu_torch.parallel.' + m for m in (
        '_stats', 'limits', 'neyman', 'cls', 'discovery', 'asymptotics',
        'coverage', 'gof', 'ranking', 'mcmc')} <= set(modules)
    assert {'blueice_tpu_torch.inference',
            'blueice_tpu_torch.models.jax_source'} <= set(modules)
    assert {'blueice_tpu_torch.parallel.distributed',
            'blueice_tpu_torch.dryrun',
            'blueice_tpu_torch.ops.unbinned_dense'} <= set(modules)
    assert {'blueice_tpu_torch.cli', 'blueice_tpu_torch.parallel.tasks',
            'blueice_tpu_torch.plots',
            'blueice_tpu_torch.native'} <= set(modules)
    code = textwrap.dedent("""
        import importlib, sys
        sys.modules['jax'] = None
        sys.modules['blueice_tpu'] = None
        for name in %r:
            importlib.import_module(name)
        assert not any(m == 'jax' or m.startswith(('jax.', 'blueice_tpu.'))
                       for m, v in sys.modules.items() if v is not None)
        print('imported', len(%r))
    """ % (modules, modules))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'imported' in out.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="runs without CUDA")
@pytest.mark.parametrize('script', ['chip_smoke.py', 'measure_unbinned.py',
                                    'measure_value_replay.py',
                                    'measure_statistics.py'])
def test_chip_scripts_exit_without_cuda(script):
    """The GPU scripts stop with code 2 and print no result line when CUDA
    is missing, in a process that cannot import jax."""
    root = Path(__file__).resolve().parents[1]
    path = str(root / script)
    code = textwrap.dedent("""
        import runpy, sys
        sys.modules['jax'] = None
        sys.modules['blueice_tpu'] = None
        sys.argv = [%r]
        runpy.run_path(%r, run_name='__main__')
    """ % (path, path))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 2, out.stderr
    assert 'CUDA is not available' in out.stderr
    assert '"ok"' not in out.stdout


@pytest.fixture(scope='module')
def lf():
    set_progress(False)
    return build_likelihood('binned', **SIZE)


def test_launch_counters_stay_zero_on_cpu(lf):
    fused.reset_launch_counts()
    study = BinnedToyStudy(lf, device='cpu', max_iter=30, engine='fused')
    t, free, cond = study.profile_ts(3, 4, 'wimp_rate_multiplier', 1.0)
    assert t.shape == (4,) and np.isfinite(free.max_ll).all()
    assert fused.launch_counts() == {'binned_vgh_fused': 0,
                                     'binned_ll_fused_multi': 0}
    fused_unbinned.reset_launch_counts()
    ulf = build_likelihood('unbinned', **dict(SIZE, livetime_days=3.0))
    study = UnbinnedToyStudy(ulf, device='cpu', max_iter=20, engine='fused')
    t, free, cond = study.profile_ts(3, 2, 'wimp_rate_multiplier', 1.0)
    assert t.shape == (2,) and np.isfinite(free.max_ll).all()
    assert fused_unbinned.launch_counts() == {'unbinned_vgh_fused': 0,
                                              'unbinned_ll_fused_multi': 0}


def test_default_device_raises_without_cuda(lf):
    """The entry points run on the card unless asked for the CPU: without
    CUDA the default raises, naming device='cpu', and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BinnedToyStudy(lf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lf.make_logl()
    # the inference slice: the compiled fits, the device chain and the
    # device template build
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lf.bestfit_jax()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lf.bestfit_emcee_device(n_steps=2, n_burn_in=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_likelihood('binned', jax_templates=True, **SIZE)
    assert resolve('cpu') == (torch.device('cpu'), torch.float64)
    assert resolve('cpu', torch.float32)[1] == torch.float32


def test_cuda_requests_raise_without_cuda(lf):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match='CUDA'):
        BinnedToyStudy(lf, device='cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        lf.make_logl(device='cuda')
    with pytest.raises(RuntimeError):
        fused.load_library()
    with pytest.raises(RuntimeError):
        fused_unbinned.load_library()


def test_auto_engine_is_closed_form_on_cpu(lf):
    """'auto' picks 'fused' only for a CUDA device; on the CPU the fit runs
    the closed form and matches engine='fused' (its plain versions)."""
    study = BinnedToyStudy(lf, device='cpu', max_iter=30)
    counts = study.simulate(11, 3)
    ref = BinnedToyStudy(lf, device='cpu', max_iter=30, engine='fused').fit_toys(counts)
    res = study.fit_toys(counts)
    np.testing.assert_allclose(res.max_ll, ref.max_ll, rtol=1e-12)


def test_not_ported_features_say_so(lf):
    with pytest.raises(ValueError, match='blob templates'):
        build_likelihood('unbinned', bb=True, **SIZE)
    with pytest.raises(ValueError, match='bb must be'):
        build_likelihood('binned', bb='bb_full', **SIZE)
    with pytest.raises(ValueError, match='blob templates'):
        build_likelihood('binned', bb=True, jax_templates=True, **SIZE)
    # mesh= is ported (a ToyMesh); anything else is refused
    with pytest.raises(TypeError, match='ToyMesh'):
        BinnedToyStudy(lf, device='cpu').simulate(0, 2, mesh=object())
    with pytest.raises(NotImplementedError, match="'fused', 'ad'"):
        make_toy_fitter(lf.make_logl(device='cpu'), engine='pallas')
    # parallel template builds are ported: prepare(n_cores=2) builds the
    # same anchor tensors through task files and a process pool
    pooled = build_likelihood('binned', prepare=False, **SIZE)
    pooled.prepare(n_cores=2)
    np.testing.assert_array_equal(pooled._builds['mus'][2],
                                  lf._builds['mus'][2])
    np.testing.assert_array_equal(pooled._builds['ps'][2],
                                  lf._builds['ps'][2])


def test_source_wise_and_autodiff_fits_are_ported(lf):
    """What the two refusals above once named: a source-wise unbinned
    likelihood builds (one morpher a source), and engine='ad' fits the
    same floating parameters as 'auto' (their fits: test_torch_ad_engine.py
    and test_torch_source_wise.py)."""
    sw = UnbinnedLogLikelihood(dict(build_config(**SIZE),
                                    source_wise_interpolation=True))
    assert sw.source_wise_interpolation
    compiled = lf.make_logl(device='cpu')
    assert (make_toy_fitter(compiled, engine='ad')[1]
            == make_toy_fitter(compiled)[1])


def test_kernel_inputs_are_checked():
    """The wrappers refuse shapes the kernels would misread, on any
    device."""
    anchor = torch.zeros((9, 2, 5), dtype=torch.float64)
    idx = torch.zeros((3, 2), dtype=torch.int64)
    t = torch.zeros((3, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match='observed'):
        fused.binned_vgh_fused(anchor, (3, 1), idx, t,
                               torch.ones((3, 2), dtype=torch.float64),
                               torch.ones((3, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match='anchor'):
        fused.binned_ll_fused_multi(anchor[0], (3, 1), idx[:, None], t[:, None],
                                    torch.ones((3, 1, 2)), torch.ones((3, 5)))


def _recorded_calls(label, contract, dtype=None):
    """chip_smoke.py's record of one 3-toy profile's calls of the path's
    wrapper of ``contract`` on the CPU (the study in ``dtype``, default
    float64): (the module's namespace, the call spec, the wrapper, the
    calls); the wrapper is put back after."""
    import runpy
    from blueice_tpu_torch import test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import fused_bb, fused_bb_lite
    from blueice_tpu_torch.utils import roofline
    smoke = runpy.run_path(str(Path(__file__).resolve().parents[1]
                               / 'chip_smoke.py'))
    set_progress(False)
    mods = dict(fused=fused, fused_bb=fused_bb, fused_bb_lite=fused_bb_lite,
                fused_unbinned=fused_unbinned, roofline=roofline)
    spec = smoke['CALLS'][contract][label]
    module = mods[spec.module]
    wrapper = getattr(module, spec.wrapper)
    assert callable(getattr(module, spec.launcher))
    if label == 'unbinned':
        import blueice_tpu_torch.likelihood as likelihood
        lf = smoke['build_model'](label, xenon_like, test_helpers, likelihood)
        study = UnbinnedToyStudy(lf, device='cpu', max_iter=30,
                                 engine='fused', dtype=dtype)
    else:
        lf = build_likelihood('binned', bb={'xenon': False, 'bb': True,
                                            'bblite': 'bb_lite'}[label],
                              **SIZE)
        study = BinnedToyStudy(lf, device='cpu', max_iter=30,
                               engine='fused', dtype=dtype)
    calls = smoke['record_calls'](label, study, mods, contract=contract,
                                  n_toys=3)
    assert getattr(module, spec.wrapper) is wrapper
    assert len(calls) >= 2
    # the shared tensors (anchor tensor and MC-count rows; unbinned: ps,
    # mask and inv_ref) are the fitters' own (one set for the free fit, one
    # for the conditional one), never copies a call; every per-call tensor
    # is a copy of its own
    shared_ptrs = set()
    for i in spec.shared:
        ptrs = {args[i].data_ptr() for args in calls}
        assert len(ptrs) <= 2
        shared_ptrs |= ptrs
    for i in range(len(calls[0])):
        if i not in spec.shared and torch.is_tensor(calls[0][i]):
            ptrs = {args[i].data_ptr() for args in calls}
            assert len(ptrs) == len(calls) and not ptrs & shared_ptrs
    return smoke, spec, wrapper, calls


@pytest.mark.parametrize('label', ['xenon', 'bb', 'bblite', 'unbinned'])
def test_chip_smoke_records_a_profiles_value_calls(label):
    """chip_smoke.py's recorder (what its value-kernel replay times) sees
    every call of the path's value wrapper in one profile, with the shared
    tensors passed through and the per-call inputs cloned, and puts the
    wrapper back."""
    smoke, spec, wrapper, calls = _recorded_calls(label, 'value')
    for args in calls:
        data = args[0]
        assert len(args) == {'xenon': 6, 'bb': 8, 'bblite': 7,
                             'unbinned': 10}[label]
        strides, idx, t, m = (args[spec.strides],) + args[spec.idx:
                                                          spec.idx + 3]
        L, A = idx.shape[:2]
        assert t.shape == (L, A, len(strides)) and m.shape[:2] == (L, A)
        assert smoke['call_candidates'](args, spec) == A
        if label == 'unbinned':
            lanes, mask, inv_ref, moff = args[2], args[6], args[7], args[8]
            assert lanes.shape == (L,) and moff.shape == (L, A)
            assert mask.shape == inv_ref.shape == (data.shape[0],
                                                   data.shape[-1])
        else:
            assert args[spec.idx + 3].shape == (L, data.shape[-1])
        # the recorded call reproduces what the wrapper computed
        assert wrapper(*args).shape == (L, A)


@pytest.mark.parametrize('label', ['xenon', 'bb', 'bblite', 'unbinned'])
def test_chip_smoke_records_a_profiles_vgh_calls(label):
    """chip_smoke.py's recorder for the vgh contract (what its vgh-kernel
    replay times) sees every call of the path's vgh wrapper in one profile,
    with the shared tensors passed through and the per-call inputs cloned,
    and puts the wrapper back."""
    smoke, spec, wrapper, calls = _recorded_calls(label, 'vgh')
    assert smoke['CALLS']['vgh'][label] == smoke['VGH_CALLS'][label]
    for args in calls:
        data = args[0]
        assert len(args) == {'xenon': 6, 'bb': 8, 'bblite': 7,
                             'unbinned': 10}[label]
        strides, idx, t, m = (args[spec.strides],) + args[spec.idx:
                                                          spec.idx + 3]
        L, K, S = idx.shape[0], len(strides), data.shape[-2]
        assert idx.shape == (L, K) and t.shape == (L, K)
        assert m.shape == (L, S)
        assert smoke['call_candidates'](args, spec) == 1
        if label != 'unbinned':
            assert args[spec.idx + 3].shape == (L, data.shape[-1])
        # the recorded call reproduces what the wrapper computed
        ll, g, H = wrapper(*args)
        assert ll.shape == (L,) and g.shape == (L, S + K)
        assert H.shape == (L, S + K, S + K)


def test_value_replay_ab_finds_the_baselines_sources(tmp_path):
    """measure_value_replay.py builds the baseline checkout's copy of each
    kernel source of both contracts (value and vgh), at the same place
    under its root."""
    import runpy
    from blueice_tpu_torch.ops import fused_bb, fused_bb_lite
    script = runpy.run_path(str(Path(__file__).resolve().parents[1]
                                / 'measure_value_replay.py'))
    mods = dict(fused=fused, fused_bb=fused_bb, fused_bb_lite=fused_bb_lite,
                fused_unbinned=fused_unbinned)
    for contract in ('value', 'vgh'):
        specs = script['CALLS'][contract]
        assert {spec.module for spec in specs.values()} == set(mods)
        assert set(script['AB_PATHS'][contract]) <= set(specs)
    for module in mods.values():
        name = Path(module.SOURCE).name
        with pytest.raises(FileNotFoundError):
            script['baseline_source'](module, str(tmp_path))
        (tmp_path / 'blueice_tpu_torch' / 'csrc').mkdir(parents=True,
                                                        exist_ok=True)
        (tmp_path / 'blueice_tpu_torch' / 'csrc' / name).write_text('')
        assert script['baseline_source'](module, str(tmp_path)) == str(
            tmp_path / 'blueice_tpu_torch' / 'csrc' / name)


def test_value_replay_ab_compares_both_contracts():
    """measure_value_replay.py's agreement check: 0 for equal outputs, the
    ll relative to itself and (vgh) g and H relative to each toy's largest
    entry."""
    import runpy
    script = runpy.run_path(str(Path(__file__).resolve().parents[1]
                                / 'measure_value_replay.py'))
    rng = np.random.default_rng(0)
    ll = torch.as_tensor(rng.uniform(1, 2, (4, 3)))
    assert script['disagreement'](ll, ll) == (0.0, 0.0)
    assert script['disagreement'](ll * (1 + 1e-6), ll)[0] == pytest.approx(
        1e-6)
    vgh = (ll[:, 0], ll, torch.as_tensor(rng.uniform(-1, 1, (4, 3, 3))))
    H = vgh[2].clone()
    H[2, 1, 1] += 1e-3 * float(vgh[2][2].abs().max())
    ll_rel, gh_rel = script['disagreement']((vgh[0], vgh[1], H), vgh)
    assert ll_rel == 0.0 and gh_rel == pytest.approx(1e-3)
    # an unbinned value call: relative to the magnitudes of its terms
    # (chip_smoke.term_scale), not to a centered ll near 0
    scale = torch.full_like(ll, 1e3)
    centered = ll - 1.5
    assert script['disagreement'](centered + 1e-3, centered, scale)[0] == \
        pytest.approx(1e-6)
    assert script['disagreement'](centered, centered, scale) == (0.0, 0.0)
    # an unbinned vgh call: its ll relative to the magnitudes of its terms
    # too, g and H to each toy's largest entry
    uvgh = (centered[:, 0], vgh[1], vgh[2])
    near = (uvgh[0] + 1e-3, uvgh[1], H)
    assert script['disagreement'](near, uvgh, scale[:, 0]) == (
        pytest.approx(1e-6), pytest.approx(1e-3))
    assert script['disagreement'](uvgh, uvgh, scale[:, 0]) == (0.0, 0.0)
    # a -inf ll (a rate of 0 at a valid event) or a NaN one (NaN rates)
    # in both agrees; in one only, not
    low = centered.clone()
    low[1, 2] = -float('inf')
    assert script['disagreement'](low, low, scale) == (0.0, 0.0)
    assert script['disagreement'](low, centered, scale)[0] == float('inf')
    nan = low.clone()
    nan[0, 0] = float('nan')
    assert script['disagreement'](nan, nan, scale) == (0.0, 0.0)
    assert np.isnan(script['disagreement'](nan, low, scale)[0])
    assert script['nonfinite']([low, nan, centered]) == 3
    # the vgh gate holds this checkout to the smaller of the old bound
    # (twice the baseline's worst error, at least 1e-5 and 1e-4; the ll
    # relative to its scale) and the new one from float32 itself (g/H
    # twice the float32 closed form's worst error, the ll lane by lane):
    # a baseline with a large error no longer widens the bound, and one
    # with a small error keeps it as tight as it was
    old_scales = [torch.tensor([1.0, 2.0, 1e-3]), torch.tensor([4.0])]
    new_ll = [torch.tensor([3e-5, 1e-5, 5e-4]), torch.tensor([2e-5])]
    f32_gh = np.array([3e-5, 1e-3])
    for baseline_worst in ((0.3, 0.05), (0.65, 0.045), (0.277, 0.00156)):
        ll, gh, old = script['held_bounds'](baseline_worst, old_scales,
                                            new_ll, f32_gh)
        assert gh == pytest.approx(2e-3) and tuple(old) == tuple(
            np.maximum((1e-5, 1e-4), 2 * np.array(baseline_worst)))
        for held, new in zip(ll, new_ll):
            torch.testing.assert_close(held, new)
    ll, gh, old = script['held_bounds']((1e-6, 1e-6), old_scales, new_ll,
                                        f32_gh)
    assert gh == pytest.approx(1e-4) and tuple(old) == (1e-5, 1e-4)
    torch.testing.assert_close(ll[0], torch.tensor([1e-5, 1e-5, 1e-8]))
    torch.testing.assert_close(ll[1], torch.tensor([2e-5]))
    # errors as large as the unbinned vgh kernel's at the centering point
    # passed the old gate of a baseline as far off; not the held one
    current = (old_scales[0] * 0.277, old_scales[1] * 0.277)
    ll, _, _ = script['held_bounds']((0.277, 0.00156), old_scales, new_ll,
                                     f32_gh)
    assert any(bool((c > a).any()) for c, a in zip(current, ll))
    # the new/old ll ratio lane by lane, non-finite lanes left out
    ratio = script['ll_ratios'](
        1e-4, [torch.tensor([1.0, 2.0, 0.0])],
        [torch.tensor([3e-5, 4e-4, 0.0])])
    torch.testing.assert_close(ratio, torch.tensor([0.3, 2.0]))


def test_value_replay_bins_calls_by_lanes():
    """measure_value_replay.py breaks a replay down by candidate count and
    bin of lanes: (A, '1-7'), (A, '8-31'), ..., (A, '256+'); a vgh call has
    A = 1."""
    import runpy
    script = runpy.run_path(str(Path(__file__).resolve().parents[1]
                                / 'measure_value_replay.py'))
    value, vgh = (script['CALLS'][c]['unbinned'] for c in ('value', 'vgh'))

    def call(spec, *idx_shape):
        args = [None] * 10
        args[spec.idx] = torch.zeros(idx_shape, dtype=torch.int64)
        return tuple(args)
    for L, label in ((1, '1-7'), (7, '1-7'), (8, '8-31'), (127, '32-127'),
                     (255, '128-255'), (256, '256+'), (1024, '256+')):
        assert script['lanes_and_A'](call(value, L, 12, 1), value) == (
            12, label)
        assert script['lanes_and_A'](call(vgh, L, 1), vgh) == (1, label)


def test_value_replay_bins_calls_by_cells():
    """measure_value_replay.py --by cells counts the grid cells (corner-id
    tuples) of each lane's candidates and breaks a value replay down by
    candidate count and bin of the call's mean cells a lane."""
    import runpy
    script = runpy.run_path(str(Path(__file__).resolve().parents[1]
                                / 'measure_value_replay.py'))
    spec = script['CALLS']['value']['unbinned']
    args = [None] * 10
    args[0] = torch.zeros((2, 3, 2, 5))            # ps (B, G, S, E)
    args[spec.strides] = (1,)
    # lane 0: four candidates in cell 0; lane 1: two in cell 0, two in 1
    args[spec.idx] = torch.tensor([[[0], [0], [0], [0]],
                                   [[0], [1], [0], [1]]])
    assert script['lane_cells'](tuple(args), spec).tolist() == [1, 2]
    assert script['cells_and_A'](tuple(args), spec) == (4, '2')
    for cells, label in ((1, '1'), (2, '2'), (3, '3-4'), (4, '3-4'),
                         (5, '5-8'), (8, '5-8'), (9, '9+'), (30, '9+')):
        assert script['cell_bin'](cells) == label


def _gaussian_vgh_call(seed=0):
    """The unbinned vgh contract's arguments at the Gaussian model's width
    (S = 2 sources on a 3-anchor axis), float32 on the CPU: masked tails,
    centered, on a lane subset in a non-trivial order."""
    rng = np.random.default_rng(seed)
    B, G, S, E, lanes = 6, 3, 2, 90, [4, 0, 5, 2, 0]
    L = len(lanes)
    ps = rng.uniform(0.001, 0.4, (B, G, S, E))
    mask = np.arange(E)[None, :] < rng.integers(E // 2, E - 2, B)[:, None]
    inv_ref = np.where(mask, rng.uniform(0.5, 2.0, (B, E)), 1.0)
    m = rng.uniform(20, 80, (L, S))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)
    return (f32(ps), (1,), torch.as_tensor(lanes),
            torch.as_tensor(rng.integers(0, 2, (L, 1))),
            f32(rng.uniform(0, 1, (L, 1))), f32(m), torch.as_tensor(mask),
            f32(inv_ref), f32(m.sum(-1) - rng.uniform(50, 150, L)), 0.0)


def test_value_replay_ab_takes_the_unbinned_vgh_calls():
    """measure_value_replay.py --contract vgh A/Bs both unbinned paths, and
    its float64 reference of an unbinned vgh call (the closed form on the
    call's gathered corner rows) equals the plain version run in float64
    on the same arguments."""
    import runpy
    script = runpy.run_path(str(Path(__file__).resolve().parents[1]
                                / 'measure_value_replay.py'))
    assert {'unbinned_xenon', 'unbinned'} <= set(script['AB_PATHS']['vgh'])
    args = _gaussian_vgh_call()
    smoke = runpy.run_path(str(Path(__file__).resolve().parents[1]
                               / 'chip_smoke.py'))
    ref = smoke['unbinned_vgh_double'](*args)
    as64 = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)
    plain = fused_unbinned.unbinned_vgh_plain(*as64)
    for x, y in zip(ref, plain):
        assert x.dtype == torch.float64
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    # and the float32 plain version agrees within the A/B's tolerances
    out = tuple(x.double() for x in fused_unbinned.unbinned_vgh_plain(*args))
    ll_err, gh_err = script['disagreement'](out, ref,
                                            smoke['term_scale'](*args))
    assert ll_err <= 1e-5 and gh_err <= 1e-4


@pytest.mark.parametrize('label', ['bb', 'unbinned'])
def test_value_replay_vgh_gate_on_a_profiles_calls(label):
    """The vgh gate's pieces on one float32 profile's recorded calls on the
    CPU (where the wrapper runs its plain version): the float32 and
    float64 closed forms of each call (unbinned: float32 an event with
    float64 sums, within 1e-4 of the plain version's outputs, g and H
    relative to each lane's largest entry, and closer to float64 than the
    plain version's float32 sums), the ll allowance lane by lane (at least
    1e-5 of the ll's scale, and at least float32's rounding of the lane's
    terms), and the allowances, which the binned wrapper's own outputs
    keep."""
    import runpy
    script = runpy.run_path(str(Path(__file__).resolve().parents[1]
                                / 'measure_value_replay.py'))
    smoke, spec, wrapper, calls = _recorded_calls(label, 'vgh',
                                                  torch.float32)
    module = {'fused_bb': fused_bb,
              'fused_unbinned': fused_unbinned}[spec.module]
    f32_errs, errs, used = [], [], []
    for args in calls:
        f32, f64 = (smoke['double'](x) for x in smoke['closed_forms'](
            module, spec.wrapper, args))
        assert f64[0].dtype == torch.float64
        allow = smoke['ll_allowance'](spec, args, f32, f64)
        assert allow.shape == f64[0].shape
        if label == 'unbinned':
            plain = fused_unbinned.unbinned_vgh_plain(*args)
            assert script['disagreement'](smoke['double'](plain), f32,
                                          smoke['term_scale'](*args)) \
                <= (1e-4, 1e-4)
            terms, rounding = smoke['term_scales'](*args)
            assert (rounding > 0).all() and (allow >= rounding).all()
            assert (allow >= 1e-5 * terms).all()
        else:
            assert (allow >= 1e-5 * f64[0].abs()).all()
        out = smoke['double'](wrapper(*args))
        f32_errs.append(smoke['disagreement'](f32, f64))
        errs.append(smoke['disagreement'](out, f64))
        used.append(smoke['disagreement'](out, f64, allow)[0])
    gh = smoke['float32_allowance'](np.array(f32_errs)[:, 1])
    assert gh >= 1e-4
    if label == 'unbinned':
        # the plain version sums over events in float32: its g loses more
        # than float32's own rounding of each event's terms
        assert np.max(f32_errs, axis=0)[1] < np.max(errs, axis=0)[1]
    else:
        assert max(used) <= 1 and np.max(errs, axis=0)[1] <= gh


@pytest.mark.parametrize('shape', [(2, 2 ** 16, 8, 2 ** 13),
                                   (2 ** 20, 1, 1, 2 ** 12)])
def test_unbinned_vgh_launcher_refuses_32bit_offsets(shape):
    """The unbinned vgh kernel addresses a toy's (G, S, E) block and the
    (B, E) mask and inv_ref at 32-bit offsets: a tensor of 2^32 entries or
    more is refused before anything is built or launched (meta tensors:
    shapes without memory)."""
    B, G, S, E = shape
    L = 2

    def meta(*size, dtype=torch.float32):
        return torch.empty(size, dtype=dtype, device='meta')
    with pytest.raises(ValueError, match='32-bit'):
        fused_unbinned.unbinned_vgh_launcher(
            meta(B, G, S, E), (1,), meta(L, dtype=torch.int64),
            meta(L, 1, dtype=torch.int64), meta(L, 1), meta(L, S),
            meta(B, E, dtype=torch.bool), meta(B, E), meta(L))
