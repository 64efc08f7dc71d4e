"""The port's toy-axis sharding (``parallel/toys.py`` meshes,
``parallel/distributed.py``, ``dryrun.py``) on the CPU, float64.

* a mesh of one process is no mesh, bit for bit, for ``profile_ts``,
  ``run``, ``profile_ts_grid``, ``profile_ts_scan`` and
  ``toy_upper_limits`` on the binned, unbinned and Beeston-Barlow
  flagship models;
* two ranks joined by gloo (``python -m blueice_tpu_torch.dryrun
  --worker``) hold the same gathered arrays and match one process within
  the tolerances of ``tests/test_distributed.py`` (t rtol 1e-8, atol
  1e-10; max_ll rtol 1e-10); a toy count that does not divide rounds up to
  ordinary, finite toys; ranks with other seeds refuse to run (two ranks
  of ``tests/torch_distributed_worker.py``, which also makes the numpy
  counts below);
* the rows a rank keeps are the rows the JAX package places on that
  device of the session's 8-device CPU mesh (``shard_toys``,
  ``to_global_toys``), and the two ranks' sharded profile of numpy-made
  counts matches the JAX study's ``_run_profile`` of the same counts
  placed by ``shard_toys(make_mesh(), counts)``;
* ``dryrun_multichip(3)`` runs through.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu.likelihood import BinnedLogLikelihood as JaxBinned
from blueice_tpu.parallel import BinnedToyStudy as JaxStudy
from blueice_tpu.parallel import make_mesh as jax_make_mesh
from blueice_tpu.parallel import shard_toys as jax_shard_toys
from blueice_tpu.parallel.distributed import \
    to_global_toys as jax_to_global_toys
from blueice_tpu.test_helpers import conf_for_test as jax_conf
from blueice_tpu.utils import set_progress as jax_set_progress
from blueice_tpu_torch import dryrun
from blueice_tpu_torch.parallel import (BinnedToyStudy, UnbinnedToyStudy,
                                        make_mesh, shard_toys,
                                        toy_upper_limits)
from blueice_tpu_torch.parallel.distributed import (
    _free_port, gather_to_hosts, init_distributed, profile_ts_distributed,
    run_distributed, to_global_toys)
from blueice_tpu_torch.parallel.toys import ToyMesh, _round_up_toys
from blueice_tpu_torch.utils import set_progress

from test_torch_profile_grid_map import (  # noqa: F401,E402
    fresh_template_caches, one_torch_thread)
from torch_distributed_worker import numpy_counts

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'torch_distributed_worker.py')

MODELS = dryrun.FLAGSHIP
TARGET = 's0_rate_multiplier'
N_TOYS = 16
#: a toy count that two ranks do not divide
N_ODD = 7
STUDY = dict(max_iter=25)


def _study(kind):
    set_progress(False)
    lf = dryrun.flagship_likelihood(kind)
    cls = UnbinnedToyStudy if kind == 'unbinned' else BinnedToyStudy
    return cls(lf, device='cpu', **STUDY)


@pytest.fixture(scope='module')
def studies():
    return {kind: _study(kind) for kind in MODELS}


@pytest.fixture(scope='module')
def two_ranks():
    """Both ranks' results of one gloo run of the package's worker: each
    model at N_TOYS toys (seed 0), and binned at N_ODD toys."""
    runs = ([dict(model=m, seed=0, n_toys=N_TOYS) for m in MODELS]
            + [dict(model='binned', seed=0, n_toys=N_ODD)])
    return dryrun.run_ranks(2, dict(runs=runs, study=STUDY), 'cpu',
                            timeout=300)


@pytest.fixture(scope='module')
def worker_ranks():
    """Both ranks' results of one gloo run of the test worker
    (``torch_distributed_worker.py``): the binned flagship's sharded
    profile of numpy-made counts (seed 3), then a draw from seeds 0 and 1
    on ranks 0 and 1."""
    spec = dict(numpy_seed=3, n_toys=N_TOYS, rank_seeds=[0, 1], study=STUDY)
    root = os.path.dirname(os.path.dirname(WORKER))
    env = dict(os.environ)
    env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, 'rank%d.json' % r) for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), '2', str(port), outs[r],
             json.dumps(spec)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log.decode(errors='replace')[-4000:]
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
    return results


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _flat(res):
    t, free, cond = res
    return (t, free.x, free.max_ll, free.n_iter, cond.x, cond.max_ll,
            cond.n_iter)


@pytest.mark.parametrize('kind', MODELS)
@pytest.mark.parametrize('entry', ['profile_ts', 'run', 'profile_ts_grid',
                                   'profile_ts_scan', 'toy_upper_limits'])
def test_one_process_mesh_is_no_mesh(studies, kind, entry):
    """Every study entry that takes mesh=, and a statistic that forwards
    it, gives with a one-process mesh what it gives with none."""
    study = studies[kind]
    mesh = make_mesh()
    assert mesh.size == 1 and mesh.group is None
    hyps = [0.5, 1.0, 2.0]
    if entry == 'profile_ts':
        def call(**kw):
            return _flat(study.profile_ts(0, 6, TARGET, 1.0, **kw))
    elif entry == 'run':
        def call(**kw):
            r = study.run(1, 6, **kw)
            return r.x, r.max_ll, r.n_iter
    elif entry == 'profile_ts_grid':
        def call(**kw):
            ts, hyps_, free, conds = study.profile_ts_grid(
                2, TARGET, hyps, 4, **kw)
            return (ts, hyps_, free.x, free.max_ll) + tuple(
                c.max_ll for c in conds)
    elif entry == 'profile_ts_scan':
        def call(**kw):
            ts, frees = study.profile_ts_scan(3, TARGET, hyps, 4,
                                              return_free=True, **kw)
            return (ts,) + tuple(f.max_ll for f in frees)
    else:
        def call(**kw):
            return (toy_upper_limits(study, 4, TARGET, hyps + [4.0], 4,
                                     **kw),)
    assert _same(call(), call(mesh=mesh))
    assert _same(call(), call(mesh=make_mesh(devices=['cpu'])))


def test_mesh_holds_one_device_per_process(studies):
    with pytest.raises(ValueError, match='init_distributed'):
        make_mesh(devices=['cpu', 'cpu'])
    with pytest.raises(TypeError, match='ToyMesh'):
        studies['binned'].profile_ts(0, 2, TARGET, 1.0, mesh=object())
    with pytest.raises(ValueError, match='process group'):
        ToyMesh(world_size=2, rank=0)
    with pytest.raises(ValueError, match='backend'):
        init_distributed(num_processes=1, backend='NCCL ', device='cpu')


def test_round_up_toys_and_padded_toys_are_finite(two_ranks):
    mesh3 = ToyMesh(group=object(), world_size=3, rank=1)  # no collective
    assert [_round_up_toys(n, mesh3) for n in (1, 3, 7, 9)] == [3, 3, 9, 9]
    assert mesh3.block(9) == (3, 6)
    with pytest.raises(ValueError, match='round'):
        mesh3.block(7)
    for res in two_ranks:
        run = res['runs'][len(MODELS)]
        assert run['n_toys'] == N_ODD and len(run['t']) == N_ODD + 1
        assert np.isfinite(run['free_ll']).all()
        assert np.isfinite(run['cond_ll']).all()
        assert (np.asarray(run['t']) >= 0).all()


@pytest.mark.parametrize('kind', MODELS)
def test_two_ranks_match_one_process(studies, two_ranks, kind):
    """Both ranks hold the same gathered arrays bit for bit; they match
    the single-process profile of the same seed within the JAX test's
    tolerances, and the single-process entry through
    profile_ts_distributed (no group: one process) is that result."""
    dryrun.same_on_every_rank(two_ranks)
    run = two_ranks[0]['runs'][MODELS.index(kind)]
    assert run['model'] == kind and two_ranks[0]['world'] == 2
    study = studies[kind]
    t, free, cond = study.profile_ts(0, N_TOYS, TARGET, 1.0)
    assert run['digest'] == dryrun.ensemble_digest(study.simulate(0, N_TOYS))
    np.testing.assert_allclose(run['t'], t, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(run['free_ll'], free.max_ll, rtol=1e-10)
    np.testing.assert_allclose(run['cond_ll'], cond.max_ll, rtol=1e-10)
    t2, free2, _ = profile_ts_distributed(study, 0, N_TOYS, TARGET, 1.0)
    assert _same((t, free.max_ll), (t2, free2.max_ll))
    r1, r2 = study.run(0, N_TOYS), run_distributed(study, 0, N_TOYS)
    assert _same((r1.x, r1.max_ll), (r2.x, r2.max_ll))


def test_ranks_with_other_seeds_refuse(worker_ranks):
    """Ranks that pass other seeds refuse to draw, every one of them (each
    would draw other toys), and both ranks hold the same sharded profile
    of the same counts."""
    dryrun.same_on_every_rank(worker_ranks)
    for res in worker_ranks:
        assert res['refusal'] is not None
        assert 'different seeds' in res['refusal']


def _jax_flagship():
    jax_set_progress(False)
    np.random.seed(dryrun.TEMPLATE_SEED)
    conf = jax_conf(n_sources=2, mc=True,
                    analysis_space=[['x', np.linspace(-10, 10, 41)]],
                    n_events_for_pdf=5000)
    conf['sources'][1]['mu'] = 3.0
    lf = JaxBinned(conf)
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    lf.prepare()
    return lf


def test_rank_rows_are_jax_placement():
    """Rank r of 8 keeps the rows the JAX package puts on device r of the
    8-device mesh, for shard_toys and to_global_toys; gather_to_hosts of
    one process is the tree as numpy."""
    counts = np.random.default_rng(0).poisson(3.0, (16, 5)).astype(float)
    jmesh = jax_make_mesh()
    assert jmesh.devices.size == 8
    for jarr in (jax_shard_toys(jmesh, counts),
                 jax_to_global_toys(jmesh, counts)):
        shards = {s.device: np.asarray(s.data)
                  for s in jarr.addressable_shards}
        for r, dev in enumerate(jmesh.devices.flat):
            mesh = ToyMesh(group=object(), world_size=8, rank=r)
            for fn in (shard_toys, to_global_toys):
                np.testing.assert_array_equal(fn(mesh, counts).numpy(),
                                              shards[dev])
    tree = (torch.arange(4.0), [torch.ones(2)])
    out = gather_to_hosts(tree)
    assert isinstance(out[0], np.ndarray) and out[1][0].tolist() == [1, 1]


def test_sharded_profile_matches_jax(studies, worker_ranks):
    """The two ranks' sharded profile of numpy-made counts against the JAX
    study's profile of the same counts placed over its 8-device mesh: the
    same optima (max_ll rtol 1e-8, t atol 1e-4, as the binned study
    parity tests)."""
    run = worker_ranks[0]['runs'][0]
    counts = numpy_counts(studies['binned'], 3, N_TOYS)
    assert run['digest'] == dryrun.ensemble_digest(torch.as_tensor(counts))
    jstudy = JaxStudy(_jax_flagship(), max_iter=25, engine='analytic',
                      profile_mode='split')
    np.testing.assert_allclose(
        np.asarray(jstudy.expected_counts()),
        studies['binned'].expected_counts().numpy(), rtol=1e-12)
    jt, jfree, jcond = jstudy._run_profile(
        jax_shard_toys(jax_make_mesh(), jnp.asarray(counts)), TARGET, 1.0,
        None)
    np.testing.assert_allclose(run['free_ll'], np.asarray(jfree.max_ll),
                               rtol=1e-8)
    np.testing.assert_allclose(run['cond_ll'], np.asarray(jcond.max_ll),
                               rtol=1e-8)
    np.testing.assert_allclose(run['free_x'], np.asarray(jfree.x),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(run['t'], np.asarray(jt), atol=1e-4)


def test_dryrun_defaults_to_the_card(monkeypatch, capsys):
    """The dry run's entry points put the ranks on the card unless given
    'cpu', and without CUDA they raise (main returns 2) before a rank
    starts."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        dryrun.run_ranks(1, dict(runs=[]))
    with pytest.raises(RuntimeError, match='CUDA'):
        dryrun.dryrun_multichip(2)
    assert dryrun.main(['2']) == 2
    assert '--device cpu' in capsys.readouterr().err


def test_dryrun_multichip_three_ranks(capsys):
    ratios = dryrun.dryrun_multichip(3, 'cpu')
    assert set(ratios) == set(MODELS)
    assert all(np.isfinite(r) and r > 0 for r in ratios.values())
    out = capsys.readouterr().out
    assert 'layout invariance' in out and 'dryrun_multichip OK' in out
