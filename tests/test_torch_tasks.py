"""Delayed and process-pool template builds of the port
(``blueice_tpu_torch.parallel.tasks``, ``python -m blueice_tpu_torch.cli``
and ``prepare(n_cores=...)``), twins of ``tests/test_parallel.py`` with the
protocol's edge cases:

* a task file is consumed only once its cache file exists, computing a
  finished hash is a no-op, an unknown hash raises ``ValueError``, and a
  task whose config skips the cache write keeps its file;
* ``compute_all`` steps over dotfiles (a killed atomic write's leftovers);
* the CLI computes a task directory in a fresh interpreter;
* ``prepare(n_cores=2)`` gives anchor tensors bit-identical to the serial
  build and to the JAX package's ``prepare(n_cores=2)``, on deterministic
  (blob) templates, in a fresh interpreter held to a time limit
  (``tests/torch_tasks_worker.py``);
* ``ipp_client=None`` builds serially.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
from scipy import stats

from blueice_tpu_torch import cli
from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
from blueice_tpu_torch.models import Model
from blueice_tpu_torch.parallel import (compute_all, compute_many,
                                        compute_single,
                                        create_models_ipyparallel)
from blueice_tpu_torch.test_helpers import conf_for_test

from test_torch_profile_grid_map import fresh_template_caches  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a fresh interpreter may take (imports, builds, pool)
SUBPROCESS_LIMIT = 300


@pytest.fixture
def dirs():
    task_dir = tempfile.mkdtemp(prefix='bt_torch_tasks_')
    cache_dir = tempfile.mkdtemp(prefix='bt_torch_cache_')
    yield task_dir, cache_dir
    shutil.rmtree(task_dir)
    shutil.rmtree(cache_dir)


def _delayed_conf(task_dir, cache_dir, **kw):
    return conf_for_test(mc=True, n_events_for_pdf=int(1e4),
                         delay_pdf_computation=True,
                         task_dir=task_dir, cache_dir=cache_dir, **kw)


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests')]
        + [p for p in [os.environ.get('PYTHONPATH')] if p]))


def test_delayed_computation_roundtrip(dirs):
    task_dir, cache_dir = dirs
    m = Model(_delayed_conf(task_dir, cache_dir, sigma=1.23))
    s = m.sources[0]
    assert not s.pdf_has_been_computed
    assert os.path.exists(os.path.join(task_dir, s.hash))

    compute_single(s.hash, task_dir=task_dir, result_dir=cache_dir)
    # Task file consumed, result exists
    assert not os.path.exists(os.path.join(task_dir, s.hash))
    assert os.path.exists(os.path.join(cache_dir, s.hash))

    # Reload: cache hit, PDF usable
    m2 = Model(_delayed_conf(task_dir, cache_dir, sigma=1.23))
    assert m2.sources[0].from_cache
    assert m2.sources[0].pdf_has_been_computed
    assert abs(m2.sources[0].pdf([0.0])[0]
               - stats.norm(0, 1.23).pdf(0)) < 0.05

    # Idempotent: computing an already-computed hash is a no-op
    compute_single(s.hash, task_dir=task_dir, result_dir=cache_dir)
    # Unknown hash is an error
    with pytest.raises(ValueError):
        compute_single('deadbeef', task_dir=task_dir, result_dir=cache_dir)


def test_task_kept_without_a_cache_file(dirs):
    """A task whose config skips the cache write computes but leaves no
    result: it raises and keeps its task file for a retry."""
    task_dir, cache_dir = dirs
    m = Model(_delayed_conf(task_dir, cache_dir, sigma=0.7,
                            never_save_to_cache=True))
    h = m.sources[0].hash
    with pytest.raises(RuntimeError, match='keeping the task file'):
        compute_single(h, task_dir=task_dir, result_dir=cache_dir)
    assert os.path.exists(os.path.join(task_dir, h))
    assert not os.path.exists(os.path.join(cache_dir, h))


def test_compute_all_and_many(dirs):
    task_dir, cache_dir = dirs
    hashes = []
    for sigma in (0.8, 1.0, 1.4):
        m = Model(_delayed_conf(task_dir, cache_dir, sigma=sigma))
        hashes.append(m.sources[0].hash)
    # a killed atomic write's leftover: skipped, not read
    with open(os.path.join(task_dir, '.tmp_abc.part'), 'wb') as f:
        f.write(b'truncated')
    assert len(os.listdir(task_dir)) == 4

    compute_many(hashes[:1], task_dir=task_dir, result_dir=cache_dir)
    assert os.path.exists(os.path.join(cache_dir, hashes[0]))
    compute_all(task_dir, task_dir=task_dir, result_dir=cache_dir)
    assert os.listdir(task_dir) == ['.tmp_abc.part']
    for h in hashes:
        assert os.path.exists(os.path.join(cache_dir, h))
    with pytest.raises(FileNotFoundError):
        compute_all(os.path.join(task_dir, 'absent'))


def test_cli(dirs):
    task_dir, cache_dir = dirs
    m = Model(_delayed_conf(task_dir, cache_dir, sigma=2.0))
    h = m.sources[0].hash
    out = subprocess.run(
        [sys.executable, '-m', 'blueice_tpu_torch.cli',
         '--input', task_dir, '--output', cache_dir, '--n_cpus', '1'],
        env=_env(), capture_output=True, text=True,
        timeout=SUBPROCESS_LIMIT)
    assert out.returncode == 0, out.stderr
    assert os.path.exists(os.path.join(cache_dir, h))
    assert not os.path.exists(os.path.join(task_dir, h))
    with pytest.raises(SystemExit) as refused:
        cli.main(['--input', task_dir, '--n_cpus', '0'])
    assert refused.value.code == 2


def test_prepare_with_n_cores_is_bit_identical(tmp_path):
    """``prepare(n_cores=2)``: task files, a process pool, loads from the
    cache; the anchor tensors equal the serial build's and the JAX
    package's pool build's bit for bit, and no task file is left."""
    out_path = str(tmp_path / 'builds.npz')
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'tests', 'torch_tasks_worker.py'),
         out_path], env=_env(), capture_output=True, text=True,
        timeout=SUBPROCESS_LIMIT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    b = np.load(out_path)
    for label in ('pool', 'jax_pool'):
        np.testing.assert_array_equal(b[label + '_mus'], b['serial_mus'])
        np.testing.assert_array_equal(b[label + '_ps'], b['serial_ps'])
        assert int(b[label + '_tasks_left']) == 0
    assert b['serial_ps'].shape[:4] == (3, 3, 3, 3)


def test_ipp_client_none_builds_serially(dirs):
    task_dir, cache_dir = dirs
    configs = [conf_for_test(mc=True, n_events_for_pdf=int(1e4), sigma=s,
                             task_dir=task_dir, cache_dir=cache_dir)
               for s in (0.9, 1.1)]
    models = create_models_ipyparallel(configs, None)
    assert [m.sources[0].config['sigma'] for m in models] == [0.9, 1.1]
    assert all(m.sources[0].pdf_has_been_computed for m in models)
    lf = UnbinnedLogLikelihood(conf_for_test(
        mc=True, n_events_for_pdf=int(1e4), task_dir=task_dir,
        cache_dir=cache_dir))
    lf.add_shape_parameter('sigma', (0.9, 1.0, 1.1))
    lf.prepare(ipp_client=None)
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(0)))
    assert np.isfinite(lf()) and np.isfinite(lf(sigma=1.05))
    assert os.listdir(task_dir) == []
