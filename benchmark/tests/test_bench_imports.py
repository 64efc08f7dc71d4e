"""What a run may load and where it refuses to run."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import runner

BENCH = os.path.join(runner.ROOT, 'benchmark')


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', sorted(
    glob.glob(os.path.join(BENCH, 'reference', '*.py'))),
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split('.')[0] for m in _imports(path)}
    assert tops <= {'itertools', 'math', 'numpy', 'torch'}, tops


@pytest.mark.parametrize('path', sorted(
    glob.glob(os.path.join(BENCH, '*.py'))
    + glob.glob(os.path.join(BENCH, 'harness', '*.py'))
    + glob.glob(os.path.join(BENCH, 'harness', 'systems', '*.py'))
    + glob.glob(os.path.join(BENCH, 'metrics', '*.py'))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_no_file_imports_jax(path):
    tops = {m.split('.')[0] for m in _imports(path)}
    assert not tops & {'jax', 'jaxlib', 'flax', 'blueice_tpu'}, tops


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'blueice_tpu_torch_like', object())
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'blueice_tpu.parallel', object())
    monkeypatch.setitem(sys.modules, 'jax.numpy', object())
    assert runner.forbidden_modules() == ['blueice_tpu', 'jax']


def _run(cwd):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'xenon.ensemble',
         '--seed', '4294967311', '--seconds', '1', '--trace', '0'],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result(cuda_absent):
    out = _run(runner.ROOT)
    assert out.returncode != 0 and out.stdout == ''


def test_benchmark_alone_fails(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    paths: no program to run, so no result (where a card is present, the
    port's import fails)."""
    with open(os.path.join(runner.ROOT, 'BENCHMARK.json')) as f:
        paths = json.load(f)['paths']
    shutil.copy(os.path.join(runner.ROOT, 'BENCHMARK.json'), tmp_path)
    for p in paths:
        shutil.copytree(os.path.join(runner.ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns('__pycache__'))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ''


@pytest.fixture
def cuda_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(cuda_device):
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'xenon.ensemble',
         '--seed', '4294967317', '--seconds', '2', '--trace', '0'],
        capture_output=True, text=True, timeout=900, cwd=runner.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().split('\n')[-1])
    assert result['correct'], out.stderr[-2000:]
