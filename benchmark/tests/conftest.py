"""Fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``): a throwaway checkout with a tiny
configuration, mix, cell and metric added as files, and the card check of
the tests marked ``cuda``."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: A small binned model of the configurations' kind: 8 x 10 bins, three
#: sources, two shape parameters on 3 anchors each (one the efficiency)
TINY_CONFIG = {
    "name": "tiny", "source": "test", "reduced": [], "assumed": {},
    "likelihood": "binned", "dtype": "float64",
    "source_model": "gaussian_blob",
    "analysis_space": [["cs1", 0.0, 100.0, 8], ["log10_cs2", 1.0, 4.0, 10]],
    "livetime_days": 278.0,
    "sources": [
        {"name": "er", "events_per_day": 620.0, "blob_mean": [35.0, 2.55],
         "blob_sigma": [18.0, 0.16], "blob_corr": -0.2,
         "band_shift_response": 1.0, "width_response": 1.0,
         "tilt_response": 0.2, "apply_efficiency": False,
         "n_mc_events": 1000000},
        {"name": "wall", "events_per_day": 1.8, "blob_mean": [8.0, 1.90],
         "blob_sigma": [6.0, 0.35], "blob_corr": 0.5,
         "band_shift_response": 0.2, "width_response": 0.5,
         "tilt_response": 1.0, "apply_efficiency": False,
         "n_mc_events": 1000000},
        {"name": "wimp", "events_per_day": 2.5, "blob_mean": [25.0, 2.05],
         "blob_sigma": [12.0, 0.17], "blob_corr": 0.35,
         "band_shift_response": 0.8, "width_response": 0.9,
         "tilt_response": 0.5, "apply_efficiency": True,
         "n_mc_events": 1000000}],
    "rate_parameters": [{"source": "wimp"},
                        {"source": "er", "normal_prior": [1.0, 0.05]},
                        {"source": "wall", "normal_prior": [1.0, 0.3]}],
    "shape_parameters": [
        {"name": "band_shift", "anchors": [-1.0, 0.0, 1.0], "base": 0.0,
         "normal_prior": [0.0, 0.5]},
        {"name": "efficiency", "anchors": [0.7, 1.0, 1.3], "base": 1.0,
         "normal_prior": [1.0, 0.1]}],
    "efficiency_parameter": "efficiency",
    "statistical_uncertainty": None,
}
TINY_MIX = {"name": "tiny_mix", "kind": "closed_loop_ensemble",
            "toys_per_call": 12, "truth": {"wimp_rate_multiplier": 1.0},
            "target": "wimp_rate_multiplier", "hypothesis": 1.0,
            "check_toys": 8}
#: A per-layer metric that only this test's files define
TINY_METRIC = '''"""median_t: the median t of the traced window's toys."""

import numpy as np


def read(run):
    if run.trace is None:
        return None
    return float(np.median(np.concatenate([c['t'] for c in run.calls])))
'''


def tiny_config(bb=False):
    cfg = json.loads(json.dumps(TINY_CONFIG))
    if bb:
        cfg['name'] = 'tiny_bb'
        cfg['statistical_uncertainty'] = {'mode': 'bb_single', 'source': 'er'}
    return cfg


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and ``benchmark/``) beside a
    link to the port, with the cells ``tiny.tiny_mix`` and
    ``tiny_bb.tiny_mix``, their configurations, mix, limits and the
    metric ``median_t`` added as new files and entries."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(REPO, 'benchmark'), root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    os.symlink(os.path.join(REPO, 'blueice_tpu_torch'),
               root / 'blueice_tpu_torch')
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    bench = root / 'benchmark'
    for bb in (False, True):
        cfg = tiny_config(bb)
        (bench / 'configs' / (cfg['name'] + '.json')).write_text(
            json.dumps(cfg))
        spec['configs'].append({'name': cfg['name'], 'source': 'test',
                                'file': 'benchmark/configs/%s.json'
                                % cfg['name'], 'reduced': [], 'why': 'test'})
        cell = cfg['name'] + '.tiny_mix'
        spec['workloads'].append({'name': cell, 'config': cfg['name'],
                                  'traffic': 'tiny_mix', 'chips': 1,
                                  'why': 'test'})
        # the limits of the configuration's own kind, set on the card
        shutil.copy(bench / 'limits' / ('%s.ensemble.json' % (
            'xenon_bb' if bb else 'xenon')), bench / 'limits' / (
                cell + '.json'))
        for m in spec['end_to_end']:
            if 'workloads' in m:
                m['workloads'].append(cell)
        for m in spec['per_layer']:
            if m['name'] in ('iters_per_fit', 'device_idle_pct'):
                m['workloads'].append(cell)
    (bench / 'traffic' / 'tiny_mix.json').write_text(json.dumps(TINY_MIX))
    (bench / 'metrics' / 'median_t.py').write_text(TINY_METRIC)
    spec['per_layer'].append({
        'name': 'median_t', 'unit': 'stat', 'better': 'lower',
        'source': 'program_counter', 'layer': 'study', 'moves': 'toys_per_s',
        'workloads': ['tiny.tiny_mix', 'tiny_bb.tiny_mix']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return root


@pytest.fixture
def cuda_device():
    """Skips the test where no CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark runs on the card)")
    return torch.device('cuda')
