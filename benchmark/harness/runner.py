"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``); its correctness limits are in
``benchmark/limits/<cell>.json``; each metric is read by
``benchmark/metrics/<metric>.py`` (its ``read(run)`` returns a number, or
None where it finds nothing to read); the configuration's ``likelihood``
key names its kind, whose reference (``benchmark/reference/<kind>.py``:
the model, its fits, the datasets' draw and the judged rows) and system
(``benchmark/harness/systems/<kind>.py``: the port's study) the run goes
through. All are found by name, so a new configuration, mix, cell, metric
or likelihood kind is new files and entries only."""

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

from . import check, ensemble, roofline, trace

__all__ = ['ROOT', 'FORBIDDEN', 'Run', 'load_cell', 'load_kind', 'prepare',
           'run_cell', 'sampled', 'forbidden_modules']

#: The checkout: the folder that holds BENCHMARK.json
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: Top-level modules that may not be loaded in a run's process
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'blueice_tpu')
#: The process's intra-op threads: one, so that a run's host work does not
#: contend for the cores that a shared machine's other processes use
THREADS = 1
#: Calls of the study that a traced run profiles
TRACED_CALLS = 1


def _read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name, root=ROOT):
    """(spec, cell, config, traffic, limits) of the cell ``name``."""
    spec = _read_json(root, 'BENCHMARK.json')
    cells = {w['name']: w for w in spec['workloads']}
    if name not in cells:
        raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                       % (name, ', '.join(sorted(cells))))
    cell = cells[name]
    bench = os.path.join(root, 'benchmark')
    return (spec, cell,
            _read_json(bench, 'configs', cell['config'] + '.json'),
            _read_json(bench, 'traffic', cell['traffic'] + '.json'),
            _read_json(bench, 'limits', name + '.json'))


def metric_entries(spec, cell, traced):
    """The metrics a run of ``cell`` reports: with ``traced`` the
    per-layer ones, else the end-to-end ones, each where its ``workloads``
    lists the cell (without the key: every cell that reports the
    end-to-end metric it moves, or every cell)."""
    e2e = spec['end_to_end']
    reported = {m['name'] for m in e2e
                if cell['name'] in m.get('workloads', [cell['name']])}
    if not traced:
        return [m for m in e2e if m['name'] in reported]
    return [m for m in spec['per_layer']
            if cell['name'] in m.get('workloads', [cell['name']])
            and ('workloads' in m or m['moves'] in reported)]


def _load(module_name, path):
    mod_spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def load_reader(name, root=ROOT):
    """The module ``benchmark/metrics/<name>.py``."""
    return _load('benchmark_metric_' + name.replace('.', '_'),
                 os.path.join(root, 'benchmark', 'metrics', name + '.py'))


class Kind:
    """A likelihood kind's two modules, found by its name: ``reference``
    (``benchmark/reference/<name>.py``: ``build(config, device, storage)``,
    ``profile_fits``, ``sampler``, ``take``, ``join``) and ``system``
    (``benchmark/harness/systems/<name>.py``: ``build_study``)."""

    def __init__(self, reference, system):
        self.reference, self.system = reference, system


def load_kind(name, root=ROOT):
    """The :class:`Kind` of a configuration's ``likelihood`` ``name``."""
    bench = os.path.join(root, 'benchmark')
    paths = (os.path.join(bench, 'reference', name + '.py'),
             os.path.join(bench, 'harness', 'systems', name + '.py'))
    for path in paths:
        if not os.path.isfile(path):
            raise KeyError("no module %s for the likelihood kind %r"
                           % (os.path.relpath(path, root), name))
    tag = name.replace('.', '_')
    return Kind(_load('benchmark_reference_' + tag, paths[0]),
                _load('benchmark_system_' + tag, paths[1]))


class Run:
    """What a run leaves for the metric readers: ``setup_s``,
    ``window_s``, ``attempted`` and ``completed`` toys, the window's
    ``calls`` (per call: t, free and conditional results), and with
    tracing ``trace`` (:class:`~.trace.Records`), else None."""

    def __init__(self, **kw):
        self.trace = None
        self.__dict__.update(kw)


def _power_limit_w():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'],
            capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _window(study, ens, target, hypothesis, seconds=None, n_calls=None,
            sync=lambda: None):
    """Calls of the study on fresh datasets, one after another: every call
    begun while fewer than ``seconds`` have passed (at least one), or
    ``n_calls`` calls. Returns (per-call results, seconds from the first
    call's start to the end of the last)."""
    from torch.profiler import record_function
    calls = []
    t0 = time.perf_counter()
    while True:
        if seconds is not None and calls and (
                time.perf_counter() - t0 >= seconds):
            break
        if n_calls is not None and len(calls) >= n_calls:
            break
        with record_function('bench.draw'):
            data = ens.datasets(len(calls))
        t_call = time.perf_counter()
        with record_function('bench.study'):
            t, free, cond = study._run_profile(data, target, hypothesis,
                                               None)
        calls.append(dict(t=t, free=free, cond=cond,
                          seconds=time.perf_counter() - t_call))
    sync()
    return calls, time.perf_counter() - t0


def sampled(reference, model, ens, calls, target, hypothesis):
    """(the reference's data of the sampled toys, the program's results on
    them, (call, toy) pairs) of the sample of the window's toys that the
    check judges: the datasets drawn again and their rows taken by the
    kind's ``reference`` (``take``, ``join``), the results in the
    reference's parameter order."""
    pairs = ens.sample(list(range(len(calls))), [len(c['t']) for c in calls])
    by_call = {}
    for c, j in pairs:
        by_call.setdefault(c, []).append(j)
    data, prog = [], {k: [] for k in ('x_free', 'x_cond', 'll_free',
                                      'll_cond', 't')}
    fixed = {target: float(hypothesis)}
    for c, rows in sorted(by_call.items()):
        data.append(reference.take(ens.datasets(c), rows))
        r = calls[c]
        for key, res in (('free', r['free']), ('cond', r['cond'])):
            prog['x_' + key].append(check.full_points(
                res.names, res.x[rows], model.names, fixed))
            prog['ll_' + key].append(np.asarray(res.max_ll, float)[rows])
        prog['t'].append(np.asarray(r['t'], float)[rows])
    prog = {k: np.concatenate(v) for k, v in prog.items()}
    return reference.join(data), prog, pairs


def prepare(name, device, root=ROOT):
    """A :class:`Run`-like namespace of what a run of cell ``name`` sets
    up before the program: the cell's files (``spec``, ``cell``,
    ``config``, ``traffic``, ``limits``), the configuration's likelihood
    ``kind`` (:class:`Kind`), the float64 reference ``model`` on
    ``device``, the ``truth`` (P,) the datasets are drawn at, the test
    (``target``, ``hypothesis``), the datasets' ``dtype``, and
    ``ensemble(seed)``, the generator of a seed's datasets. Sets the
    process's torch threads (:data:`THREADS`) and turns TF32 off."""
    import torch
    spec, cell, config, traffic, limits = load_cell(name, root)
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = load_kind(config['likelihood'], root)
    model = kind.reference.build(config, device)
    truth = np.array(model.defaults, dtype=float)
    for k, v in traffic.get('truth', {}).items():
        truth[model.names.index(k)] = float(v)
    dtype = getattr(torch, config['dtype'])
    draw = kind.reference.sampler(model, truth,
                                  int(traffic['toys_per_call']), device,
                                  dtype)

    def make(seed):
        return ensemble.Ensemble(traffic, draw, seed, device)
    return Run(spec=spec, cell=cell, config=config, traffic=traffic,
               limits=limits, kind=kind, model=model, truth=truth,
               target=traffic['target'],
               hypothesis=float(traffic['hypothesis']), dtype=dtype,
               ensemble=make)


def run_cell(name, seed, seconds, traced, device='cuda', t_start=None,
             root=ROOT, study_hook=None):
    """One run of cell ``name``. Returns (result dict, lines that give each
    number compared beside its limit). ``study_hook(study)`` may replace
    the study's timed path (the harness's own tests break it with it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    t_start = time.time() if t_start is None else t_start
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        # the device's context, which the program needs, before the
        # reference's time is taken apart
        torch.zeros(1, device=device)
    marks = {'imports': time.time() - t_start}
    cx = prepare(name, device, root)
    # the reference's set-up (its anchor payloads, the draws' expectation)
    # is the yardstick's and not counted in ``setup_s``
    reference_s = time.time() - t_start - marks['imports']
    marks['reference'] = reference_s
    spec, cell, config, traffic, limits = (cx.spec, cx.cell, cx.config,
                                           cx.traffic, cx.limits)
    model, target, hyp, dtype = cx.model, cx.target, cx.hypothesis, cx.dtype
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ens = cx.ensemble(seed)

    entries = metric_entries(spec, cell, traced)
    readers = [(m, load_reader(m['name'], root)) for m in entries]
    interposers = [r.INTERPOSE for _, r in readers
                   if getattr(r, 'INTERPOSE', None) is not None]
    cache_dir = os.path.join(root, 'build', 'benchmark_cache')
    with roofline.installed(interposers):
        lf, study = cx.kind.system.build_study(config, device, cache_dir,
                                               dtype=dtype)
        marks['program'] = time.time() - t_start - reference_s
        if study_hook is not None:
            study_hook(study)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        # warm-up: one call at the cell's shapes, on datasets of its own
        study._run_profile(ens.datasets(ensemble.WARM_CALL), target, hyp,
                           None)
        sync()
        setup_s = time.time() - t_start - reference_s
        records = None
        if traced:
            for i in interposers:
                i.recording = True
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                with record_function('bench.window'):
                    calls, window_s = _window(
                        study, ens, target, hyp,
                        n_calls=TRACED_CALLS,
                        sync=sync)
            for i in interposers:
                i.recording = False
        else:
            calls, window_s = _window(study, ens, target, hyp,
                                      seconds=seconds, sync=sync)
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        del study, lf
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        attempted = sum(len(c['t']) for c in calls)
        failed = int(sum(np.sum(~(np.isfinite(c['t'])
                                  & np.isfinite(c['free'].max_ll)
                                  & np.isfinite(c['cond'].max_ll)))
                         for c in calls))
        n_iter = np.concatenate([np.concatenate([c['free'].n_iter,
                                                 c['cond'].n_iter])
                                 for c in calls])
        if traced:
            records = trace.records_of(prof, attempted, n_iter, interposers)
            del prof
        t_judge = time.time()
        data, prog, pairs = sampled(cx.kind.reference, model, ens, calls,
                                    target, hyp)
        numbers = check.judge(cx.kind.reference, model, data, prog, target,
                              hyp)[0]
        judged = len(pairs)
        judge_s = time.time() - t_judge
        run = Run(setup_s=setup_s, window_s=window_s, attempted=attempted,
                  completed=attempted - failed, calls=calls, trace=records,
                  n_iter=n_iter)
        metrics = {}
        for m, reader in readers:
            value = reader.read(run)
            if value is not None:
                metrics[m['name']] = {'value': float(value), 'unit': m['unit']}

    correct, lines = check.verdict(numbers, limits)
    correct = bool(correct and failed == 0)
    lines.append('failed_toys %d <= 0' % failed)
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
           'count': int(cell['chips']),
           'memory_peak_bytes': int(memory_peak)}
    if cuda:
        dev['power_limit_w'] = _power_limit_w()
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': dev}
    if records is not None:
        dev['busy_s'] = records.busy_s
        dev['window_s'] = records.window_s
        result['breakdown'] = records.breakdown()
    result['judged_toys'] = judged
    result['seconds'] = {'setup': setup_s, 'window': window_s,
                         'judge': judge_s, 'calls': len(calls),
                         'per_call': [c['seconds'] for c in calls],
                         'setup_marks': marks}
    result['check'] = {n: {'value': numbers[n], 'limit': limits[n]}
                       for n in check.NUMBERS}
    result['check']['failed_toys'] = {'value': failed, 'limit': 0}
    return result, lines


def forbidden_modules():
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))
