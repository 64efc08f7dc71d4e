"""A dry run of the toy-axis sharding over several processes: the port's
twin of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``).

The reference jits its toy step over an n-device mesh of one process and
covers the binned flagship model only. Here ``n`` ranks run as processes
(``python -m blueice_tpu_torch.dryrun --worker ...``, gloo between them; all
on the card, or on the CPU when asked), and each runs three studies of
the flagship model (two Gaussian Monte-Carlo sources over 40 bins, the
rate of s0 and the shape mu on 3 anchors): binned, unbinned, and binned
with Beeston-Barlow ``bb_single`` on s1. It checks:

* the sharded profile fits are finite and t >= 0, and every rank holds
  the same gathered result;
* layout invariance: the n-rank result against one rank's at the same
  seed (within the float64 tolerances of ``tests/test_distributed.py``;
  whether it came out bit-identical is printed);
* a 3-rank layout (not a power of two);
* a toy count that does not divide by n, rounded up, every toy finite;
* the weak-scaling ratio t_n(n m toys) / t_1(m toys), printed: 1 where
  the ranks overlap fully, n where they take turns.

Run it with ``python -m blueice_tpu_torch.dryrun [n_ranks] [--device
cpu]`` (without ``--device`` the ranks share the card).
"""

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .device import resolve

__all__ = ['flagship_likelihood', 'run_ranks', 'dryrun_multichip']

#: the dry run's models: 'binned', 'unbinned' and 'bb' are the flagship's
#: (:func:`flagship_likelihood`); the others are ``examples.xenon_like``
#: models at full width ('xenon', 'xenon_bb' with bb_single on ER,
#: 'unbinned_xenon' at 3 live days)
FLAGSHIP = ('binned', 'unbinned', 'bb')
TARGETS = {'binned': 's0_rate_multiplier', 'unbinned': 's0_rate_multiplier',
           'bb': 's0_rate_multiplier', 'xenon': 'wimp_rate_multiplier',
           'xenon_bb': 'wimp_rate_multiplier',
           'unbinned_xenon': 'wimp_rate_multiplier'}
#: the float64 tolerances of a sharded result against one rank's
#: (``tests/test_distributed.py``): t (rtol, atol), max_ll rtol
T_TOL = (1e-8, 1e-10)
LL_RTOL = 1e-10
#: the seed of the flagship's Monte-Carlo templates (every process draws
#: them from the same numpy state, as the JAX package's worker does)
TEMPLATE_SEED = 1234567
#: toys a rank of the weak-scaling runs
WEAK_TOYS = 4


def flagship_likelihood(kind, n_events_for_pdf=5000):
    """The dry run's model ``kind`` (see :data:`TARGETS`), prepared. The
    flagship's templates come from numpy's global state reseeded at
    :data:`TEMPLATE_SEED`, so every process builds the same ones."""
    from . import likelihood
    if kind not in FLAGSHIP:
        from .examples import xenon_like
        if kind == 'unbinned_xenon':
            return xenon_like.build_likelihood('unbinned', livetime_days=3.0)
        return xenon_like.build_likelihood('binned', bb=kind == 'xenon_bb')
    from .test_helpers import conf_for_test
    np.random.seed(TEMPLATE_SEED)
    conf = conf_for_test(n_sources=2, mc=True,
                         analysis_space=[['x', np.linspace(-10, 10, 41)]],
                         n_events_for_pdf=int(n_events_for_pdf))
    conf['sources'][1]['mu'] = 3.0
    if kind == 'unbinned':
        lf = likelihood.UnbinnedLogLikelihood(conf)
    else:
        lf = likelihood.BinnedLogLikelihood(conf, likelihood_config=(
            {'model_statistical_uncertainty_handling': 'bb_single',
             'bb_single_source': 's1'} if kind == 'bb' else None))
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
    lf.prepare()
    return lf


def ensemble_digest(toys):
    """sha256 of an ensemble's bytes (counts, or an event set's coords,
    mask and bins), to tell two draws apart without moving them."""
    h = hashlib.sha256()
    for x in (toys if isinstance(toys, (tuple, list)) else (toys,)):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _launch_modules():
    from .ops import (fused, fused_bb, fused_bb_lite, fused_unbinned,
                      newton_step, param_graph)
    return (fused, fused_bb, fused_bb_lite, fused_unbinned, param_graph,
            newton_step)


def _launches():
    out = {}
    for module in _launch_modules():
        out.update(module.launch_counts())
    return out


def _study(kind, device, study_kw):
    from .likelihood import UnbinnedLogLikelihood
    from .parallel import BinnedToyStudy, UnbinnedToyStudy
    lf = flagship_likelihood(kind)
    cls = (UnbinnedToyStudy if isinstance(lf, UnbinnedLogLikelihood)
           else BinnedToyStudy)
    return cls(lf, device=device, **study_kw)


def run_record(run, seconds, toys, result):
    """A run's record as a rank writes it: ``run`` with its ``seconds``,
    the launch counts since the last reset, the digest of the ensemble
    ``toys`` it fitted, and the gathered profile ``result`` (t, free,
    conditional ToyResults) as lists."""
    t, free, cond = result
    return dict(run, seconds=seconds, launches=_launches(),
                digest=ensemble_digest(toys), t=t.tolist(),
                free_ll=free.max_ll.tolist(), cond_ll=cond.max_ll.tolist(),
                free_x=free.x.tolist(), cond_x=cond.x.tolist(),
                free_iter=free.n_iter.tolist(),
                cond_iter=cond.n_iter.tolist())


def worker(rank, world, port, out_path, device, spec):
    """One rank: join the gloo group, then for each run of ``spec`` (a
    dict: 'runs', a list of dicts with the model, its seed, n_toys and
    'repeats' (default 1); 'study', the studies' keywords) draw the
    model's ensemble over the global mesh and profile it ``repeats`` times
    (``study.profile_ts``'s two steps, so that the digest is of the toys
    fitted; timed, every launch counter reset before and read after), and
    write every run's gathered result to ``out_path``."""
    from .parallel.distributed import init_distributed, global_mesh
    from .utils import set_progress
    set_progress(False)
    if device == 'cpu':
        torch.set_num_threads(1)
    init_distributed('localhost:%d' % port, world, rank, backend='gloo',
                     device=device)
    mesh = global_mesh()
    studies, runs = {}, []
    for run in spec['runs']:
        model = run['model']
        if model not in studies:
            studies[model] = _study(model, mesh.device, spec.get('study', {}))
        study = studies[model]
        secs = []
        for module in _launch_modules():
            module.reset_launch_counts()
        for _ in range(run.get('repeats', 1)):
            t0 = time.perf_counter()
            toys = study.simulate(run['seed'], run['n_toys'], mesh=mesh)
            result = study._run_profile(toys, TARGETS[model], 1.0, None,
                                        mesh=mesh)
            if mesh.device.type == 'cuda':
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        runs.append(run_record(run, secs, toys, result))
    with open(out_path, 'w') as f:
        json.dump(dict(rank=rank, world=world, device=str(mesh.device),
                       runs=runs), f)
    torch.distributed.destroy_process_group()


def run_ranks(world, spec, device=None, timeout=300):
    """Run :func:`worker` as ``world`` processes (``python -m
    blueice_tpu_torch.dryrun --worker``, each a fresh interpreter: a
    CUDA-initialised parent cannot fork one) and return their results,
    rank by rank. ``device``: None for the card (without CUDA this
    raises), or 'cpu'. Raises if a rank fails or outlasts ``timeout``
    seconds (every rank is then stopped)."""
    from .parallel.distributed import _free_port
    device = resolve(device)[0].type
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix='blueice_tpu_torch_dryrun_')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env['PYTHONPATH'] = root + os.pathsep + env.get('PYTHONPATH', '')
    outs = [os.path.join(tmp, 'rank%d.json' % r) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'blueice_tpu_torch.dryrun', '--worker',
         str(r), str(world), str(port), outs[r], device, json.dumps(spec)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        deadline = time.time() + timeout
        logs = [p.communicate(timeout=max(1.0, deadline - time.time()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    try:
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError("dry-run rank %d of %d failed (rc %d):\n%s"
                                   % (r, world, p.returncode,
                                      log.decode(errors='replace')[-4000:]))
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _arrays(run):
    return {k: np.asarray(v) for k, v in run.items()
            if isinstance(v, list) and k != 'seconds'}


def same_on_every_rank(results):
    """Raise unless every rank holds the same gathered arrays, bit for
    bit, and the same ensemble digest, run by run."""
    for r in results[1:]:
        for a, b in zip(results[0]['runs'], r['runs']):
            if a['digest'] != b['digest']:
                raise AssertionError("ranks 0 and %d drew different %s toys"
                                     % (r['rank'], a['model']))
            for k, v in _arrays(a).items():
                if not np.array_equal(v, _arrays(b)[k]):
                    raise AssertionError(
                        "ranks 0 and %d hold different %s %s"
                        % (r['rank'], a['model'], k))


def layout_gap(run, ref):
    """(bit-identical, max relative |d t|, max relative |d max_ll|) of a
    run against the same run at another world size; raises beyond
    :data:`T_TOL` / :data:`LL_RTOL`."""
    a, b = _arrays(run), _arrays(ref)
    if run['digest'] != ref['digest']:
        raise AssertionError("%s: the toys differ between the layouts"
                             % run['model'])
    np.testing.assert_allclose(a['t'], b['t'], rtol=T_TOL[0],
                               atol=T_TOL[1])
    for k in ('free_ll', 'cond_ll'):
        np.testing.assert_allclose(a[k], b[k], rtol=LL_RTOL)
    same = all(np.array_equal(a[k], b[k]) for k in ('t', 'free_ll',
                                                    'cond_ll', 'free_x'))
    d_t = np.max(np.abs(a['t'] - b['t']) / np.maximum(np.abs(b['t']), 1e-300))
    d_ll = max(np.max(np.abs(a[k] - b[k]) / np.abs(b[k]))
               for k in ('free_ll', 'cond_ll'))
    return same, float(d_t), float(d_ll)


def _check_finite(run):
    a = _arrays(run)
    if not (np.isfinite(a['free_ll']).all() and np.isfinite(a['cond_ll']).all()
            and (a['t'] >= 0).all()):
        raise AssertionError("%s: a sharded fit is not finite or t < 0"
                             % run['model'])


def dryrun_multichip(n_devices, device=None, models=FLAGSHIP, timeout=300):
    """The dry run over ``n_devices`` ranks (see the module docstring);
    prints what it checked and returns the weak-scaling ratio of each
    model. ``device``: None for every rank on the card (without CUDA this
    raises), or 'cpu'."""
    n = int(n_devices)
    device = resolve(device)[0].type
    sizes = [n, 1] + ([3] if n > 3 else [])
    n_cmp = int(np.lcm.reduce(sizes)) * 2
    n_odd = 2 * n + 1
    def spec(seed, n_toys, repeats=1):
        return [dict(model=m, seed=seed, n_toys=n_toys, repeats=repeats)
                for m in models]
    study = dict(max_iter=25)
    full = run_ranks(n, dict(runs=spec(0, n_cmp) + spec(0, n_odd)
                             + spec(1, WEAK_TOYS * n, 3), study=study),
                     device, timeout)
    one = run_ranks(1, dict(runs=spec(0, n_cmp) + spec(1, WEAK_TOYS, 3),
                            study=study), device, timeout)
    same_on_every_rank(full)
    k = len(models)
    runs, runs1 = full[0]['runs'], one[0]['runs']
    for run in runs[:2 * k]:
        _check_finite(run)
    print("dryrun_multichip: %d ranks (%s): %d toys profiled a model (%s); "
          "fits finite, t >= 0, every rank holds the same result"
          % (n, device, n_cmp, ', '.join(models)))
    for run, ref in zip(runs[:k], runs1[:k]):
        same, d_t, d_ll = layout_gap(run, ref)
        print("dryrun_multichip: %s layout invariance, %d ranks vs 1: the "
              "same toys; %s (max relative |d t| %.3g, |d max_ll| %.3g)"
              % (run['model'], n, 'bit-identical' if same else
                 'within t rtol %g, max_ll rtol %g' % (T_TOL[0], LL_RTOL),
                 d_t, d_ll))
    if n > 3:
        three = run_ranks(3, dict(runs=spec(0, n_cmp), study=study),
                          device, timeout)
        same_on_every_rank(three)
        for run, ref in zip(three[0]['runs'], runs1[:k]):
            _check_finite(run)
            same, d_t, d_ll = layout_gap(run, ref)
            print("dryrun_multichip: %s on 3 ranks (not a power of two) vs "
                  "1: %s (max relative |d t| %.3g)"
                  % (run['model'], 'bit-identical' if same else 'within '
                     'tolerance', d_t))
    padded = -(-n_odd // n) * n
    for run in runs[k:2 * k]:
        if len(run['t']) != padded:
            raise AssertionError("%s: %d toys over %d ranks gave %d, not %d"
                                 % (run['model'], n_odd, n, len(run['t']),
                                    padded))
    print("dryrun_multichip: %d toys rounded up to %d over %d ranks; every "
          "padded toy an ordinary, finite one" % (n_odd, padded, n))
    ratios = {}
    for run, ref in zip(runs[2 * k:], runs1[k:]):
        t_n, t_1 = min(run['seconds'][1:]), min(ref['seconds'][1:])
        ratios[run['model']] = t_n / t_1
        print("dryrun_multichip: %s weak scaling: %d ranks x %d toys %.3f s "
              "vs 1 rank x %d toys %.3f s (warm, best of 2): ratio %.3f "
              "(1: the ranks overlap fully; %d: they take turns)"
              % (run['model'], n, WEAK_TOYS, t_n, WEAK_TOYS, t_1,
                 t_n / t_1, n))
    print("dryrun_multichip OK: %d ranks; sharded fits, layout invariance "
          "(%d vs 1%s), non-divisible toy rounding, weak scaling %s"
          % (n, n, ', 3' if n > 3 else '', json.dumps(
              {m: round(r, 3) for m, r in ratios.items()})))
    return ratios


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m blueice_tpu_torch.dryrun',
        description="Dry run of the toy-axis sharding over n ranks.")
    parser.add_argument('n_ranks', nargs='?', type=int, default=2)
    parser.add_argument('--device', choices=('cpu', 'cuda'), default=None,
                        help="the ranks' device (default: the card)")
    parser.add_argument('--worker', nargs=6, metavar=(
        'RANK', 'WORLD', 'PORT', 'OUT', 'DEVICE', 'SPEC'),
        help="run one rank (used by run_ranks)")
    args = parser.parse_args(argv)
    if args.worker:
        rank, world, port, out, device, spec = args.worker
        worker(int(rank), int(world), int(port), out, device,
               json.loads(spec))
        return 0
    if args.device is None and not torch.cuda.is_available():
        print("dryrun: CUDA is not available; pass --device cpu",
              file=sys.stderr)
        return 2
    dryrun_multichip(args.n_ranks, args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
