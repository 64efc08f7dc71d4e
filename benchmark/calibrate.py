"""Readings that the correctness limits of a cell are set from (not run by
the benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--faults name,... --fault-seeds 1,2,3]
        [--out FILE]

In one process, set up once: for each seed of ``--seeds``, one call of the
program at the cell's batch on that seed's first datasets, its sample of
toys judged as a run judges it (the lower readings); for each seed of
``--control-seeds``, the lower-precision control put in the program's place
on the same sampled toys (the kind's reference built with
``storage=torch.bfloat16``: binned, its anchor payloads in bfloat16,
computing in float32), judged alike (the upper readings); for
each seed of ``--fault-seeds``, the program with each planted fault of
``--faults`` (``harness/faults.py``), judged alike. One JSON line per
reading on standard output (and appended to ``--out``), with each
per-toy gap's widest values and median."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, 'a') as f:
            f.write(line + '\n')


def _worst_toy(det, prog, pairs, calls, names):
    """What the toy with the widest fit gap looks like: its place, its
    fits' iterations, and the program's and the reference's points and
    values in the fit that stops short."""
    import numpy as np
    i = int(np.argmax(det['fit_gap']))
    fit = ('free' if det['fit_gap_free'][i] >= det['fit_gap_cond'][i]
           else 'cond')
    c, j = pairs[i]
    res = calls[c][fit]
    return dict(sample_index=i, call=c, toy=j, fit=fit,
                n_iter_free=int(calls[c]['free'].n_iter[j]),
                n_iter_cond=int(calls[c]['cond'].n_iter[j]),
                x_prog=dict(zip(names, np.round(prog['x_' + fit][i], 6)
                                .tolist())),
                x_ref=dict(zip(names, np.round(det['ref']['x_' + fit][i], 6)
                               .tolist())),
                ll_prog=float(res.max_ll[j]),
                ll_ref=float(det['ref']['ll_' + fit][i]))


def _spread(det):
    """Each per-toy gap's 12 widest values and its median."""
    import numpy as np
    out = {}
    for k in ('eval_gap', 't_eval_gap', 'fit_gap', 't_gap'):
        a = np.sort(np.asarray(det[k], float))[::-1]
        out[k] = dict(top=[float(v) for v in a[:12]],
                      median=float(np.median(a)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--faults', default='')
    ap.add_argument('--fault-seeds', default='')
    ap.add_argument('--out', default='')
    args = ap.parse_args(argv)

    import gc
    import numpy as np
    import torch
    from benchmark.harness import check, faults, runner
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cx = runner.prepare(args.workload, 'cuda')
    reference, system = cx.kind.reference, cx.kind.system
    cache_dir = os.path.join(runner.ROOT, 'build', 'benchmark_cache')

    def seeds_of(text):
        return [int(s) for s in text.split(',') if s]

    def profile(study, seed):
        ens = cx.ensemble(seed)
        t0 = time.time()
        t, free, cond = study._run_profile(ens.datasets(0), cx.target,
                                           cx.hypothesis, None)
        call_s = time.time() - t0
        calls = [dict(t=t, free=free, cond=cond)]
        data, prog, pairs = runner.sampled(reference, cx.model, ens, calls,
                                           cx.target, cx.hypothesis)
        return call_s, calls, data, prog, pairs

    def reading(side, seed, data, prog, **extra):
        t0 = time.time()
        numbers, det = check.judge(reference, cx.model, data, prog,
                                   cx.target, cx.hypothesis)
        row = dict(cell=args.workload, seed=seed, side=side,
                   judge_s=time.time() - t0, **numbers, **extra)
        row['gaps'] = _spread(det)
        return row, det

    seeds, control_seeds = seeds_of(args.seeds), seeds_of(args.control_seeds)
    lf, study = system.build_study(cx.config, 'cuda', cache_dir, cx.dtype)
    control = reference.build(cx.config, 'cuda', storage=torch.bfloat16)
    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        call_s, calls, data, prog, pairs = profile(study, seed)
        if seed in seeds:
            t, free, cond = (calls[0][k] for k in ('t', 'free', 'cond'))
            row, det = reading(
                'program', seed, data, prog, call_s=call_s,
                median_t=float(np.median(t)),
                mean_iters=float(np.mean(np.concatenate(
                    [free.n_iter, cond.n_iter]))))
            row['worst'] = _worst_toy(det, prog, pairs, calls,
                                      cx.model.names)
            _emit(row, args.out)
        if seed in control_seeds:
            ctrl = reference.profile_fits(control, data, cx.target,
                                          cx.hypothesis)
            _emit(reading('control', seed, data, ctrl)[0], args.out)
    del lf, study, control
    for name in [f for f in args.faults.split(',') if f]:
        gc.collect()
        torch.cuda.empty_cache()
        lf, study = system.build_study(cx.config, 'cuda', cache_dir,
                                       cx.dtype)
        faults.FAULTS[name](study)
        for seed in seeds_of(args.fault_seeds):
            call_s, calls, data, prog, pairs = profile(study, seed)
            _emit(reading('fault.' + name, seed, data, prog,
                          call_s=call_s)[0], args.out)
        del lf, study
    print(json.dumps(dict(done=True, seconds=time.time() - T_START)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
