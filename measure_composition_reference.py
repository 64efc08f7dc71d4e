#!/usr/bin/env python3
"""The JAX package's median profile statistic on the composition paths, on
the CPU: the centres of ``chip_smoke.py``'s median-t bands for ``combined``
and ``xenon_log``.

Run from the root of a checkout on a machine with JAX (the port's tests
need it too; the card's machine has none):

    python3 measure_composition_reference.py [n_toys] [label ...]

For each label (default both), it builds the path's likelihood with the
JAX package, exactly as ``chip_smoke.py`` builds it with the port
(``combined_likelihood``, ``xenon_log_likelihood``), and runs
``blueice_tpu.parallel.BinnedToyStudy(lf, engine='analytic', max_iter=96,
tol=3e-4)`` in float64 with ``profile_ts`` on ``wimp_rate_multiplier`` at
hypothesis 1.0, ``n_toys`` toys (default 256) for each of seeds 0 and 1:
the toys of ``study.simulate(PRNGKey(seed), n_toys)``, fitted in chunks of
``CHUNK`` (the float64 program over all of them at once needs tens of GB
of host memory). It prints, per label, the median t of each seed and of
both together, the bootstrap spread (standard deviation over 2,000 resamples) of the pooled
median, the mean fitted target, and the wall time. The last line is one
JSON object with these numbers.
"""

import json
import sys
import time

import numpy as np

from chip_smoke import combined_likelihood, xenon_log_likelihood

TARGET = 'wimp_rate_multiplier'
LABELS = ('combined', 'xenon_log')
#: toys a fitted chunk
CHUNK = 32


def reference(label, n_toys):
    import jax
    from blueice_tpu import composition, likelihood
    from blueice_tpu.examples import xenon_like
    from blueice_tpu.parallel import BinnedToyStudy

    t0 = time.time()
    if label == 'combined':
        lf = combined_likelihood(xenon_like, likelihood, composition)
    else:
        lf = xenon_log_likelihood(xenon_like, likelihood)
    built = time.time() - t0
    study = BinnedToyStudy(lf, engine='analytic', max_iter=96, tol=3e-4)
    ts, means = [], []
    for seed in (0, 1):
        counts = study.simulate(jax.random.PRNGKey(seed), n_toys)
        t, target = [], []
        for start in range(0, n_toys, CHUNK):
            chunk = jax.tree_util.tree_map(
                lambda c: c[start:start + CHUNK], counts)
            t_c, free, _ = study._run_profile(chunk, TARGET, 1.0, None)
            t.append(np.asarray(t_c))
            target.append(np.asarray(free[TARGET]))
            print("%s seed %d: %d toys, %.1f s" % (
                label, seed, start + CHUNK, time.time() - t0), flush=True)
        ts.append(np.concatenate(t))
        means.append(float(np.mean(np.concatenate(target))))
    pooled = np.concatenate(ts)
    rng = np.random.default_rng(0)
    boot = [np.median(rng.choice(pooled, pooled.size)) for _ in range(2000)]
    out = dict(label=label, n_toys=n_toys, seeds=[0, 1],
               median_t_by_seed=[float(np.median(t)) for t in ts],
               median_t=float(np.median(pooled)),
               bootstrap_sd=float(np.std(boot)),
               mean_target_by_seed=means,
               build_s=built, seconds=time.time() - t0)
    print("%s: %s" % (label, out), flush=True)
    return out


def main(argv):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    n_toys = int(argv[0]) if argv and argv[0].isdigit() else 256
    labels = [a for a in argv if not a.isdigit()] or LABELS
    results = [reference(label, n_toys) for label in labels]
    print(json.dumps({'jax_cpu_reference': results}))


if __name__ == '__main__':
    main(sys.argv[1:])
