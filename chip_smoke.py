#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (blueice_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``blueice_tpu_torch/csrc`` (one nvcc
per source, all started together, sm_90a, into ``build/``) and drives five
paths of the port, each a profile-likelihood toy study at the width of a
model the repo supports, float32 on the card:

* ``xenon``: the XENON1T-style binned likelihood (6 sources, 3^4 = 81
  anchors, 50x62 bins, 8 floating parameters), 512 toys;
* ``bb``: the same with Beeston-Barlow ``bb_single`` on the ER source, 256
  toys;
* ``bblite``: the same with Barlow-Beeston-lite on all sources, 256 toys;
* ``unbinned_xenon``: the same sources and anchors as an extended unbinned
  likelihood at 3 live days (~1,880 events per toy), 256 toys;
* ``unbinned``: bench.py's Gaussian unbinned model (2 Monte-Carlo sources
  over 100 bins, shape parameter mu on 3 anchors, ~2,000 events per toy),
  1,024 toys, target s0_rate_multiplier;
* ``combined``: XENON1T's two science runs as one LogLikelihoodSum, SR0
  (32.1 live days) and SR1 (246.7) of the binned model above, the 8
  parameters shared by name, plus a correlated calibration constraint on
  band_shift and band_width_scale (rho = 0.5), 256 toys; each child runs
  the binned kernels (``combined_likelihood``);
* ``xenon_log``: the binned model with geometric (log) template morphing,
  256 toys; no kernel may launch, since the kernels bake in the linear
  lerp (``xenon_log_likelihood``).

For each path:

1. its two kernels vs their plain PyTorch versions on the card (ll relative
   1e-5; g and H within 1e-4 of each toy's largest entry), with warm times
   (CUDA events) of a whole wrapper call (``ms``, median of 20) and of the
   kernel alone (``kernel_ms``: the wrapper's tables built once, then 20
   launches captured in a CUDA graph, its replay timed, median of 5; and
   ``kernel_ms_cold``, the launches cycling over copies of the path's data
   that together outgrow the 50 MB L2, ``roofline.cold_launches``) beside
   the least time the card could take for the same work (``bound_ms``:
   bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is
   larger, counted from this run's inputs, see
   ``blueice_tpu_torch.utils.roofline.work``). Binned paths at the XENON
   shape (512 toys; the value kernel at A = 12 and 20); unbinned paths on
   the study's own scored event tensors (all toys of the path, A = 12 and
   20);
2. the path itself, twice (seeds 0 and 1), with every launch counter set
   to 0 just before and read just after: the path's own two kernels and
   the parameter graph's two (``GRAPH_KERNELS``, ``ops/param_graph.py``)
   must have launched, the others not (``combined``: the xenon kernels and
   the graph's; ``xenon_log``: none); the profile statistic is checked against the
   reference's statistics (median t band, mean fitted target in
   (0.7, 1.3); for ``combined`` and ``xenon_log`` the band is centred on
   the JAX package's own median t on the CPU, ``JAX_MEDIAN_T``); then, on
   the five single-likelihood paths, the value and the vgh kernel over one
   profile's own calls (``replay_calls``: every call of the wrapper
   recorded, their launches replayed from CUDA graphs, summed time beside
   summed bound); then, on the six paths with kernels, the parameter
   graph's two kernels over one profile's own calls (``graph_rows``: every
   ``graph_fwd`` and ``graph_chain`` call recorded, each held to the
   PyTorch graph at the same inputs, idx equal, t, m, the prior and x
   within 1e-6 of the call's largest entry, g and H within 1e-5 of each
   lane's; the kernels alone replayed from CUDA graphs, the wrapper calls
   and the PyTorch graph timed, all summed beside the summed bound; rows
   ``graph_fwd`` and ``graph_chain`` of the path in the ``{"kernels":
   ...}`` line);
3. the same toys (counts, or event sets) fitted on CUDA in float32 and on
   the CPU in float64 (plain versions): max |d max_ll| <= 0.05, median
   |d t| <= 0.01.

Then the roofline part (``blueice_tpu_torch.utils.roofline``):

4. the op-mix kernel (``csrc/op_mix.cu``) vs its plain version for each mix
   (fma, bb, bblite, poisson), one loop trip on the check inputs
   (``op_mix_inputs(check=True)``) at the mix's check nudge (``MIXES``),
   within 1e-5 of the float64 scale of each element's terms
   (``op_mix_scale``), over the elements that fill the card;
5. the op-mix ceilings (``op_mix_record``) with every launch counter set to
   0 just before and read just after: the op-mix kernel must have launched,
   no fit kernel; then the vgh kernels' roofline verdicts and the dense
   unbinned engine's (``roofline_record``, the last by
   ``measure_unbinned_jnp``), printed as a table, and per kernel warm and
   L2-cold (an L2-cold HBM share above 100% fails).

Wherever a phase below has a path's kernels launch and no other, the
parameter graph's two kernels count among the path's (``own_kernels``):
they run wherever a path's likelihood kernels do.

Between the paths and the roofline part runs the statistics part
(``STATS``), on the studies of the paths above
(``blueice_tpu_torch.parallel``), each phase between reset and read of
every launch counter, its path's two kernels launched and no other:

6. the xenon sensitivity band: ``sensitivity_band`` over 256
   background-only toys with the 'auto' grid, seed 0 and then warm with
   seed 1 (a finite median, fewer than a quarter of the toys beyond the
   grid, quantiles ascending, every limit at or above the grid start),
   then the first 8 toys' grid on the card against a float64 CPU study
   at the same hypotheses (``referee_grid``: max |d max_ll| <= 0.05,
   median |d t| <= 0.01 over every (hypothesis, toy) pair);
7. the xenon observed upper limit (90%) on one simulated background-only
   dataset bound with ``set_data``: ``observed_interval``, cold and three
   times warm, against float64 on the CPU at the same grid (relative gap
   <= 0.01); then every vgh and value call of one ``profile_map`` (66
   lanes on the one dataset) recorded, and each kernel held to the
   float64 closed form within phase 1's tolerances, the unbinned ll lane
   by lane within an allowance derived from float32 itself
   (``map_calls_row``, ``ll_allowance``);
8. the Gaussian unbinned band, as 6 over 1,024 toys;
9. the unbinned_xenon observed upper limit, as 7, on one simulated event
   set bound with ``set_data``;
10. the combined observed upper limit: as 7 on one simulated
   background-only SR0/SR1 dataset pair, passed as ``counts=`` with an
   empty entry for the constraint, cold and once warm, against float64 on
   the CPU at the same grid; the xenon kernels launched and no other.

The statistics part runs at full size, uncut: 256 toys in the xenon band
and 1,024 in the Gaussian one. It takes longer than the two bands alone
because the float64 CPU referees (the grid of 8 toys x the band's
hypotheses, and each interval at its final grid) take about half of it;
cutting the band's toys would not shorten them, and the referees hold
every hypothesis of the grid.

After the statistics part runs the inference part (``inference_part``):
inference on one dataset of a model, drawn from ``default_rng(0)``, each
phase between reset and read of every launch counter, its model's
kernels launched and no other, and each of them held to the float64
closed form on the phase's own recorded calls (``phase_rows``: one lane;
a chain's value calls at A = 20), timed beside its plain version and its
bound (rows with path '<model> bestfit_jax', '<model> mcmc', 'xenon
interval (bestfit_jax)' in the ``{"kernels": ...}`` line):

11. the device template build: ``build_likelihood('binned',
   jax_templates=True)`` at full width into a fresh cache directory, 12
   batched device calls (6 single, 6 batched) and no kernel launch, every
   anchor pmf within rtol 1e-6, atol 1e-12 of the host
   ``GaussianBlobSource`` build;
12. ``bestfit_jax`` on xenon (those templates), unbinned_xenon (3 live
   days) and the Gaussian unbinned model: re-scored on the host float64
   likelihood at least the host referee's maximum - 1e-3 (scipy's Powell,
   ``REFEREE_SCIPY``), the target within 5e-3 of the referee's, the errors
   finite and within 5% of the float64 CPU fit's;
13. ``bestfit_emcee_device`` on xenon and unbinned_xenon (``CHAIN``: 40
   walkers, 1,000 steps, 500 burn-in, errors): the value kernel and the
   graph's forward kernel exactly 2 n_steps + 2 launches each, no other, the chain under CUDA's sync debug mode 'error';
   the last ensemble plus one walker out of bounds through the walkers'
   log_prob against its plain version on the card (relative 1e-5, -inf at
   the same places); every median within its own posterior sigma of the
   referee's optimum, the ll at the medians within n_dim of its maximum;
14. ``one_parameter_interval`` of the xenon dataset's wimp rate (upper,
   90%) with ``bestfit_routine='jax'`` against the host referee's: within
   1%.

Between the statistics part and the inference part runs the autodiff part
(``autodiff_part``): the autodiff fit engine (``make_toy_fitter(engine=
'ad')``, ``torch.func`` over the compiled likelihood) on the card, held to
the kernels on the same toys (``engines_gate``: at least 95% of the toys
agree in x within a float32 bound, a tenth of a parabolic error or ten
times the engines' median spread, the larger; on those max |d max_ll| <=
0.05 and median |d t| <= 0.01; on every toy |d max_ll| < 0.2), each run of
the engine between reset and read of every launch counter with no kernel
launched:

15. ``unbinned_xenon_sw``: ``build_likelihood('unbinned',
   livetime_days=3.0, source_wise_interpolation=True)`` at full width
   (the WIMP over its 3^4 anchors, the five others, which list
   'efficiency' in dont_hash_settings, over 3^3), 256 toys through
   ``UnbinnedToyStudy`` (engine 'auto': the autodiff engine), against the
   unbinned_xenon study (#15/#16) on the same event sets; median t in
   (0.25, 0.80);
16. ``xenon_sw``: the binned twin, 128 toys through ``BinnedToyStudy``,
   against xenon (#1/#2) on the same counts; median t in (0.10, 0.20);
17. the xenon engines: 64 of xenon's toys through ``engine='ad'`` and
   through the fused engine.

The inference part ends with two phases on the autodiff engine, each
held to the host referee in float64, no kernel launched:

18. (e) the unbinned SR0+SR1 ``LogLikelihoodSum``: two unbinned XENON
   science runs, live times in the ratio 32.1 : 246.7 (cut to
   ``SUM_LIVETIME_SCALE`` of them) and the calibration constraint:
   ``bestfit_jax`` (re-scored within 1e-3 of the referee, errors within
   5% of float64) and its 90% upper limit through ``bestfit_jax``
   (within 1e-4 relative);
19. (f) a ``LogLikelihoodReParam`` of the xenon dataset's model, the WIMP
   rate written as a cross-section: ``bestfit_jax`` as (e).

After the inference part runs the sharding part (``sharding_part``; ``python3
chip_smoke.py sharding`` runs it alone), each phase between reset and read
of every launch counter:

20. (s1) xenon's profile of 512 toys with a one-process mesh
   (``make_mesh()``) and then, after ``init_distributed`` at world size 1
   on NCCL, through ``profile_ts_distributed`` (its results gathered as
   CUDA tensors over NCCL): both bit-identical to the profile with no
   mesh, the xenon kernels launched and no other;
21. (s2) two ranks on the one card, spawned as fresh interpreters that
   import the port only (``blueice_tpu_torch.dryrun.run_ranks``; gloo,
   since NCCL refuses two ranks on one device; the kernels built here
   first), on xenon (512 toys), bb and unbinned_xenon (128 toys each,
   full width): each rank's path kernels launched and no other, both
   ranks' gathered arrays bit-identical, the toys bit-identical to the
   single-process draw at the seed, the fits within phase 3's gate of one
   process's on the same toys (max |d max_ll| <= 0.05, median |d t| <=
   0.01; the largest gap printed: the kernels size a toy's ranges by the
   batch, so a rank's half sums in another order), the median t in the
   path's band; xenon's warm profile fits/s at one and two ranks;
22. (s3) the dense unbinned engine (``parallel.fitter._FORCE_DENSE_UNBINNED``,
   ``ops/unbinned_dense.py``) on unbinned_xenon (256 toys) and the
   Gaussian model (1,024 toys) against the path's kernels on the same
   event sets: no kernel launched in a dense run, ``engines_gate`` with
   the path's band, seconds, fits/s, iterations and peak device memory
   printed, and the dense ops' recorded calls held to float64
   (``held_dense_calls``), where the same ops with TF32 products or with
   bfloat16 coefficients must fail (controls of the gate).

After the sharding part runs the host part (``host_part``; ``python3
chip_smoke.py host`` runs it alone), each phase between reset and read of
every launch counter, at full width and uncut:

23. (h1) the prepared xenon (512 toys) and unbinned_xenon (3 live days,
   256 toys) likelihoods through ``pickle.dumps``/``loads`` and through
   ``save_pickle``/``read_pickle``: each restored likelihood's profile (a
   fresh study on the card, seed 0) bit-identical in t and max_ll to the
   original's, its path's two kernels launched and no other; the
   pickle's size and the dump and load seconds printed;
24. (h2) the xenon model (host blob templates) built serially and with
   ``prepare(n_cores=4)`` into fresh cache and task directories, the
   process-wide template cache emptied before each: every anchor's mus
   and pmf bit-identical, no task file left, a 512-toy profile (seed 0)
   of each bit-identical, the xenon kernels launched and no other; both
   builds' seconds printed;
25. (h3) the xenon model with ``RadialInterpolator`` morphing (the
   default 10 latin anchors, after ``np.random.seed(0)``): 64 toys fitted
   on the card by ``engine='auto'``, which must pick the autodiff engine
   and launch no kernel, and in float64 on the CPU: max |d max_ll| <=
   0.05, median |d t| <= 0.01; fits/s printed;
26. (h4) ``include_livetime``: the compiled xenon logl (float32, the
   card) at 278, 139 and 556 live days and the combined SR0+SR1 Sum's,
   one joint live time, at SR1's 246.7 days, half and twice it
   (``LIVETIMES``), each within 0.05 of the host float64 value; no
   kernel launched;
27. (h5) the native histogram filler available; 2,000,000 events over
   the XENON (cs1, log10_cs2) 50x62 edges with NaN, inf and exact-edge
   values: counts equal to ``np.histogramdd``'s, weighted sums within
   rtol 1e-12, both timed on the host CPU; the Gaussian unbinned path's
   Monte-Carlo templates built through it equal to a numpy fill bit for
   bit;
28. (h6) one warm 512-toy xenon profile inside ``profile_to`` and
   ``trace('xenon profile')``: the Chrome trace names ``vgh_kernel``,
   ``ll_kernel`` and the span, the xenon kernels launched and no other;
   the wall time with and without the profiler printed.

Run with no arguments, as above, it is the smoke test. Path names as
arguments (``python3 chip_smoke.py bb bblite``) run those paths alone and
no statistics or roofline part: a quicker measurement of their kernels, which prints the
same lines for them (``python3 chip_smoke.py combined xenon_log``: the
composition paths alone). ``python3 chip_smoke.py inference`` runs the
inference part alone (``autodiff`` the autodiff part, ``sharding`` the
sharding part, ``host`` the host part); it adds about 110 s to a run on an H100 (PERF.md
section 6), most of it the phases' float64 checks and the host referee.

The paths ``combined`` and ``xenon_log`` and the ``combined interval``
phase add about 110 s to a run on an H100 (25, 6 and 77 s, most of the
last its float64 CPU referee; PERF.md section 6); nothing of them is cut:
their phase 3 compares 8 toys. ``measure_unbinned.py`` holds the torch.profiler
account and the engine A/B of the unbinned paths.

Any failure raises (exit code != 0, no result line). Without CUDA it exits
with code 2 before doing anything. The last line of standard output is
``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

KERNEL_TOYS = 512
TIMED_RUNS = 20
#: phase 1's tolerances: the ll relative (to |ll|; unbinned, to the
#: magnitudes of its terms, ``term_scale``), g and H relative to each toy's
#: largest entry
TOLERANCE = (1e-5, 1e-4)
#: float32's unit roundoff
F32_UNIT = 2.0 ** -24
CSRC = 'blueice_tpu_torch/csrc/'
TPU = 'blueice_tpu/ops/'

# label: (model, target, toys of the main path, toys compared between
# float32 and float64, band of the median t)
PATHS = {
    'xenon': ('binned', 'wimp_rate_multiplier', 512, 16, (0.10, 0.20)),
    'bb': ('bb', 'wimp_rate_multiplier', 256, 8, (0.08, 0.20)),
    'bblite': ('bblite', 'wimp_rate_multiplier', 256, 8, (0.08, 0.20)),
    'unbinned_xenon': ('unbinned_xenon', 'wimp_rate_multiplier', 256, 8,
                       (0.25, 0.80)),
    'unbinned': ('unbinned_gauss', 's0_rate_multiplier', 1024, 16,
                 (0.33, 0.66)),
    'combined': ('combined', 'wimp_rate_multiplier', 256, 8, None),
    'xenon_log': ('xenon_log', 'wimp_rate_multiplier', 256, 8, None),
}
#: parts that run alone when named (``python3 chip_smoke.py inference``)
PARTS = ('inference', 'autodiff', 'sharding', 'host')
#: the JAX package's median t of the path on the CPU, float64, and the
#: bootstrap spread of that median (``measure_composition_reference.py``:
#: 256 toys for each of seeds 0 and 1; PERF.md section 6)
JAX_MEDIAN_T = {
    'combined': (0.1910109646642013, 0.018239730435379912),
    'xenon_log': (0.1477779580909555, 0.016995368345532724),
}


def median_band(label):
    """The band of the path's median t: PATHS' own, or centred on the JAX
    package's figure, its half-width 0.05 (as the xenon band's) or three
    times that figure's bootstrap spread, whichever is larger."""
    band = PATHS[label][4]
    if band is not None:
        return band
    centre, spread = JAX_MEDIAN_T[label]
    half = max(0.05, 3.0 * spread)
    return (centre - half, centre + half)

# kernel row metadata per path: (wrapper, source, Pallas body it replaces,
# the other Pallas flavour of the same contract)
META = {
    'xenon': [('binned_vgh_fused', 'fused_binned.cu', 'fused.py:144',
               'fused.py:597'),
              ('binned_ll_fused_multi', 'fused_binned.cu', 'fused.py:251',
               'fused.py:690')],
    'bb': [('binned_bb_vgh_fused', 'fused_bb.cu', 'fused_bb.py:191',
            'fused_bb.py:458'),
           ('binned_bb_ll_fused_multi', 'fused_bb.cu', 'fused_bb.py:227',
            'fused_bb.py:605')],
    'bblite': [('binned_bblite_vgh_fused', 'fused_bb_lite.cu',
                'fused_bb_lite.py:154', 'fused_bb_lite.py:417'),
               ('binned_bblite_ll_fused_multi', 'fused_bb_lite.cu',
                'fused_bb_lite.py:189', 'fused_bb_lite.py:511')],
    # G = 81 > 16: the TPU ran the per-toy gather flavour (when it fit VMEM)
    'unbinned_xenon': [('unbinned_vgh_fused', 'fused_unbinned.cu',
                        'fused_unbinned.py:245', 'fused_unbinned.py:81'),
                       ('unbinned_ll_fused_multi', 'fused_unbinned.cu',
                        'fused_unbinned.py:332', 'fused_unbinned.py:156')],
    # G = 3 <= 16: the block flavour
    'unbinned': [('unbinned_vgh_fused', 'fused_unbinned.cu',
                  'fused_unbinned.py:81', 'fused_unbinned.py:245'),
                 ('unbinned_ll_fused_multi', 'fused_unbinned.cu',
                  'fused_unbinned.py:156', 'fused_unbinned.py:332')],
}
# each binned child of the Sum takes the xenon kernels; a log-morphed model
# none
META['combined'] = META['xenon']
META['xenon_log'] = []


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Median warm time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rel_to_toy_max(a, b):
    """max |a - b| relative to each toy's largest |b| entry."""
    scale = b.abs().flatten(1).max(1).values.reshape(
        (-1,) + (1,) * (b.dim() - 1))
    return float(((a - b).abs() / scale).max())


def ptxas_report(lib_paths):
    """The -Xptxas -v lines (registers, spills, static shared memory) of the
    instantiations the paths run: S = 6, K = 4 (XENON) and S = 2, K = 1
    (Gaussian unbinned), the parameter graph's at K = 4 and K = 1, and of
    the four op-mix kernels, from the logs kept beside the libraries."""
    lines = []
    for path in lib_paths:
        with open(path[:-3] + '.log') as f:
            text = f.read()
        for entry in text.split("Compiling entry function '")[1:]:
            name = entry.split("'", 1)[0]
            shape = re.search(r'([a-z_]+_kernel)ILi(\d)ELi(\d)E', name)
            mix = re.search(r'(op_mix_kernel)ILi(\d)E', name)
            graph = re.search(r'(graph_[a-z]+_kernel)ILi(\d)EE', name)
            if mix:
                label = '%s<%s>' % mix.groups()
            elif graph and graph.group(2) in ('4', '1'):
                label = '%s<%s>' % graph.groups()
            elif shape and (shape.group(2, 3) == ('6', '4') or (
                    shape.group(2, 3) == ('2', '1') and 'unbinned' in path)):
                label = '%s<%s,%s>' % shape.groups()
            else:
                continue
            spills = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                               r'loads', entry)
            regs = re.search(r'Used (\d+) registers', entry)
            smem = re.search(r'(\d+) bytes smem', entry)
            lines.append('%s: %s registers, spill stores/loads %s/%s B, %s '
                         'B static shared memory'
                         % (label, regs.group(1) if regs else '?',
                            *(spills.groups() if spills else ('?', '?')),
                            smem.group(1) if smem else '0'))
    return lines


def sass_functions(lib_path):
    """{(kernel, S, K): SASS text} of a library's fit kernels ({(kernel,
    None, K): ...} of the parameter graph's) and {('op_mix', kind, None):
    ...} of its op-mix kernels (``cuobjdump -sass``; the
    anonymous namespace's mangled name, which differs between two builds,
    left out), or None where the toolkit has no cuobjdump."""
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs = {}
    for block in out.split('Function : ')[1:]:
        name, body = block.split('\n', 1)
        mix = re.search(r'op_mix_kernelILi(\d)E', name)
        shape = re.search(r'\d([a-z][a-z_]*_kernel)ILi(\d)ELi(\d)E', name)
        graph = re.search(r'\d(graph_[a-z]+_kernel)ILi(\d)EE', name)
        if mix:
            funcs[('op_mix', mix.group(1), None)] = body
        elif graph:
            funcs[(graph.group(1), None, graph.group(2))] = body
        elif shape:
            funcs[shape.groups()] = body
    return funcs


def sass_ops(body):
    """The opcodes of a function's SASS text."""
    return re.findall(r'/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)',
                      body)


def sass_census(lib_paths):
    """From each library's SASS (``sass_functions``): per op-mix kernel its
    instruction count and its FFMA and MUFU instructions (the fma kernel's
    16-step body over 4 elements must hold at least 64 FFMA, or the compiler
    folded the mix), and per fit kernel of the instantiations
    ``ptxas_report`` names its instruction count and its local-memory loads
    and stores (LDL, STL: spills or a dynamically indexed array). Returns
    the report lines."""
    lines = []
    for path in lib_paths:
        funcs = sass_functions(path)
        if funcs is None:
            return ['cuobjdump not found: no SASS census']
        for (name, S, K), body in funcs.items():
            ops = sass_ops(body)
            count = lambda prefix: sum(op.startswith(prefix) for op in ops)
            if name == 'op_mix':
                ffma = count('FFMA')
                lines.append('op_mix_kernel<%s>: %d SASS instructions, %d '
                             'FFMA, %d MUFU' % (S, len(ops), ffma,
                                                count('MUFU')))
                if S == '0' and ffma < 64:
                    raise AssertionError("the fma mix compiled to %d FFMA "
                                         "(< 64): its loop was folded" % ffma)
            elif S is None and K in ('4', '1'):
                lines.append('%s<%s>: %d SASS instructions, %d LDL, %d STL'
                             % (name, K, len(ops), count('LDL'),
                                count('STL')))
            elif (S, K) == ('6', '4') or ((S, K) == ('2', '1')
                                          and 'unbinned' in path):
                lines.append('%s<%s,%s>: %d SASS instructions, %d LDL, %d '
                             'STL' % (name, S, K, len(ops), count('LDL'),
                                      count('STL')))
    return lines


# -- the paths ---------------------------------------------------------------

#: live days of XENON1T's two science runs, SR0 and SR1 (Aprile et al., PRL
#: 121, 111302 (2018))
SCIENCE_RUNS_DAYS = (32.1, 246.7)
#: the combined path's calibration of the band's position and width:
#: (parameters, mean, covariance), rho = 0.012 / (0.3 * 0.08) = 0.5
CALIBRATION = (['band_shift', 'band_width_scale'], [0.0, 1.0],
               [[0.09, 0.012], [0.012, 0.0064]])


def combined_likelihood(xenon_like, likelihood, composition):
    """SR0 + SR1 + the calibration constraint, the 8 parameters shared by
    name. Package-agnostic: pass either package's modules."""
    runs = [xenon_like.build_likelihood('binned', livetime_days=days)
            for days in SCIENCE_RUNS_DAYS]
    constraint = composition.correlated_gaussian_constraint(*CALIBRATION)
    return likelihood.LogLikelihoodSum(runs + [constraint])


def xenon_log_likelihood(xenon_like, likelihood):
    """``xenon_like``'s binned model with geometric (log) template morphing:
    ``build_config()`` with ``build_likelihood``'s parameter declarations."""
    NormalPrior = xenon_like.NormalPrior
    lf = likelihood.BinnedLogLikelihood(
        xenon_like.build_config(),
        likelihood_config={'template_interpolation': 'log'})
    lf.add_rate_parameter('wimp')
    lf.add_rate_parameter('er', log_prior=NormalPrior(1, 0.05))
    lf.add_rate_parameter('nr', log_prior=NormalPrior(1, 0.2))
    lf.add_rate_parameter('wall', log_prior=NormalPrior(1, 0.3))
    zs = tuple(np.linspace(-1, 1, 3))
    lf.add_shape_parameter('band_shift', zs, log_prior=NormalPrior(0, 0.5))
    lf.add_shape_parameter('band_width_scale',
                           tuple(np.linspace(0.8, 1.2, 3)),
                           log_prior=NormalPrior(1, 0.1))
    lf.add_shape_parameter('cs1_tilt', zs, log_prior=NormalPrior(0, 0.5))
    lf.add_shape_parameter('efficiency', tuple(np.linspace(0.7, 1.3, 3)),
                           log_prior=NormalPrior(1, 0.1))
    lf.prepare()
    return lf


def build_model(label, xenon_like, test_helpers, likelihood):
    model = PATHS[label][0]
    if model == 'combined':
        from blueice_tpu_torch import composition
        return combined_likelihood(xenon_like, likelihood, composition)
    if model == 'xenon_log':
        return xenon_log_likelihood(xenon_like, likelihood)
    if model == 'unbinned_xenon':
        return xenon_like.build_likelihood('unbinned', livetime_days=3.0)
    if model == 'unbinned_gauss':
        # bench.py's `unbinned` scenario (bench.py:125-146); the MC template
        # draws come from numpy's global state
        np.random.seed(0)
        conf = test_helpers.conf_for_test(
            n_sources=2, mc=True,
            analysis_space=[['x', np.linspace(-10, 10, 101)]],
            n_events_for_pdf=int(2e5))
        conf['sources'][1]['mu'] = 3.0
        lf = likelihood.UnbinnedLogLikelihood(conf)
        lf.add_rate_parameter('s0')
        lf.add_shape_parameter('mu', (-1.0, 0.0, 1.0))
        lf.prepare()
        return lf
    return xenon_like.build_likelihood(
        'binned', bb={'binned': False, 'bb': True, 'bblite': 'bb_lite'}[model])


def binned_ops(label, compiled, mods):
    """(vgh kernel, vgh plain, vgh launcher, value kernel, value plain,
    value launcher) of a binned path, the MC-count rows (G, N) its kernels
    also read (None on xenon) and their trailing arguments: each is called
    as f(anchor, strides, idx, t, m, observed) on xenon, else as
    f(anchor, rows, strides, idx, t, m, observed, *extra)."""
    fused, fused_bb, fused_bb_lite = mods['fused'], mods['fused_bb'], \
        mods['fused_bb_lite']
    if label in ('xenon', 'combined'):
        return (fused.binned_vgh_fused, fused.binned_vgh_plain,
                fused.binned_vgh_launcher, fused.binned_ll_fused_multi,
                fused.binned_ll_plain, fused.binned_ll_launcher), None, ()
    S = len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    nme = compiled.nme_tensor_host.reshape(G, S, -1)
    if label == 'bb':
        rows = nme[:, compiled.bb_source_i]
        fns = (fused_bb.binned_bb_vgh_fused, fused_bb.binned_bb_vgh_plain,
               fused_bb.binned_bb_vgh_launcher,
               fused_bb.binned_bb_ll_fused_multi, fused_bb.binned_bb_ll_plain,
               fused_bb.binned_bb_ll_launcher)
        extra = (compiled.bb_source_i,)
    else:
        rows = nme.sum(axis=1)
        fns = (fused_bb_lite.binned_bblite_vgh_fused,
               fused_bb_lite.binned_bblite_vgh_plain,
               fused_bb_lite.binned_bblite_vgh_launcher,
               fused_bb_lite.binned_bblite_ll_fused_multi,
               fused_bb_lite.binned_bblite_ll_plain,
               fused_bb_lite.binned_bblite_ll_launcher)
        extra = ()
    rows = torch.as_tensor(rows, dtype=torch.float32,
                           device=compiled.device).contiguous()
    return fns, rows, extra


def binned_data(label, compiled, mods, rng):
    """Phase 1's data of a binned path: the anchor tensor (G, S, N), the
    observed counts of KERNEL_TOYS toys at the default expectations (drawn
    from ``rng``), and ``binned_ops``' kernels, MC-count rows and trailing
    arguments."""
    S = len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    anchor = compiled.ps_tensor.reshape(G, S, -1).contiguous()
    expected = compiled.expected_counts(compiled.defaults).cpu().numpy()
    obs = torch.as_tensor(
        rng.poisson(expected.ravel(), (KERNEL_TOYS, anchor.shape[-1])),
        dtype=torch.float32, device=compiled.device)
    fns, mc, extra = binned_ops(label, compiled, mods)
    return anchor, obs, fns, mc, extra


def unbinned_data(label, study):
    """Phase 1's data of an unbinned path: the study's scored event set of
    the path's toys (seed 0), (ps (B, G, S, E), mask (B, E), inv_ref
    (B, E), ref_msum (B,)), and the lanes (B,), all toys in a seeded
    random order."""
    ps, mask, (inv_ref, ref_msum, _) = study._fit_data(
        study.simulate(0, PATHS[label][2]))
    lanes = torch.randperm(ps.shape[0],
                           generator=torch.Generator().manual_seed(0)
                           ).to(study.compiled.device)
    return ps, mask, inv_ref, ref_msum, lanes


def random_point(compiled, rng, lead):
    """Random lower corners, lerp weights and rates within 20% of the
    default expectations (float32 tensors on the card)."""
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    dev = compiled.device
    mus = compiled.rates(compiled.defaults).cpu().numpy()
    hi = [len(a) - 1 for a in compiled.anchor_arrays]
    idx = np.stack([rng.integers(0, h, lead) for h in hi], axis=-1) \
        if K else np.zeros(lead + (0,), int)
    t = rng.random(lead + (K,))
    m = mus * rng.uniform(0.8, 1.2, lead + (S,))

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)
    return torch.as_tensor(idx, device=dev), f32(t), f32(m)


def check_pair(label, name, out, ref, ll_scale):
    """(max abs err, max rel err, text) of a kernel against its plain
    version; raises unless the ll is within 1e-5 of ``ll_scale`` (per toy,
    see ``term_scale``) and g and H within 1e-4 of each toy's largest
    entry."""
    ll, ll_ref = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
    ll_rel = float(((ll - ll_ref).abs() / ll_scale).max())
    rel, ok = ll_rel, ll_rel <= 1e-5
    detail = 'll err %.3g (of its terms)' % ll_rel
    if isinstance(out, tuple):
        g_rel = rel_to_toy_max(out[1], ref[1])
        h_rel = rel_to_toy_max(out[2], ref[2])
        ok = ok and g_rel <= 1e-4 and h_rel <= 1e-4
        rel = max(ll_rel, g_rel, h_rel)
        detail += ', g %.3g, H %.3g (of toy max)' % (g_rel, h_rel)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    if not (ok and all(bool(torch.isfinite(o).all()) for o in outs)):
        raise AssertionError("%s %s disagrees with its plain version: %s"
                             % (label, name, detail))
    abs_err = max(float((a - b).abs().max()) for a, b in zip(outs, refs))
    return abs_err, rel, detail


def term_scales(ps, strides, lanes, idx, t, m, mask, inv_ref, moff, outlier):
    """Per lane (and candidate), in float64, (terms, rounding): the sum of
    the magnitudes of the centered unbinned ll's terms, sum_e |log(lam_e *
    inv_ref_e)| + |moff|, the scale of that ll's float32 rounding (a
    centered ll near the reference point is a small difference of O(1)
    terms, so its own magnitude is no scale for a relative error; the
    binned deviance ll has terms of one sign, so there the scale is |ll|);
    and float32's rounding of each valid event's product lam_e *
    inv_ref_e, summed, F32_UNIT sum_e |lam_e inv_ref_e| (at the centering
    point every term log(lam_e inv_ref_e) is smaller than that rounding,
    so the terms alone are no scale for the ll there)."""
    from blueice_tpu_torch.ops import fused
    from blueice_tpu_torch.ops.binned_vgh import corner_weight_tables
    single = idx.dim() == 2
    if single:
        idx, t, m, moff = idx[:, None], t[:, None], m[:, None], moff[:, None]
    ids = fused.corner_ids(strides, idx, ps.shape[1])          # (L, A, C)
    w = corner_weight_tables(t.double())[0]
    mk, ir = mask[lanes][:, None], inv_ref[lanes].double()[:, None]
    lam = 0.0
    for c in range(ids.shape[2]):
        rows = ps[lanes[:, None], ids[:, :, c]].double()        # (L, A, S, E)
        lam = lam + w[:, :, c, None] * torch.einsum(
            'las,lase->lae', m.double(), rows)
    if outlier:
        lam = torch.where(lam > 0, lam, torch.full_like(lam, outlier))
    zero = torch.zeros_like(lam)
    out = (torch.where(mk, torch.log(lam * ir).abs(), zero).sum(-1)
           + moff.double().abs(),
           F32_UNIT * torch.where(mk, (lam * ir).abs(), zero).sum(-1))
    return tuple(x[:, 0] for x in out) if single else out


def term_scale(*args):
    """The first of ``term_scales``: the magnitudes of the terms."""
    return term_scales(*args)[0]


def disagreement(out, ref, scale=None):
    """(ll, g and H) relative differences of ``out`` from ``ref``: the ll
    (a value call's, or the first of a vgh call's (ll, g, H)) relative to
    ``scale`` (default: itself; an unbinned call's, the magnitudes of its
    terms, ``term_scale``; an allowance, ``ll_allowance``, makes it the
    share of the allowance used), g and H relative to each toy's largest
    entry (0 for a value call). Equal values count 0, and so do infinities of one
    sign and NaNs in both (a candidate whose rate is 0 at a valid event, or
    whose rates are NaN: the plain version gives the same); a NaN or an
    infinity in one only counts NaN or inf, which no bound holds."""
    ll, ll_ref = (out[0], ref[0]) if isinstance(out, tuple) else (out, ref)
    scale = ll_ref.abs() if scale is None else scale
    same = (ll == ll_ref) | (ll.isnan() & ll_ref.isnan())
    err = torch.where(same, torch.zeros_like(ll),
                      (ll - ll_ref).abs() / scale)
    if not isinstance(out, tuple):
        return float(err.max()), 0.0
    return (float(err.max()), max(rel_to_toy_max(out[1], ref[1]),
                                  rel_to_toy_max(out[2], ref[2])))


def double(out):
    """A call's outputs in float64."""
    return tuple(x.double() for x in out) if isinstance(out, tuple) \
        else out.double()


def unbinned_vgh_double(ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                        outlier=0.0, event_dtype=torch.float64):
    """The unbinned vgh contract on one call's arguments, the lanes' corner
    rows gathered (``ps[lanes[:, None], ids]``, (L, C, S, E), so the (B, G,
    S, E) event tensor is never copied whole), then
    ``unbinned_vgh.vgh_parts`` on them: every per-event quantity in
    ``event_dtype``, every sum over events in float64 (float64: the float64
    reference; float32: float32 itself on each event's terms, as the kernel
    sums g). Returns (ll, g, H) in float64."""
    from blueice_tpu_torch.ops import fused
    from blueice_tpu_torch.ops.unbinned_vgh import vgh_parts
    ids = fused.corner_ids(strides, idx, ps.shape[1])             # (L, C)
    corners = ps[lanes[:, None], ids].to(event_dtype)
    log_sum, g, H = vgh_parts(corners, m.to(event_dtype),
                              t.to(event_dtype), mask[lanes], outlier,
                              inv_ref[lanes].to(event_dtype),
                              sum_dtype=torch.float64)
    return log_sum - moff.double(), g, H


def closed_forms(module, wrapper, args):
    """(float32, float64) closed forms of a recorded call of ``wrapper``
    (a vgh or value wrapper of ``module``): the plain version on the call's
    arguments, and on them cast to float64; an unbinned vgh call's, the
    closed form on its gathered corner rows with float32 and with float64
    events (``unbinned_vgh_double``)."""
    if wrapper == 'unbinned_vgh_fused':
        return (unbinned_vgh_double(*args, event_dtype=torch.float32),
                unbinned_vgh_double(*args))
    plain = getattr(module, wrapper.replace('_fused_multi', '_plain')
                    .replace('_fused', '_plain'))
    return plain(*args), plain(*(a.double() if torch.is_tensor(a)
                                 and a.is_floating_point() else a
                                 for a in args))


def ll_allowance(spec, args, f32, f64):
    """The allowance of a kernel's ll against the float64 reference
    ``f64`` on one recorded call, derived from float32 itself lane by lane
    (and candidate by candidate), in absolute terms: the larger of
    ``TOLERANCE``'s 1e-5 of the ll's scale (binned |ll|; unbinned the
    magnitudes of its terms, ``term_scale``) and float32's rounding of the
    lane's terms (unbinned, F32_UNIT sum_e |lam_e inv_ref_e|,
    ``term_scales``; binned none) plus twice the float32 closed form
    ``f32``'s own error on that lane (0 where it is not finite). So the
    centering point's rounding widens the bound only on the lanes where it
    exceeds the terms, and on none of the others."""
    ll32, ll64 = (x[0] if isinstance(x, tuple) else x for x in (f32, f64))
    err = (ll32.double() - ll64).abs()
    err = torch.where(torch.isfinite(err), err, torch.zeros_like(err))
    if spec.module != 'fused_unbinned':
        scale, rounding = ll64.abs(), 0.0
    else:
        scale, rounding = term_scales(*args)
    return torch.maximum(TOLERANCE[0] * scale, rounding + 2 * err)


def float32_allowance(f32_gh):
    """The allowance of a kernel's g and H errors (relative to each toy's
    largest entry) against the float64 reference on a set of recorded
    calls, derived from float32 itself: twice the float32 closed form's
    worst error on the same calls (``closed_forms``), and at least
    ``TOLERANCE``'s 1e-4. (Over the calls, not call by call: two float32
    evaluations of one call scatter by several times each other's error
    where a lane's g nearly vanishes.)"""
    return max(TOLERANCE[1], 2 * float(np.max(f32_gh)))


def kernel_rows(label, study, mods):
    """Phase 1: each kernel of the path against its plain version, timed
    (a whole wrapper call, and the kernel alone), beside its bound. Returns
    the path's two kernel rows."""
    from blueice_tpu_torch.utils.roofline import (N_INNER, bound,
                                                  cold_launches,
                                                  distinct_rows,
                                                  launch_elapsed_s,
                                                  row_events, work)
    compiled = study.compiled
    K = len(compiled.shape_names)
    S = len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    grid = [len(a) for a in compiled.anchor_arrays]
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(K))
    rng = np.random.default_rng(0)
    fused, fu = mods['fused'], mods['fused_unbinned']
    unbinned = not compiled.is_binned

    if unbinned:
        ps, mask, inv_ref, ref_msum, lanes = unbinned_data(label, study)
        B, n = ps.shape[0], ps.shape[-1]

        def moff_of(m):
            return (m.sum(-1) - (ref_msum[lanes] if m.dim() == 2
                                 else ref_msum[lanes][:, None])).contiguous()
        data = (ps, mask, inv_ref)

        def call(fn, idx, t, m, data=data):
            ps, mask, inv_ref = data
            return fn(ps, strides, lanes, idx, t, m, mask, inv_ref,
                      moff_of(m), compiled.outlier_likelihood)

        def ll_scale(idx, t, m, ref_ll):
            return term_scale(ps, strides, lanes, idx, t, m, mask, inv_ref,
                              moff_of(m), compiled.outlier_likelihood)

        valid = mask[lanes].sum(-1)          # valid events of each lane

        def costs(ids, lead):
            # the whole mask (1 B an event) and the valid events' inv_ref
            per_lane = int(np.prod(lead[1:]))
            return dict(row_floats=S * row_events(ids, valid),
                        data_bytes=mask.numel() + 4 * int(valid.sum()),
                        items=per_lane * int(valid.sum()))
        fns = (fu.unbinned_vgh_fused, fu.unbinned_vgh_plain,
               fu.unbinned_vgh_launcher, fu.unbinned_ll_fused_multi,
               fu.unbinned_ll_plain, fu.unbinned_ll_launcher)
        shape = 'B=%d E=%d (%.1f valid events a toy)' % (
            B, n, float(valid.double().mean()))
    else:
        B = KERNEL_TOYS
        anchor, obs, fns, mc, extra = binned_data(label, compiled, mods, rng)
        n = anchor.shape[-1]
        data = (anchor, obs, mc)

        def call(fn, idx, t, m, data=data):
            anchor, obs, mc = data
            if mc is None:
                return fn(anchor, strides, idx, t, m, obs)
            return fn(anchor, mc, strides, idx, t, m, obs, *extra)

        def ll_scale(idx, t, m, ref_ll):
            return ref_ll.abs()

        def costs(ids, lead):
            rows = distinct_rows(ids)
            return dict(row_floats=(S + (mc is not None)) * rows * n,
                        data_bytes=B * n * 4, items=int(np.prod(lead)) * n,
                        mc_rows=mc is not None)
        shape = 'B=%d N=%d' % (B, n)

    meta = [dict(name=w, path=label, route='cuda', source=CSRC + src,
                 replaces=TPU + rep, also_replaces=TPU + alt,
                 library_ms=None)
            for w, src, rep, alt in META[label]]
    vgh, vgh_plain, vgh_launcher, value, value_plain, value_launcher = fns

    def kernel_ms(launcher, idx, t, m):
        """(warm, cold) ms of the kernel alone: on one input that stays in
        L2 between launches (the path's condition for the shared anchor
        tensor), and cycling over copies of the path's data that together
        outgrow L2 (``roofline.cold_launches``)."""
        warm = 1e3 * launch_elapsed_s(call(launcher, idx, t, m)[0])
        cold = cold_launches(lambda *d: call(launcher, idx, t, m, d), data)
        cold_ms = 1e3 * launch_elapsed_s(cold, max(N_INNER, len(cold)))
        del cold
        return warm, cold_ms

    idx, t, m = random_point(compiled, rng, (B,))
    out, ref = call(vgh, idx, t, m), call(vgh_plain, idx, t, m)
    torch.cuda.synchronize()
    abs_err, rel, detail = check_pair(label, 'vgh kernel', out, ref,
                                      ll_scale(idx, t, m, ref[0]))
    ms = cuda_ms(lambda: call(vgh, idx, t, m))
    alone_ms, cold_ms = kernel_ms(vgh_launcher, idx, t, m)
    plain_ms = cuda_ms(lambda: call(vgh_plain, idx, t, m))
    ids = fused.corner_ids(strides, idx, G)
    nbytes, flops = work('vgh', S, K, (B,), **costs(ids, (B,)))
    bound_ms, bound_by = bound(nbytes, flops)
    log("%s vgh kernel   %s: %s; wrapper %.4f ms, kernel alone %.4f ms "
        "(L2-cold %.4f) vs plain %.4f ms; bound %.4f ms (%s: %.1f MB, %.3f "
        "GFLOP)" % (label, shape, detail, ms, alone_ms, cold_ms, plain_ms,
                    bound_ms, bound_by, nbytes / 1e6, flops / 1e9))
    rows = [dict(meta[0], max_abs_err=abs_err, max_rel_err=rel, ms=ms,
                 kernel_ms=alone_ms, kernel_ms_cold=cold_ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)]

    row = dict(meta[1], max_abs_err=0.0, max_rel_err=0.0)
    for A in (12, 20):
        idx, t, m = random_point(compiled, rng, (B, A))
        out, ref = call(value, idx, t, m), call(value_plain, idx, t, m)
        torch.cuda.synchronize()
        abs_err, rel, detail = check_pair(label, 'value kernel (A=%d)' % A,
                                          out, ref, ll_scale(idx, t, m, ref))
        ms = cuda_ms(lambda: call(value, idx, t, m))
        alone_ms, cold_ms = kernel_ms(value_launcher, idx, t, m)
        plain_ms = cuda_ms(lambda: call(value_plain, idx, t, m))
        ids = fused.corner_ids(strides, idx, G)
        nbytes, flops = work('value', S, K, (B, A), **costs(ids, (B, A)))
        bound_ms, bound_by = bound(nbytes, flops)
        log("%s value kernel %s A=%d: %s; wrapper %.4f ms, kernel alone "
            "%.4f ms (L2-cold %.4f) vs plain %.4f ms; bound %.4f ms (%s: "
            "%.1f MB, %.3f GFLOP)" % (label, shape, A, detail, ms, alone_ms,
                                      cold_ms, plain_ms, bound_ms, bound_by,
                                      nbytes / 1e6, flops / 1e9))
        row['max_abs_err'] = max(row['max_abs_err'], abs_err)
        row['max_rel_err'] = max(row['max_rel_err'], rel)
        suffix = '' if A == 12 else '_A%d' % A
        row.update({'ms' + suffix: ms, 'kernel_ms' + suffix: alone_ms,
                    'kernel_ms_cold' + suffix: cold_ms,
                    'plain_ms' + suffix: plain_ms,
                    'bound_ms' + suffix: bound_ms,
                    'bound_by' + suffix: bound_by})
    rows.append(row)
    return rows


def check_statistics(label, t, free, band):
    target = PATHS[label][1]
    mean_target = float(np.mean(free[target]))
    med = float(np.median(t))
    if not np.isfinite(free.max_ll).all():
        raise AssertionError("%s: non-finite free-fit max_ll" % label)
    if not (t >= 0).all():
        raise AssertionError("%s: negative profile statistic" % label)
    if not 0.7 < mean_target < 1.3:
        raise AssertionError("%s: mean fitted %s %.4f outside (0.7, 1.3)"
                             % (label, target, mean_target))
    if not band[0] < med < band[1]:
        raise AssertionError("%s: median t %.4f outside %s"
                             % (label, med, band))
    return mean_target, med


def read_launches(mods):
    """Every wrapper's launch count since the last reset."""
    launches = {}
    for module in mods.values():
        launches.update(module.launch_counts())
    return launches


def own_kernels(label):
    """The kernels a phase of the path launches: its two likelihood kernels
    and, with them, the parameter graph's two (``GRAPH_KERNELS``)."""
    own = [name for name, _, _, _ in META[label]]
    return own + list(GRAPH_KERNELS) if own else own


def check_own_launches(label, launches, what):
    """Print a phase's launches; raise unless each of the path's kernels
    (``own_kernels``) launched in it and no other kernel did."""
    log("%s kernel launches in %s: %s" % (label, what, launches))
    own = own_kernels(label)
    if not all(launches[name] > 0 for name in own):
        raise AssertionError("%s: a kernel of the path never launched in %s"
                             % (label, what))
    if any(count for name, count in launches.items() if name not in own):
        raise AssertionError("%s: another path's kernel launched in %s"
                             % (label, what))


def main_path(label, study, mods, rows):
    """Phase 2: the path twice between reset and read of every counter."""
    _, target, n_toys, _, _ = PATHS[label]
    band = median_band(label)
    for module in mods.values():
        module.reset_launch_counts()
    results = []
    for seed in (0, 1):
        t0 = time.time()
        t, free, cond = study.profile_ts(seed, n_toys=n_toys, target=target,
                                         hypothesis=1.0)
        torch.cuda.synchronize()
        results.append((time.time() - t0, t, free, cond))
    launches = read_launches(mods)
    check_own_launches(label, launches, 'the main path')
    for (secs, t, free, cond), run in zip(results, ('first', 'warm')):
        mean_target, med = check_statistics(label, t, free, band)
        log("%s profile_ts %s run: %d toys in %.3f s (%.1f profile fits/s); "
            "median t %.4f; mean %s %.4f; mean Newton iterations free %.1f, "
            "conditional %.1f" % (label, run, n_toys, secs, n_toys / secs,
                                  med, target, mean_target,
                                  free.n_iter.mean(), cond.n_iter.mean()))
    for row in rows:
        row['launches'] = launches[row['name']]
    return launches


def distinct_per_row(x):
    """Distinct values of each row of an integer tensor (R, M), -1 not
    counted (padding)."""
    s = x.sort(-1).values
    return 1 + (s[:, 1:] != s[:, :-1]).sum(-1) - (s[:, 0] < 0).long()


# The wrappers a profile's calls are recorded from, per contract: label ->
# (module, wrapper, launcher, positions of the arguments shared by every
# call, positions of strides and idx). Shared: the binned anchor tensor
# and, on bb and bb-lite, the MC-count rows; the unbinned study's ps (1.04
# GB on unbinned_xenon), mask and inv_ref.
Calls = collections.namedtuple('Calls',
                               'module wrapper launcher shared strides idx')
VALUE_CALLS = {
    'xenon': Calls('fused', 'binned_ll_fused_multi', 'binned_ll_launcher',
                   (0,), 1, 2),
    'bb': Calls('fused_bb', 'binned_bb_ll_fused_multi',
                'binned_bb_ll_launcher', (0, 1), 2, 3),
    'bblite': Calls('fused_bb_lite', 'binned_bblite_ll_fused_multi',
                    'binned_bblite_ll_launcher', (0, 1), 2, 3),
    'unbinned_xenon': Calls('fused_unbinned', 'unbinned_ll_fused_multi',
                            'unbinned_ll_launcher', (0, 6, 7), 1, 3),
    'unbinned': Calls('fused_unbinned', 'unbinned_ll_fused_multi',
                      'unbinned_ll_launcher', (0, 6, 7), 1, 3),
}
VGH_CALLS = {
    'xenon': Calls('fused', 'binned_vgh_fused', 'binned_vgh_launcher', (0,),
                   1, 2),
    'bb': Calls('fused_bb', 'binned_bb_vgh_fused', 'binned_bb_vgh_launcher',
                (0, 1), 2, 3),
    'bblite': Calls('fused_bb_lite', 'binned_bblite_vgh_fused',
                    'binned_bblite_vgh_launcher', (0, 1), 2, 3),
    'unbinned_xenon': Calls('fused_unbinned', 'unbinned_vgh_fused',
                            'unbinned_vgh_launcher', (0, 6, 7), 1, 3),
    'unbinned': Calls('fused_unbinned', 'unbinned_vgh_fused',
                      'unbinned_vgh_launcher', (0, 6, 7), 1, 3),
}
CALLS = {'value': VALUE_CALLS, 'vgh': VGH_CALLS}


def record_calls(label, study, mods, contract='value', seed=0,
                 n_toys=None, run=None):
    """Every call of the path's wrapper of ``contract`` (``CALLS``) in one
    ``profile_ts`` of ``n_toys`` toys (default: the path's), or in
    ``run(fresh)``, on a fresh study like ``study`` (whose fitters take the
    wrapper through a recorder; the wrapper is put back after): a list of
    each call's arguments, the per-call inputs cloned and the shared
    tensors passed through, as on the path."""
    _, target, path_toys, _, _ = PATHS[label]

    def on_fresh_study():
        extra = {} if study.compiled.is_binned else dict(n_max=study.n_max)
        fresh = type(study)(study.lf, dtype=study.compiled.dtype,
                            device=study.device, max_iter=study.max_iter,
                            tol=study.tol, engine=study.engine, **extra)
        if run is None:
            fresh.profile_ts(seed, n_toys=n_toys or path_toys,
                             target=target, hypothesis=1.0)
        else:
            run(fresh)
    return recorded_calls(mods, [CALLS[contract][label]],
                          on_fresh_study)[0]


def recorded_calls(mods, specs, run):
    """Every call of the wrappers of ``specs`` (``CALLS``) in ``run()``,
    whose fitters must be built inside it (they read the wrappers when
    they are built; each is put back after): per spec, a list of each
    call's arguments, the per-call inputs cloned and the shared tensors
    passed through."""
    saved, calls = [], []
    for spec in specs:
        module = mods[spec.module]
        wrapper, mine = getattr(module, spec.wrapper), []

        def recorder(*args, spec=spec, wrapper=wrapper, mine=mine):
            mine.append(tuple(
                a.clone() if torch.is_tensor(a) and i not in spec.shared
                else a for i, a in enumerate(args)))
            return wrapper(*args)
        recorder.launches = 0       # the launchers count on the module's name
        setattr(module, spec.wrapper, recorder)  # read when fitters are built
        saved.append((module, spec.wrapper, wrapper))
        calls.append(mine)
    try:
        run()
    finally:
        for module, name, wrapper in saved:
            setattr(module, name, wrapper)
    return calls


def call_candidates(args, spec):
    """Candidates a toy of a recorded call: A of a value call, 1 of a vgh
    call (its idx is (L, K))."""
    idx = args[spec.idx]
    return idx.shape[1] if idx.dim() == 3 else 1


def time_calls(launcher, calls, spec, key=call_candidates):
    """{key: summed ms} of recorded calls (``record_calls`` of the contract
    ``spec``): one launcher built per call, the launches of each group of
    calls (by ``key(args, spec)``, default the candidate count A,
    ``call_candidates``) captured in one CUDA graph in call order, and the
    replays timed (``roofline.launch_elapsed_s``)."""
    from blueice_tpu_torch.utils.roofline import launch_elapsed_s
    groups = {}
    for args in calls:
        groups.setdefault(key(args, spec), []).append(launcher(*args)[0])
    return {k: 1e3 * len(fns) * launch_elapsed_s(fns, len(fns))
            for k, fns in sorted(groups.items())}


def call_work(contract, args, spec, S, K, G):
    """(bytes, operations) of one recorded call (``roofline.work``), as
    phase 1 counts them: binned, the distinct corner rows (the MC-count
    row among the rows a corner reads) over every bin and the observed
    counts; unbinned, each lane's distinct corner rows over its valid
    events, the lanes' mask and the valid events' inv_ref. Returns the
    corner ids (L, A, C) too."""
    from blueice_tpu_torch.ops import fused
    from blueice_tpu_torch.utils.roofline import (distinct_rows, row_events,
                                                  work)
    strides, idx = args[spec.strides], args[spec.idx]
    L, A = idx.shape[0], call_candidates(args, spec)
    ids = fused.corner_ids(strides, idx, G).reshape(L, A, -1)
    lead = (L, A) if contract == 'value' else (L,)
    if spec.module == 'fused_unbinned':
        ps, lanes, mask = args[0], args[2], args[6]
        valid = mask[lanes].sum(-1)
        n_valid = int(valid.sum())
        return work(contract, S, K, lead,
                    row_floats=S * row_events(ids, valid),
                    data_bytes=L * ps.shape[-1] + 4 * n_valid,
                    items=A * n_valid) + (ids,)
    R = S + (len(spec.shared) > 1)              # rows a corner reads
    N = args[0].shape[-1]
    return work(contract, S, K, lead, row_floats=R * distinct_rows(ids) * N,
                data_bytes=L * N * 4, items=L * A * N, mc_rows=R > S) + (ids,)


def replay_calls(label, study, mods, rows, contract='value'):
    """The kernel of ``contract`` over the profile's own calls
    (``record_calls``, seed 0; the kernels are built and loaded), replayed
    from CUDA graphs (``time_calls``). Prints the calls, their mean lanes L
    (and, of the value kernel, candidates A and distinct corner rows U per
    toy and per group of 8 candidates), the summed kernel time and the
    summed bound (``call_work``); adds them to the kernel's row."""
    from blueice_tpu_torch.utils.roofline import bound
    spec = CALLS[contract][label]
    calls = record_calls(label, study, mods, contract)
    torch.cuda.synchronize()
    if not calls:
        raise AssertionError("%s: the profile made no %s-kernel call"
                             % (label, contract))
    compiled = study.compiled
    K, S = len(compiled.shape_names), len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    stats = dict(lanes=0, cands=0, toy_rows=0, groups=0, group_rows=0,
                 bound_ms=0.0)
    for args in calls:
        nbytes, flops, ids = call_work(contract, args, spec, S, K, G)
        L, A = ids.shape[:2]
        n_grp = -(-A // 8)
        grouped = torch.nn.functional.pad(ids, (0, 0, 0, 8 * n_grp - A),
                                          value=-1)
        stats['toy_rows'] += int(distinct_per_row(ids.reshape(L, -1)).sum())
        stats['group_rows'] += int(distinct_per_row(
            grouped.reshape(L * n_grp, -1)).sum())
        stats['groups'] += L * n_grp
        stats['lanes'] += L
        stats['cands'] += L * A
        stats['bound_ms'] += bound(nbytes, flops)[0]
    per_A = time_calls(getattr(mods[spec.module], spec.launcher), calls,
                       spec)
    n = len(calls)
    out = dict(replay_calls=n, replay_ms=sum(per_A.values()),
               replay_bound_ms=stats['bound_ms'],
               replay_mean_lanes=stats['lanes'] / n)
    if contract == 'value':
        out.update(replay_mean_A=stats['cands'] / stats['lanes'],
                   replay_mean_U_toy=stats['toy_rows'] / stats['lanes'],
                   replay_mean_U_group=stats['group_rows'] / stats['groups'])
        log("%s value kernel over one profile's own calls: %d calls, mean "
            "lanes L %.1f, mean A %.2f (lane-weighted), mean distinct corner "
            "rows U %.2f a toy, %.2f a group of 8 candidates; kernel time "
            "summed %.4f ms (%s), bound summed %.4f ms"
            % (label, n, out['replay_mean_lanes'], out['replay_mean_A'],
               out['replay_mean_U_toy'], out['replay_mean_U_group'],
               out['replay_ms'], ', '.join('A=%d: %d calls %.4f ms' % (
                   A, sum(call_candidates(a, spec) == A for a in calls),
                   ms) for A, ms in per_A.items()),
               out['replay_bound_ms']))
    else:
        log("%s vgh kernel over one profile's own calls: %d calls, mean "
            "lanes L %.1f (min %d, max %d); kernel time summed %.4f ms, "
            "bound summed %.4f ms"
            % (label, n, out['replay_mean_lanes'],
               min(a[spec.idx].shape[0] for a in calls),
               max(a[spec.idx].shape[0] for a in calls),
               out['replay_ms'], out['replay_bound_ms']))
    next(r for r in rows if r['name'] == spec.wrapper).update(out)


# -- the parameter graph's kernels ---------------------------------------------

#: the parameter graph's two kernels (``ops/param_graph.py``,
#: ``csrc/param_graph.cu``), which run wherever a path's likelihood kernels
#: run; their limits against the PyTorch graph (``tests/test_torch_param_graph
#: .py``'s): t, m, the prior and x relative to the call's largest entry; H
#: relative to each lane's largest entry, g to each lane's largest gradient
#: term (``gradient_terms``: near a fit's optimum g is a small difference
#: of such terms, which the two sum in other orders); idx equal
GRAPH_KERNELS = ('graph_fwd', 'graph_chain')
GRAPH_TOLERANCE = (1e-6, 1e-5)
#: what they replace: the JAX package's parameter graph, jnp ops that XLA
#: fuses (no Pallas kernel)
GRAPH_REPLACES = 'blueice_tpu/parallel/fitter.py:996'


def record_graph_calls(run):
    """Every parameter-graph call of ``run()`` that ran on the kernels:
    (forward calls, chain calls), each the graph, its inputs and the outputs
    the path got, cloned. ``_ParamGraph.evaluate`` and ``.gradient`` are
    wrapped on the class for the run (so graphs built before it count too)
    and put back after."""
    from blueice_tpu_torch.parallel import fitter
    cls = fitter._ParamGraph
    evaluate, gradient = cls.evaluate, cls.gradient
    fwd, chain = [], []

    def clone(x):
        return x.clone() if torch.is_tensor(x) else x

    def recording_evaluate(graph, u, fv, derivs=False, want_x=False):
        out = evaluate(graph, u, fv, derivs, want_x)
        if graph.kernel is not None:
            fwd.append((graph, u.clone(), fv.clone(), derivs, want_x,
                        tuple(clone(o) for o in out[:5])))
        return out

    def recording_gradient(graph, u, fv, parts, g_mt, H_mt):
        out = gradient(graph, u, fv, parts, g_mt, H_mt)
        if graph.kernel is not None:
            chain.append((graph, u.clone(), fv.clone(), g_mt.clone(),
                          H_mt.clone(), tuple(o.clone() for o in out)))
        return out
    cls.evaluate, cls.gradient = recording_evaluate, recording_gradient
    try:
        run()
    finally:
        cls.evaluate, cls.gradient = evaluate, gradient
    torch.cuda.synchronize()
    return fwd, chain


@contextlib.contextmanager
def torch_ops(graph):
    """The graph on its PyTorch ops (no kernel tables) inside the block."""
    tables, graph.kernel = graph.kernel, None
    try:
        yield graph
    finally:
        graph.kernel = tables


def graph_gap(what, a, b, per_lane=False, scale=None):
    """max |a - b| over b's largest |entry| (``per_lane``: each lane's, the
    lanes on the first axis; ``scale``: a given scale of each lane), over
    the finite entries; raises unless a and b are finite at the same
    places."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError("%s: the kernel and the PyTorch graph are not "
                             "finite at the same places (%d and %d entries "
                             "not)" % (what, int((~fa).sum()),
                                       int((~fb).sum())))
    if not b.numel():
        return 0.0
    zero = torch.zeros_like(b)
    diff = (torch.where(fb, a, zero) - torch.where(fb, b, zero)).abs()
    size = torch.where(fb, b, zero).abs()
    if per_lane or scale is not None:
        if scale is None:
            scale = size.flatten(1).max(1).values
        return float((diff.flatten(1).max(1).values
                      / scale.clamp(min=1e-30)).max())
    return float(diff.max()) / max(float(size.max()), 1e-30)


def gradient_terms(graph, u, fv, parts, g_mt):
    """Each lane's largest gradient term (L,), the scale of g's float32
    rounding: max over the coordinates n of |d1_n| (sum_m |J_mn g_mt_m| +
    |prior gradient_n|), J the Jacobian of (m, t) in x and d1 the
    transform's slope. From the PyTorch graph's chain, linear in g_mt:
    d1 J_m = g(0) - g(e_m) (H_mt zero; ``parts`` from its ``evaluate``
    with ``derivs``)."""
    L, P = g_mt.shape
    H0 = g_mt.new_zeros((L, P, P))
    with torch_ops(graph):
        base = graph.gradient(u, fv, parts, torch.zeros_like(g_mt), H0)[0]
        terms = base.abs()
        for m in range(P):
            e = torch.zeros_like(g_mt)
            e[:, m] = 1.0
            col = base - graph.gradient(u, fv, parts, e, H0)[0]
            terms = terms + (g_mt[:, m:m + 1] * col).abs()
    return terms.max(1).values


def graph_work(name, graph, u, fv, want_x=False):
    """(bytes, float32 operations) of one graph-kernel call. Bytes: the
    inputs read once and the outputs written once (graph_fwd: each row's u,
    idx, t, m, prior and x where asked; graph_chain: each lane's u, g_mt,
    H_mt, g and H; each lane's fv) and the tables (the mus anchors and the
    GraphDesc) once. Operations, the leading terms only, so a lower bound:
    graph_fwd the lerp of each source's 2^K corners axis by axis (3 a pair)
    and the rate and efficiency products; graph_chain each corner's weight
    and its first and second t-derivatives summed over the sources, and
    J^T H_mt J over J's nonzeros."""
    S, K, n, R = graph.S, graph.K, u.shape[-1], fv.shape[-1]
    C, NP, P = 2 ** K, K * (K - 1) // 2, S + K
    L, rows = u.shape[0], u.numel() // n
    tables = 4 * graph.kernel.mus.numel() + graph.kernel.desc_dev.numel()
    if name == 'graph_fwd':
        per_row = 4 * n + 8 * K + 4 * K + 4 * S + 4 + (4 * n if want_x else 0)
        return (rows * per_row + 4 * L * R + tables,
                float(rows * S * (3 * (C - 1) + 2)))
    per_lane = 4 * (2 * n + R + P + P * P + n * n)
    ops = 2 * C * S * (1 + K + NP) + 4 * P * (S * (K + 2) + K)
    return L * per_lane + tables, float(L * ops)


def graph_rows(label, study, launches):
    """The parameter graph's two kernels over one profile's own calls
    (``record_graph_calls``: the path's study, seed 0, its toys): each
    call's outputs against the PyTorch graph's at the same inputs
    (``GRAPH_TOLERANCE``), then timed over those calls: the kernel alone
    (each call's launcher, the launches of a group of calls, by candidates
    A, captured in one CUDA graph and replayed, ``time_calls``), the whole
    wrapper calls and the PyTorch graph (CUDA events around all the calls),
    summed, beside the summed bound (``graph_work``). Returns their two rows
    of the ``kernels`` line, ``launches`` (the main path's) in each."""
    from blueice_tpu_torch.ops import param_graph
    from blueice_tpu_torch.utils.roofline import bound
    _, target, n_toys, _, _ = PATHS[label]
    fwd, chain = record_graph_calls(lambda: study.profile_ts(
        0, n_toys=n_toys, target=target, hypothesis=1.0))
    if not (fwd and chain):
        raise AssertionError("%s: the profile made no call of a graph kernel"
                             % label)
    ftol, ctol = GRAPH_TOLERANCE
    errs = dict.fromkeys(('t', 'm', 'prior', 'x', 'g', 'H', 'g_lane'), 0.0)
    for graph, u, fv, _, want_x, got in fwd:
        with torch_ops(graph):
            ref = graph.evaluate(u, fv)
        if not torch.equal(got[0], ref[0]):
            raise AssertionError("%s graph_fwd: idx differs from the PyTorch "
                                 "graph's at L = %d" % (label, u.shape[0]))
        for key, a, b in zip(('t', 'm', 'prior', 'x'), got[1:5], ref[1:5]):
            if key != 'x' or want_x:
                errs[key] = max(errs[key], graph_gap(
                    '%s graph_fwd %s' % (label, key), a, b))
    plain_parts = []
    for graph, u, fv, g_mt, H_mt, (g, H) in chain:
        with torch_ops(graph):
            parts = graph.evaluate(u, fv, derivs=True)[5]
            ref_g, ref_H = graph.gradient(u, fv, parts, g_mt, H_mt)
        plain_parts.append(parts)
        errs['g'] = max(errs['g'], graph_gap(
            '%s graph_chain g' % label, g, ref_g,
            scale=gradient_terms(graph, u, fv, parts, g_mt)))
        errs['g_lane'] = max(errs['g_lane'], graph_gap(
            '%s graph_chain g' % label, g, ref_g, per_lane=True))
        errs['H'] = max(errs['H'], graph_gap('%s graph_chain H' % label, H,
                                             ref_H, per_lane=True))
    torch.cuda.synchronize()

    def plain_fwd():
        for graph, u, fv, derivs, _, _ in fwd:
            with torch_ops(graph):
                graph.evaluate(u, fv, derivs=derivs)

    def plain_chain():
        for (graph, u, fv, g_mt, H_mt, _), parts in zip(chain, plain_parts):
            with torch_ops(graph):
                graph.gradient(u, fv, parts, g_mt, H_mt)
    def fwd_args(graph, u, fv, derivs, want_x, got):
        return graph.kernel, u, fv, want_x

    def chain_args(graph, u, fv, g_mt, H_mt, got):
        return graph.kernel, u, fv, g_mt, H_mt

    def candidates(call, _):
        u = call[1]
        return u.shape[1] if u.dim() == 3 else 1
    kinds = {
        'graph_fwd': dict(
            calls=fwd, err=max(errs[k] for k in ('t', 'm', 'prior', 'x')),
            tol=ftol, plain=plain_fwd, args=fwd_args,
            wrapper=param_graph.graph_fwd,
            launcher=param_graph.graph_fwd_launcher,
            work=lambda graph, u, fv, _, want_x, __:
                graph_work('graph_fwd', graph, u, fv, want_x)),
        'graph_chain': dict(
            calls=chain, err=max(errs['g'], errs['H']), tol=ctol,
            plain=plain_chain, args=chain_args,
            wrapper=param_graph.graph_chain,
            launcher=param_graph.graph_chain_launcher,
            work=lambda graph, u, fv, *_: graph_work('graph_chain', graph,
                                                     u, fv))}
    rows = []
    for name, kind in kinds.items():
        calls, args, wrapper = kind['calls'], kind['args'], kind['wrapper']
        per_A = time_calls(lambda *c: kind['launcher'](*args(*c)), calls,
                           None, key=candidates)
        kernel_ms = sum(per_A.values())
        ms = cuda_ms(lambda: [wrapper(*args(*c)) for c in calls], runs=3,
                     warmup=1)
        plain_ms = cuda_ms(kind['plain'], runs=3, warmup=1)
        work = [kind['work'](*c) for c in calls]
        bound_ms = sum(bound(b, f)[0] for b, f in work)
        nbytes = sum(b for b, _ in work)
        lanes = [c[1].shape[0] for c in calls]
        log("%s %s over one profile's own calls: %d calls, mean lanes L "
            "%.1f (min %d, max %d), rows %d; largest gap to the PyTorch "
            "graph %.3g (limit %.0e; %s); kernel alone summed %.4f ms (%s), "
            "wrapper calls summed %.4f ms, PyTorch graph summed %.4f ms; "
            "bound summed %.4f ms (%.1f MB)"
            % (label, name, len(calls), np.mean(lanes), min(lanes),
               max(lanes), sum(c[1].numel() // c[1].shape[-1] for c in calls),
               kind['err'], kind['tol'], ', '.join(
                   '%s %.3g' % (k, errs[k]) for k in (
                       ('t', 'm', 'prior', 'x') if name == 'graph_fwd'
                       else ('g', 'H', 'g_lane'))),
               kernel_ms, ', '.join('A=%d: %.4f ms' % a for a in per_A.items()),
               ms, plain_ms, bound_ms, nbytes / 1e6))
        if not kind['err'] <= kind['tol']:
            raise AssertionError("%s %s: the kernel disagrees with the "
                                 "PyTorch graph by %.3g (limit %.0e)"
                                 % (label, name, kind['err'], kind['tol']))
        rows.append(dict(
            name=name, path=label, route='cuda', source=CSRC + 'param_graph.cu',
            replaces=GRAPH_REPLACES, also_replaces=None, library_ms=None,
            launches=launches[name], max_rel_err=kind['err'],
            replay_calls=len(calls), replay_mean_lanes=float(np.mean(lanes)),
            kernel_ms=kernel_ms, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by='bytes' if all(bound(b, f)[1] == 'bytes'
                                    for b, f in work) else 'mixed'))
    return rows


def two_precisions(label, study, cls):
    """Phase 3: the same toys in float32 on the card and in float64 on the
    CPU (plain versions)."""
    from blueice_tpu_torch.parallel.fitter import tree_map
    _, target, n_toys, n_compare, _ = PATHS[label]
    if study.compiled.is_binned:
        toys = tree_map(lambda c: c[:n_compare], study.simulate(0, n_toys))
        cpu_toys = tree_map(lambda c: c.cpu().double(), toys)
        cpu_study = cls(study.lf, dtype=torch.float64, device='cpu',
                        max_iter=96, tol=3e-4)
    else:
        toys = tuple(x[:n_compare] for x in study.simulate(0, n_toys))
        cpu_toys = tuple(x.cpu() for x in toys)
        cpu_study = cls(study.lf, n_max=study.n_max, dtype=torch.float64,
                        device='cpu', max_iter=96, tol=3e-4)
    t32, f32, c32 = study._run_profile(toys, target, 1.0, None)
    t0 = time.time()
    t64, f64, c64 = cpu_study._run_profile(cpu_toys, target, 1.0, None)
    d_ll = np.maximum(np.abs(f32.max_ll - f64.max_ll),
                      np.abs(c32.max_ll - c64.max_ll))
    d_t = np.abs(t32 - t64)
    worst = int(np.argmax(d_ll))
    log("%s float32 (CUDA) vs float64 (CPU, %.1f s), %d toys: max |d "
        "max_ll| %.4g, median |d t| %.4g; worst toy %d: free %.4f vs %.4f, "
        "conditional %.4f vs %.4f, t %.4f vs %.4f"
        % (label, time.time() - t0, n_compare, d_ll.max(), np.median(d_t),
           worst, f32.max_ll[worst], f64.max_ll[worst], c32.max_ll[worst],
           c64.max_ll[worst], t32[worst], t64[worst]))
    if not (d_ll.max() <= 0.05 and np.median(d_t) <= 0.01):
        raise AssertionError("%s: float32 fits disagree with float64" % label)


def check_on_card(label, compiled):
    """The study's defaults: float32 on the card."""
    if compiled.device.type != 'cuda' or compiled.dtype != torch.float32:
        raise AssertionError("%s: the study did not default to float32 on "
                             "the card" % label)


def run_path(label, mods, api):
    model = PATHS[label][0]
    t0 = time.time()
    lf = build_model(label, api['xenon_like'], api['test_helpers'],
                     api['likelihood'])
    if model.startswith('unbinned'):
        cls = api['UnbinnedToyStudy']
        study = cls(lf, max_iter=96, tol=3e-4)          # the card, float32
        log("%s likelihood: anchor pdf tensor %s (grid, sources, bins), "
            "n_max %d, built in %.1f s"
            % (label, tuple(study._pdf_tensor.shape), study.n_max,
               time.time() - t0))
    else:
        cls = api['BinnedToyStudy']
        study = cls(lf, max_iter=96, tol=3e-4)          # the card, float32
        compiled = study.compiled
        children = getattr(compiled, 'children', None) or [compiled]
        log("%s likelihood: anchor tensor(s) %s (grid, sources, bins)%s, "
            "built in %.1f s" % (
                label, [tuple(c.ps_tensor.shape) for c in children
                        if c.has_data],
                ' log-morphed' if compiled.log_morph else '',
                time.time() - t0))
    check_on_card(label, study.compiled)
    rows = []
    if META[label]:
        # a Sum's kernels at the shapes of its SR1 child
        kernel_study = (types.SimpleNamespace(compiled=children[1])
                        if label == 'combined' else study)
        rows = kernel_rows(label, kernel_study, mods)
    launches = main_path(label, study, mods, rows)
    for contract in CALLS:
        if label in CALLS[contract]:
            replay_calls(label, study, mods, rows, contract)
    if META[label]:
        rows += graph_rows(label, study, launches)
    two_precisions(label, study, cls)
    return rows, study, cls


# -- the statistics part --------------------------------------------------

#: phase: (the path whose study it runs on, 'band' (``sensitivity_band``
#: over that many toys) or 'interval' (``observed_interval`` on one
#: simulated dataset bound with ``set_data``), toys)
STATS = collections.OrderedDict([
    ('xenon band', ('xenon', 'band', 256)),
    ('xenon interval', ('xenon', 'interval', None)),
    ('unbinned band', ('unbinned', 'band', 1024)),
    ('unbinned_xenon interval', ('unbinned_xenon', 'interval', None)),
    ('combined interval', ('combined', 'interval', None)),
])
#: toys of a band's float32-vs-float64 grid referee
REFEREE_TOYS = 8


def counted(mods, fn):
    """(fn(), every wrapper's launches in it): the counters set to 0 just
    before and read just after."""
    for module in mods.values():
        module.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, read_launches(mods)


def path_rows(rows, label):
    return [r for r in rows if r.get('path') == label]


def cpu_referee_study(study, cls):
    """A float64 CPU study of the same likelihood (plain versions)."""
    extra = {} if study.compiled.is_binned else dict(n_max=study.n_max)
    return cls(study.lf, dtype=torch.float64, device='cpu', max_iter=96,
               tol=3e-4, **extra)


def referee_grid(cpu, toys, target, hyps, f32, c32):
    """(ts, free, conds) of the float64 referee of a float32 grid on the
    same toys: ``cpu._run_profile_grid``, then every fit also started at
    the float32 optimum, the better of the two kept (as bench.py's interval
    referee takes the better of its two chains): where the float32 fit
    found a better optimum than the float64 fit's own start, float64 from
    there measures the precision, not the start."""
    from blueice_tpu_torch.parallel.toys import ToyResults, _best_of_two
    _, _, f64, c64 = cpu._run_profile_grid(toys, target, hyps, None)
    data = (cpu._counts(toys) if cpu.compiled.is_binned
            else cpu._fit_data(toys))
    fit_free, _, fit_cond, _, names_free, names_cond, _ = cpu._profile_fn(
        target, None)

    def better(ref, start, fit, *args):
        again = [v.cpu().numpy() for v in fit(data, *args, x0=start.x)]
        return _best_of_two((ref.x, ref.max_ll, ref.n_iter), again)
    free = ToyResults(names_free, *better(f64, f32, fit_free))
    conds = [ToyResults(names_cond, *better(a, b, fit_cond, [h]))
             for h, a, b in zip(hyps, c64, c32)]
    ts = np.stack([np.maximum(2.0 * (free.max_ll - c.max_ll), 0.0)
                   for c in conds])
    return ts, free, conds


def band_phase(phase, label, study, cls, mods, rows, n_toys):
    """``sensitivity_band`` on the path's study (background-only truth,
    'auto' grid), seed 0 and then warm with seed 1, between reset and read
    of every counter; gates on the band; then the first REFEREE_TOYS toys
    of seed 1 through ``_run_profile_grid`` at the warm run's final grid,
    on the card and on a float64 CPU study (``referee_grid``)."""
    from blueice_tpu_torch.parallel import sensitivity_band, limits
    target = PATHS[label][1]
    grids = []
    grid_fn = study.profile_ts_grid

    def recording(*args, **kwargs):
        out = grid_fn(*args, **kwargs)
        grids.append(out[1])
        return out

    def run():
        out = []
        for seed in (0, 1):
            t0 = time.time()
            band = sensitivity_band(study, seed, target, 'auto', n_toys)
            torch.cuda.synchronize()
            out.append((time.time() - t0, band, grids[-1], len(grids)))
        return out
    study.profile_ts_grid = recording
    try:
        results, launches = counted(mods, run)
    finally:
        del study.profile_ts_grid
    check_own_launches(label, launches, phase)
    calls = 0
    for (secs, band, hyps, n_grids), run in zip(results, ('first', 'warm')):
        lims, qs = band['limits'], np.array(list(band['band'].values()))
        log("%s %s run: %d toys in %.3f s (%.1f limits/s); band %s; %d "
            "beyond the grid; final grid [%.5g, %.5g] of %d points, %d grid "
            "runs" % (phase, run, n_toys, secs, n_toys / secs, json.dumps(
                band['band']), band['n_beyond_grid'], hyps[0], hyps[-1],
                len(hyps), n_grids - calls))
        calls = n_grids
        if not (np.isfinite(band['band'][0.5])
                and band['n_beyond_grid'] < n_toys // 4
                and (np.diff(qs) >= 0).all()
                and (lims[np.isfinite(lims)] >= hyps[0]).all()):
            raise AssertionError("%s: the %s band fails its gates" % (phase,
                                                                       run))
    for row in path_rows(rows, label):
        row['launches_band'] = launches[row['name']]
        row['band_s'] = results[1][0]
        row['band_limits_per_s'] = n_toys / results[1][0]

    hyps = results[1][2]
    toys = study.simulate(1, n_toys, {target: 0.0})     # the band's truth
    if study.compiled.is_binned:
        toys = toys[:REFEREE_TOYS]
        cpu_toys = toys.cpu().double()
    else:
        toys = tuple(x[:REFEREE_TOYS] for x in toys)
        cpu_toys = tuple(x.cpu() for x in toys)
    t32, _, f32, c32 = study._run_profile_grid(toys, target, hyps, None)
    t0 = time.time()
    t64, f64, c64 = referee_grid(cpu_referee_study(study, cls), cpu_toys,
                                 target, hyps, f32, c32)
    d_ll = max([float(np.abs(f32.max_ll - f64.max_ll).max())]
               + [float(np.abs(a.max_ll - b.max_ll).max())
                  for a, b in zip(c32, c64)])
    d_t = np.abs(t32 - t64)
    crit = limits._checked_crit(hyps, 0.9, None)
    d_lim = np.abs(limits._edge_from_curves(t32, hyps, f32[target], crit,
                                            'upper')
                   - limits._edge_from_curves(t64, hyps, f64[target], crit,
                                              'upper'))
    log("%s float32 (CUDA) vs float64 (CPU, %.1f s), %d toys x %d "
        "hypotheses: max |d max_ll| %.4g, median |d t| %.4g (max %.4g); "
        "largest |d limit| %.4g (grid step %.4g)"
        % (phase, time.time() - t0, REFEREE_TOYS, len(hyps), d_ll,
           np.median(d_t), d_t.max(), np.nanmax(d_lim),
           (hyps[-1] - hyps[0]) / (len(hyps) - 1)))
    if not (d_ll <= 0.05 and np.median(d_t) <= 0.01):
        raise AssertionError("%s: the float32 grid disagrees with float64"
                             % phase)


def observed_dataset(lf):
    """One dataset of the background-only model (the wimp rate at 0),
    drawn from a seeded generator and bound with ``set_data``."""
    lf.set_data(lf.base_model.simulate({'wimp': 0.0},
                                       rng=np.random.default_rng(1)))


def sum_dataset(study, target):
    """One background-only dataset of a Sum's study (``target`` at 0),
    drawn from seed 1: a tuple, one count tensor per child."""
    from blueice_tpu_torch.parallel.fitter import tree_map
    return tree_map(lambda c: c[0], study.simulate(1, 1, truth={target: 0.0}))


def map_calls_row(phase, label, study, mods, contract, hyps):
    """Every call of the path's wrapper of ``contract`` in one
    ``profile_map`` at the interval's final grid (``record_calls``: the
    lanes all on the observed dataset): the kernel held to the float64
    closed form within phase 1's tolerances (``TOLERANCE``: the binned ll
    relative to |ll|, g and H relative to each toy's largest entry), except
    the unbinned ll, which phase 1's 1e-5 of its terms cannot hold at the
    centering point where every map lane starts: that is held lane by lane
    to ``ll_allowance``, derived from float32 itself. Timed (replayed from
    CUDA graphs) beside the plain version and the summed bound. Returns
    the kernel's row of this phase."""
    target = PATHS[label][1]
    calls = record_calls(label, study, mods, contract,
                         run=lambda s: s.profile_map([(target, hyps)]))
    return dict(held_calls_row(phase, label, study.compiled, mods, contract,
                               calls, "one map's"),
                path=label + ' interval map', map_calls=len(calls))


def held_calls_row(phase, label, compiled, mods, contract, calls, what,
                   gh_from_float32=False, every=1, plain_runs=3):
    """The path's kernel of ``contract`` on recorded calls
    (``recorded_calls``) of ``compiled``: held to the float64 closed form
    within phase 1's tolerances, the unbinned ll lane by lane within
    ``ll_allowance``; timed (replayed from CUDA graphs) beside the plain
    version and the summed bound. Returns those fields of its row.

    ``gh_from_float32``: g and H within ``float32_allowance`` of the same
    calls instead of phase 1's 1e-4 (the calls of a fit near its optimum,
    where g nearly vanishes and its largest entry is no scale for float32's
    rounding). ``every``: hold every that many-th call (all are timed and
    bounded): a long chain's calls all have one shape. ``plain_runs``: the
    plain version's timed runs over all the calls (median, after a warm-up
    run; a single run has none: holding the calls ran the plain version at
    their shapes)."""
    from blueice_tpu_torch.utils.roofline import bound
    spec = CALLS[contract][label]
    module = mods[spec.module]
    torch.cuda.synchronize()
    if not calls:
        raise AssertionError("%s: no %s-kernel call" % (phase, contract))
    wrapper = getattr(module, spec.wrapper)
    used, f32_errs, abs_err = [], [], 0.0
    for args in calls[::every]:
        out = double(wrapper(*args))
        f32, f64 = (double(x) for x in closed_forms(module, spec.wrapper,
                                                     args))
        if spec.module == 'fused_unbinned':
            allow = ll_allowance(spec, args, f32, f64)
            f32_errs.append(disagreement(f32, f64, term_scale(*args)))
        else:
            allow = TOLERANCE[0] * (f64[0] if contract == 'vgh'
                                    else f64).abs()
            f32_errs.append(disagreement(f32, f64))
        used.append(disagreement(out, f64, allow))
        for a, b in zip(*((x,) if torch.is_tensor(x) else x
                          for x in (out, f32))):
            abs_err = max(abs_err, float((a - b).abs().nan_to_num(
                0.0, 0.0).max()))
    gh_allow = (float32_allowance([e[1] for e in f32_errs])
                if gh_from_float32 else TOLERANCE[1])
    used = np.max(used, axis=0) / [1.0, gh_allow]
    K, S = len(compiled.shape_names), len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    bounds = [bound(*call_work(contract, args, spec, S, K, G)[:2])
              for args in calls]
    ms = sum(time_calls(getattr(module, spec.launcher), calls,
                        spec).values())
    plain = getattr(module, spec.wrapper.replace('_fused_multi', '_plain')
                    .replace('_fused', '_plain'))
    plain_ms = cuda_ms(lambda: [plain(*args) for args in calls],
                       runs=plain_runs, warmup=1 if plain_runs > 1 else 0)
    lanes = [a[spec.idx].shape[0] for a in calls]
    bound_ms = sum(b for b, _ in bounds)
    by = collections.Counter()
    for b, kind in bounds:
        by[kind] += b
    log("%s: the %s kernel over %s %d calls (%d-%d lanes, all on "
        "one dataset; every %d held): against float64, the ll uses %.3g of "
        "its allowance "
        "(%s), g/H %.3g of %.3g (float32 closed form: ll %.3g of %s, g/H "
        "%.3g); kernel time summed %.4f ms, plain %.4f ms, bound summed "
        "%.4f ms" % (
            phase, contract, what, len(calls), min(lanes), max(lanes),
            every, used[0],
            'float32 lane by lane' if spec.module == 'fused_unbinned'
            else '1e-5 of |ll|', used[1], gh_allow,
            *np.max(f32_errs, axis=0)[:1],
            'its terms' if spec.module == 'fused_unbinned' else '|ll|',
            np.max(f32_errs, axis=0)[1], ms, plain_ms, bound_ms))
    if not (used <= 1).all():
        raise AssertionError("%s: the %s kernel disagrees with float64 on "
                             "its calls beyond its allowance"
                             % (phase, contract))
    return dict(name=spec.wrapper, max_abs_err=abs_err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by.most_common(1)[0][0], allowance_used=list(used))


def interval_phase(phase, label, study, cls, mods, rows):
    """``observed_interval(kind='upper', cl=0.9)`` on one background-only
    dataset bound with ``set_data``, cold and then three times warm,
    between reset and read of every counter; the same interval on a
    float64 CPU study at the last call's final grid (relative gap <=
    0.01); the kernels on one map's own calls (``map_calls_row``).
    A Sum has no ``set_data``: its dataset is one simulated
    background-only draw, passed as ``counts=`` (an empty entry for the
    constraint), cold and once warm, and no map calls are recorded.
    Returns this phase's kernel rows."""
    from blueice_tpu_torch.parallel import observed_interval
    from blueice_tpu_torch.parallel.fitter import tree_map
    target = PATHS[label][1]
    is_sum = hasattr(study.compiled, 'children')
    if is_sum:
        counts = sum_dataset(study, target)
        kwargs, runs = dict(counts=counts), 2
    else:
        observed_dataset(study.lf)
        kwargs, runs = {}, 4

    def run():
        out = []
        for _ in range(runs):
            t0 = time.time()
            ul, _, hyps, _ = observed_interval(study, target, kind='upper',
                                               cl=0.9, return_grid=True,
                                               **kwargs)
            torch.cuda.synchronize()
            out.append((time.time() - t0, ul, hyps))
        return out
    results, launches = counted(mods, run)
    check_own_launches(label, launches, phase)
    warm = float(np.median([secs for secs, _, _ in results[1:]]))
    ul, hyps = results[-1][1:]
    t0 = time.time()
    # the float64 map at the float32 call's final grid: the same
    # hypotheses and interpolation, one map where 'auto' takes 3-6
    if is_sum:
        kwargs['counts'] = tree_map(lambda c: c.cpu().double(), counts)
    ul64 = observed_interval(cpu_referee_study(study, cls), target, hyps,
                             kind='upper', cl=0.9, **kwargs)
    gap = abs(ul - ul64) / abs(ul64)
    log("%s: upper limit (90%%) %.6g, float64 CPU %.6g at the same grid "
        "(%.1f s): relative gap %.3g; cold %.3f s, warm %.3f s (median of "
        "%d); final grid [%.5g, %.5g] of %d points"
        % (phase, ul, ul64, time.time() - t0, gap, results[0][0], warm,
           runs - 1, hyps[0], hyps[-1], len(hyps)))
    if not (np.isfinite(ul) and gap <= 0.01):
        raise AssertionError("%s: the float32 upper limit disagrees with "
                             "float64" % phase)
    for row in path_rows(rows, label):
        row['launches_interval'] = launches[row['name']]
        row['interval_s'] = warm
    new = []
    if is_sum:
        return new
    for (name, src, rep, alt), contract in zip(META[label],
                                               ('vgh', 'value')):
        row = dict(route='cuda', source=CSRC + src, replaces=TPU + rep,
                   also_replaces=TPU + alt, library_ms=None,
                   launches=launches[name])
        row.update(map_calls_row(phase, label, study, mods, contract, hyps))
        new.append(row)
    return new


def statistics_part(studies, mods, rows):
    """The statistics on the paths' studies (``STATS``): each phase between
    reset and read of every counter, its own kernels launched and no
    other's. Returns the interval phases' kernel rows (the map's calls)."""
    new = []
    for phase, (label, kind, n_toys) in STATS.items():
        study, cls = studies[label]
        t0 = time.time()
        if kind == 'band':
            band_phase(phase, label, study, cls, mods, rows, n_toys)
        else:
            new += interval_phase(phase, label, study, cls, mods, rows)
        log("%s: %.1f s" % (phase, time.time() - t0))
    return new


# -- the autodiff part ----------------------------------------------------

#: the source-wise paths: label -> (the global twin's path, toys). The
#: source-wise model (each source morphed over the shape parameters it
#: depends on: the WIMP over 3^4 anchors, the five others, which list
#: 'efficiency' in dont_hash_settings, over 3^3) fits on the autodiff
#: engine, no kernel; its twin on the twin's kernels, the same toys
SW_PATHS = collections.OrderedDict([
    ('unbinned_xenon_sw', ('unbinned_xenon', 256)),
    ('xenon_sw', ('xenon', 128)),
])
#: phase (g): xenon toys fitted by the autodiff and by the fused engine
ENGINE_TOYS = 64
#: two fits of a toy agree in a coordinate of x within this share of its
#: parabolic error there, or ``X_SPREAD`` times the engines' median spread
#: in those units, the larger: float32's tolerance on the objective (ftol
#: 1e-3) leaves each fit within about sqrt(2e-3) = 0.045 of an error of
#: its optimum (``engines_gate``)
X_ERR_SHARE = 0.1
X_SPREAD = 10.0


def parabolic_errors(study, toys, res, target=None):
    """(toys, n) parabolic errors at the fits ``res`` of ``toys``: the
    inverse of the float32 Hessian of the study's plain closed form at the
    fitted points (with ``target``, the conditional fits at 1.0)."""
    from blueice_tpu_torch.parallel.fitter import x_space_ops
    compiled = study.compiled
    runtime = [] if target is None else [target]
    vgh = x_space_ops(compiled, res.names, runtime_fixed=runtime,
                      engine='analytic')[1]
    data = (study._counts(toys).reshape(len(res.x), -1)
            if compiled.is_binned else study._fit_data(toys))
    x = torch.as_tensor(res.x, dtype=compiled.dtype, device=compiled.device)
    fv = torch.ones((x.shape[0], len(runtime)), dtype=compiled.dtype,
                    device=compiled.device)
    H = vgh(x, data, fv)[2].double()
    cov = torch.linalg.pinv(H)
    return torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                                  min=0)).cpu().numpy()


def engines_gate(what, ad, ref, errors, band=None):
    """Hold a profile of the autodiff engine, ``ad = (t, free, cond)``, to
    the kernels' on the same toys, ``ref``, with ``errors`` the parabolic
    errors of the kernels' free and conditional fits: a toy agrees where
    every coordinate of both its fits is within the float32 bound (the
    larger of ``X_ERR_SHARE`` and ``X_SPREAD`` times the median |dx| /
    error over the toys, in units of the error); at least 95% of the toys
    agree, on those max |d max_ll| <= 0.05 and median |d t| <= 0.01, on
    every toy |d max_ll| < 0.2, and (with ``band``) the median t inside
    it. Prints the bound beside the gate; returns the gate's numbers."""
    (t, free, cond), (t_r, free_r, cond_r) = ad, ref
    shares = [np.abs(a.x - r.x) / np.maximum(err, 1e-30)
              for a, r, err in ((free, free_r, errors[0]),
                                (cond, cond_r, errors[1]))]
    spread = float(np.median(np.concatenate([sh.ravel() for sh in shares])))
    bound = max(X_ERR_SHARE, X_SPREAD * spread)
    agree = np.all(shares[0] <= bound, axis=1) & np.all(shares[1] <= bound,
                                                        axis=1)
    d_ll = np.maximum(np.abs(free.max_ll - free_r.max_ll),
                      np.abs(cond.max_ll - cond_r.max_ll))
    d_t = np.abs(t - t_r)
    out = dict(agree=float(agree.mean()), spread=spread, bound=bound,
               ll_agree=float(d_ll[agree].max()) if agree.any() else np.inf,
               ll_all=float(d_ll.max()),
               t_agree=float(np.median(d_t[agree])) if agree.any() else np.inf,
               median_t=float(np.median(t)), median_t_ref=float(
                   np.median(t_r)))
    worst = [dict(zip(a.names, (float('%.3g' % v) for v in sh.max(axis=0))))
             for a, sh in zip((free, cond), shares)]
    log("%s gate: %d of %d toys agree in x (%.4f; >= 0.95) within the "
        "float32 bound %.4g of a parabolic error (the engines' median "
        "spread %.3g; the bound is %g of an error or %g times the spread, "
        "the larger; the largest |dx| / error per coordinate: %s free, %s "
        "conditional); on those max |d max_ll| %.4g (<= 0.05), median "
        "|d t| %.4g (<= 0.01); every toy max |d max_ll| %.4g (< 0.2); "
        "median t %.4f (kernels %.4f)%s" % (
            what, int(agree.sum()), len(t), out['agree'], bound, spread,
            X_ERR_SHARE, X_SPREAD, json.dumps(worst[0]),
            json.dumps(worst[1]), out['ll_agree'], out['t_agree'],
            out['ll_all'], out['median_t'], out['median_t_ref'],
            '' if band is None else ' in %s' % (band,)))
    if not (out['agree'] >= 0.95 and out['ll_agree'] <= 0.05
            and out['t_agree'] <= 0.01 and out['ll_all'] < 0.2
            and (band is None or band[0] < out['median_t'] < band[1])):
        raise AssertionError("%s: the autodiff engine disagrees with the "
                             "kernels" % what)
    return out


def ad_profile(what, study, toys, target, mods):
    """One profile of the autodiff engine on ``toys``, every counter set to
    0 just before and read just after (no kernel may launch): ((t, free,
    cond), seconds, peak device memory in GB)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out, launches = counted(mods, lambda: study._run_profile(
        toys, target, 1.0, None))
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("%s kernel launches in the autodiff engine's profile: %s"
        % (what, launches))
    if any(launches.values()):
        raise AssertionError("%s: a kernel launched in the autodiff "
                             "engine's profile" % what)
    return out, secs, peak


def kernel_profile(label, study, toys, target, mods, what):
    """The same toys' profile on the kernels of path ``label``: ((t, free,
    cond), seconds)."""
    t0 = time.time()
    out, launches = counted(mods, lambda: study._run_profile(
        toys, target, 1.0, None))
    secs = time.time() - t0
    check_own_launches(label, launches, what)
    return out, secs


def log_engines(what, n_toys, ad, ad_secs, peak, ref, ref_secs):
    (_, free, cond), (_, free_r, cond_r) = ad, ref
    log("%s: %d toys, autodiff engine %.3f s (%.2f profile fits/s; mean "
        "iterations free %.1f, conditional %.1f; peak device memory %.2f "
        "GB), kernels %.3f s (%.2f profile fits/s; %.1f, %.1f)" % (
            what, n_toys, ad_secs, n_toys / ad_secs, free.n_iter.mean(),
            cond.n_iter.mean(), peak, ref_secs, n_toys / ref_secs,
            free_r.n_iter.mean(), cond_r.n_iter.mean()))


def run_sw_path(label, mods, api, studies):
    """A source-wise path: its model's profile study on the autodiff
    engine against the global twin's on its kernels, the same toys (the
    twin's, seed 0), ``engines_gate`` with the twin's band."""
    twin, n_toys = SW_PATHS[label]
    model, target, _, _, band = PATHS[twin]
    unbinned = model.startswith('unbinned')
    cls = api['UnbinnedToyStudy' if unbinned else 'BinnedToyStudy']
    t0 = time.time()
    lf = api['xenon_like'].build_likelihood(
        'unbinned' if unbinned else 'binned', source_wise_interpolation=True,
        **(dict(livetime_days=3.0) if unbinned else {}))
    study = cls(lf, max_iter=96, tol=3e-4)              # the card, float32
    check_on_card(label, study.compiled)
    grids = {sn: tuple(len(a) for a in m.anchor_z_arrays)
             for sn, m in lf.source_morphers.items()}
    log("%s likelihood: per-source anchor grids %s, built in %.1f s"
        % (label, json.dumps(grids), time.time() - t0))
    glob = (studies[twin][0] if twin in studies else
            cls(build_model(twin, api['xenon_like'], api['test_helpers'],
                            api['likelihood']), max_iter=96, tol=3e-4))
    toys = glob.simulate(0, n_toys)
    ad, ad_secs, peak = ad_profile(label, study, toys, target, mods)
    ref, ref_secs = kernel_profile(twin, glob, toys, target, mods,
                                   '%s twin' % label)
    log_engines('%s (autodiff) vs %s (kernels)' % (label, twin), n_toys, ad,
                ad_secs, peak, ref, ref_secs)
    errors = (parabolic_errors(glob, toys, ref[1]),
              parabolic_errors(glob, toys, ref[2], target))
    engines_gate(label, ad, ref, errors, band)


def engines_phase(mods, api, studies):
    """(g) ``ENGINE_TOYS`` of the xenon path's toys (seed 0) through
    ``make_toy_fitter(engine='ad')`` and through the fused engine, as two
    profile studies of one likelihood: ``engines_gate``."""
    what = 'xenon engines'
    target = PATHS['xenon'][1]
    cls = api['BinnedToyStudy']
    study = (studies['xenon'][0] if 'xenon' in studies else
             cls(build_model('xenon', api['xenon_like'], api['test_helpers'],
                             api['likelihood']), max_iter=96, tol=3e-4))
    ad_study = cls(study.lf, max_iter=96, tol=3e-4, engine='ad')
    counts = study.simulate(0, ENGINE_TOYS)
    ad, ad_secs, peak = ad_profile(what, ad_study, counts, target, mods)
    ref, ref_secs = kernel_profile('xenon', study, counts, target, mods, what)
    log_engines('%s (autodiff vs fused)' % what, ENGINE_TOYS, ad, ad_secs,
                peak, ref, ref_secs)
    errors = (parabolic_errors(study, counts, ref[1]),
              parabolic_errors(study, counts, ref[2], target))
    engines_gate(what, ad, ref, errors)


def autodiff_part(mods, api, studies):
    """The source-wise paths (``SW_PATHS``) and phase (g), the autodiff
    engine's profile studies held to the kernels'. No kernel rows."""
    for label in SW_PATHS:
        t0 = time.time()
        run_sw_path(label, mods, api, studies)
        log("path %s: %.1f s" % (label, time.time() - t0))
    t0 = time.time()
    engines_phase(mods, api, studies)
    log("xenon engines phase: %.1f s" % (time.time() - t0))


# -- the inference part ---------------------------------------------------

#: the models whose one dataset (drawn from ``default_rng(0)``) the
#: inference part fits, each a path's model launching that path's kernels
INFERENCE = ('xenon', 'unbinned_xenon', 'unbinned')
#: the chain of phase (c): walkers, steps, burn-in
CHAIN = (40, 1000, 500)
#: (c) and (d) hold every that many-th call to float64 (all are timed):
#: a chain's calls all have one shape, one dataset and A = 20; an
#: interval's are its fits' on one dataset
CHAIN_HELD_EVERY = 10
INTERVAL_HELD_EVERY = 2
#: the host referee of the fits: scipy's Powell at tight tolerances. Its
#: default BFGS stalls at the band_shift kink of the full-width XENON
#: model (ll -4233.178 against -4232.986 for Powell and the Newton fit on
#: that dataset), so it would referee its own stall.
REFEREE_SCIPY = dict(method='Powell',
                     options=dict(xtol=1e-8, ftol=1e-12, maxfev=100000))
#: the upper end of the interval search of phase (d)
INTERVAL_BOUND = 3.0


def fresh_compile(lf):
    """Drop ``lf``'s cached compiles (``compile.cached_logl``), so the next
    fit builds its fitters anew: with a recorder, or after one."""
    lf.__dict__.pop('_torch_compiled_for_fit', None)


def host_referee(lf, **fixed):
    """(fit, max ll, seconds) of ``bestfit_scipy`` (``REFEREE_SCIPY``) on
    the host float64 likelihood."""
    from blueice_tpu_torch.inference import bestfit_scipy
    t0 = time.time()
    fit, ll = bestfit_scipy(lf, minimize_kwargs=REFEREE_SCIPY, **fixed)
    return fit, float(ll), time.time() - t0


def templates_phase(api, mods, tmp):
    """(a) ``build_likelihood('binned', jax_templates=True)`` at full width
    into a fresh cache directory: 12 batched device calls (6 single, 6
    batched), no kernel launch, every anchor pmf within rtol 1e-6, atol
    1e-12 of the host ``GaussianBlobSource`` build. Returns the
    likelihood."""
    from blueice_tpu_torch.models import jax_source
    xenon_like = api['xenon_like']

    def dirs(name):
        return dict(cache_dir=os.path.join(tmp, name),
                    task_dir=os.path.join(tmp, name + '_tasks'))
    calls0 = jax_source.DEVICE_CALLS
    t0 = time.time()
    lf, launches = counted(mods, lambda: xenon_like.build_likelihood(
        'binned', jax_templates=True, **dirs('device')))
    secs = time.time() - t0
    calls = jax_source.DEVICE_CALLS - calls0
    t0 = time.time()
    host = xenon_like.build_likelihood('binned', **dirs('host'))
    host_secs = time.time() - t0
    worst = 0.0
    for zs, m_host in host.anchor_models.items():
        for s_host, s_dev in zip(m_host.sources,
                                 lf.anchor_models[zs].sources):
            got, want = s_dev.get_pmf_grid()[0], s_host.get_pmf_grid()[0]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
            worst = max(worst, float(np.max(np.abs(got - want)
                                            / (1e-12 + 1e-6 * np.abs(want)))))
    n = sum(len(m.sources) for m in lf.anchor_models.values())
    log("inference templates: build_likelihood('binned', jax_templates=True)"
        " %s bins, %d anchor models x %d sources: %d device calls, %.3f s "
        "(host GaussianBlobSource build %.3f s); pmfs use %.3g of rtol 1e-6,"
        " atol 1e-12; kernel launches %s" % (
            'x'.join(str(len(e) - 1) for _, e in
                     lf.base_model.config['analysis_space']),
            len(lf.anchor_models), n // len(lf.anchor_models), calls, secs,
            host_secs, worst, launches))
    if calls != 12 or any(launches.values()):
        raise AssertionError("inference templates: %d device calls (want "
                             "12), launches %s" % (calls, launches))
    return lf


def inference_models(api, mods, tmp):
    """{label: likelihood} of ``INFERENCE``, each with one dataset drawn
    from ``default_rng(0)`` bound: xenon the device-built templates of
    (a), unbinned_xenon at 3 live days, the Gaussian unbinned model."""
    lfs = {'xenon': templates_phase(api, mods, tmp),
           'unbinned_xenon': api['xenon_like'].build_likelihood(
               'unbinned', livetime_days=3.0,
               cache_dir=os.path.join(tmp, 'unbinned'),
               task_dir=os.path.join(tmp, 'unbinned_tasks')),
           'unbinned': build_model('unbinned', api['xenon_like'],
                                   api['test_helpers'], api['likelihood'])}
    for lf in lfs.values():
        lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(0)))
    return lfs


def phase_rows(phase, label, lf, mods, launches, contracts, run, every=1):
    """The path's kernels of ``contracts`` on every call of ``run()`` on a
    fresh compile (``recorded_calls``, ``held_calls_row``, every
    ``every``-th call held); rows with the phase's own launch counts."""
    from blueice_tpu_torch.compile import cached_logl

    def fresh_run():
        fresh_compile(lf)
        run()
    recorded = dict(zip(contracts, recorded_calls(
        mods, [CALLS[contract][label] for contract in contracts], fresh_run)))
    rows = []
    for (name, src, rep, alt), contract in zip(META[label], ('vgh', 'value')):
        if contract not in contracts:
            continue
        calls = recorded[contract]
        row = dict(path=phase, route='cuda', source=CSRC + src,
                   replaces=TPU + rep, also_replaces=TPU + alt,
                   library_ms=None, launches=launches[name],
                   phase_calls=len(calls))
        row.update(held_calls_row(phase, label, cached_logl(lf), mods,
                                  contract, calls, "the phase's",
                                  gh_from_float32=True, every=every,
                                  plain_runs=1))
        rows.append(row)
    fresh_compile(lf)               # later fits build with the wrappers
    return rows


def fit_phase(label, lf, referee, mods):
    """(b) ``bestfit_jax`` on the card: the model's vgh and value kernels
    launched, no other; the fit re-scored on the host float64 likelihood
    at least the referee's maximum - 1e-3, the target within 5e-3 of the
    referee's, the errors finite and within 5% of the same fit on the CPU
    in float64. Returns the phase's kernel rows."""
    phase = '%s bestfit_jax' % label
    target = PATHS[label][1]
    ref_fit, ref_ll, ref_secs = referee
    fresh_compile(lf)
    t0 = time.time()
    (fit, ll), launches = counted(mods, lambda: lf.bestfit_jax())
    cold = time.time() - t0
    check_own_launches(label, launches, phase)
    warm = []
    for _ in range(3):
        t0 = time.time()
        lf.bestfit_jax()
        torch.cuda.synchronize()
        warm.append(time.time() - t0)
    x = {k: v for k, v in fit.items() if not k.endswith('_error')}
    rescored = float(lf(**x))
    t0 = time.time()
    cpu, ll64 = lf.bestfit_jax(device='cpu')
    cpu_secs = time.time() - t0
    err_gap = max(abs(fit[k + '_error'] / cpu[k + '_error'] - 1) for k in x)
    vgh_name, value_name = (name for name, _, _, _ in META[label])
    log("%s: %d iterations (%d Newton; one lane: one value call before "
        "the loop and one an iteration, one vgh call a Newton iteration "
        "and one for the errors), launches %s; cold %.3f s, warm %.4f s a "
        "fit (median of 3); max ll %.6f, re-scored on the host %.6f, "
        "referee %.6f (%.1f s); %s %.6f vs %.6f; errors within %.3g of the "
        "float64 CPU fit's (%.1f s, max ll %.6f)" % (
            phase, launches[value_name] - 1, launches[vgh_name] - 1,
            launches, cold, float(np.median(warm)), ll, rescored, ref_ll,
            ref_secs, target, fit[target], ref_fit[target], err_gap,
            cpu_secs, ll64))
    if not (rescored >= ref_ll - 1e-3
            and abs(fit[target] - ref_fit[target]) < 5e-3
            and all(np.isfinite(fit[k + '_error']) for k in x)
            and err_gap <= 0.05):
        raise AssertionError("%s: the fit fails its gates" % phase)
    return phase_rows(phase, label, lf, mods, launches, ('vgh', 'value'),
                      lambda: lf.bestfit_jax())


def chain_phase(label, lf, referee, mods):
    """(c) ``bestfit_emcee_device`` on the card (``CHAIN``, errors): the
    value kernel launched 2 n_steps + 2 times and nothing else, the chain
    without a host sync (CUDA sync debug mode 'error'); at the last
    ensemble, plus one walker out of the shape bounds, the walkers'
    log_prob within 1e-5 (relative) of its plain version on the card, -inf
    at the same places; every median within its own posterior sigma of
    the referee's optimum; the ll at the medians finite and within n_dim
    of the referee's maximum. Returns the phase's kernel row."""
    from blueice_tpu_torch.compile import cached_logl
    from blueice_tpu_torch.parallel import mcmc
    phase = '%s mcmc' % label
    n_walkers, n_steps, n_burn_in = CHAIN
    ref_fit, ref_ll, _ = referee
    sample, seen = mcmc.sample_stretch, {}

    def recording(log_prob, generator, p0, n, a=2.0):
        torch.cuda.synchronize()
        t0 = time.time()
        torch.cuda.set_sync_debug_mode('error')
        try:
            out = sample(log_prob, generator, p0, n, a)
        finally:
            torch.cuda.set_sync_debug_mode('default')
        torch.cuda.synchronize()
        seen.update(chain=out[0], secs=time.time() - t0)
        return out

    def run():
        return lf.bestfit_emcee_device(
            n_walkers=n_walkers, n_steps=n_steps, n_burn_in=n_burn_in,
            return_errors=True)
    mcmc.sample_stretch = recording
    try:
        (res, ll, errs), launches = counted(mods, run)
    finally:
        mcmc.sample_stretch = sample
    # each value call: one forward graph launch and one value kernel launch
    want = dict.fromkeys((META[label][1][0], 'graph_fwd'), 2 * n_steps + 2)
    log("%s kernel launches: %s" % (phase, launches))
    if any(n != want.get(name, 0) for name, n in launches.items()):
        raise AssertionError("%s: launches %s, want %s and no other"
                             % (phase, launches, want))
    chain = seen['chain']
    accept = float((chain[:, 1:] != chain[:, :-1]).any(-1).double().mean())

    compiled = cached_logl(lf)
    log_prob, names, _ = mcmc.make_device_log_prob(compiled)
    plain = mcmc.make_device_log_prob(compiled, engine='analytic')[0]
    walkers = torch.cat([chain[:, -1], chain[:1, -1]])
    walkers[-1, names.index('band_shift')] = 1.5
    out, ref = log_prob(walkers), plain(walkers)
    same_inf = bool((torch.isneginf(out) == torch.isneginf(ref)).all())
    finite = torch.isfinite(ref)
    rel = float(((out - ref).abs() / ref.abs())[finite].max())
    sigmas = {k: abs(res[k] - ref_fit[k]) / errs[k] for k in res}
    log("%s: %d walkers x %d steps (burn-in %d) in %.3f s, acceptance "
        "%.3f; walker log_prob at the last ensemble + 1 out of bounds vs "
        "plain: rel err %.3g, -inf at the same places %s (%d of %d); "
        "medians from the referee's optimum in own sigmas: max %.3f (%s); "
        "ll at the medians %.6f, referee %.6f" % (
            phase, n_walkers, n_steps, n_burn_in, seen['secs'], accept, rel,
            same_inf, int((~torch.isfinite(out)).sum()), len(walkers),
            max(sigmas.values()), max(sigmas, key=sigmas.get), ll, ref_ll))
    if not (same_inf and bool(torch.isneginf(out[-1])) and rel <= 1e-5
            and max(sigmas.values()) <= 1.0 and np.isfinite(ll)
            and ref_ll - ll <= len(names)):
        raise AssertionError("%s: the chain fails its gates" % phase)
    return phase_rows(phase, label, lf, mods, launches, ('value',), run,
                      every=CHAIN_HELD_EVERY)


def interval_inference_phase(lf, mods):
    """(d) ``one_parameter_interval`` of the xenon dataset's wimp rate
    (upper, 90%) with ``bestfit_routine='jax'`` on the card against the
    same call with the host referee (``host_referee``) in float64: the
    limits within 1%; the xenon kernels launched and no other. Returns the
    phase's kernel rows."""
    from blueice_tpu_torch.inference import bestfit_jax, one_parameter_interval
    phase = 'xenon interval (bestfit_jax)'
    target = PATHS['xenon'][1]
    fits = collections.Counter()

    def jax_fit(lf, **kwargs):
        fits['jax'] += 1
        return bestfit_jax(lf, **kwargs)

    def scipy_fit(lf, **kwargs):
        fits['scipy'] += 1
        return host_referee(lf, **kwargs)[:2]

    def run():
        return one_parameter_interval(lf, target, INTERVAL_BOUND,
                                      kind='upper', confidence_level=0.9,
                                      bestfit_routine=jax_fit)
    fresh_compile(lf)
    t0 = time.time()
    ul, launches = counted(mods, run)
    secs = time.time() - t0
    check_own_launches('xenon', launches, phase)
    t0 = time.time()
    ul64 = one_parameter_interval(lf, target, INTERVAL_BOUND,
                                  kind='upper', confidence_level=0.9,
                                  bestfit_routine=scipy_fit)
    gap = abs(ul - ul64) / abs(ul64)
    log("%s: upper limit (90%%) %.6g in %.2f s (%d fits), host referee "
        "%.6g in %.2f s (%d fits): relative gap %.3g" % (
            phase, ul, secs, fits['jax'], ul64, time.time() - t0,
            fits['scipy'], gap))
    if not (np.isfinite(ul) and gap <= 0.01):
        raise AssertionError("%s: the upper limit disagrees with the host "
                             "referee" % phase)
    return phase_rows(phase, 'xenon', lf, mods, launches, ('vgh', 'value'),
                      run, every=INTERVAL_HELD_EVERY)


#: phase (e): the science runs' live times are cut by this factor, their
#: ratio kept (the host referee's fits grow with the events; PERF.md
#: section 4)
SUM_LIVETIME_SCALE = 0.02
#: phase (f): the WIMP cross-section at the model's base rate (in units
#: of 1e-46 cm^2); its range is 0 to ten times that
XSEC_BASE = 3.0


def unbinned_sum_likelihood(api, tmp):
    """(e)'s model: XENON1T's SR0 and SR1 as two unbinned XENON
    likelihoods, live times in the ratio 32.1 : 246.7
    (``SCIENCE_RUNS_DAYS`` times ``SUM_LIVETIME_SCALE``), each with one
    dataset drawn from ``default_rng`` of its index, plus the calibration
    constraint; the 8 parameters shared by name."""
    from blueice_tpu_torch import composition
    runs = []
    for i, days in enumerate(SCIENCE_RUNS_DAYS):
        lf = api['xenon_like'].build_likelihood(
            'unbinned', livetime_days=days * SUM_LIVETIME_SCALE,
            cache_dir=os.path.join(tmp, 'sr%d' % i),
            task_dir=os.path.join(tmp, 'sr%d_tasks' % i))
        lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(i)))
        runs.append(lf)
    constraint = composition.correlated_gaussian_constraint(*CALIBRATION)
    return api['likelihood'].LogLikelihoodSum(runs + [constraint])


def reparam_likelihood(lf):
    """(f)'s model: ``lf`` with the WIMP rate written as a cross-section,
    ``wimp_rate_multiplier = wimp_xsec / XSEC_BASE``."""
    from blueice_tpu_torch import composition
    lf.pdf_base_config['wimp_xsec'] = XSEC_BASE
    return composition.LogLikelihoodReParam(lf, {
        'wimp_rate_multiplier': {'params': ['wimp_xsec'],
                                 'func': lambda xsec: xsec},
        'wimp_xsec': (np.linspace(0.0, 10 * XSEC_BASE, 11), None, None)})


def no_launches(phase, launches):
    log("%s kernel launches: %s" % (phase, launches))
    if any(launches.values()):
        raise AssertionError("%s: a kernel launched on the autodiff engine"
                             % phase)


def ad_fit_phase(phase, lf, target, mods):
    """``bestfit_jax`` on the card through the autodiff engine, no kernel
    launched, against the host referee (``host_referee``, float64): the
    fit re-scored on the host float64 likelihood within 1e-3 of the
    referee's maximum (as phase (b)), the maximum the fit reports within
    1e-2 of it (float32's rounding of a binned sum of ~1e5 events); the
    target within 5e-3 (relative) of the referee's; the errors finite and
    within 5% of the same fit on the CPU in float64."""
    from blueice_tpu_torch.compile import cached_logl
    from blueice_tpu_torch.parallel.fitter import (make_toy_fitter,
                                                   observed_data)
    ref_fit, ref_ll, ref_secs = host_referee(lf)
    fresh_compile(lf)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    (fit, ll), launches = counted(mods, lambda: lf.bestfit_jax())
    cold = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    no_launches(phase, launches)
    warm = []
    for _ in range(2):
        t0 = time.time()
        lf.bestfit_jax()
        torch.cuda.synchronize()
        warm.append(time.time() - t0)
    compiled = cached_logl(lf)
    n_iter = int(make_toy_fitter(compiled, max_iter=250)[0](
        observed_data(compiled))[2][0])
    x = {k: v for k, v in fit.items() if not k.endswith('_error')}
    rescored = float(lf(**x))
    t0 = time.time()
    cpu, ll64 = lf.bestfit_jax(device='cpu')
    cpu_secs = time.time() - t0
    err_gap = max(abs(fit[k + '_error'] / cpu[k + '_error'] - 1) for k in x)
    target_gap = abs(fit[target] - ref_fit[target]) / max(
        1.0, abs(ref_fit[target]))
    log("%s: %d iterations; cold %.3f s, warm %.3f s a fit (median of 2); "
        "peak device memory %.3f GB; max ll %.6f, re-scored on the host "
        "%.6f, referee %.6f (%.1f s); %s %.6f vs %.6f; errors within %.3g "
        "of the float64 CPU fit's (%.1f s, max ll %.6f)" % (
            phase, n_iter, cold, float(np.median(warm)), peak, ll, rescored,
            ref_ll, ref_secs, target, fit[target], ref_fit[target], err_gap,
            cpu_secs, ll64))
    if not (abs(rescored - ref_ll) <= 1e-3 and abs(ll - ref_ll) <= 1e-2
            and target_gap < 5e-3
            and all(np.isfinite(fit[k + '_error']) for k in x)
            and err_gap <= 0.05):
        raise AssertionError("%s: the fit fails its gates" % phase)


def ad_interval_phase(phase, lf, target, mods):
    """``one_parameter_interval`` (upper, 90%) with
    ``bestfit_routine='jax'`` on the autodiff engine, no kernel launched,
    against the same call with the host referee: within 1e-4 relative."""
    from blueice_tpu_torch.inference import bestfit_jax, one_parameter_interval
    fits = collections.Counter()

    def jax_fit(lf, **kwargs):
        fits['jax'] += 1
        return bestfit_jax(lf, **kwargs)

    def scipy_fit(lf, **kwargs):
        fits['scipy'] += 1
        return host_referee(lf, **kwargs)[:2]

    fresh_compile(lf)
    t0 = time.time()
    ul, launches = counted(mods, lambda: one_parameter_interval(
        lf, target, INTERVAL_BOUND, kind='upper', confidence_level=0.9,
        bestfit_routine=jax_fit))
    secs = time.time() - t0
    no_launches(phase, launches)
    t0 = time.time()
    ul64 = one_parameter_interval(lf, target, INTERVAL_BOUND, kind='upper',
                                  confidence_level=0.9,
                                  bestfit_routine=scipy_fit)
    gap = abs(ul - ul64) / abs(ul64)
    log("%s: upper limit (90%%) %.6g in %.2f s (%d fits), host referee "
        "%.6g in %.2f s (%d fits): relative gap %.3g (<= 1e-4)" % (
            phase, ul, secs, fits['jax'], ul64, time.time() - t0,
            fits['scipy'], gap))
    if not (np.isfinite(ul) and gap <= 1e-4):
        raise AssertionError("%s: the upper limit disagrees with the host "
                             "referee" % phase)


def inference_part(mods, api):
    """The inference part: (a) the device template build, (b)
    ``bestfit_jax`` on the three models of ``INFERENCE``, (c)
    ``bestfit_emcee_device`` on xenon and unbinned_xenon, (d)
    ``one_parameter_interval`` through ``bestfit_jax``; each phase between
    reset and read of every launch counter. Returns its kernel rows."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix='chip_smoke_inference_')
    rows = []
    try:
        lfs = inference_models(api, mods, tmp)
        referees = {label: host_referee(lf) for label, lf in lfs.items()}
        for label in INFERENCE:
            t0 = time.time()
            rows += fit_phase(label, lfs[label], referees[label], mods)
            log("%s bestfit_jax phase: %.1f s" % (label, time.time() - t0))
        for label in ('xenon', 'unbinned_xenon'):
            t0 = time.time()
            rows += chain_phase(label, lfs[label], referees[label], mods)
            log("%s mcmc phase: %.1f s" % (label, time.time() - t0))
        t0 = time.time()
        rows += interval_inference_phase(lfs['xenon'], mods)
        log("xenon interval (bestfit_jax) phase: %.1f s" % (time.time() - t0))
        t0 = time.time()
        target = PATHS['xenon'][1]
        sum_lf = unbinned_sum_likelihood(api, tmp)
        ad_fit_phase('unbinned SR0+SR1 bestfit_jax', sum_lf, target, mods)
        ad_interval_phase('unbinned SR0+SR1 interval (bestfit_jax)', sum_lf,
                          target, mods)
        log("unbinned SR0+SR1 phase: %.1f s" % (time.time() - t0))
        t0 = time.time()
        ad_fit_phase('xenon ReParam bestfit_jax',
                     reparam_likelihood(lfs['xenon']), 'wimp_xsec', mods)
        log("xenon ReParam phase: %.1f s" % (time.time() - t0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


# -- the sharding part ----------------------------------------------------

#: (s2) path: (the model of ``blueice_tpu_torch.dryrun``, toys, profiles a
#: rank runs: the second of xenon's is its warm time)
SHARD_PATHS = collections.OrderedDict([
    ('xenon', ('xenon', 512, 2)),
    ('bb', ('xenon_bb', 128, 1)),
    ('unbinned_xenon', ('unbinned_xenon', 128, 1)),
])
#: (s3) path: toys fitted by the dense engine and by the kernels
DENSE_PATHS = collections.OrderedDict([('unbinned_xenon', 256),
                                       ('unbinned', 1024)])
#: recorded calls of each dense op held to the plain closed forms
DENSE_HELD = 40
STUDY_KW = dict(max_iter=96, tol=3e-4)


def path_study(label, api, studies):
    """(study, cls) of path ``label``: the one its path built, or a new
    one (``python3 chip_smoke.py sharding`` alone)."""
    if label in studies:
        return studies[label]
    unbinned = PATHS[label][0].startswith('unbinned')
    cls = api['UnbinnedToyStudy' if unbinned else 'BinnedToyStudy']
    study = cls(build_model(label, api['xenon_like'], api['test_helpers'],
                            api['likelihood']), **STUDY_KW)
    check_on_card(label, study.compiled)
    studies[label] = (study, cls)
    return studies[label]


def same_bits(what, a, b):
    """Raise unless two (t, free, cond) profiles are bit-identical."""
    pairs = [(a[0], b[0])] + [(getattr(x, k), getattr(y, k))
                              for x, y in zip(a[1:], b[1:])
                              for k in ('x', 'max_ll', 'n_iter')]
    if not all(np.array_equal(x, y) for x, y in pairs):
        raise AssertionError("%s is not bit-identical to the profile with "
                             "no mesh" % what)


def one_rank_phase(mods, api, studies):
    """(s1) xenon's profile with a one-process mesh, then through NCCL at
    world size 1 (``profile_ts_distributed``, its results gathered as CUDA
    tensors), each between reset and read of every counter and
    bit-identical to the profile with no mesh. Returns (that profile, its
    warm seconds)."""
    from blueice_tpu_torch.parallel import (init_distributed, make_mesh,
                                            profile_ts_distributed)
    import torch.distributed as dist
    study, _ = path_study('xenon', api, studies)
    _, target, n_toys, _, _ = PATHS['xenon']
    study.profile_ts(0, n_toys, target, 1.0)          # warm (phase 2's seed)
    t0 = time.time()
    ref = study.profile_ts(0, n_toys, target, 1.0)
    torch.cuda.synchronize()
    secs = time.time() - t0
    out, launches = counted(mods, lambda: study.profile_ts(
        0, n_toys, target, 1.0, mesh=make_mesh()))
    check_own_launches('xenon', launches, '(s1) a one-process mesh')
    same_bits('(s1) xenon with make_mesh()', out, ref)
    rank, world = init_distributed(num_processes=1)
    try:
        mesh = make_mesh()
        backend = dist.get_backend(mesh.group)
        if (rank, world, backend) != (0, 1, 'nccl'):
            raise AssertionError("(s1): a group of %d on %s, rank %d"
                                 % (world, backend, rank))
        out, launches = counted(mods, lambda: profile_ts_distributed(
            study, 0, n_toys, target, 1.0, mesh=mesh))
        check_own_launches('xenon', launches, '(s1) NCCL at world size 1')
        same_bits('(s1) xenon through NCCL at world size 1', out, ref)
    finally:
        dist.destroy_process_group()
    log("(s1) xenon, %d toys: profile_ts with make_mesh() and "
        "profile_ts_distributed over NCCL at world size 1 (%s, rank %d of "
        "%d) bit-identical to no mesh; one rank warm %.3f s (%.1f profile "
        "fits/s)" % (n_toys, mesh.device, rank, world, secs, n_toys / secs))
    return ref, secs


def two_ranks_phase(mods, api, studies, one_rank):
    """(s2) each of ``SHARD_PATHS`` over two ranks on the one card (gloo:
    NCCL refuses two ranks on one device), spawned as fresh interpreters
    that import the port only (``blueice_tpu_torch.dryrun.run_ranks``;
    the kernels were built here before). Raises unless each rank launched
    its path's two kernels and no other, both ranks hold the same arrays
    bit for bit, the toys are the single-process draw's, the fits agree
    with one process's on the same toys (phase 3's gate) and the median t
    is in the path's band."""
    from blueice_tpu_torch import dryrun
    from blueice_tpu_torch.parallel import ToyResults
    runs = [dict(model=m, seed=0, n_toys=n, repeats=r)
            for m, n, r in SHARD_PATHS.values()]
    t0 = time.time()
    results = dryrun.run_ranks(2, dict(runs=runs, study=STUDY_KW), 'cuda',
                               timeout=600)
    log("(s2) two ranks on the card (%s): %.1f s, their runs %s"
        % (', '.join(r['device'] for r in results), time.time() - t0,
           json.dumps([[round(x, 3) for x in run['seconds']]
                       for r in results for run in r['runs']])))
    dryrun.same_on_every_rank(results)
    for i, label in enumerate(SHARD_PATHS):
        run = results[0]['runs'][i]
        _, target, _, _, band = PATHS[label]
        n_toys = run['n_toys']
        for r in results:
            check_own_launches(label, r['runs'][i]['launches'],
                               '(s2) rank %d' % r['rank'])
        study, _ = path_study(label, api, studies)
        toys = study.simulate(0, n_toys)
        if dryrun.ensemble_digest(toys) != run['digest']:
            raise AssertionError("(s2) %s: the ranks drew other toys than "
                                 "one process at the same seed" % label)
        ref = (one_rank[0] if label == 'xenon' else
               study._run_profile(toys, target, 1.0, None))
        t, free_ll, cond_ll = (np.asarray(run[k])
                               for k in ('t', 'free_ll', 'cond_ll'))
        d_ll = np.maximum(np.abs(free_ll - ref[1].max_ll),
                          np.abs(cond_ll - ref[2].max_ll))
        d_t = np.abs(t - ref[0])
        free = ToyResults(ref[1].names, np.asarray(run['free_x']), free_ll,
                          np.asarray(run['free_iter']))
        mean_target, med = check_statistics(label, t, free, band)
        log("(s2) %s, %d toys over two ranks: toys bit-identical to one "
            "process's draw; both ranks' arrays bit-identical; against one "
            "process on the same toys max |d max_ll| %.4g (<= 0.05), "
            "median |d t| %.4g (<= 0.01), largest |d t| %.4g, %d of %d "
            "toys bit-identical in t; median t %.4f (one process %.4f) in "
            "%s, mean %s %.4f" % (
                label, n_toys, d_ll.max(), np.median(d_t), d_t.max(),
                int((d_t == 0).sum()), n_toys, med, np.median(ref[0]),
                band, target, mean_target))
        if not (d_ll.max() <= 0.05 and np.median(d_t) <= 0.01):
            raise AssertionError("(s2) %s: two ranks disagree with one "
                                 "process" % label)
    warm = max(r['runs'][0]['seconds'][1] for r in results)
    n_toys = results[0]['runs'][0]['n_toys']
    log("(s2) xenon warm profile fits/s: one rank %.1f (%.3f s), two ranks "
        "on one card %.1f (%.3f s, the slower rank)"
        % (n_toys / one_rank[1], one_rank[1], n_toys / warm, warm))


class DenseCalls:
    """Recorder of the dense engine's calls: while installed, the fitter's
    dense ops (``parallel.fitter._dense_unbinned_ops``: the dense ops in
    the kernel wrappers' calling convention) keep every call made while
    ``active`` with its outputs, under the dense op's name; ``ops`` holds
    the ops themselves, unrecorded."""

    NAMES = ('unbinned_vgh_dense', 'unbinned_ll_dense_many')

    def __init__(self, fitter):
        self.fitter, self.active, self.ops = fitter, False, {}
        self.calls = {name: [] for name in self.NAMES}
        self.saved = make = fitter._dense_unbinned_ops

        def recording_ops():
            self.ops = dict(zip(self.NAMES, make()))
            return tuple(self._recording(name) for name in self.NAMES)
        fitter._dense_unbinned_ops = recording_ops

    def _recording(self, name):
        def call(*args):
            out = self.ops[name](*args)
            if self.active:
                self.calls[name].append((args, out))
            return out
        return call

    def restore(self):
        self.fitter._dense_unbinned_ops = self.saved


@contextlib.contextmanager
def tf32_products():
    """The dense ops' float32 products in TF32 (10-bit mantissas), the
    precision that ``device.resolve`` turns off."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


class _Bf16Bmm:
    """``torch``, except that ``bmm`` rounds its first operand (the dense
    ops' corner weights and their coefficients w m) to bfloat16."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def bmm(a, b):
        return torch.bmm(a.to(torch.bfloat16).to(a.dtype), b)


@contextlib.contextmanager
def bf16_coefficients():
    """The dense ops with their weights and coefficients in bfloat16."""
    from blueice_tpu_torch.ops import unbinned_dense
    unbinned_dense.torch = _Bf16Bmm()
    try:
        yield
    finally:
        unbinned_dense.torch = torch


#: (name, context) of the controls that ``held_dense_calls`` runs on the
#: same calls: a dense op of lower precision must fail its allowance
DENSE_CONTROLS = (('TF32 products', tf32_products),
                  ('bfloat16 coefficients', bf16_coefficients))


def held_dense_calls(label, recorder):
    """Hold recorded dense calls (up to ``DENSE_HELD`` an op, evenly over
    the run; ``DenseCalls``) to the float64 closed forms of the kernel
    contracts on the same arguments (``closed_forms``: the lanes' gathered
    corner rows), as ``held_calls_row`` holds the kernels on a path's own
    calls, with the plain versions in float32 (``unbinned_vgh_plain``,
    ``unbinned_ll_plain``: float32 sums over events, as the dense ops')
    for the float32 yardstick: the ll lane by lane within ``ll_allowance``
    (1e-5 of its terms, or float32's own rounding where that is larger: at
    the centering point, where the fits start, every term is below it), g
    and H within ``float32_allowance`` (phase 1's 1e-4, or twice the plain
    version's error on the same calls: near an optimum g is a sum of large
    terms that nearly cancel). The dense value forms one more float32
    product than the plain version, its coefficients w m, each rounded
    once (relative F32_UNIT) and shared by every event of the lane: its ll
    allowance adds F32_UNIT for each valid event (the relative rounding of
    that event's rate, a term of the log). Each op is run again on the
    same calls under ``DENSE_CONTROLS``; raises unless the op holds its
    allowances and every control fails them (the gate tells float32 from
    a lower precision)."""
    from blueice_tpu_torch.ops import fused_unbinned
    plains = {'vgh': fused_unbinned.unbinned_vgh_plain,
              'value': fused_unbinned.unbinned_ll_plain}
    for name, contract in (('unbinned_vgh_dense', 'vgh'),
                           ('unbinned_ll_dense_many', 'value')):
        spec = CALLS[contract][label]
        recorded, op = recorder.calls[name], recorder.ops[name]
        if not recorded:
            raise AssertionError("(s3) %s: no %s call recorded"
                                 % (label, name))
        pick = np.unique(np.linspace(0, len(recorded) - 1,
                                     DENSE_HELD).astype(int))
        used, f32_errs, lanes = [], [], 0
        controls = {c: [] for c, _ in DENSE_CONTROLS}
        for i in pick:
            args, out = recorded[i]
            mask, rows = args[6], args[2]
            f32 = double(plains[contract](*args))
            f64 = double(closed_forms(fused_unbinned, spec.wrapper, args)[1])
            allow = ll_allowance(spec, args, f32, f64)
            if contract == 'value':
                # the coefficients w m, rounded once each and shared by
                # every event of the lane: u of each valid event's rate
                allow = allow + F32_UNIT * mask[rows].sum(-1)[:, None]
            f32_errs.append(disagreement(f32, f64, term_scale(*args)))
            used.append(disagreement(double(out), f64, allow))
            for c, context in DENSE_CONTROLS:
                with context():
                    controls[c].append(disagreement(double(op(*args)), f64,
                                                    allow))
            lanes += rows.shape[0]
        gh_allow = float32_allowance([e[1] for e in f32_errs])
        used = np.max(used, axis=0) / [1.0, gh_allow]
        controls = {c: np.max(v, axis=0) / [1.0, gh_allow]
                    for c, v in controls.items()}
        log("(s3) %s %s: %d of %d recorded calls (%.1f lanes a call) "
            "against float64: the ll uses %.3g of its allowance (float32 "
            "lane by lane), g/H %.3g of %.3g (the float32 plain version: "
            "ll %.3g of its terms, g/H %.3g); controls on the same calls: "
            "%s" % (
                label, name, len(pick), len(recorded), lanes / len(pick),
                used[0], used[1], gh_allow, *np.max(f32_errs, axis=0),
                '; '.join('%s, the ll %.3g of its allowance, g/H %.3g'
                          % (c, *v) for c, v in controls.items())))
        if not (used <= 1).all():
            raise AssertionError("(s3) %s: %s disagrees with float64 on its "
                                 "calls beyond its allowance" % (label, name))
        for c, v in controls.items():
            if (v <= 1).all():
                raise AssertionError(
                    "(s3) %s: %s with %s holds the allowance: the gate "
                    "cannot tell float32 from that" % (label, name, c))


def dense_phase(label, mods, api, studies):
    """(s3) the dense engine (``parallel.fitter._FORCE_DENSE_UNBINNED``)
    on ``DENSE_PATHS[label]`` toys of the path against the path's kernels
    on the same event sets: no kernel launched in either dense run (the
    first recorded, the second timed), ``engines_gate`` with the path's
    band, its recorded calls held to the plain closed forms."""
    from blueice_tpu_torch.parallel import fitter
    study, cls = path_study(label, api, studies)
    _, target, _, _, band = PATHS[label]
    n_toys = DENSE_PATHS[label]
    toys = study.simulate(0, n_toys)
    recorder = DenseCalls(fitter)
    fitter._FORCE_DENSE_UNBINNED = True
    try:
        dense = cls(study.lf, n_max=study.n_max, **STUDY_KW)
        recorder.active = True
        _, launches = counted(mods, lambda: dense._run_profile(
            toys, target, 1.0, None))
        recorder.active = False
        no_launches('(s3) %s dense engine, first run' % label, launches)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out, launches = counted(mods, lambda: dense._run_profile(
            toys, target, 1.0, None))
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        no_launches('(s3) %s dense engine, warm run' % label, launches)
    finally:
        fitter._FORCE_DENSE_UNBINNED = False
        recorder.restore()
    kernel_profile(label, study, toys, target, mods, '(s3) kernels, first')
    ref, ref_secs = kernel_profile(label, study, toys, target, mods,
                                   '(s3) kernels, warm')
    log("(s3) %s, %d toys: dense engine warm %.3f s (%.2f profile fits/s; "
        "mean iterations free %.1f, conditional %.1f; peak device memory "
        "%.2f GB), kernels warm %.3f s (%.2f profile fits/s; %.1f, %.1f)"
        % (label, n_toys, secs, n_toys / secs, out[1].n_iter.mean(),
           out[2].n_iter.mean(), peak, ref_secs, n_toys / ref_secs,
           ref[1].n_iter.mean(), ref[2].n_iter.mean()))
    errors = (parabolic_errors(study, toys, ref[1]),
              parabolic_errors(study, toys, ref[2], target))
    engines_gate('(s3) %s dense engine vs kernels' % label, out, ref, errors,
                 band)
    held_dense_calls(label, recorder)


def sharding_part(mods, api, studies):
    """(s1) one rank, (s2) two ranks on the one card, (s3) the dense
    unbinned engine; each phase between reset and read of every launch
    counter. No kernel rows (no kernel of its own)."""
    t0 = time.time()
    one_rank = one_rank_phase(mods, api, studies)
    log("(s1) phase: %.1f s" % (time.time() - t0))
    t0 = time.time()
    two_ranks_phase(mods, api, studies, one_rank)
    log("(s2) phase: %.1f s" % (time.time() - t0))
    for label in DENSE_PATHS:
        t0 = time.time()
        dense_phase(label, mods, api, studies)
        log("(s3) %s phase: %.1f s" % (label, time.time() - t0))


# -- the host part --------------------------------------------------------

#: (h1) the paths whose prepared likelihoods are pickled
PICKLED = ('xenon', 'unbinned_xenon')
#: (h2) worker processes of the parallel template build
HOST_CORES = 4
#: (h3) toys of the radial model, fitted on the card and on the CPU
RADIAL_TOYS = 64
#: (h4) live times (days) the compiled values are held at: the xenon
#: model's base, half and twice it; for the SR0+SR1 Sum, whose one joint
#: live time scales each child from its own base, SR1's (which holds 246.7
#: of the 278.8 days): at 556 joint days SR0 runs at 17 times its base and
#: |ll| ~ 4e5, which float32 resolves only to ~0.07 (a float32 CPU run)
LIVETIMES = {'xenon': (278.0, 139.0, 556.0),
             'SR0+SR1': (246.7, 123.35, 493.4)}
#: (h4) allowed |compiled float32 - host float64| of a log likelihood
LIVETIME_GAP = 0.05
#: (h5) events of the native filler's sample
FILL_EVENTS = 2_000_000


def same_profile(what, a, b):
    """Raise unless two (t, free, cond) profiles have bit-identical t and
    max_ll."""
    if not (np.array_equal(a[0], b[0])
            and all(np.array_equal(x.max_ll, y.max_ll)
                    for x, y in zip(a[1:], b[1:]))):
        raise AssertionError("%s: t or max_ll differs from the original "
                             "likelihood's profile" % what)


def pickle_phase(mods, api, studies):
    """(h1) each of ``PICKLED``'s prepared likelihoods through
    ``pickle.dumps``/``loads`` and through ``save_pickle``/``read_pickle``;
    each restored likelihood's profile (a fresh study on the card, seed 0)
    bit-identical to the original's, its path's kernels launched and no
    other."""
    import pickle
    import tempfile
    from blueice_tpu_torch.utils.io import read_pickle, save_pickle
    for label in PICKLED:
        study, cls = path_study(label, api, studies)
        _, target, n_toys, _, _ = PATHS[label]
        ref = study.profile_ts(0, n_toys, target, 1.0)
        t0 = time.time()
        blob = pickle.dumps(study.lf)
        dump_s = time.time() - t0
        t0 = time.time()
        restored = pickle.loads(blob)
        load_s = time.time() - t0
        tmp = tempfile.mkdtemp(prefix='chip_smoke_pickle_')
        try:
            path = os.path.join(tmp, 'lf.pkl')
            t0 = time.time()
            save_pickle(study.lf, path)
            save_s = time.time() - t0
            t0 = time.time()
            read_back = read_pickle(path)
            read_s = time.time() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for how, lf in (('pickle.loads', restored),
                        ('read_pickle', read_back)):
            if '_torch_compiled_for_fit' in lf.__dict__:
                raise AssertionError("(h1) %s: a device cache was pickled"
                                     % label)
            out, launches = counted(mods, lambda: cls(
                lf, **STUDY_KW).profile_ts(0, n_toys, target, 1.0))
            check_own_launches(label, launches, '(h1) %s' % how)
            same_profile('(h1) %s after %s' % (label, how), out, ref)
        log("(h1) %s: pickle %.1f MB, dumps %.3f s, loads %.3f s, "
            "save_pickle %.3f s, read_pickle %.3f s; both restored "
            "likelihoods' profiles (%d toys, seed 0) bit-identical in t and "
            "max_ll" % (label, len(blob) / 1e6, dump_s, load_s, save_s,
                        read_s, n_toys))


def xenon_build(api, root, n_cores):
    """The xenon model (host blob templates) prepared into fresh cache and
    task directories under ``root``, the process-wide template cache
    emptied first: (likelihood, seconds of ``prepare``)."""
    from blueice_tpu_torch.models.source import Source
    Source._data_cache.clear()
    lf = api['xenon_like'].build_likelihood(
        'binned', prepare=False, cache_dir=os.path.join(root, 'cache'),
        task_dir=os.path.join(root, 'tasks'))
    t0 = time.time()
    lf.prepare(n_cores=n_cores)
    return lf, time.time() - t0


def parallel_build_phase(mods, api, tmp):
    """(h2) the xenon model built serially and with ``prepare(n_cores=
    HOST_CORES)``: every anchor's mus and pmf bit-identical, no task file
    left, and a 512-toy profile (seed 0) of each bit-identical, the xenon
    kernels launched and no other. Returns the serial build."""
    serial, serial_s = xenon_build(api, os.path.join(tmp, 'serial'), 1)
    pooled, pooled_s = xenon_build(api, os.path.join(tmp, 'pool'),
                                   HOST_CORES)
    for name in ('mus', 'ps'):
        if not np.array_equal(serial._builds[name][2],
                              pooled._builds[name][2]):
            raise AssertionError("(h2) the parallel build's %s anchors "
                                 "differ from the serial build's" % name)
    left = os.listdir(os.path.join(tmp, 'pool', 'tasks'))
    if left:
        raise AssertionError("(h2) %d task files left" % len(left))
    _, target, n_toys, _, _ = PATHS['xenon']
    cls = api['BinnedToyStudy']
    profiles = []
    for lf in (serial, pooled):
        out, launches = counted(mods, lambda: cls(lf, **STUDY_KW).profile_ts(
            0, n_toys, target, 1.0))
        check_own_launches('xenon', launches, '(h2) a profile')
        profiles.append(out)
    same_profile('(h2) the parallel build', profiles[1], profiles[0])
    log("(h2) xenon templates (%s anchors x %d sources): serial prepare "
        "%.2f s, prepare(n_cores=%d) %.2f s; mus and pmf anchors "
        "bit-identical, the profiles (%d toys, seed 0) bit-identical"
        % ('x'.join(str(n) for n in serial._builds['ps'][2].shape[:4]),
           serial._builds['ps'][2].shape[4], serial_s, HOST_CORES,
           pooled_s, n_toys))
    return serial


def radial_phase(mods, api):
    """(h3) the xenon model with the scattered-anchor RadialInterpolator
    (10 latin anchors after ``np.random.seed(0)``): ``RADIAL_TOYS`` toys
    fitted on the card by ``engine='auto'`` (the autodiff engine, no kernel
    launched) and in float64 on the CPU, held to phase 3's figures."""
    from blueice_tpu_torch.parallel import fitter
    lf = api['xenon_like'].build_likelihood('binned', prepare=False)
    lf.config['morpher'] = 'RadialInterpolator'
    np.random.seed(0)
    t0 = time.time()
    lf.prepare()
    build_s = time.time() - t0
    cls = api['BinnedToyStudy']
    study = cls(lf, **STUDY_KW)
    check_on_card('xenon radial', study.compiled)
    if fitter._engine_family(study.compiled) != 'ad':
        raise AssertionError("(h3) engine 'auto' does not pick 'ad'")
    target = PATHS['xenon'][1]
    toys = study.simulate(0, RADIAL_TOYS)
    study._run_profile(toys, target, 1.0, None)          # warm
    (t32, f32, c32), secs, peak = ad_profile(
        '(h3) xenon radial', study, toys, target, mods)
    cpu = cpu_referee_study(study, cls)
    t0 = time.time()
    t64, f64, c64 = cpu._run_profile(toys.cpu().double(), target, 1.0, None)
    cpu_s = time.time() - t0
    d_ll = np.maximum(np.abs(f32.max_ll - f64.max_ll),
                      np.abs(c32.max_ll - c64.max_ll))
    d_t = np.abs(t32 - t64)
    log("(h3) xenon radial (%d anchors, built in %.1f s): %d toys, "
        "engine 'ad' on the card warm %.3f s (%.2f profile fits/s, mean "
        "iterations free %.1f, conditional %.1f, peak device memory %.2f "
        "GB); float64 CPU %.1f s; max |d max_ll| %.4g, median |d t| %.4g, "
        "median t %.4f" % (
            len(lf.morpher._anchor_order), build_s, RADIAL_TOYS, secs,
            RADIAL_TOYS / secs, f32.n_iter.mean(), c32.n_iter.mean(), peak,
            cpu_s, d_ll.max(), np.median(d_t), np.median(t32)))
    if not (d_ll.max() <= 0.05 and np.median(d_t) <= 0.01):
        raise AssertionError("(h3) float32 radial fits disagree with "
                             "float64")


def livetime_phase(mods, api, lf):
    """(h4) ``include_livetime``: the compiled xenon logl (float32, the
    card) and the combined SR0+SR1 Sum's, with its one joint live time,
    at ``LIVETIMES`` against the host float64 value, within
    ``LIVETIME_GAP``; no kernel launched. The likelihoods' data are drawn
    from seeded generators."""
    import warnings
    from blueice_tpu_torch import composition
    from blueice_tpu_torch.compile import build_logl
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(0)))
    joint = combined_likelihood(api['xenon_like'], api['likelihood'],
                                composition)
    for i, child in enumerate(joint.likelihood_list[:2]):
        child.set_data(child.base_model.simulate(
            rng=np.random.default_rng(10 + i)))
    with warnings.catch_warnings():
        # the children's base live times differ: the joint default is the
        # first child's
        warnings.simplefilter('ignore', UserWarning)
        compiled = {'xenon': (build_logl(lf, include_livetime=True), lf),
                    'SR0+SR1': (build_logl(joint, include_livetime=True),
                                joint)}
    rows = []

    def evaluate():
        for name, (c, host) in compiled.items():
            check_on_card('(h4) %s' % name, c.children[0] if hasattr(
                c, 'children') else c)
            for days in LIVETIMES[name]:
                rows.append((name, days, float(c(livetime_days=days)),
                             float(host(livetime_days=days))))
    _, launches = counted(mods, evaluate)
    if any(launches.values()):
        raise AssertionError("(h4) a kernel launched: %s" % launches)
    for name, days, value, ref in rows:
        log("(h4) %s at livetime_days %.1f: compiled float32 %.4f, host "
            "float64 %.4f, |d| %.3g" % (name, days, value, ref,
                                        abs(value - ref)))
        if not abs(value - ref) <= LIVETIME_GAP:
            raise AssertionError("(h4) %s at %.1f days: |d| %.3g > %g"
                                 % (name, days, abs(value - ref),
                                    LIVETIME_GAP))


def native_phase(mods, api):
    """(h5) the native filler: available; a 2-D sample of ``FILL_EVENTS``
    over the XENON (cs1, log10_cs2) 50x62 edges, with NaN, inf and
    exact-edge values, against ``np.histogramdd`` (counts exact, weighted
    sums rtol 1e-12), both timed on this host's CPU; then the Gaussian
    unbinned path's Monte-Carlo templates built through it equal to a
    numpy fill of the same draws, bit for bit."""
    from blueice_tpu_torch import native
    from blueice_tpu_torch.models.source import Source
    if not native.available():
        raise AssertionError("(h5) the native filler is not available")
    edges = [np.asarray(e, dtype=float) for _, e in
             api['xenon_like'].build_config()['analysis_space']]
    rng = np.random.default_rng(0)
    sample = np.stack([rng.normal(50.0, 30.0, FILL_EVENTS),
                       rng.normal(2.5, 0.8, FILL_EVENTS)], axis=-1)
    for d, e in enumerate(edges):
        sample[:5000, d] = e[rng.integers(0, len(e), 5000)]
    sample[5000] = np.nan
    sample[5001] = np.inf
    sample[5002] = -np.inf
    weights = rng.random(FILL_EVENTS)

    def timed(fn):
        t0 = time.time()
        out = fn()
        return out, time.time() - t0
    (got, native_s), (ref, numpy_s) = (
        timed(lambda: native.histogram_nd(sample, edges)),
        timed(lambda: np.histogramdd(sample, bins=edges)[0]))
    (got_w, native_w_s), (ref_w, numpy_w_s) = (
        timed(lambda: native.histogram_nd(sample, edges, weights=weights)),
        timed(lambda: np.histogramdd(sample, bins=edges,
                                     weights=weights)[0]))
    if not np.array_equal(got, ref):
        raise AssertionError("(h5) native counts differ from numpy's")
    rel = float(np.max(np.abs(got_w - ref_w) / np.maximum(np.abs(ref_w),
                                                          1e-300)))
    if not rel <= 1e-12:
        raise AssertionError("(h5) weighted sums differ by %.3g" % rel)
    log("(h5) native filler, %d events over %dx%d bins (NaN, inf, edges): "
        "counts exact, weighted rtol %.3g; native %.4f s (weighted %.4f), "
        "np.histogramdd %.4f s (weighted %.4f) on the host CPU"
        % (FILL_EVENTS, len(edges[0]) - 1, len(edges[1]) - 1, rel,
           native_s, native_w_s, numpy_s, numpy_w_s))

    def templates():
        Source._data_cache.clear()
        lf = build_model('unbinned', api['xenon_like'], api['test_helpers'],
                         api['likelihood'])
        return [(s._pdf_histogram.values, s._n_events_histogram.values)
                for m in lf.anchor_models.values() for s in m.sources]
    t0 = time.time()
    filled, launches = counted(mods, templates)
    native_build_s = time.time() - t0
    saved = native._LIB, native._TRIED
    native._LIB, native._TRIED = None, True     # the numpy fallback
    try:
        t0 = time.time()
        numpy_filled = templates()
        numpy_build_s = time.time() - t0
    finally:
        native._LIB, native._TRIED = saved
    if any(launches.values()):
        raise AssertionError("(h5) a kernel launched: %s" % launches)
    if not all(np.array_equal(a, b) for x, y in zip(filled, numpy_filled)
               for a, b in zip(x, y)):
        raise AssertionError("(h5) a native-filled template differs from "
                             "the numpy fill")
    log("(h5) the Gaussian unbinned model's %d Monte-Carlo templates: "
        "native fill bit-identical to numpy's; built in %.2f s (native) and "
        "%.2f s (numpy)" % (len(filled), native_build_s, numpy_build_s))


def profiler_phase(mods, api, studies, tmp):
    """(h6) one warm xenon profile inside ``profile_to`` and
    ``trace('xenon profile')``: the written trace names the binned vgh and
    value kernels and the span; the profile's wall time with and without
    the profiler."""
    from blueice_tpu_torch.utils import profile_to, trace
    study, _ = path_study('xenon', api, studies)
    _, target, n_toys, _, _ = PATHS['xenon']
    study.profile_ts(0, n_toys, target, 1.0)             # warm
    t0 = time.time()
    study.profile_ts(0, n_toys, target, 1.0)
    torch.cuda.synchronize()
    plain_s = time.time() - t0

    def profiled():
        t0 = time.time()
        with profile_to(os.path.join(tmp, 'profile')) as prof:
            with trace('xenon profile'):
                study.profile_ts(0, n_toys, target, 1.0)
                torch.cuda.synchronize()
            inside = time.time() - t0
        return prof, inside, time.time() - t0
    (prof, inside_s, total_s), launches = counted(mods, profiled)
    check_own_launches('xenon', launches, '(h6) the profiled run')
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    names = [e.get('name', '') for e in events]
    found = {key: sum(key in n for n in names)
             for key in ('vgh_kernel', 'll_kernel', 'xenon profile')}
    log("(h6) xenon profile (%d toys) inside profile_to and trace: %d trace "
        "events, %s; wall %.3f s without the profiler, %.3f s inside it "
        "(%.3f s with the trace written)"
        % (n_toys, len(events), found, plain_s, inside_s, total_s))
    if not all(found.values()):
        raise AssertionError("(h6) the trace lacks %s"
                             % [k for k, v in found.items() if not v])


def host_part(mods, api, studies):
    """(h1)-(h6): pickled likelihoods, the parallel template build, the
    radial morpher, the live time, the native filler and the profiler
    hooks, each phase between reset and read of every launch counter. No
    kernel rows (no kernel of its own)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix='chip_smoke_host_')

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        log("%s phase: %.1f s" % (name, time.time() - t0))
        return out
    try:
        timed('(h1)', pickle_phase, mods, api, studies)
        serial = timed('(h2)', parallel_build_phase, mods, api, tmp)
        timed('(h3)', radial_phase, mods, api)
        timed('(h4)', livetime_phase, mods, api, serial)
        timed('(h5)', native_phase, mods, api)
        timed('(h6)', profiler_phase, mods, api, studies, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def roofline_part(mods):
    """Parts 4 and 5: the op-mix kernel against its plain version, the
    op-mix ceilings between reset and read of every counter, and the vgh
    kernels' roofline verdicts. Returns the op-mix kernel rows (row 17)."""
    roofline = mods['roofline']
    rows = []
    for kind, mix in roofline.MIXES.items():
        x, aux = roofline.op_mix_inputs(kind, roofline.op_mix_elements(kind),
                                        check=True)
        out = roofline.op_mix(kind, x, aux, 1, mix.check_eps)
        ref = roofline.op_mix_plain(kind, x, aux, 1, mix.unroll,
                                    mix.check_eps)
        torch.cuda.synchronize()
        scale = roofline.op_mix_scale(kind, x, aux, 1, mix.unroll,
                                      mix.check_eps)
        rel = float(((out.double() - ref.double()).abs() / scale).max())
        if not (rel <= 1e-5 and bool(torch.isfinite(out).all())):
            raise AssertionError("op mix %s disagrees with its plain version: "
                                 "%.3g of its terms' scale" % (kind, rel))
        log("roofline op-mix kernel %s, %d elements, one trip (%d steps) at "
            "eps %g: err %.3g of its terms' scale" % (
                kind, x.numel(), mix.unroll, mix.check_eps, rel))
        rows.append(dict(name='op_mix:%s' % kind, path='roofline',
                         route='cuda', source=CSRC + 'op_mix.cu',
                         replaces='blueice_tpu/utils/roofline.py:338',
                         library_ms=None,
                         max_abs_err=float((out - ref).abs().max()),
                         max_rel_err=rel))

    for module in mods.values():
        module.reset_launch_counts()
    record = roofline.op_mix_record()
    launches = {}
    for module in mods.values():
        launches.update(module.launch_counts())
    log("roofline kernel launches in the op-mix part: %s" % launches)
    if launches.pop('op_mix') != sum(
            d['launches'] for d in record['detail'].values()) or not all(
            d['launches'] > 0 for d in record['detail'].values()):
        raise AssertionError("roofline: the op-mix launch counter did not "
                             "count the op-mix part's launches")
    if any(launches.values()):
        raise AssertionError("roofline: a fit kernel launched in the op-mix "
                             "part")

    for row, (kind, mix) in zip(rows, roofline.MIXES.items()):
        d = record['detail'][kind]
        x, aux = roofline.op_mix_inputs(kind, d['elements'])
        plain_ms = cuda_ms(lambda: roofline.op_mix_plain(
            kind, x, aux, d['reps'], mix.unroll, d['eps']), runs=1, warmup=0)
        flops = float(mix.charge * mix.unroll * d['elements'] * d['reps'])
        nbytes = 4 * d['elements'] * (2 + mix.n_aux)
        bound_ms, bound_by = roofline.bound(nbytes, flops)
        row.update(launches=d['launches'], ms=1e3 * d['t_single_s'],
                   ms_double=1e3 * d['t_double_s'], plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   gflops=d['gflops_achieved'],
                   frac_of_fp32=d['frac_of_nominal_fp32'], reps=d['reps'],
                   elements=d['elements'], threads=d['threads'])
        log("roofline op mix %-7s %d elements (%d blocks of 256 threads, %d "
            "each), %d trips x %d steps: t(r) %.4f ms, t(2r) %.4f ms, %.1f "
            "GFLOP/s charged, %.4f of the fp32 peak; bound %.4f ms (%s: "
            "%.3f GFLOP, %.1f MB); plain %.1f ms; %d launches"
            % (kind, d['elements'], d['grid'], d['V'], d['reps'], mix.unroll,
               row['ms'], row['ms_double'], d['gflops_achieved'],
               d['frac_of_nominal_fp32'], bound_ms, bound_by, flops / 1e9,
               nbytes / 1e6, plain_ms, d['launches']))
    log("roofline op-mix record: %s" % json.dumps(
        {k: v for k, v in record.items() if k != 'detail'}))

    verdicts = roofline.roofline_record()['kernels']
    for line in roofline.format_report(verdicts).splitlines():
        log("roofline " + line)
    for v in verdicts:
        log("roofline %s: kernel alone %.4f ms (L2-cold %.4f, %d input "
            "copies), wrapper %.4f ms, bound %.4f ms (%s), %.4f (cold %.4f) "
            "of the fp32 peak, %.4f (cold %.4f) of HBM" % (
                v['kernel'], 1e3 * v['elapsed_s'], 1e3 * v['elapsed_cold_s'],
                v['copies'], 1e3 * v['dispatch_s'],
                1e3 * max(v['t_compute_s'], v['t_hbm_s']), v['binding'],
                v['frac_of_compute_roof'], v['frac_of_compute_roof_cold'],
                v['frac_of_hbm_roof'], v['frac_of_hbm_roof_cold']))
        if v['frac_of_hbm_roof_cold'] > 1.0:
            raise AssertionError("roofline %s: an L2-cold HBM share above "
                                 "100%%: its inputs stayed in L2"
                                 % v['kernel'])
    return rows


def main(labels):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    unknown = [label for label in labels
               if label not in PATHS and label not in PARTS]
    if unknown:
        print("chip_smoke: unknown path %s (paths: %s; parts: %s)"
              % (', '.join(unknown), ', '.join(PATHS), ', '.join(PARTS)),
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from blueice_tpu_torch import likelihood, test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import (fused, fused_bb, fused_bb_lite,
                                       fused_unbinned, param_graph)
    from blueice_tpu_torch.parallel import BinnedToyStudy, UnbinnedToyStudy
    from blueice_tpu_torch.utils import roofline, set_progress

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_progress(False)
    log(roofline.card_line())
    log("torch %s, CUDA %s, device %s" % (torch.__version__,
                                          torch.version.cuda,
                                          torch.cuda.get_device_name(0)))
    mods = dict(fused=fused, fused_bb=fused_bb, fused_bb_lite=fused_bb_lite,
                fused_unbinned=fused_unbinned, param_graph=param_graph,
                roofline=roofline)
    api = dict(xenon_like=xenon_like, test_helpers=test_helpers,
               likelihood=likelihood, BinnedToyStudy=BinnedToyStudy,
               UnbinnedToyStudy=UnbinnedToyStudy)
    t0 = time.time()
    libs = fused.build_libraries([m.SOURCE for m in mods.values()])
    for module in mods.values():
        module.load_library()
    log("kernel build + load (%d sources in parallel): %.1f s"
        % (len(libs), time.time() - t0))
    for line in ptxas_report(libs):
        log("ptxas " + line)
    for line in sass_census(libs):
        log("sass " + line)

    rows, studies = [], {}
    for label in [lb for lb in labels if lb in PATHS] if labels else PATHS:
        t0 = time.time()
        path_rows, study, cls = run_path(label, mods, api)
        rows += path_rows
        studies[label] = (study, cls)
        log("path %s: %.1f s" % (label, time.time() - t0))
    if not labels:
        t0 = time.time()
        rows += statistics_part(studies, mods, rows)
        log("statistics part: %.1f s" % (time.time() - t0))
    if not labels or 'autodiff' in labels:
        t0 = time.time()
        autodiff_part(mods, api, studies)
        log("autodiff part: %.1f s" % (time.time() - t0))
    if not labels or 'inference' in labels:
        t0 = time.time()
        rows += inference_part(mods, api)
        log("inference part: %.1f s" % (time.time() - t0))
    if not labels or 'sharding' in labels:
        t0 = time.time()
        sharding_part(mods, api, studies)
        log("sharding part: %.1f s" % (time.time() - t0))
    if not labels or 'host' in labels:
        t0 = time.time()
        host_part(mods, api, studies)
        log("host part: %.1f s" % (time.time() - t0))
    if not labels:
        t0 = time.time()
        rows += roofline_part(mods)
        log("roofline part: %.1f s" % (time.time() - t0))

    log(roofline.card_line())
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
