#!/usr/bin/env python3
"""A/B of the value or vgh kernels against other checkouts', on a profile's
own calls, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 measure_value_replay.py [--contract value|vgh] [--seed N] \\
        [--by lanes|cells] BASELINE[,...] [path ...]

BASELINE is the root of another checkout of the repo (for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists) whose kernels' C entries take the arguments this
checkout's take: for the value contract (the default) ``bt_binned_ll_multi``,
``bt_bb_ll_multi``, ``bt_bblite_ll_multi``, ``bt_unbinned_ll_multi``; for the
vgh contract ``bt_binned_vgh``, ``bt_bb_vgh``, ``bt_bblite_vgh``,
``bt_unbinned_vgh``. Several baselines, separated by commas, are measured
on the same calls. For each path (``xenon``, ``bb``, ``bblite``,
``unbinned_xenon``, ``unbinned``, or the ones named), float32 on the
card:

1. every call of the path's wrapper of the contract in one ``profile_ts``
   (seed ``--seed``, default 0; the path's toys) is recorded with this
   checkout's kernels (``chip_smoke.record_calls``); with ``--by cells``
   (value contract) the distribution of the grid cells a lane's
   candidates fall in, over every lane of every call, is printed;
2. the same calls are replayed from CUDA graphs (``chip_smoke.time_calls``,
   by candidate count and bin of lanes, ``LANE_BINS``, or with ``--by
   cells`` by the bin of the call's mean cells a lane, ``CELL_BINS``) with each library
   in turns, the baselines, this checkout's twice, the
   baselines in reverse (one baseline: baseline, current, current,
   baseline); each bin's calls and summed bound (``chip_smoke.call_work``)
   are printed first, then each replay's summed time, then each library's
   median and the ratio baseline / current;
3. in the same turns, each library's kernel alone at phase 1's inputs of
   ``chip_smoke.py`` (binned: 512 toys; unbinned: the path's scored event
   sets; the value kernel at A = 12 and 20), 20 launches replayed from a
   CUDA graph, warm and L2-cold (``roofline.cold_launches``);
4. the outputs on every recorded call are checked, and the run fails
   (after every baseline's line is printed) unless they hold: a
   value baseline's agree with this checkout's to relative 1e-5 (0:
   bit-identical; an unbinned ll relative to the magnitudes of its terms,
   ``chip_smoke.term_scale``; equal values agree, infinities and NaNs
   too, and the non-finite outputs of both are counted); the vgh kernels are
   held to a float64 reference on the same calls (``chip_smoke.closed_forms``:
   binned, the plain version; unbinned, ``chip_smoke.unbinned_vgh_double``,
   the closed form on the call's gathered corner rows), g and H relative
   to each toy's largest entry, the ll in absolute terms, this checkout's
   within the smaller of two bounds (``held_bounds``), so that a change of
   the gate can only tighten it: the old bound, twice the baseline's own
   worst error (at least 1e-5 and 1e-4; the ll relative to |ll|,
   unbinned to ``term_scale``), and the new bound, derived from float32
   itself on the same calls: g and H twice the float32 closed form's
   worst error (unbinned: float32 an event and float64 sums over events,
   as the kernel sums g; at least 1e-4, ``chip_smoke.float32_allowance``),
   the ll lane by lane (``chip_smoke.ll_allowance``: 1e-5 of its scale,
   or float32's rounding of the lane's terms plus twice the float32
   closed form's error on that lane, the larger). A baseline with a large
   error no longer widens the bound. Both bounds are printed side by
   side, the ll's as the new/old ratio over every lane. The errors are
   printed, and for the vgh the largest difference between the two
   libraries' outputs (0: bit-identical).

Before the turns it prints, per kernel source and baseline, which kernels
compile to the same SASS in both builds, instantiation by instantiation.

Without CUDA it exits with code 2. It prints the card's name and power
limit first and last.
"""

import argparse
import os
import sys

import numpy as np
import torch

from chip_smoke import (CALLS, PATHS, TOLERANCE, binned_data, build_model,
                        call_candidates, call_work, closed_forms,
                        disagreement, double, float32_allowance, ll_allowance,
                        log, random_point, record_calls, sass_functions,
                        term_scale, time_calls, unbinned_data)

#: The paths of each contract's A/B
AB_PATHS = {contract: tuple(label for label in PATHS if label in specs)
            for contract, specs in CALLS.items()}


def baseline_source(module, root):
    """The path of ``module``'s CUDA source in the checkout at ``root``."""
    from blueice_tpu_torch.ops import fused
    repo = os.path.dirname(os.path.dirname(fused.CSRC_DIR))
    source = os.path.join(root, os.path.relpath(module.SOURCE, repo))
    if not os.path.exists(source):
        raise FileNotFoundError("baseline source %s not found" % source)
    return source


def load_baseline(module, root):
    """The baseline checkout's build of ``module``'s source, loaded with
    ``module``'s C signatures (its ``load_library`` with the build pointed
    at the baseline's source)."""
    from blueice_tpu_torch.ops import fused
    source = baseline_source(module, root)
    build = fused.build_library
    fused.build_library = lambda *_: build(source)
    try:
        return module.load_library.__wrapped__()
    finally:
        fused.build_library = build


def phase1_args(label, study, mods, contract):
    """{name: arguments} of the path's wrapper of ``contract`` at phase 1's
    inputs (``chip_smoke.kernel_rows``: the same seed and draws): the vgh
    call, or the value calls at A = 12 and 20."""
    compiled = study.compiled
    rng = np.random.default_rng(0)
    grid = [len(a) for a in compiled.anchor_arrays]
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(len(grid)))
    if not compiled.is_binned:
        ps, mask, inv_ref, ref_msum, lanes = unbinned_data(label, study)
        lead = lanes.shape
    else:
        anchor, obs, _, mc, extra = binned_data(label, compiled, mods, rng)
        lead = obs.shape[:1]
    points = {'': random_point(compiled, rng, lead)}
    if contract == 'value':
        points = {'A=%d' % A: random_point(compiled, rng, lead + (A,))
                  for A in (12, 20)}
    out = {}
    for name, (idx, t, m) in points.items():
        if not compiled.is_binned:
            moff = (m.sum(-1) - ref_msum[lanes].reshape(
                lead + (1,) * (m.dim() - 2))).contiguous()
            out[name] = (ps, strides, lanes, idx, t, m, mask, inv_ref, moff,
                         compiled.outlier_likelihood)
        else:
            head = (anchor,) if mc is None else (anchor, mc)
            out[name] = head + (strides, idx, t, m, obs) + tuple(extra)
    return out


#: The lane counts by which a replay's time is broken down
LANE_BINS = (1, 8, 32, 128, 256)


def lanes_and_A(args, spec):
    """(A, lane bin) of a recorded call: its candidates and its lanes' bin
    of ``LANE_BINS`` ('1-7', ..., '256+')."""
    L = args[spec.idx].shape[0]
    i = max(j for j, lo in enumerate(LANE_BINS) if L >= lo)
    hi = LANE_BINS[i + 1] - 1 if i + 1 < len(LANE_BINS) else None
    return (call_candidates(args, spec),
            '%d-%d' % (LANE_BINS[i], hi) if hi else '%d+' % LANE_BINS[i])


#: The mean cells a lane by which a value replay's time is broken down
CELL_BINS = (1, 2, 3, 5, 9)


def lane_cells(args, spec):
    """(L,) distinct grid cells (corner-id tuples, as the value kernels
    group candidates) among each lane's candidates in a recorded value
    call."""
    from blueice_tpu_torch.ops import fused
    from chip_smoke import distinct_per_row
    idx = args[spec.idx]
    L, A = idx.shape[:2]
    G = args[0].shape[1 if spec.module == 'fused_unbinned' else 0]
    ids = fused.corner_ids(args[spec.strides], idx, G).reshape(L * A, -1)
    cell = ids.unique(dim=0, return_inverse=True)[1].reshape(L, A)
    return distinct_per_row(cell)


def cell_bin(cells):
    """The bin of ``CELL_BINS`` ('1', '2', '3-4', '5-8', '9+') of a count
    of cells."""
    i = max(j for j, lo in enumerate(CELL_BINS) if cells >= lo)
    if i + 1 == len(CELL_BINS):
        return '%d+' % CELL_BINS[i]
    hi = CELL_BINS[i + 1] - 1
    return '%d' % hi if hi == CELL_BINS[i] else '%d-%d' % (CELL_BINS[i], hi)


def cells_and_A(args, spec):
    """(A, cell bin) of a recorded value call: its candidates and the bin
    of ``CELL_BINS`` of its mean cells a lane (rounded to the nearest)."""
    mean = float(lane_cells(args, spec).double().mean())
    return call_candidates(args, spec), cell_bin(int(mean + 0.5))


def bins_and_bounds(calls, spec, contract, compiled, bin_of):
    """'A, bin: n calls, bound x ms' of each bin (``bin_of``) of a
    contract's recorded calls, the bound summed (``chip_smoke.call_work``)."""
    from blueice_tpu_torch.utils.roofline import bound
    K, S = len(compiled.shape_names), len(compiled.rate_names)
    G = compiled.mus_tensor.numel() // S
    bins = {}
    for args in calls:
        n, ms = bins.get(bin_of(args, spec), (0, 0.0))
        bins[bin_of(args, spec)] = (n + 1, ms + bound(*call_work(
            contract, args, spec, S, K, G)[:2])[0])
    return ', '.join('A=%d, %s: %d calls, bound %.4f ms' % (A, b, n, ms)
                     for (A, b), (n, ms) in sorted(bins.items()))


def held_bounds(baseline_worst, old_scales, new_ll, f32_gh):
    """What this checkout's vgh outputs are held to against the float64
    reference: (ll allowance of each call, absolute, lane by lane; g and H
    bound, relative to each toy's largest entry; old (ll, g/H) bound), the
    smaller of two bounds on every lane. Old: twice the baseline's worst
    error (at least ``TOLERANCE``), the ll relative to ``old_scales`` (|ll|
    or ``term_scale``), which grows with that baseline's own error. New,
    from float32 itself on the same calls: ``new_ll`` (each call's
    ``chip_smoke.ll_allowance``) and ``chip_smoke.float32_allowance`` of
    the float32 closed form's g and H errors ``f32_gh``. A baseline with a
    large error does not widen the bound; one with a small error keeps
    it as tight as it was."""
    old = np.maximum(TOLERANCE, 2 * np.asarray(baseline_worst))
    ll = [torch.minimum(old[0] * s, n) for s, n in zip(old_scales, new_ll)]
    return ll, min(old[1], float32_allowance(f32_gh)), old


def ll_ratios(old, old_scales, new_ll):
    """The new/old ratio of the ll allowances, in absolute terms, over
    every finite lane of every call (above 1 where the new bound alone
    would be looser)."""
    ratio = torch.cat([(n / (old * s)).flatten()
                       for s, n in zip(old_scales, new_ll)])
    return ratio[torch.isfinite(ratio)]


def ab(label, study, mods, baselines, contract, seed=0, by='lanes'):
    """Steps 1-4 for one path; ``baselines``: {name: {module name:
    library}}; the calls of ``profile_ts(seed)``, broken down ``by`` 'lanes'
    or 'cells'. Returns the failures of step 4 (texts; none: [])."""
    from blueice_tpu_torch.utils.roofline import (N_INNER, cold_launches,
                                                  launch_elapsed_s)
    spec = CALLS[contract][label]
    module = mods[spec.module]
    launcher = getattr(module, spec.launcher)
    calls = record_calls(label, study, mods, contract, seed=seed)
    phase1 = phase1_args(label, study, mods, contract)
    torch.cuda.synchronize()
    bin_of = lanes_and_A
    if by == 'cells':
        bin_of = cells_and_A
        cells = torch.cat([lane_cells(args, spec) for args in calls]).tolist()
        log("%s value calls of seed %d, cells a lane over %d lanes of %d "
            "calls: %s" % (label, seed, len(cells), len(calls), ', '.join(
                '%s: %d' % (b, sum(cell_bin(c) == b for c in cells))
                for b in dict.fromkeys(cell_bin(c) for c in range(1, 10)))))
    log("%s %s calls by bin: %s" % (label, contract, bins_and_bounds(
        calls, spec, contract, study.compiled, bin_of)))
    libs = dict(current=module.load_library())
    libs.update((b, lib[spec.module]) for b, lib in baselines.items())
    order = list(baselines) + ['current', 'current'] + list(baselines)[::-1]
    totals = {kind: [] for kind in libs}
    # phase 1 alone: {kind: {input name (warm or cold): [ms, ...]}}
    alone = {kind: {} for kind in libs}
    outs = {}
    load = module.load_library
    try:
        for kind in order:
            module.load_library = lambda kind=kind: libs[kind]
            per_A = time_calls(launcher, calls, spec, key=bin_of)
            totals[kind].append(sum(per_A.values()))
            for name, args in phase1.items():
                cold = cold_launches(launcher, args)
                for key, ms in ((name, 1e3 * launch_elapsed_s(
                        launcher(*args)[0])), ((name + ' cold').strip(),
                        1e3 * launch_elapsed_s(cold, max(N_INNER,
                                                         len(cold))))):
                    alone[kind].setdefault(key, []).append(ms)
                del cold
            log("%s %s replay, %s kernel: %d calls, %.4f ms (%s); phase 1 "
                "alone %s" % (
                    label, contract, kind, len(calls), totals[kind][-1],
                    ', '.join('A=%d, %s %s: %.4f ms' % (A, by[0].upper(), b,
                                                         ms)
                              for (A, b), ms in per_A.items()),
                    ', '.join('%s %.4f ms' % (key or 'warm', ms[-1])
                              for key, ms in alone[kind].items())))
            if kind not in outs:
                outs[kind] = []
                for args in calls:
                    launch, out = launcher(*args)
                    launch()
                    outs[kind].append(out)
    finally:
        module.load_library = load
    torch.cuda.synchronize()
    # What the outputs are held to: value, this checkout's outputs; vgh, a
    # float64 reference on the same calls (``chip_smoke.closed_forms``:
    # binned, the plain version; unbinned, the closed form on the gathered
    # corner rows, as the plain version on float64 arguments would copy the
    # whole event tensor, 1 GB on unbinned_xenon, every call), within the
    # smaller of the old bound and one derived from float32 itself on the
    # same calls (``held_bounds``)
    scales = [None] * len(calls)
    if spec.module == 'fused_unbinned':
        scales = [term_scale(*args) for args in calls]
    if contract == 'vgh':
        refs, new_ll, f32_errs = [], [], []
        for args, s in zip(calls, scales):
            f32, f64 = (double(x) for x in closed_forms(
                module, spec.wrapper, args))
            refs.append(f64)
            new_ll.append(ll_allowance(spec, args, f32, f64))
            f32_errs.append(disagreement(f32, f64, s))
        f32_errs = np.array(f32_errs)
        old_scales = [r[0].abs() if s is None else s
                      for r, s in zip(refs, scales)]
    else:
        refs = outs['current']
    errs = {kind: np.array([disagreement(double(o), double(r), s)
                            for o, r, s in zip(outs[kind], refs, scales)])
            for kind in libs}
    worst = {kind: e.max(axis=0) for kind, e in errs.items()}
    cur = float(np.median(totals['current']))
    failures = []
    for kind in baselines:
        if contract == 'vgh':
            held_ll, held_gh, old = held_bounds(worst[kind], old_scales,
                                                new_ll, f32_errs[:, 1])
            # the share of the held bound this checkout uses, call by call
            bad = np.array([disagreement(double(o), r, a) for o, r, a in
                            zip(outs['current'], refs, held_ll)])
            bad[:, 1] /= held_gh
            ok = (bad <= 1).all()
            ratio = ll_ratios(old[0], old_scales, new_ll)
            new_gh = float32_allowance(f32_errs[:, 1])
            log("%s vgh gate, seed %d, %s: old bound (twice %s's worst "
                "error, at least 1e-5, 1e-4): ll %.3g of %s, g/H %.3g; new "
                "bound (from float32: the float32 closed form's worst "
                "error ll %.3g of %s, g/H %.3g): g/H %.3g, ll lane by lane "
                "(1e-5 of the scale, or float32's rounding plus twice the "
                "float32 closed form's error), new/old over %d lanes: "
                "median %.3g, max %.3g, %d lanes looser; held to the "
                "smaller: g/H %.3g (new/old %.3g), this checkout uses ll "
                "%.3g, g/H %.3g of it" % (
                    label, seed, kind, kind, old[0],
                    '|ll|' if scales[0] is None else 'term_scale', old[1],
                    f32_errs[:, 0].max(),
                    '|ll|' if scales[0] is None else 'term_scale',
                    f32_errs[:, 1].max(), new_gh, ratio.numel(),
                    float(ratio.median()), float(ratio.max()),
                    int((ratio > 1).sum()), held_gh, new_gh / old[1],
                    *bad.max(axis=0)))
            apart = max(float((x - y).abs().max()) for a, b in zip(
                outs[kind], outs['current']) for x, y in zip(a, b))
            held = "the float64 reference within the held bound (this " \
                "checkout uses ll %.3g, g/H %.3g of it; errors of %s ll " \
                "%.3g, g/H %.3g, of this checkout %.3g, %.3g); largest " \
                "difference between the two %.3g" % (
                    *bad.max(axis=0), kind, *worst[kind],
                    *worst['current'], apart)
        else:
            ok = (worst[kind] <= (1e-5, 0.0)).all()
            bad = errs[kind]
            held = "each other (%.3g; non-finite outputs %d, %d)" % (
                worst[kind][0], nonfinite(outs[kind]),
                nonfinite(outs['current']))
        if not ok:
            i = int(bad.max(axis=1).argmax())
            failures.append(
                "%s: the %s kernels of %s and this checkout are not held to "
                "%s, worst on call %d of %d (%d lanes; lerp weights t in "
                "[%g, %g])" % (
                    label, contract, kind, held, i, len(calls),
                    calls[i][spec.idx].shape[0],
                    float(calls[i][spec.idx + 1].min()),
                    float(calls[i][spec.idx + 1].max())))
            log(failures[-1])
        base = float(np.median(totals[kind]))
        phase = []
        for key, ms in alone[kind].items():
            b1, c1 = float(np.median(ms)), float(np.median(
                alone['current'][key]))
            phase.append('%s %.4f ms, current %.4f ms (%.3fx)' % (
                key or 'warm', b1, c1, b1 / c1))
        log("%s %s replay medians: %s %.4f ms, current %.4f ms (%.3fx); "
            "phase 1 alone: %s; outputs held to %s" % (
                label, contract, kind, base, cur, base / cur,
                '; '.join(phase), held))
    return failures


def sass_comparison(lib, base, label):
    """Which kernels of two builds of one source compile to the same SASS,
    instantiation by instantiation (``chip_smoke.sass_functions``): a line
    of counts per kernel name."""
    ours, theirs = sass_functions(lib), sass_functions(base)
    if ours is None or theirs is None:
        return 'sass %s: cuobjdump not found' % label
    same, differ = {}, {}
    for key in sorted(set(ours) & set(theirs), key=str):
        tally = same if ours[key] == theirs[key] else differ
        tally[key[0]] = tally.get(key[0], 0) + 1
    return 'sass %s: identical %s; differ %s' % (label, same, differ)


def nonfinite(outs):
    """Non-finite entries of a list of value calls' outputs."""
    return sum(int((~torch.isfinite(out)).sum()) for out in outs)


def main(argv):
    if not torch.cuda.is_available():
        print("measure_value_replay: CUDA is not available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog='measure_value_replay.py')
    parser.add_argument('--contract', choices=sorted(CALLS), default='value')
    parser.add_argument('--seed', type=int, default=0,
                        help="the recorded profile's seed")
    parser.add_argument('--by', choices=('lanes', 'cells'), default='lanes',
                        help="break the replay down by bin of lanes, or "
                        "(value contract) of mean cells a lane")
    parser.add_argument('baselines')
    parser.add_argument('paths', nargs='*', metavar='path',
                        help=' | '.join(PATHS))
    args = parser.parse_args(argv)
    paths = AB_PATHS[args.contract]
    if not set(args.paths) <= set(paths):
        parser.error("the %s contract's paths are %s"
                     % (args.contract, ', '.join(paths)))
    if args.by == 'cells' and args.contract != 'value':
        parser.error("--by cells breaks down value calls")
    from blueice_tpu_torch import likelihood, test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import (fused, fused_bb, fused_bb_lite,
                                       fused_unbinned)
    from blueice_tpu_torch.parallel import BinnedToyStudy, UnbinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    from blueice_tpu_torch.utils.roofline import card_line

    set_progress(False)
    log(card_line())
    roots = args.baselines.split(',')
    mods = dict(fused=fused, fused_bb=fused_bb, fused_bb_lite=fused_bb_lite,
                fused_unbinned=fused_unbinned)
    fused.build_libraries([m.SOURCE for m in mods.values()] + [
        baseline_source(m, root) for root in roots for m in mods.values()])
    baselines = {root: {name: load_baseline(m, root)
                        for name, m in mods.items()} for root in roots}
    for root in roots:
        for name, m in mods.items():
            log(sass_comparison(fused.build_library(m.SOURCE),
                                fused.build_library(baseline_source(m, root)),
                                '%s vs %s' % (name, root)))
    failures = []
    for label in args.paths or paths:
        lf = build_model(label, xenon_like, test_helpers, likelihood)
        cls = UnbinnedToyStudy if label.startswith('unbinned') \
            else BinnedToyStudy
        study = cls(lf, max_iter=96, tol=3e-4)
        failures += ab(label, study, mods, baselines, args.contract,
                       args.seed, args.by)
    log(card_line())
    if failures:
        raise AssertionError('; '.join(failures))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
