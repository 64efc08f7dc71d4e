#!/usr/bin/env python3
"""A/B of the binned value or vgh kernels against other checkouts', on a
profile's own calls, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 measure_value_replay.py [--contract value|vgh] BASELINE[,...] \\
        [path ...]

BASELINE is the root of another checkout of the repo (for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists) whose kernels' C entries take the arguments this
checkout's take: for the value contract (the default) ``bt_binned_ll_multi``,
``bt_bb_ll_multi``, ``bt_bblite_ll_multi``; for the vgh contract
``bt_binned_vgh``, ``bt_bb_vgh``, ``bt_bblite_vgh``. Several baselines,
separated by commas, are measured on the same calls. For each binned path
(``xenon``, ``bb``, ``bblite``, or the ones named), float32 on the card:

1. every call of the path's wrapper of the contract in one ``profile_ts``
   (seed 0, the path's toys) is recorded with this checkout's kernels
   (``chip_smoke.record_calls``);
2. the same calls are replayed from CUDA graphs (``chip_smoke.time_calls``)
   with each library in turns, the baselines, this checkout's twice, the
   baselines in reverse (one baseline: baseline, current, current,
   baseline); each replay's summed time is printed, then each library's
   median and the ratio baseline / current;
3. in the same turns, each library's kernel alone at phase 1's inputs of
   ``chip_smoke.py`` (512 toys; the value kernel at A = 12), 20 launches
   replayed from a CUDA graph;
4. the outputs on every recorded call are checked, or the run fails: a
   value baseline's agree with this checkout's to relative 1e-5 (0:
   bit-identical); the vgh kernels are held to the plain version in
   float64 on the same calls (ll relative, g and H relative to each toy's
   largest entry), this checkout's within 1e-5 and 1e-4 or within twice a
   baseline's error (where float32 itself loses digits, next to an anchor
   whose MC-count row is empty). The errors are printed, and for the vgh
   the largest difference between the two libraries' outputs (0:
   bit-identical).

Without CUDA it exits with code 2. It prints the card's name and power
limit first and last.
"""

import argparse
import os
import sys

import numpy as np
import torch

from chip_smoke import (CALLS, binned_data, build_model, log, random_point,
                        record_calls, rel_to_toy_max, time_calls)

BINNED = ('xenon', 'bb', 'bblite')


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
    """The arguments of the path's wrapper of ``contract`` at phase 1's
    inputs (``chip_smoke.kernel_rows``: the same seed and draws)."""
    compiled = study.compiled
    rng = np.random.default_rng(0)
    anchor, obs, _, mc, extra = binned_data(label, compiled, mods, rng)
    grid = [len(a) for a in compiled.anchor_arrays]
    strides = tuple(int(np.prod(grid[d + 1:])) for d in range(len(grid)))
    idx, t, m = random_point(compiled, rng, obs.shape[:1])
    if contract == 'value':
        idx, t, m = random_point(compiled, rng, obs.shape[:1] + (12,))
    head = (anchor,) if mc is None else (anchor, mc)
    return head + (strides, idx, t, m, obs) + tuple(extra)


def disagreement(out, ref):
    """(ll, g and H) relative differences of ``out`` from ``ref``: the ll
    (a value call's, or the first of a vgh call's (ll, g, H)) relative to
    itself, g and H relative to each toy's largest entry (0 for a value
    call)."""
    if not isinstance(out, tuple):
        return float(((out - ref).abs() / ref.abs()).max()), 0.0
    return (float(((out[0] - ref[0]).abs() / ref[0].abs()).max()),
            max(rel_to_toy_max(out[1], ref[1]),
                rel_to_toy_max(out[2], ref[2])))


def ab(label, study, mods, baselines, contract):
    """Steps 1-4 for one path; ``baselines``: {name: {module name:
    library}}."""
    from blueice_tpu_torch.utils.roofline import launch_elapsed_s
    mod_name, name, launcher_name, shared = CALLS[contract][label]
    module = mods[mod_name]
    launcher = getattr(module, launcher_name)
    calls = record_calls(label, study, mods, contract)
    phase1 = phase1_args(label, study, mods, contract)
    torch.cuda.synchronize()
    libs = dict(current=module.load_library())
    libs.update((b, lib[mod_name]) for b, lib in baselines.items())
    order = list(baselines) + ['current', 'current'] + list(baselines)[::-1]
    totals = {kind: [] for kind in libs}
    alone = {kind: [] for kind in libs}
    outs = {}
    load = module.load_library
    try:
        for kind in order:
            module.load_library = lambda kind=kind: libs[kind]
            per_A = time_calls(launcher, calls, shared)
            totals[kind].append(sum(per_A.values()))
            alone[kind].append(1e3 * launch_elapsed_s(launcher(*phase1)[0]))
            log("%s %s replay, %s kernel: %d calls, %.4f ms (%s); phase 1 "
                "alone %.4f ms" % (
                    label, contract, kind, len(calls), totals[kind][-1],
                    ', '.join('A=%d: %.4f ms' % a for a in per_A.items()),
                    alone[kind][-1]))
            if kind not in outs:
                outs[kind] = []
                for args in calls:
                    launch, out = launcher(*args)
                    launch()
                    outs[kind].append(out)
    finally:
        module.load_library = load
    torch.cuda.synchronize()
    # What the outputs are held to: value, this checkout's outputs; vgh, the
    # plain version in float64 on the same calls (in a bin next to an anchor
    # whose MC-count row is empty float32 itself loses digits, so two
    # float32 kernels may differ there by more than their tolerance)
    if contract == 'vgh':
        plain = getattr(module, name.replace('_fused', '_plain'))
        refs = [plain(*(a.double() if torch.is_tensor(a)
                        and a.is_floating_point() else a for a in args))
                for args in calls]
    else:
        refs = outs['current']
    errs = {kind: np.array([disagreement(double(o), double(r)) for o, r in
                            zip(outs[kind], refs)]) for kind in libs}
    worst = {kind: e.max(axis=0) for kind, e in errs.items()}
    cur, cur1 = (float(np.median(x['current'])) for x in (totals, alone))
    for kind in baselines:
        if contract == 'vgh':
            bound = np.maximum((1e-5, 1e-4), 2 * worst[kind])
            ok = (worst['current'] <= bound).all()
            bad = errs['current']
            apart = max(float((x - y).abs().max()) for a, b in zip(
                outs[kind], outs['current']) for x, y in zip(a, b))
            held = "the float64 plain version (current %.3g, %.3g; %s %.3g, " \
                "%.3g); largest difference between the two %.3g" % (
                    *worst['current'], kind, *worst[kind], apart)
        else:
            ok = (worst[kind] <= (1e-5, 0.0)).all()
            bad = errs[kind]
            held = "each other (%.3g)" % worst[kind][0]
        if not ok:
            i = int(bad.max(axis=1).argmax())
            raise AssertionError(
                "%s: the %s kernels of %s and this checkout are not held to "
                "%s, worst on call %d of %d (%d lanes; lerp weights t in "
                "[%g, %g])" % (
                    label, contract, kind, held, i, len(calls),
                    calls[i][shared + 1].shape[0],
                    float(calls[i][shared + 2].min()),
                    float(calls[i][shared + 2].max())))
        base, base1 = (float(np.median(x[kind])) for x in (totals, alone))
        log("%s %s replay medians: %s %.4f ms, current %.4f ms (%.3fx); "
            "phase 1 alone %.4f ms, current %.4f ms (%.3fx); outputs held "
            "to %s" % (label, contract, kind, base, cur, base / cur, base1,
                       cur1, base1 / cur1, held))


def double(out):
    """A call's outputs in float64."""
    return tuple(x.double() for x in out) if isinstance(out, tuple) \
        else out.double()


def main(argv):
    if not torch.cuda.is_available():
        print("measure_value_replay: CUDA is not available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog='measure_value_replay.py')
    parser.add_argument('--contract', choices=sorted(CALLS), default='value')
    parser.add_argument('baselines')
    parser.add_argument('paths', nargs='*', metavar='path',
                        help=' | '.join(BINNED))
    args = parser.parse_args(argv)
    if not set(args.paths) <= set(BINNED):
        parser.error("paths are %s" % ', '.join(BINNED))
    from blueice_tpu_torch import likelihood, test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import fused, fused_bb, fused_bb_lite
    from blueice_tpu_torch.parallel import BinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    from blueice_tpu_torch.utils.roofline import card_line

    set_progress(False)
    log(card_line())
    roots = args.baselines.split(',')
    mods = dict(fused=fused, fused_bb=fused_bb, fused_bb_lite=fused_bb_lite)
    fused.build_libraries([m.SOURCE for m in mods.values()] + [
        baseline_source(m, root) for root in roots for m in mods.values()])
    baselines = {root: {name: load_baseline(m, root)
                        for name, m in mods.items()} for root in roots}
    for label in args.paths or BINNED:
        lf = build_model(label, xenon_like, test_helpers, likelihood)
        study = BinnedToyStudy(lf, max_iter=96, tol=3e-4)
        ab(label, study, mods, baselines, args.contract)
    log(card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
