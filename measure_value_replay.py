#!/usr/bin/env python3
"""A/B of the binned value kernels against another checkout's, on a
profile's own calls, on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA GPU:

    python3 measure_value_replay.py BASELINE [path ...]

BASELINE is the root of another checkout of the repo (for example an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists) whose value kernels' C entries (``bt_binned_ll_multi``,
``bt_bb_ll_multi``, ``bt_bblite_ll_multi``) take the arguments this
checkout's take. For each binned path (``xenon``, ``bb``, ``bblite``, or
the ones named), float32 on the card:

1. every call of the path's value wrapper in one ``profile_ts`` (seed 0,
   the path's toys) is recorded with this checkout's kernels
   (``chip_smoke.record_value_calls``);
2. the same calls are replayed from CUDA graphs
   (``chip_smoke.time_value_calls``) with the baseline's library and with
   this checkout's, in the order baseline, current, current, baseline;
   each replay's summed time is printed, then the medians and their ratio;
3. the two libraries' outputs on every recorded call agree to relative
   1e-5, or the run fails.

Without CUDA it exits with code 2. It prints the card's name and power
limit first and last.
"""

import os
import sys

import numpy as np
import torch

from chip_smoke import (VALUE_CALLS, build_model, log, record_value_calls,
                        time_value_calls)

BINNED = ('xenon', 'bb', 'bblite')
ORDER = ('baseline', 'current', 'current', 'baseline')


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


def ab(label, study, mods, baseline):
    """Steps 1-3 for one path."""
    mod_name, name, launcher_name, shared = VALUE_CALLS[label]
    module = mods[mod_name]
    launcher = getattr(module, launcher_name)
    calls = record_value_calls(label, study, mods)
    torch.cuda.synchronize()
    libs = dict(current=module.load_library(), baseline=baseline[mod_name])
    load = module.load_library
    totals = {kind: [] for kind in libs}
    outs = {}
    try:
        for kind in ORDER:
            module.load_library = lambda kind=kind: libs[kind]
            per_A = time_value_calls(launcher, calls, shared)
            totals[kind].append(sum(per_A.values()))
            log("%s value replay, %s kernel: %d calls, %.4f ms (%s)" % (
                label, kind, len(calls), totals[kind][-1], ', '.join(
                    'A=%d: %.4f ms' % a for a in per_A.items())))
            if kind not in outs:
                outs[kind] = []
                for args in calls:
                    launch, out = launcher(*args)
                    launch()
                    outs[kind].append(out)
    finally:
        module.load_library = load
    torch.cuda.synchronize()
    worst = max(float(((a - b).abs() / b.abs()).max())
                for a, b in zip(outs['current'], outs['baseline']))
    if not worst <= 1e-5:
        raise AssertionError("%s: the two value kernels disagree by %.3g"
                             % (label, worst))
    base, cur = (float(np.median(totals[k])) for k in ('baseline', 'current'))
    log("%s value replay medians: baseline %.4f ms, current %.4f ms (%.3fx); "
        "the two agree to %.3g" % (label, base, cur, base / cur, worst))


def main(args):
    if not torch.cuda.is_available():
        print("measure_value_replay: CUDA is not available", file=sys.stderr)
        return 2
    if not args or not all(label in BINNED for label in args[1:]):
        print("usage: measure_value_replay.py BASELINE [%s ...]"
              % ' | '.join(BINNED), file=sys.stderr)
        return 2
    from blueice_tpu_torch import likelihood, test_helpers
    from blueice_tpu_torch.examples import xenon_like
    from blueice_tpu_torch.ops import fused, fused_bb, fused_bb_lite
    from blueice_tpu_torch.parallel import BinnedToyStudy
    from blueice_tpu_torch.utils import set_progress
    from blueice_tpu_torch.utils.roofline import card_line

    set_progress(False)
    log(card_line())
    mods = dict(fused=fused, fused_bb=fused_bb, fused_bb_lite=fused_bb_lite)
    fused.build_libraries([m.SOURCE for m in mods.values()] + [
        baseline_source(m, args[0]) for m in mods.values()])
    baseline = {name: load_baseline(m, args[0]) for name, m in mods.items()}
    for label in args[1:] or BINNED:
        lf = build_model(label, xenon_like, test_helpers, likelihood)
        study = BinnedToyStudy(lf, max_iter=96, tol=3e-4)
        ab(label, study, mods, baseline)
    log(card_line())
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
