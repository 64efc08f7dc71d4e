"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (imports, the kernels' libraries, the templates, the reference and
one warm call at the cell's shapes) counts as ``setup_s``; then the window
runs calls for ``--seconds`` (``--trace 1``: the traffic's traced calls
under the profiler), the sampled toys are judged against the reference, and
the last line of standard output is the result, one JSON object. The last
lines of standard error give each number compared beside its limit.

Exits 2, printing no result, without a CUDA device or with fewer devices
than the cell asks for; 3 if a forbidden module (JAX or the JAX package)
was loaded."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness import runner
    cell = runner.load_cell(args.workload)[1]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell['chips']):
        print("the cell asks for %d devices, %d present"
              % (cell['chips'], torch.cuda.device_count()), file=sys.stderr)
        return 2
    result, lines = runner.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), device='cuda',
                                    t_start=T_START)
    bad = runner.forbidden_modules()
    if bad:
        print("forbidden modules loaded: %s" % ', '.join(bad),
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
