"""Batch computation of delayed source PDF templates.

Counterpart of :mod:`blueice_tpu.cli` (its ``bluethaw``): compute every
pending task file in a directory into the content-addressed template
cache, optionally on several worker processes::

    python -m blueice_tpu_torch.cli --input pdf_tasks --output pdf_cache \\
        --n_cpus 4
"""

import argparse
import sys

from .parallel.tasks import compute_all

__all__ = ['main']


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m blueice_tpu_torch.cli',
        description="Compute blueice_tpu_torch PDF templates from task files")
    parser.add_argument('--input', default='./pdf_tasks',
                        help="Directory with task files to compute")
    parser.add_argument('--output', default='./pdf_cache',
                        help="Directory for the computed template cache")
    parser.add_argument('--n_cpus', type=int, default=1,
                        help="Number of worker processes")
    args = parser.parse_args(argv)
    if args.n_cpus < 1:
        parser.error("--n_cpus must be at least 1")

    compute_all(args.input, args.n_cpus,
                task_dir=args.input, result_dir=args.output)
    return 0


if __name__ == '__main__':
    sys.exit(main())
