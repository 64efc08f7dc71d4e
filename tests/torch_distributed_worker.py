"""One rank of the test-only two-process gloo runs of
``tests/test_torch_distributed.py`` (the package's own worker,
``python -m blueice_tpu_torch.dryrun --worker``, drives the dry run).

argv: rank world port out_path spec_json, where spec holds 'numpy_seed'
and 'n_toys' (the binned flagship's sharded profile of numpy-made counts,
:func:`numpy_counts`, which the JAX package's study can fit too),
'rank_seeds' (one seed a rank, drawn under the mesh: the ranks must
refuse) and 'study' (the study's keywords). Writes the profile's record
(``dryrun.run_record``) and the refusal's message to ``out_path``.
"""

import json
import sys

import numpy as np
import torch


def numpy_counts(study, seed, n_toys):
    """numpy Poisson counts (n_toys, *bins) at the study's default
    expectation, from ``np.random.default_rng(seed)``."""
    expected = study.expected_counts().cpu().numpy()
    return np.random.default_rng(seed).poisson(
        expected, (n_toys,) + expected.shape).astype(float)


def main(rank, world, port, out_path, spec):
    from blueice_tpu_torch import dryrun
    from blueice_tpu_torch.parallel import BinnedToyStudy
    from blueice_tpu_torch.parallel.distributed import (init_distributed,
                                                        global_mesh)
    from blueice_tpu_torch.utils import set_progress
    set_progress(False)
    torch.set_num_threads(1)
    init_distributed('localhost:%d' % port, world, rank, backend='gloo',
                     device='cpu')
    mesh = global_mesh()
    study = BinnedToyStudy(dryrun.flagship_likelihood('binned'),
                           device='cpu', **spec['study'])
    counts = numpy_counts(study, spec['numpy_seed'], spec['n_toys'])
    result = study._run_profile(counts, dryrun.TARGETS['binned'], 1.0, None,
                                mesh=mesh)
    record = dryrun.run_record(dict(model='binned', n_toys=spec['n_toys']),
                               [], torch.as_tensor(counts), result)
    try:
        study.simulate(spec['rank_seeds'][rank], 4, mesh=mesh)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    with open(out_path, 'w') as f:
        json.dump(dict(rank=rank, world=world, runs=[record],
                       refusal=refusal), f)
    torch.distributed.destroy_process_group()


if __name__ == '__main__':
    rank, world, port, out_path, spec = sys.argv[1:6]
    main(int(rank), int(world), int(port), out_path, json.loads(spec))
