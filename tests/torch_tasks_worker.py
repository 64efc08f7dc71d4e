"""The process-pool template builds of ``tests/test_torch_tasks.py``, run
in a fresh interpreter that the test holds to a time limit (a hung pool
then fails the test instead of stalling the suite).

argv: out_path. Builds the reduced XENON-style binned likelihood of both
packages (blob templates, which carry no random draws) three times, each
into fresh cache and task directories with the process-wide template
caches emptied: the port serially, the port with ``prepare(n_cores=2)``,
the JAX package with ``prepare(n_cores=2)``. Writes each build's mus and
pmf anchor tensors and the number of task files left to ``out_path``
(npz).
"""

import os
import sys
import tempfile

import numpy as np

SIZE = dict(n_cs1_bins=5, n_cs2_bins=4, livetime_days=30.0)


def build(xenon, source_cls, n_cores):
    source_cls._data_cache.clear()
    root = tempfile.mkdtemp(prefix='torch_tasks_worker_')
    task_dir = os.path.join(root, 'tasks')
    lf = xenon.build_likelihood('binned', prepare=False,
                                cache_dir=os.path.join(root, 'cache'),
                                task_dir=task_dir, **SIZE)
    lf.prepare(n_cores=n_cores)
    left = len(os.listdir(task_dir)) if os.path.exists(task_dir) else 0
    return (np.asarray(lf._builds['mus'][2]), np.asarray(lf._builds['ps'][2]),
            left)


def main(out_path):
    from blueice_tpu_torch.examples import xenon_like as txenon
    from blueice_tpu_torch.models.source import Source as TorchSource
    from blueice_tpu_torch.utils import set_progress
    from blueice_tpu.examples import xenon_like as jxenon
    from blueice_tpu.models.source import Source as JaxSource
    from blueice_tpu.utils.progress import set_progress as jax_set_progress
    set_progress(False)
    jax_set_progress(False)
    out = {}
    for label, xenon, cls, n_cores in (
            ('serial', txenon, TorchSource, 1),
            ('pool', txenon, TorchSource, 2),
            ('jax_pool', jxenon, JaxSource, 2)):
        mus, ps, left = build(xenon, cls, n_cores)
        out[label + '_mus'], out[label + '_ps'] = mus, ps
        out[label + '_tasks_left'] = left
    np.savez(out_path, **out)


if __name__ == '__main__':
    main(sys.argv[1])
