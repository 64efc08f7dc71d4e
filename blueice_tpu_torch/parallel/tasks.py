"""Delayed, multi-process and cluster computation of source PDF templates.

Counterpart of :mod:`blueice_tpu.parallel.tasks`: content-addressed task
files written by ``Source.prepare_task`` are consumed by workers
(:func:`compute_single`), fanned out over a process pool
(:func:`compute_many`) or over a whole directory (:func:`compute_all`, the
entry point of ``python -m blueice_tpu_torch.cli``). The protocol is
restartable and idempotent: finished hashes are skipped, a task file is
deleted only after its result exists, and cache writes are atomic, so a
killed run resumes.

The workers only fill numpy templates on the host; nothing in them touches
a device (a source whose template is built on the card is built in the
parent, before the task files are written, by
:func:`blueice_tpu_torch.models.jax_source.prefill_anchor_templates`).
"""

import logging
import os
from concurrent.futures import ProcessPoolExecutor

from ..utils import read_pickle

__all__ = ['create_models_ipyparallel', 'compute_single', 'compute_many',
           'compute_all']
log = logging.getLogger('blueice_tpu_torch.parallel')


def compute_single(hash, task_dir='pdf_tasks', result_dir='pdf_cache'):
    """Compute one source PDF template from its saved task file."""
    result_filename = os.path.join(result_dir, hash)
    if os.path.exists(result_filename):
        log.debug("Task %s already computed, nothing done.", hash)
        return

    task_filename = os.path.join(task_dir, hash)
    if not os.path.exists(task_filename):
        raise ValueError("Hash %s does not correspond to a task or result"
                         % hash)

    source_class, source_config = read_pickle(task_filename)
    source_config['cache_dir'] = result_dir
    source_config['delay_pdf_computation'] = False
    s = source_class(source_config)

    # Delete the task only once the result exists: a crash, or a config
    # that skips the cache write, leaves the task for the next sweep
    if s.hash != hash:
        raise ValueError("The source's hash changed from %s to %s"
                         % (hash, s.hash))
    if not os.path.exists(result_filename):
        raise RuntimeError(
            "Task %s computed but produced no cache file at %s (is "
            "never_save_to_cache set?); keeping the task file for retry"
            % (hash, result_filename))
    os.remove(task_filename)


def compute_many(hashes, n_cpus=1, *args, **kwargs):
    """Compute several task files, on a process pool when ``n_cpus`` is
    not 1 (a worker's exception is raised here)."""
    from ..utils.progress import progress_iter
    hashes = list(hashes)
    if n_cpus != 1:
        with ProcessPoolExecutor(max_workers=n_cpus) as pool:
            futures = [pool.submit(compute_single, h, *args, **kwargs)
                       for h in hashes]
            for f in progress_iter(futures,
                                   desc="Computing on %d cores" % n_cpus):
                f.result()
    else:
        for h in progress_iter(hashes, desc="Computing templates"):
            compute_single(h, *args, **kwargs)


def compute_all(input_dir='./pdf_tasks', *args, **kwargs):
    """Compute every pending task file in input_dir. Dotfiles are skipped:
    a hard-killed atomic write can leave a '.tmp_*.part' behind, and a
    resumed run must step over it rather than read a truncated pickle."""
    if not os.path.exists(input_dir):
        raise FileNotFoundError("Input directory %s does not exist"
                                % input_dir)
    compute_many([h for h in os.listdir(input_dir) if not h.startswith('.')],
                 *args, **kwargs)


def create_models_ipyparallel(configs, ipp_client=None, block=False):
    """A Model per config, built on an ipyparallel cluster (serially here
    without a client). The engines must run in the same working
    directory."""
    from ..models import Model

    if ipp_client is None:
        return [Model(conf) for conf in configs]

    ipp_client[:].use_dill()

    def compute_model(conf):
        from blueice_tpu_torch.models import Model
        return Model(conf)

    asyncresult = ipp_client.load_balanced_view().map(
        compute_model, configs, ordered=True, block=block)
    return list(asyncresult)
