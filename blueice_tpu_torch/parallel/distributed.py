"""Toy ensembles spread over processes: one process per device, joined by
``torch.distributed``.

Counterpart of :mod:`blueice_tpu.parallel.distributed`. The JAX package
runs one SPMD program over a global device mesh; torch runs one process
per device (NCCL between GPUs, gloo on the CPU, or between two ranks that
share one GPU, which NCCL refuses). Every process runs the same code:

    init_distributed(coordinator, num_processes, process_id)   # once
    mesh = global_mesh()                                       # every rank
    t, free, cond = profile_ts_distributed(study, seed, n, target, h,
                                           mesh=mesh)          # on every rank

The contract is the JAX module's:

* toy i is the same dataset at any world size: every rank draws the whole
  ensemble from the same int seed on its own device type
  (:func:`_prepare_ensemble`; a binned ensemble of 512 XENON toys is 6.3
  MB, an unbinned event set smaller still) and keeps its rows; only the
  heavy per-toy tensors (an unbinned study's scored (B, G, S, E) densities)
  are made for the rank's rows alone;
* n_toys is rounded up to a multiple of the world size, and the padded
  toys are ordinary toys;
* each rank fits only its contiguous block of rows;
* every rank returns the full, gathered result (:func:`gather_to_hosts`);
* the straggler refinement runs after the gather, identically on every
  rank.

Any study entry that takes ``mesh=`` (``simulate``, ``run``,
``profile_ts``, ``profile_ts_grid``, ``profile_ts_scan``, and so every
statistic that forwards it) runs this way under a grouped mesh;
:func:`profile_ts_distributed` and :func:`run_distributed` are those
entries on the global mesh. ``simulate(mesh=)`` returns the whole ensemble
on every rank, so ``fit_toys`` of it (and ``gof_pvalue``) fits every toy
on every rank: correct, not sharded.
"""

import socket

import torch
import torch.distributed as dist

from ..device import resolve

__all__ = ['init_distributed', 'global_mesh', 'to_global_toys',
           'gather_to_hosts', 'profile_ts_distributed', 'run_distributed']

BACKENDS = ('nccl', 'gloo')

#: this process's rank device, set by :func:`init_distributed` (the process
#: group it belongs to is process-wide state of torch.distributed too)
_RANK_DEVICE = {}


def is_initialized():
    """Whether this process belongs to an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def rank_device():
    """This rank's torch device: the one :func:`init_distributed` chose, or
    for a group made elsewhere the current CUDA device under NCCL and the
    CPU otherwise."""
    if 'device' in _RANK_DEVICE:
        return _RANK_DEVICE['device']
    if dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None, device=None):
    """Join this process to the process group (idempotent:
    ``torch.distributed.is_initialized()``).

    :param coordinator_address: 'host:port' (or a ``tcp://`` URL) of rank
      0's store; None: a free local port for a group of one, and for more
      ranks the environment's ``MASTER_ADDR`` / ``MASTER_PORT``, as torch's
      launcher sets them (``env://``).
    :param num_processes: the world size (None: 1).
    :param process_id: this process's rank (None: 0).
    :param backend: 'nccl' or 'gloo' (anything else raises); None: NCCL
      when the rank's device is CUDA, gloo on the CPU. Two ranks sharing
      one GPU need gloo (NCCL refuses them).
    :param device: this rank's device: None for the card
      (``cuda:(rank % device_count)``; without CUDA this raises, as every
      entry point of the port does), 'cpu', or a CUDA device.
    :return: (rank, world size).
    """
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if backend is not None and backend not in BACKENDS:
        raise ValueError("backend must be one of %s or None, got %r"
                         % (BACKENDS, backend))
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError("process_id %d outside num_processes %d"
                         % (rank, world))
    dev = resolve(device)[0]
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda', rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend == 'nccl' and dev.type != 'cuda':
        raise ValueError("the NCCL backend needs a CUDA device, got %s"
                         % dev)
    if coordinator_address is None:
        init_method = ('tcp://localhost:%d' % _free_port() if world == 1
                       else 'env://')
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = 'tcp://' + coordinator_address
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    _RANK_DEVICE['device'] = dev
    return rank, world


def global_mesh(axis_name='toys', devices=None):
    """The mesh of every rank of the group, this rank on its device (one
    process alone without a group): :func:`~blueice_tpu_torch.parallel.
    toys.make_mesh`."""
    from .toys import make_mesh
    return make_mesh(devices, axis_name)


def to_global_toys(mesh, tree, axis_name='toys'):
    """This rank's rows of an ensemble every rank holds whole (leading axis
    the full toy axis): the rows the JAX package's placement gives this
    rank's devices (:func:`~blueice_tpu_torch.parallel.toys.shard_toys`;
    the port's ranks are one contiguous block each by construction)."""
    from .toys import shard_toys
    return shard_toys(mesh, tree, axis_name)


def gather_to_hosts(tree, mesh=None):
    """numpy arrays of the whole toy axis on every rank: each rank's block
    of every leaf of ``tree`` (a tensor, or a tuple or list of them),
    concatenated in rank order by ``all_gather`` over the mesh's group
    (CUDA tensors under NCCL, host tensors under gloo). Without a grouped
    mesh, the leaves as numpy."""
    if isinstance(tree, (tuple, list)):
        return [gather_to_hosts(x, mesh) for x in tree]
    x = torch.as_tensor(tree)
    if mesh is None or mesh.group is None:
        return x.cpu().numpy()
    if dist.get_backend(mesh.group) == 'gloo':
        x = x.cpu()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts).cpu().numpy()


def _prepare_ensemble(seed_or_generator, n_toys, mesh):
    """(n_toys, seed) of a layout-invariant draw under ``mesh``: n_toys
    rounded up to a multiple of the world size, and the seed to draw the
    whole ensemble from. One process alone draws from the seed as given (a
    mesh of one process is no mesh). In a process group every rank reads
    one int (``seed_of``: a Generator gives one draw) and the ranks
    compare theirs (``all_gather_object``): a mismatch raises on every
    rank, since each rank would otherwise draw other toys."""
    from .toys import _round_up_toys, seed_of
    n_toys = _round_up_toys(n_toys, mesh)
    if mesh.group is None:
        return n_toys, seed_or_generator
    seed = seed_of(seed_or_generator)
    seeds = [None] * mesh.world_size
    dist.all_gather_object(seeds, seed, group=mesh.group)
    if len(set(seeds)) != 1:
        raise ValueError("the ranks draw from different seeds %s: every "
                         "rank must pass the same seed" % seeds)
    return n_toys, seed


def profile_ts_distributed(study, seed_or_generator, n_toys, target,
                           hypothesis, truth=None, fixed=None, mesh=None,
                           axis_name='toys'):
    """``study.profile_ts`` over the global mesh (default
    :func:`global_mesh`): each rank fits its block; every rank returns
    (t (n_toys,), free ToyResults, conditional ToyResults) of the whole
    ensemble, the same on every rank and toy for toy the single-process
    result of the same seed."""
    mesh = global_mesh(axis_name) if mesh is None else mesh
    return study.profile_ts(seed_or_generator, n_toys, target, hypothesis,
                            truth=truth, fixed=fixed, mesh=mesh)


def run_distributed(study, seed_or_generator, n_toys, truth=None, fixed=None,
                    mesh=None, axis_name='toys'):
    """``study.run`` (simulate and free fit) over the global mesh."""
    mesh = global_mesh(axis_name) if mesh is None else mesh
    return study.run(seed_or_generator, n_toys, truth=truth, fixed=fixed,
                     mesh=mesh)
