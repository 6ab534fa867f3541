"""Multi-process bring-up and per-process data feeding, on
``torch.distributed`` (counterpart of ``ppgs_tpu/parallel/multihost.py``).

The JAX recipe, rank for process: every process calls ``initialize`` at
startup (a no-op without configuration); the mesh spans the ranks
(``make_hybrid_mesh``: one rank a device, so the per-process layout is one
device and the leading axis spans the processes); every process
materialises the same global batch and keeps its block
(``local_slice``); metric accumulators, which are pure sums
(``evaluate/metrics.py``), are summed across processes at the end of an
evaluation pass; per-utterance work takes every process_count-th item
(``shard_iterator``).

NCCL is the backend for a CUDA device, gloo for the CPU or when the caller
names it: two ranks that share one card go over gloo, since NCCL refuses
two ranks on one device (``comm.py`` stages their CUDA tensors through
the host). Every helper is its single-process equivalent without a process
group, so one code path runs from one card to many.
"""

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import devices
from . import Mesh, comm, make_mesh, replicate, shard_batch, tree_map, world

TIMEOUT_SECONDS = 300       # rendezvous and collectives (gloo's connect
                            # timeout under a loaded CPU lost JAX tests)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = None,
               device=None, timeout: float = TIMEOUT_SECONDS):
    """Idempotent process-group bring-up.

    Arguments default from the environment (PPGS_COORDINATOR as
    'host:port', PPGS_NUM_PROCESSES, PPGS_PROCESS_ID); with none set it is
    a no-op, as a single process with no configuration is in JAX. The
    rendezvous is a TCP store on the coordinator's address, rank 0 its
    server. ``backend`` defaults to NCCL on a CUDA ``device`` (None means
    the card, raising without one, as every entry point does) and gloo on
    the CPU; a second call, from another entry point, returns at once.
    ``timeout`` (seconds) bounds the rendezvous and every collective.
    Returns the backend, or None when there is nothing to bring up."""
    if dist.is_initialized():
        return dist.get_backend()
    coordinator_address = coordinator_address or os.environ.get(
        'PPGS_COORDINATOR')
    if num_processes is None and 'PPGS_NUM_PROCESSES' in os.environ:
        num_processes = int(os.environ['PPGS_NUM_PROCESSES'])
    if process_id is None and 'PPGS_PROCESS_ID' in os.environ:
        process_id = int(os.environ['PPGS_PROCESS_ID'])
    if coordinator_address is None and num_processes is None:
        return None
    if coordinator_address is None or num_processes is None:
        raise ValueError('a process group needs PPGS_COORDINATOR and '
                         'PPGS_NUM_PROCESSES (and PPGS_PROCESS_ID)')
    process_id = process_id or 0
    if backend is None:
        device = devices.resolve(device)
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    host, port = coordinator_address.rsplit(':', 1)
    wait = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=wait)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=wait)
    return backend


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    from . import _MESHES

    _MESHES.clear()


def process_count() -> int:
    return world()[0]


def process_index() -> int:
    return world()[1]


def make_hybrid_mesh(ici_shape: Sequence[int] = (-1,),
                     axis_names: Sequence[str] = ('data',),
                     dcn_shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over every rank. Each process drives one device, so the
    per-process layout ``ici_shape`` has one device: its -1 fills with the
    world size, and the processes are the mesh (``dcn_shape``, when given,
    is then the mesh's shape)."""
    mesh = make_mesh(ici_shape, axis_names)
    if dcn_shape is not None and tuple(dcn_shape) != tuple(
            mesh.shape.values()):
        raise ValueError(f'dcn_shape {tuple(dcn_shape)} is not the mesh '
                         f'{tuple(mesh.shape.values())} of the '
                         f'{process_count()} processes')
    return mesh


def shard_global_batch(mesh: Mesh, tree, axis: str = 'data', device=None):
    """This process's LOCAL batch as tensors on ``device``: the rows it
    passes are already its own block (``local_slice``), so they are only
    placed. Single process: its block of the mesh's ``axis`` (all rows on
    one rank)."""
    if process_count() == 1:
        tree = shard_batch(mesh, tree, axis)
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(device),
                    tree)


def replicate_global(mesh: Mesh, tree, device=None):
    """Identical host arrays on every rank's device (all processes pass
    the same values, the SPMD contract); rank 0's are broadcast, so a
    process that passed others would get rank 0's."""
    return replicate(mesh, tree, device)


def aggregate_across_processes(tree, group=None):
    """The sum of a tree of metric accumulators (tensors) over all
    processes: one ``all_reduce`` a tensor, in place. The Metrics state is
    pure sums (``evaluate/metrics.py::init_state``), so the per-dataset and
    aggregate metrics are exact across any process split. ``group``: the
    processes to sum over (default all; a training evaluation sums over
    its data group). No-op for one process."""
    if process_count() == 1:
        return tree
    group = dist.group.WORLD if group is None else group
    return tree_map(lambda t: comm.all_reduce_sum(t, group, 'metrics'),
                    tree)


def local_slice(tree, axis: int = 0):
    """This process's contiguous block of a global batch (numpy or
    tensors): every process runs the same epoch-seeded sampler and
    materialises the same padded global batch, and keeps its block, so a
    multi-process run is step for step the single-process one. The dim
    must already be padded to a multiple of the process count."""
    n, i = process_count(), process_index()
    if n == 1:
        return tree

    def f(x):
        if x.shape[axis] % n:
            raise ValueError(
                f'global batch dim {x.shape[axis]} not divisible by '
                f'{n} processes (pad to the global mesh multiple first)')
        b = x.shape[axis] // n
        index = [slice(None)] * x.ndim
        index[axis] = slice(i * b, (i + 1) * b)
        return x[tuple(index)]

    return tree_map(f, tree)


def shard_iterator(iterable):
    """Every process_count-th item, starting at this process's index: the
    process's share of a deterministically ordered stream, for
    per-utterance work that needs no step alignment (evaluation,
    preprocessing)."""
    n, i = process_count(), process_index()
    if n == 1:
        yield from iterable
        return
    for j, item in enumerate(iterable):
        if j % n == i:
            yield item


def any_process(flag: bool) -> bool:
    """The OR of a host boolean over all processes: an ``all_reduce`` MAX
    of one int, which every process must join every time. It coordinates
    an interrupt: a SIGTERM lands on each process at another moment, and a
    collective checkpoint needs every process at the same step."""
    if process_count() == 1:
        return bool(flag)
    group = dist.group.WORLD
    device = ('cuda' if dist.get_backend(group) == 'nccl' else 'cpu')
    value = torch.tensor([int(bool(flag))], device=device)
    return bool(comm.all_reduce_max(value, group, 'any_process').item())


def is_primary() -> bool:
    """True on the process that owns host-side side effects (checkpoint
    writes, metric logs, figures)."""
    return process_index() == 0
