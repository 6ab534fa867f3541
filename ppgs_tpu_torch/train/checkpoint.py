"""Training checkpoints: the JAX package's two backends
(``ppgs_tpu/train/checkpoint.py``).

'npz': ``{step:08d}.npz`` holding the flat keys ``params.*``,
``opt_state.count``, ``opt_state.mu.*`` and ``opt_state.nu.*`` (the JAX
parameter layout, ``convert.model_params_to_jax``), with ``{step:08d}.json``
({step, epoch}) beside it, so a checkpoint of either package resumes in the
other.

'orbax': the JAX package's orbax contract without orbax, which is neither
a dependency of the port nor installed beside the card; orbax's on-disk
format is out of scope. A checkpoint is a step directory ``{step}/``
holding ``state.npz`` (the same flat JAX-layout arrays) and ``meta.json``:

- saves are asynchronous: the state comes to the host on the step thread,
  and a writer thread writes it into ``{step}.partial/`` while training
  goes on;
- saves are collective: every rank calls ``orbax_save`` at the same step
  (the train loop agrees on an interrupted step first); rank 0 writes the
  arrays, and every rank's writer leaves ``process_{rank}.done`` once its
  part is on disk. Rank 0's writer renames the directory to ``{step}/``
  when every rank's marker is there: a step directory is complete or
  absent;
- ``wait_until_finished`` joins this rank's writers and then waits, with
  the others, at a barrier: before exit and before a restore;
- ``orbax_latest`` is the largest complete step directory.

The writers touch files only, never a process group, so nothing they do
can interleave with the step's collectives.
"""

import json
import os
import threading
import time
from pathlib import Path

import numpy as np


def npz_save(directory, step, epoch, flat):
    """Write the flat {key: array} state as {step:08d}.npz (+ .json)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f'{step:08d}.npz'
    np.savez(path, **flat)
    with open(directory / f'{step:08d}.json', 'w') as file:
        json.dump({'step': int(step), 'epoch': int(epoch)}, file)
    return path


def npz_latest(directory):
    """The checkpoint with the largest step in ``directory``, or None."""
    paths = sorted(Path(directory).glob('[0-9]*.npz'))
    return paths[-1] if paths else None


def npz_restore(path):
    """(flat {key: array}, step, epoch) of a checkpoint."""
    with np.load(path) as data:
        flat = {key: data[key] for key in data.files}
    with open(Path(path).with_suffix('.json')) as file:
        meta = json.load(file)
    return flat, meta['step'], meta['epoch']


###############################################################################
# orbax backend (asynchronous, collective step directories)
###############################################################################


COMMIT_TIMEOUT = 600        # seconds rank 0 waits for the ranks' markers

_WRITERS = {}               # resolved directory -> this rank's writers
_SAVED = {}                 # resolved directory -> steps saved here


def _rank_and_count():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def orbax_steps(directory):
    """The complete steps in ``directory``, ascending."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.is_dir() and p.name.isdigit())


def _write(directory, step, epoch, flat, rank, count):
    partial = directory / f'{step}.partial'
    partial.mkdir(parents=True, exist_ok=True)
    if rank == 0:
        np.savez(partial / 'state.npz', **flat)
        with open(partial / 'meta.json', 'w') as file:
            json.dump({'step': int(step), 'epoch': int(epoch)}, file)
    (partial / f'process_{rank}.done').touch()
    if rank != 0:
        return
    deadline = time.time() + COMMIT_TIMEOUT
    while not all((partial / f'process_{r}.done').exists()
                  for r in range(count)):
        if time.time() > deadline:
            raise TimeoutError(f'checkpoint step {step}: not every rank '
                               f'finished its part in {COMMIT_TIMEOUT} s')
        time.sleep(0.01)
    for r in range(count):
        (partial / f'process_{r}.done').unlink()
    os.replace(partial, directory / str(step))


def orbax_save(directory, step, epoch, flat):
    """Save the flat {key: array} state as step directory ``{step}/``
    (collective: every rank calls it at the same step; rank 0's ``flat``
    is written). The arrays are copied to the host here; the files are
    written by a thread. A step already saved is skipped, on every rank
    alike."""
    directory = Path(directory).resolve()
    path = directory / str(step)
    saved = _SAVED.setdefault(str(directory), set())
    if step in saved or step in orbax_steps(directory):
        return path
    saved.add(step)
    rank, count = _rank_and_count()
    host = {k: np.array(v, copy=True) for k, v in flat.items()} \
        if rank == 0 else {}
    writer = _Writer(target=_write,
                     args=(directory, step, epoch, host, rank, count))
    writer.start()
    _WRITERS.setdefault(str(directory), []).append(writer)
    return path


class _Writer(threading.Thread):
    """A writer thread that keeps its exception for ``join``."""

    def run(self):
        self.error = None
        try:
            super().run()
        except BaseException as error:       # re-raised in join_checked
            self.error = error

    def join_checked(self):
        self.join()
        if self.error is not None:
            raise self.error


def wait_until_finished(directory):
    """Block until this rank's pending saves of ``directory`` are on disk,
    then wait for every rank (a barrier), so that every step saved so far
    is complete on return."""
    for writer in _WRITERS.pop(str(Path(directory).resolve()), []):
        writer.join_checked()
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def orbax_latest(directory):
    """The largest complete step directory, or None."""
    steps = orbax_steps(directory)
    return Path(directory) / str(steps[-1]) if steps else None


def orbax_restore(path):
    """(flat {key: array}, step, epoch) of a step directory."""
    path = Path(path)
    with np.load(path / 'state.npz') as data:
        flat = {key: data[key] for key in data.files}
    with open(path / 'meta.json') as file:
        meta = json.load(file)
    return flat, meta['step'], meta['epoch']
