"""Training checkpoints: the JAX package's npz backend
(``ppgs_tpu/train/checkpoint.py``), in the same file layout.

A checkpoint is ``{step:08d}.npz`` holding the flat keys ``params.*``,
``opt_state.count``, ``opt_state.mu.*`` and ``opt_state.nu.*`` (the JAX
parameter layout, ``convert.model_params_to_jax``), with ``{step:08d}.json``
({step, epoch}) beside it, so a checkpoint of either package resumes in the
other. The orbax backend is not ported.
"""

import json
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
