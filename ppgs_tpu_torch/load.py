"""Loading utilities: audio and model parameters (reference: ppgs/load.py).

Checkpoints are the JAX package's flat .npz pytrees ('layers.0.attn.wq',
...), read and written in the same key layout (``ppgs_tpu/load.py:34-73``),
so one file serves both packages; ``model`` also reads the reference's .pt
checkpoints.
"""

import functools
from pathlib import Path

import numpy as np

from . import config as config_mod
from . import convert
from . import devices


def audio(file):
    """Load audio from disk as (1, samples) float32 at the config's rate."""
    from .data import audio as audio_io

    return audio_io.load(file, config_mod.default().sample_rate)


###############################################################################
# Parameter pytree <-> flat npz
###############################################################################


def flatten_params(params, prefix=''):
    """Nested dicts/lists of arrays -> {'a.0.b': array}."""
    flat = {}
    if isinstance(params, dict):
        for key, value in params.items():
            flat.update(flatten_params(value, f'{prefix}{key}.'))
    elif isinstance(params, (list, tuple)):
        for i, value in enumerate(params):
            flat.update(flatten_params(value, f'{prefix}{i}.'))
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


def unflatten_params(flat):
    """{'a.0.b': array} -> nested dicts, with all-digit keys as lists."""
    tree = {}
    for key, value in flat.items():
        parts = key.split('.')
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(tree)


def save_params(path, params):
    np.savez(path, **flatten_params(params))


def load_flat(path):
    """The flat {key: array} contents of a parameter npz."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def load_params(path):
    return unflatten_params(load_flat(path))


def require_file(path, what, script):
    """``path`` as a string, or FileNotFoundError naming the ``script``
    that makes it."""
    if not Path(path).exists():
        raise FileNotFoundError(f'{what} not found at {path}. Convert them '
                                f'with {script} (needs network).')
    return str(path)


@functools.lru_cache(maxsize=8)
def prepared_model(build, path, device, config):
    """``build(config, flat)``'s module from the flat parameters of the npz
    at ``path``, on ``device`` for inference. The last eight (build, path,
    device, config) are kept, so that a frontend reads and prepares its
    weights once."""
    return build(config, load_flat(path)).to(device).eval().requires_grad_(
        False)


###############################################################################
# Model loading
###############################################################################


def model(checkpoint=None, representation=None, config=None, device=None):
    """Load a model for inference (ppgs/load.py:33-81) -> (model, config).

    ``checkpoint`` is a JAX-package .npz, or a reference .pt checkpoint of
    the transformer or the convolution model, converted as it is read
    (``convert.load_torch_checkpoint``, unpickled with ``weights_only``).
    The module is ``config.model``'s (``models.build``): the transformer,
    the convolution model, W2V2 or W2V2FC. Without a checkpoint, W2V2FC
    reads the converted Charsiu weights (``preprocess.w2v2fc.
    W2V2FC_CHECKPOINT``; the reference returns the pretrained model, no
    PPG checkpoint), raising FileNotFoundError naming the converter when
    they are missing. ``device``: None means 'cuda' and raises without a
    CUDA device (``devices.resolve``). The module comes back with its
    compute-dtype copies prepared (``convert.prepare_model``).
    """
    from . import models

    config = config_mod.get(config)
    if representation is not None and representation != config.representation:
        matches = [c for c in config_mod.REGISTRY.values()
                   if c.representation == representation]
        if representation == 'mel':
            matches = [config_mod.REGISTRY['mel']]
        if not matches:
            raise ValueError(
                f'No registered config uses representation '
                f'{representation!r}; supply a config explicitly')
        config = matches[0]
    models.get(config)      # raises for an unknown model
    device = devices.resolve(device)
    if config.model == 'transformer':
        # raises for a width the card's kernels do not take yet
        models.transformer.use_kernels(config, device)

    if checkpoint is None:
        checkpoint = config.local_checkpoint
    if checkpoint is None and config.model == 'W2V2FC':
        from .preprocess import w2v2fc

        checkpoint = require_file(w2v2fc.W2V2FC_CHECKPOINT,
                                  'Charsiu weights',
                                  'scripts/convert_w2v2.py --charsiu')
    if checkpoint is None:
        # The converted checkpoints, under the published names
        name = {'mel': 'mel-800k.npz', 'w2v2fb': 'w2v2fb-425k.npz'}.get(
            config.representation)
        if name is None:
            raise ValueError(
                f'No default checkpoints exist for representation '
                f'{config.representation}')
        checkpoint = config_mod.CHECKPOINT_DIR / name
        if not Path(checkpoint).exists():
            raise FileNotFoundError(
                f'Checkpoint {checkpoint} not found. Convert the published '
                f'reference checkpoint with scripts/convert_checkpoint.py')
    checkpoint = Path(checkpoint)
    if checkpoint.suffix == '.pt':
        if config.model not in ('transformer', 'convolution'):
            raise ValueError(
                f'.pt checkpoints are read for the transformer and the '
                f'convolution model, not {config.model!r}: convert it to '
                f'an npz')
        sd = convert.load_torch_checkpoint(checkpoint)
        params = (convert.transformer_params_from_state_dict(
            sd, num_layers=config.num_hidden_layers)
            if config.model == 'transformer'
            else convert.convolution_params_from_state_dict(sd))
        flat = flatten_params(params)
    else:
        flat = load_flat(checkpoint)
        # Training checkpoints nest model params next to optimizer state
        if any(key.startswith('params.') for key in flat):
            flat = {key[len('params.'):]: value
                    for key, value in flat.items()
                    if key.startswith('params.')}
    module = models.build(config)
    module.load_state_dict(convert.model_params_from_jax(config, flat),
                           strict=True)
    convert.prepare_model(module)
    return module.to(device).eval().requires_grad_(False), config


###############################################################################
# Partitions and class weights
###############################################################################


def partition(dataset):
    """Load the partition dict of a dataset (ppgs/load.py:84-87) from
    ``config.PARTITION_DIR``."""
    import json

    with open(config_mod.PARTITION_DIR / f'{dataset}.json') as file:
        return json.load(file)


def phoneme_weights(config=None, device=None):
    """Class-balancing weights min(count)/count (ppgs/load.py:90-127) as a
    float32 tensor on ``device`` (CPU by default), read from
    ``config.CLASS_WEIGHT_FILE``. When that file is missing they are
    counted over the framewise targets of the training partition, as in
    the JAX package, and written there."""
    import torch

    config = config_mod.get(config)
    path = config_mod.CLASS_WEIGHT_FILE
    if path.exists():
        with np.load(path) as data:
            weights = np.asarray(data['weights'], dtype=np.float32)
    else:
        from .data import Dataset

        dataset = Dataset(config.training_dataset, 'train',
                          features=['phonemes', 'length'], config=config)
        counts = np.zeros(config.output_channels, dtype=np.int64)
        for i in range(len(dataset)):
            phonemes, length = dataset[i]
            valid = np.asarray(phonemes)[:int(length)]
            counts += np.bincount(valid, minlength=config.output_channels)
        weights = (counts.min() / np.maximum(counts, 1)).astype(np.float32)
        np.savez(path, weights=weights)
    return torch.from_numpy(weights).to(device or 'cpu')
