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

    ``checkpoint`` is a JAX-package .npz, or a reference .pt checkpoint
    converted as it is read (``convert.load_torch_checkpoint``, unpickled
    with ``weights_only``). The module is ``config.model``'s: the
    transformer or the convolution model. ``device``: None means 'cuda' and
    raises without a CUDA device (``devices.resolve``). A transformer comes
    back with its encoder weights prepared for its compute dtype
    (``convert.prepare``).
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
    models.get(config)      # raises for a model that is not ported
    device = devices.resolve(device)
    transformer = config.model == 'transformer'
    if transformer:
        # raises for a width the card's kernels do not take yet
        models.transformer.use_kernels(config, device)

    if checkpoint is None:
        checkpoint = config.local_checkpoint
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
        sd = convert.load_torch_checkpoint(checkpoint)
        params = (convert.transformer_params_from_state_dict(
            sd, num_layers=config.num_hidden_layers) if transformer
            else convert.convolution_params_from_state_dict(sd))
        flat = flatten_params(params)
    else:
        flat = load_flat(checkpoint)
        # Training checkpoints nest model params next to optimizer state
        if any(key.startswith('params.') for key in flat):
            flat = {key[len('params.'):]: value
                    for key, value in flat.items()
                    if key.startswith('params.')}
    if transformer:
        module = models.transformer.Transformer(config)
        module.load_state_dict(convert.params_from_jax(flat), strict=True)
        convert.prepare(module)
    else:
        module = models.convolution.Convolution(config)
        module.load_state_dict(convert.convolution_params_from_jax(flat),
                               strict=True)
    return module.to(device).eval().requires_grad_(False), config


###############################################################################
# Class weights
###############################################################################


def phoneme_weights(config=None, device=None):
    """Class-balancing weights min(count)/count (ppgs/load.py:90-127), read
    from the JAX package's asset by path, as a float32 tensor on ``device``
    (CPU by default). Computing them from the training partition needs the
    dataset loaders, which are not ported yet (ROADMAP.md A7)."""
    import torch

    config = config_mod.get(config)
    path = config_mod.CLASS_WEIGHT_FILE
    if not path.exists():
        raise NotImplementedError(
            f'{path} is missing, and computing the phoneme weights from '
            f'the {config.training_dataset} partition needs the dataset '
            f'loaders, which ppgs_tpu_torch does not port yet (ROADMAP.md '
            f'A7)')
    with np.load(path) as data:
        weights = np.asarray(data['weights'], dtype=np.float32)
    return torch.from_numpy(weights).to(device or 'cpu')
