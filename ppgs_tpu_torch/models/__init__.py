"""Model factory (reference: ppgs/model/core.py:9-25)."""

from ..config import Config
from . import convolution, transformer, w2v2_ppg


def get(config: Config):
    """The (init, forward) pair for config.model: ``init(config,
    generator)`` gives random parameters in the JAX package's layout,
    ``forward(module, features, lengths, ...)`` runs the module that
    ``build`` makes."""
    if config.model == 'transformer':
        return transformer.init, transformer.forward
    if config.model == 'convolution':
        return convolution.init, convolution.forward
    if config.model == 'Wav2Vec2.0':
        return w2v2_ppg.init, w2v2_ppg.forward
    if config.model == 'W2V2FC':
        return w2v2_ppg.fc_init, w2v2_ppg.fc_forward
    raise ValueError(f'Model {config.model} is not defined')


def build(config: Config):
    """The ``nn.Module`` of config.model, its parameters not yet loaded."""
    get(config)         # raises for an unknown model
    return {'transformer': transformer.Transformer,
            'convolution': convolution.Convolution,
            'Wav2Vec2.0': w2v2_ppg.W2V2,
            'W2V2FC': w2v2_ppg.W2V2FC}[config.model](config)
