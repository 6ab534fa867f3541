"""Model factory (reference: ppgs/model/core.py:9-25)."""

from ..config import Config
from . import convolution, transformer


def get(config: Config):
    """The (init, forward) pair for config.model. The transformer and the
    convolution model are ported; the wav2vec2 models are queued in
    ROADMAP.md."""
    if config.model == 'transformer':
        return transformer.init, transformer.forward
    if config.model == 'convolution':
        return convolution.init, convolution.forward
    raise ValueError(
        f'Model {config.model!r} is not ported to ppgs_tpu_torch yet; see '
        f'ROADMAP.md for the order of the port')
