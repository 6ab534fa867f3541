"""Model factory (reference: ppgs/model/core.py:9-25)."""

from ..config import Config
from . import transformer


def get(config: Config):
    """The (init, forward) pair for config.model. Only the transformer is
    ported so far; the other models are queued in ROADMAP.md."""
    if config.model == 'transformer':
        return transformer.init, transformer.forward
    raise ValueError(
        f'Model {config.model!r} is not ported to ppgs_tpu_torch yet; see '
        f'ROADMAP.md for the order of the port')
