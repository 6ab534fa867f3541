from . import bottleneck, mel, spectrogram, w2v2fb, w2v2fc, w2v2ft
from .core import (
    datasets,
    from_audio,
    from_audios,
    from_dataloader,
    from_files_to_files,
    save_masked,
)

_PORTED = {'mel': mel, 'w2v2fb': w2v2fb, 'w2v2fc': w2v2fc, 'w2v2ft': w2v2ft,
           'bottleneck': bottleneck, 'spectrogram': spectrogram}
# The JAX package's frontends that wait for the codec frontend's port
_QUEUED = ('encodec', 'dac')


def get(representation: str):
    """Frontend for a representation (reference: ppgs/core.py:333-336).
    Every frontend of the JAX package is ported but the codec ones, queued
    in ROADMAP.md; any other name raises ValueError('Unknown
    representation ...'), as in the JAX package ('wav', the w2v2ft
    config's representation, among them)."""
    if representation in _PORTED:
        return _PORTED[representation]
    if representation in _QUEUED:
        raise ValueError(
            f'Representation {representation!r} is not ported to '
            f'ppgs_tpu_torch yet (see ROADMAP.md); {", ".join(_PORTED)} are '
            f'available')
    raise ValueError(f'Unknown representation {representation}')
