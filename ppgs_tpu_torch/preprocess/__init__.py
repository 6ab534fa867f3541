from . import bottleneck, mel, spectrogram, w2v2fb, w2v2fc, w2v2ft
from . import encodec, dac
from .core import (
    datasets,
    from_audio,
    from_audios,
    from_dataloader,
    from_files_to_files,
    save_masked,
)

_FRONTENDS = {'mel': mel, 'w2v2fb': w2v2fb, 'w2v2fc': w2v2fc,
              'w2v2ft': w2v2ft, 'bottleneck': bottleneck,
              'spectrogram': spectrogram, 'encodec': encodec, 'dac': dac}


def get(representation: str):
    """Frontend for a representation (reference: ppgs/core.py:333-336).
    Every frontend of the JAX package is ported; any other name raises
    ValueError('Unknown representation ...'), as in the JAX package
    ('wav', the w2v2ft config's representation, among them)."""
    if representation in _FRONTENDS:
        return _FRONTENDS[representation]
    raise ValueError(f'Unknown representation {representation}')
