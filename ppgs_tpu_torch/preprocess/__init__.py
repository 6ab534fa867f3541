from . import bottleneck, mel, spectrogram, w2v2fb

_PORTED = {'mel': mel, 'w2v2fb': w2v2fb, 'bottleneck': bottleneck,
           'spectrogram': spectrogram}


def get(representation: str):
    """Frontend for a representation. ``mel``, ``w2v2fb``, ``bottleneck``
    and ``spectrogram`` are ported so far; the other frontends of the JAX
    package are queued in ROADMAP.md."""
    if representation in _PORTED:
        return _PORTED[representation]
    raise ValueError(
        f'Representation {representation!r} is not ported to ppgs_tpu_torch '
        f'yet (see ROADMAP.md); {", ".join(_PORTED)} are available')
