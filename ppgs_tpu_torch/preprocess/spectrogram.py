"""Magnitude spectrogram frontend (reference: ppgs/preprocess/spectrogram.py).

Counterpart of ``ppgs_tpu/preprocess/spectrogram.py``: the fp32 magnitude
STFT of ``ops/stft.py``, with the frontends' protocol (``from_audios``,
``from_audio``, ``from_file``, ``from_file_to_file``) and a ``device``.
"""

import numpy as np
import torch

from .. import config as config_mod
from .. import devices
from ..ops import stft as stft_ops


def from_audios(audio, lengths=None, config=None, device=None):
    """(B, 1, S) audio -> (B, num_fft // 2 + 1, T) float32 magnitudes on
    ``device`` (None: the card, raising without one).

    ``lengths``: per-row valid sample counts; the end reflection lands at
    their maximum (the true batch end), not at the padded S.
    """
    device = devices.resolve(device)
    config = config_mod.get(config)
    valid = int(np.max(np.asarray(lengths))) if lengths is not None else None
    return stft_ops.magnitude_spectrogram(
        torch.as_tensor(audio).to(device), config.num_fft, config.hopsize,
        config.window_size, valid_samples=valid)


def from_audio(audio, sample_rate=None, config=None, device=None):
    """(1, S) or (B, 1, S) audio -> (B, num_fft // 2 + 1, T).
    ``sample_rate`` is ignored, as by every frontend."""
    audio = torch.as_tensor(audio)
    if audio.ndim == 2:
        audio = audio[None]
    return from_audios(audio, config=config, device=device)


def from_file(audio_file, config=None, device=None):
    from ..data import audio as audio_io

    return from_audio(audio_io.load(audio_file), config=config, device=device)


def from_file_to_file(audio_file, output_file, config=None, device=None):
    np.save(output_file, from_file(audio_file, config, device).cpu().numpy())
