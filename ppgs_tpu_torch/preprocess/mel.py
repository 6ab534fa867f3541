"""Log-mel spectrogram frontend (reference: ppgs/preprocess/mel.py:14-76).

Framing, windowed DFT, magnitude, mel projection and log compression; see
ops/stft.py. Float32 on every config.
"""

import numpy as np
import torch

from .. import config as config_mod
from ..ops import stft as stft_ops


def from_audios(audio, lengths=None, config=None):
    """(B, 1, S) audio tensor -> (B, num_mels, T) float32 log-mel.

    ``lengths``: per-row valid sample counts; the end reflection lands at
    their maximum (the true batch end), not at the padded S.
    """
    config = config_mod.get(config)
    valid = int(np.max(np.asarray(lengths))) if lengths is not None else None
    return stft_ops.log_mel_spectrogram(
        audio,
        sample_rate=config.sample_rate,
        num_fft=config.num_fft,
        hopsize=config.hopsize,
        window_size=config.window_size,
        num_mels=config.num_mels,
        valid_samples=valid)


def from_audio(audio, config=None):
    """(1, S) or (B, 1, S) audio tensor -> (B, num_mels, T)."""
    audio = torch.as_tensor(audio)
    if audio.ndim == 2:
        audio = audio[None]
    return from_audios(audio, config=config)
