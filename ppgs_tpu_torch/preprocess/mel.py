"""Log-mel spectrogram frontend (reference: ppgs/preprocess/mel.py:14-76).

Framing, windowed DFT, magnitude, mel projection and log compression; see
ops/stft.py. Float32 on every config, unless a bf16 config opts in with
``PPGS_TPU_FUSED_MEL=1``: then the fused bf16 kernel B9 runs
(``ops/stft.py::fused_log_mel``), as the JAX package's opt-in does.
"""

import os

import numpy as np
import torch

from .. import config as config_mod
from .. import devices
from ..ops import stft as stft_ops


def use_fused_mel(config) -> bool:
    """The JAX package's opt-in (``ppgs_tpu/ops/stft.py:270-285``): a bf16
    config and ``PPGS_TPU_FUSED_MEL=1``. The TPU backend check has no
    counterpart: on the CPU the kernel's plain version runs."""
    return (config.compute_dtype == 'bfloat16'
            and os.environ.get('PPGS_TPU_FUSED_MEL', '0') == '1')


def from_audios(audio, lengths=None, config=None, device=None):
    """(B, 1, S) audio -> (B, num_mels, T) float32 log-mel on ``device``
    (None: the card, raising without one).

    ``lengths``: per-row valid sample counts; the end reflection lands at
    their maximum (the true batch end), not at the padded S.
    """
    device = devices.resolve(device)
    config = config_mod.get(config)
    valid = int(np.max(np.asarray(lengths))) if lengths is not None else None
    spectrogram = (stft_ops.fused_log_mel_spectrogram if use_fused_mel(config)
                   else stft_ops.log_mel_spectrogram)
    return spectrogram(
        torch.as_tensor(audio).to(device),
        sample_rate=config.sample_rate,
        num_fft=config.num_fft,
        hopsize=config.hopsize,
        window_size=config.window_size,
        num_mels=config.num_mels,
        valid_samples=valid)


def from_audio(audio, sample_rate=None, config=None, device=None):
    """(1, S) or (B, 1, S) audio -> (B, num_mels, T). ``sample_rate`` is
    taken second and ignored, as by every frontend (the audio is at
    ``config.sample_rate``)."""
    audio = torch.as_tensor(audio)
    if audio.ndim == 2:
        audio = audio[None]
    return from_audios(audio, config=config, device=device)


def from_file(audio_file, config=None, device=None):
    from ..data import audio as audio_io

    return from_audio(audio_io.load(audio_file), config=config, device=device)


def from_file_to_file(audio_file, output_file, config=None, device=None):
    np.save(output_file, from_file(audio_file, config, device).cpu().numpy())
