"""Raw-audio passthrough frontend for end-to-end wav2vec2 fine-tuning
(reference: ppgs/preprocess/w2v2ft/core.py:32-69, representation 'wav';
the JAX package's ``ppgs_tpu/preprocess/w2v2ft.py``).

Resamples to 16 kHz and pads by window // 2 - hop // 2 on each side.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from .. import devices

WINDOW_SIZE = 400
HOP_SIZE = 160
PAD = WINDOW_SIZE // 2 - HOP_SIZE // 2


def from_audios(audio, lengths=None, config=None, device=None):
    """(B, 1, S) or (B, S) audio -> (B, S + 2 PAD) float32 on ``device``
    (None: the card, raising without one)."""
    device = devices.resolve(device)
    audio = torch.as_tensor(audio).to(device, torch.float32)
    if audio.ndim == 3:
        audio = audio.squeeze(1)
    return F.pad(audio, (PAD, PAD))


def from_audio(audio, sample_rate=None, config=None, device=None):
    """(1, S) or (B, 1, S) audio at ``sample_rate`` (resampled to the
    config's rate on the host) -> (B, S' + 2 PAD)."""
    config = config_mod.get(config)
    if sample_rate is not None and sample_rate != config.sample_rate:
        from ..data import audio as audio_io

        if isinstance(audio, torch.Tensor):
            audio = audio.cpu().numpy()
        audio = audio_io.resample(np.asarray(audio), sample_rate,
                                  config.sample_rate)
    audio = torch.as_tensor(audio)
    if audio.ndim == 2:
        audio = audio[None]
    return from_audios(audio, config=config, device=device)


def from_file(audio_file, config=None, device=None):
    from ..data import audio as audio_io

    return from_audio(audio_io.load(audio_file), config=config, device=device)


def from_file_to_file(audio_file, output_file, config=None, device=None):
    np.save(output_file, from_file(audio_file, config, device).cpu().numpy()
            .astype(np.float16))


def from_files_to_files(audio_files, output_files, config=None, device=None):
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, config, device)
