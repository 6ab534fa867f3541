"""Charsiu wav2vec2 frame-classifier latent frontend
(reference: ppgs/preprocess/w2v2fc/core.py:31-110; the JAX package's
``ppgs_tpu/preprocess/w2v2fc.py``).

768-d hidden states at 100 Hz from the charsiu/en_w2v2_fc_10ms trunk (the
stride-1 wav2vec2 variant, ``models.w2v2_ppg.w2v2_100hz_config``), with the
plain feature-level mask (no ``mask_config``). The weights are the JAX
package's converted npz of the W2V2FC model (``W2V2FC_CHECKPOINT``, made
by its scripts/convert_w2v2.py --charsiu, which needs the network); the
frontend reads its 'w2v2.*' trunk.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from .. import devices
from .. import load as load_mod
from ..models import w2v2, w2v2_ppg
from ..models.w2v2_ppg import PADDING
from . import w2v2fb

W2V2FC_CHECKPOINT = config_mod.CHECKPOINT_DIR / 'charsiu-w2v2-fc.npz'


def _checkpoint():
    """``W2V2FC_CHECKPOINT``, or FileNotFoundError naming the converter when
    it is missing."""
    return load_mod.require_file(W2V2FC_CHECKPOINT, 'Charsiu weights',
                                 'scripts/convert_w2v2.py --charsiu')


def _build(config: w2v2.W2V2Config, flat):
    """The trunk of a W2V2FC parameter file: its 'w2v2.*' leaves."""
    return w2v2fb._build(config, {key[len('w2v2.'):]: value
                                  for key, value in flat.items()
                                  if key.startswith('w2v2.')})


def _trunk(config: w2v2.W2V2Config, device):
    """The prepared 100 Hz ``Wav2Vec2`` for ``config`` on ``device``."""
    return load_mod.prepared_model(_build, _checkpoint(), torch.device(device),
                                   config)


@torch.no_grad()
def from_audios(audio, lengths=None, config=None, device=None):
    """(B, 1, S) audio @16 kHz -> (B, 768, S // hopsize) float32 latents
    @100 Hz on ``device`` (None: the card, raising without one), in the
    config's compute dtype inside."""
    device = devices.resolve(device)
    config = config_mod.get(config)
    audio = torch.as_tensor(audio).to(device)
    B, S = audio.shape[0], audio.shape[-1]
    if lengths is None:
        lengths = np.full((B,), S)
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                              device=device)
    wcfg = w2v2_ppg.w2v2_100hz_config(config.compute_dtype)
    padded = F.pad(audio.float(), (PADDING, PADDING)).reshape(
        B, S + 2 * PADDING)
    hidden = w2v2.forward(_trunk(wcfg, device), padded,
                          lengths + 2 * PADDING, wcfg)
    frames = S // config.hopsize
    return hidden.transpose(1, 2)[..., :frames].float()


def from_audio(audio, sample_rate=None, config=None, device=None):
    """(1, S) or (B, 1, S) audio -> (B, 768, S // hopsize) latents."""
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
