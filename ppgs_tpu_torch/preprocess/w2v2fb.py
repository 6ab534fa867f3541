"""wav2vec 2.0 feature-bottleneck frontend
(reference: ppgs/preprocess/w2v2fb/core.py:32-115; the JAX package's
``ppgs_tpu/preprocess/w2v2fb.py``).

facebook/wav2vec2-base's last hidden state at 50 Hz, nearest-upsampled x2
to 100 Hz. The weights are the JAX package's converted npz
(``W2V2FB_CHECKPOINT``, made once by its scripts/convert_w2v2.py, which
needs the network), read through ``convert.w2v2_params_from_jax``.

With a > 1 'model' axis on the config's mesh over several ranks the trunk
is tensor-parallel (``tp_placement``): each rank holds its slices of the
tensors that the w2v2 rule splits, and the trunk's kernels (B7) run on
each layer's gathered weights.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from .. import convert
from .. import devices
from .. import load as load_mod
from .. import parallel
from ..models import w2v2

# pad = window//2 - hop//2 (reference w2v2fb/core.py:24-25,60)
WINDOW_SIZE = 400
HOP_SIZE = 320
PAD = WINDOW_SIZE // 2 - HOP_SIZE // 2

W2V2FB_CHECKPOINT = config_mod.CHECKPOINT_DIR / 'wav2vec2-base.npz'


def _checkpoint():
    """``W2V2FB_CHECKPOINT``, or FileNotFoundError naming the converter when
    it is missing."""
    return load_mod.require_file(W2V2FB_CHECKPOINT, 'wav2vec2-base weights',
                                 'scripts/convert_w2v2.py')


def _build(config: w2v2.W2V2Config, flat):
    model = w2v2.Wav2Vec2(config)
    model.load_state_dict(convert.w2v2_params_from_jax(flat), strict=True)
    convert.prepare_w2v2(model)
    return model


def _trunk(config: w2v2.W2V2Config, device):
    """The prepared ``Wav2Vec2`` for ``config`` on ``device``."""
    return load_mod.prepared_model(_build, _checkpoint(), torch.device(device),
                                   config)


def tp_placement(wcfg: w2v2.W2V2Config, config, device):
    """The trunk's TP placement (``parallel.frontend_tp_placement`` with the
    w2v2 rule, sharded from the host's copy), or None."""
    if 'model' not in config.mesh_axis_names or parallel.world()[0] < 2:
        return None
    return parallel.frontend_tp_placement(
        _trunk(wcfg, 'cpu'), config, parallel.w2v2_module_dims, device)


def nearest_upsample_indices(in_size: int, out_size: int):
    """torch F.interpolate(mode='nearest') index map: floor(i*in/out)."""
    return (np.arange(out_size) * in_size // out_size).astype(np.int64)


@torch.no_grad()
def from_audios(audio, lengths=None, config=None, device=None):
    """(B, 1, S) audio @16 kHz -> (B, 768, S // hopsize) float32 latents
    @100 Hz on ``device`` (None: the card, raising without one), in the
    config's compute dtype inside (bf16 by default; the fp32 config for
    strict parity)."""
    device = devices.resolve(device)
    config = config_mod.get(config)
    audio = torch.as_tensor(audio).to(device)
    B, S = audio.shape[0], audio.shape[-1]
    if lengths is None:
        lengths = np.full((B,), S)
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                              device=device)
    out_frames = S // config.hopsize
    wcfg = dataclasses.replace(w2v2.BASE, compute_dtype=config.compute_dtype)
    padded = F.pad(audio.float(), (PAD, PAD)).reshape(B, S + 2 * PAD)
    placement = tp_placement(wcfg, config, device)
    if placement is None:
        hidden = w2v2.forward(_trunk(wcfg, device), padded,
                              lengths + 2 * PAD, wcfg)
    else:
        hidden = placement.run(
            lambda trunk, a, n: w2v2.forward(trunk, a, n, wcfg), padded,
            lengths + 2 * PAD)
    hidden = hidden.transpose(1, 2)                       # (B, 768, T50)
    idx = torch.from_numpy(nearest_upsample_indices(
        hidden.shape[-1], out_frames)).to(device)
    return hidden[..., idx].float()


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
