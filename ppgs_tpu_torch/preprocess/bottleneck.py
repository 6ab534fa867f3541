"""ASR bottleneck frontend (reference: ppgs/preprocess/bottleneck/core.py +
conformer_ppg_model/{stft,frontend,log_mel,utterance_mvn}.py; the JAX
package's ``ppgs_tpu/preprocess/bottleneck.py``).

Pad 432 -> STFT (n_fft 1024, a rectangular 800-sample window centred in
1024, hop 160, center=False) -> power spectrum -> mel (slaney) ->
log(x + 1e-20) -> utterance MVN -> the 16-block conformer
(``models/conformer.py``) -> (B, 144, T) at 100 Hz. The DSP runs in fp32
on every config (the STFT is the mel frontend's DFT-as-conv with this
window, ``ops/stft.py``); the conformer in the config's compute dtype.

Reference quirks kept, since the model was trained with them:
utterance_mvn divides by sqrt(std) = var ** 0.25 (utterance_mvn.py:69-74),
and its variance sum includes the -mean of the padded frames.

The weights are the JAX package's converted npz (``BOTTLENECK_CHECKPOINT``,
made from the published ``24epoch.pth`` by its scripts/convert_conformer.py,
which needs the network; ``convert.conformer_params_from_checkpoint``
converts it without JAX). With a > 1 'model' axis on the config's mesh
over several ranks the conformer is tensor-parallel
(``parallel.frontend_tp_placement`` with the conformer rule): each rank
holds its slices of the blocks' split tensors, and B8 runs on each block's
gathered weights.
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from .. import convert
from .. import devices
from .. import load as load_mod
from .. import parallel
from ..models import conformer
from ..ops import filterbank
from ..ops import stft as stft_ops

N_FFT = 1024
WIN_LENGTH = 800
HOP = 160
PAD = N_FFT // 2 - HOP // 2         # 432

BOTTLENECK_CHECKPOINT = config_mod.CHECKPOINT_DIR / 'conformer-24epoch.npz'


def _checkpoint():
    """``BOTTLENECK_CHECKPOINT``, or FileNotFoundError naming the converter
    when it is missing."""
    return load_mod.require_file(BOTTLENECK_CHECKPOINT, 'Conformer weights',
                                 'scripts/convert_conformer.py')


def _build(config: conformer.ConformerConfig, flat):
    model = conformer.Conformer(config)
    model.load_state_dict(convert.conformer_params_from_jax(flat), strict=True)
    convert.prepare_conformer(model)
    return model


def _encoder(config: conformer.ConformerConfig, device):
    """The prepared ``Conformer`` for ``config`` on ``device``."""
    return load_mod.prepared_model(_build, _checkpoint(), torch.device(device),
                                   config)


@functools.lru_cache(maxsize=1)
def _dft_basis():
    """Rectangular-window (800 samples, centred in 1024) real-DFT filters
    (2 * 513, 1024)."""
    n_freqs = N_FFT // 2 + 1
    n = np.arange(N_FFT, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    angle = 2.0 * np.pi * np.outer(k, n) / N_FFT
    window = np.zeros(N_FFT)
    start = (N_FFT - WIN_LENGTH) // 2
    window[start:start + WIN_LENGTH] = 1.0
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=0) * window
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _mel_basis():
    return filterbank.mel_filterbank(16000, N_FFT, 80)


@functools.lru_cache(maxsize=4)
def _weights(device):
    """The DFT basis re-blocked for the hop-channel conv, as a torch conv
    weight (2F, hop, J), and the mel basis (80, F), on ``device``."""
    kernel = stft_ops.block_analysis_kernel(_dft_basis(), HOP)  # (J, hop, 2F)
    return (torch.from_numpy(np.ascontiguousarray(
                kernel.transpose(2, 1, 0))).to(device),
            torch.from_numpy(_mel_basis()).to(device))


def log_mel_power(audio, lengths):
    """(B, P) padded fp32 audio, (B,) int64 lengths -> ((B, T, 80) log-mel
    power features, zero past each row's frames, olens)."""
    weight, mel_basis = _weights(audio.device)
    taps = weight.shape[-1]
    B, P = audio.shape
    if P < N_FFT:
        raise ValueError(
            f'Audio too short for the bottleneck frontend: {P} padded '
            f'samples < one {N_FFT}-sample analysis window (need at least '
            f'{N_FFT - 2 * PAD} raw samples before the +/-{PAD} padding).')
    T = (P - N_FFT) // HOP + 1
    # Hop-sized channels; basis columns past N_FFT are zero, so the zero
    # tail up to (T + J - 1) * hop is exact
    need = (T + taps - 1) * HOP
    x = F.pad(audio, (0, max(0, need - P)))[:, :need]
    out = F.conv1d(x.reshape(B, T + taps - 1, HOP).transpose(1, 2), weight)
    n_freqs = N_FFT // 2 + 1
    real, imag = out[:, :n_freqs], out[:, n_freqs:]
    power = (real * real + imag * imag).transpose(1, 2)     # (B, T, F)
    logmel = torch.log(power @ mel_basis.T + 1e-20)
    olens = (lengths - N_FFT + HOP) // HOP
    mask = torch.arange(T, device=audio.device)[None] < olens[:, None]
    return logmel.masked_fill(~mask[..., None], 0.0), olens


def utterance_mvn(x, olens):
    """Reference MVN with its quirks (see the module docstring)."""
    mask = torch.arange(x.shape[1], device=x.device)[None] < olens[:, None]
    x = x.masked_fill(~mask[..., None], 0.0)
    denom = olens[:, None, None].to(x.dtype)
    mean = x.sum(dim=1, keepdim=True) / denom
    x = x - mean
    var = (x ** 2).sum(dim=1, keepdim=True) / denom
    std = torch.sqrt(var).clamp_min(1e-20)
    return x / torch.sqrt(std)


@torch.no_grad()
def from_audios(audio, lengths=None, config=None, device=None):
    """(B, 1, S) audio @16 kHz -> (B, 144, S // 160) float32 bottleneck
    latents on ``device`` (None: the card, raising without one). The
    conformer runs in the config's compute dtype (bf16 by default; the fp32
    config for strict parity)."""
    device = devices.resolve(device)
    config = config_mod.get(config)
    audio = torch.as_tensor(audio).to(device, torch.float32)
    B, S = audio.shape[0], audio.shape[-1]
    if lengths is None:
        lengths = np.full((B,), S)
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                              device=device) + 2 * PAD
    padded = F.pad(audio.reshape(B, S), (PAD, PAD))
    feats, olens = log_mel_power(padded, lengths)
    feats = utterance_mvn(feats, olens)
    ccfg = dataclasses.replace(conformer.BOTTLENECK,
                               compute_dtype=config.compute_dtype)
    placement = None
    if 'model' in config.mesh_axis_names and parallel.world()[0] > 1:
        placement = parallel.frontend_tp_placement(
            _encoder(ccfg, 'cpu'), config, parallel.conformer_module_dims,
            device)
    if placement is None:
        out = conformer.forward(_encoder(ccfg, device), feats, olens)
    else:
        out = placement.run(conformer.forward, feats, olens)
    return out.transpose(1, 2)                            # (B, 144, T)


def from_audio(audio, sample_rate=None, config=None, device=None):
    """(1, S) or (B, 1, S) audio -> (B, 144, S // 160) latents."""
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
