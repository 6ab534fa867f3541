"""Inference API (reference: ppgs/core.py:22-391,551-621).

from_audio -> from_features -> infer, with a model cache; counterpart of
``ppgs_tpu/core.py``. Every entry point takes ``device``: None means
'cuda', and without a CUDA device the call raises instead of running on
the CPU; tests pass ``device='cpu'``.

The JAX package rounds the frame count up to a multiple of the chunk
stride so that XLA's compile cache is reused; PyTorch runs eagerly, so the
port drops that bucketing and runs at the true T. The outputs agree (the
padded frames were masked there), which tests/test_torch_slice.py checks
at frame counts that are not multiples of the stride.

Not ported yet (ROADMAP.md): from_files_to_files with workers (A7),
from_dataloader, and the context- and data-parallel branches.
"""

from typing import Dict, Union

import numpy as np
import torch

from . import config as config_mod
from . import devices
from . import load as load_mod
from . import preprocess
from .models import transformer as transformer_model


###############################################################################
# Model cache
###############################################################################


_MODEL_CACHE: Dict[tuple, tuple] = {}


def _get_model(representation, checkpoint, config, device):
    key = (representation, str(checkpoint), config, str(device))
    if key not in _MODEL_CACHE:
        _MODEL_CACHE[key] = load_mod.model(
            checkpoint=checkpoint, representation=representation,
            config=config, device=device)
    return _MODEL_CACHE[key]


###############################################################################
# API
###############################################################################


@torch.no_grad()
def infer(features, lengths, representation='mel', checkpoint=None,
          softmax=True, legacy_mode=False, config=None, extent=None,
          device=None):
    """Model inference on (B, C, T) features (reference ppgs/core.py:551-598).

    Returns (B, num_phonemes, T) posteriorgrams (or logits if
    softmax=False) on ``device``.

    ``extent``: the physical frame extent of the equivalent reference
    tensor (batch-max frame length). Frames in [extent, T) are zeroed
    before the input conv: in the reference they do not exist and the conv
    zero-pads there. Defaults to T.
    """
    device = devices.resolve(device)
    base_config = config_mod.get(config)
    if base_config.representation_kind == 'latents':
        return features
    config_mod.require_no_frontend(base_config)
    model, config = _get_model(representation, checkpoint, base_config,
                               device)

    features = torch.as_tensor(features).to(device, torch.float32)
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                              device=device)
    B, _, T = features.shape
    phys = T if extent is None else int(extent)
    keep = torch.arange(T, device=device) < phys
    features = features * keep

    if config.model != 'transformer':
        # The convolution model takes the features as they are: no
        # chunking (ppgs_tpu/core.py:121-125)
        logits = model(features, lengths)
    elif not legacy_mode and T > config.chunk_length:
        logits = transformer_model.chunked_forward(
            model, features, lengths, true_frames=phys)
    else:
        logits = transformer_model.forward(
            model, features, lengths,
            phys_lengths=torch.full((B,), phys, device=device))
    return torch.softmax(logits, dim=1) if softmax else logits


def from_audio(audio, sample_rate: Union[int, float] = None,
               representation: str = None, checkpoint=None, lengths=None,
               legacy_mode: bool = False, config=None, device=None):
    """Infer PPGs from batched audio (B, 1, S) -> (B, P, frames).

    ``audio`` is a numpy array or a tensor (a tensor already on the device
    is used in place when no resampling is needed). ``lengths``: per-row
    valid sample counts (B,), defaulting to S for every row. With
    variable-length rows, zero-pad the audio to a common S, pass the true
    lengths here, and read each row's first ``lengths[i] // hopsize``
    frames. The frontend runs on the padded batch, as in the JAX package.
    """
    device = devices.resolve(device)
    config = config_mod.get(config)
    representation = representation or config.representation
    sample_rate = sample_rate or config.sample_rate

    if audio.ndim == 2:
        audio = audio[None]
    B = audio.shape[0]
    if lengths is not None:
        lengths = np.asarray(lengths, dtype=np.int64).reshape(-1)
        if lengths.shape[0] != B:
            raise ValueError(
                f'lengths has {lengths.shape[0]} entries for batch size {B}')
    if sample_rate != config.sample_rate:
        from .data import audio as audio_io

        if isinstance(audio, torch.Tensor):
            audio = audio.cpu().numpy()
        audio = audio_io.resample(np.asarray(audio, np.float32), sample_rate,
                                  config.sample_rate)
        if lengths is not None:
            lengths = np.minimum(
                np.round(lengths * (config.sample_rate / sample_rate)),
                audio.shape[-1]).astype(np.int64)
    audio = torch.as_tensor(audio).to(device, torch.float32)

    full = lengths is None
    if full:
        lengths = np.full((B,), audio.shape[-1], dtype=np.int64)

    features = preprocess.get(representation).from_audios(
        audio, lengths, config=config, device=device)
    if full:
        feat_lengths = np.full((B,), features.shape[-1], dtype=np.int64)
    else:
        feat_lengths = np.minimum(
            lengths // config.hopsize, features.shape[-1])
    return from_features(
        features, feat_lengths, representation=representation,
        checkpoint=checkpoint, legacy_mode=legacy_mode, config=config,
        extent=None if full else int(np.max(feat_lengths)), device=device)


def from_features(features, lengths, representation: str = None,
                  checkpoint=None, softmax: bool = True,
                  legacy_mode: bool = False, config=None, extent: int = None,
                  device=None):
    """Infer PPGs from input features (B, C, T)."""
    config = config_mod.get(config)
    return infer(
        features=features, lengths=lengths,
        representation=representation or config.representation,
        checkpoint=checkpoint, softmax=softmax, legacy_mode=legacy_mode,
        config=config, extent=extent, device=device)


def from_file(file, representation: str = None, checkpoint=None,
              legacy_mode: bool = False, config=None, device=None):
    """Infer PPGs from an audio file -> (P, frames)."""
    audio = load_mod.audio(file)
    return from_audio(
        audio[None], representation=representation, checkpoint=checkpoint,
        legacy_mode=legacy_mode, config=config, device=device)[0]


def from_file_to_file(audio_file, output_file, representation: str = None,
                      checkpoint=None, legacy_mode: bool = False,
                      config=None, device=None):
    """Infer PPGs from an audio file and save them as .npy."""
    result = from_file(audio_file, representation, checkpoint, legacy_mode,
                       config, device)
    np.save(output_file, result.cpu().numpy())


def from_files_to_files(audio_files, output_files, representation=None,
                        checkpoint=None, num_workers: int = 0,
                        max_frames: int = None, legacy_mode: bool = False,
                        config=None, device=None):
    """Infer PPGs from audio files and save each as .npy, one file at a
    time (reference ppgs/core.py:207-272, ``num_workers=0``).
    ``max_frames`` batches the worker path only, as in the JAX package.
    The worker path (frame-budget batches from the data loader) waits for
    the port of the data pipeline: ``num_workers > 0`` raises."""
    if num_workers > 0:
        raise NotImplementedError(
            'from_files_to_files(num_workers > 0) batches through the data '
            'loader, which ppgs_tpu_torch does not port yet (ROADMAP.md A7); '
            'pass num_workers=0')
    device = devices.resolve(device)
    config = config_mod.get(config)
    representation = representation or config.representation
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, representation,
                          checkpoint, legacy_mode, config, device)


def resample(audio, sample_rate, target_rate=None):
    """Audio resampling (reference ppgs/core.py:600-609), on the host."""
    from .data import audio as audio_io

    target_rate = target_rate or config_mod.default().sample_rate
    return audio_io.resample(np.asarray(audio), sample_rate, target_rate)


def representation_file_extension(config=None):
    """Cache filename suffix for the config's representation (reference
    ppgs/core.py:612-621), with .npy instead of .pt."""
    config = config_mod.get(config)
    if (config.representation == config.best_representation
            and config.representation_kind == 'ppg'):
        return '-ppg.npy'
    if config.representation_kind == 'ppg':
        return f'-{config.representation}-ppg.npy'
    return f'-{config.representation}.npy'
