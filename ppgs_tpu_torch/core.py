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

File batches (``from_files_to_files(num_workers > 0)``,
``from_dataloader``) go through the data loader (``data/loader.py``): its
thread reads and collates numpy batches, the card runs the frontend and
the model on the main thread, one copy to the host a batch, and a thread
pool saves the outputs.

The parallel branches take the config's mesh (``config.mesh_shape`` /
``mesh_axis_names``) over the process group of ``parallel.multihost``:
``infer`` splits a chunked input's time over a > 1 'seq' axis (context
parallelism, ``parallel/context.py``) and gathers the PPGs;
``from_dataloader`` pads each batch to the 'data' axis, runs each rank's
rows on its device and saves each rank's own files.
"""

import concurrent.futures
import inspect
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

from . import config as config_mod
from . import devices
from . import frontend as frontend_mod
from . import load as load_mod
from . import parallel
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
    model, config = _get_model(representation, checkpoint, base_config,
                               device)

    if (config.frontend is not None
            and representation == config.representation):
        # Codebook FRONTEND: encodec / dac features are cached int codes,
        # dequantized to latents on the device before the extent mask
        # (reference ppgs/core.py:105-115). Padded code frames inside the
        # extent decode to the sum of each level's code 0, as in JAX
        features = frontend_mod.make_frontend(config.frontend)(
            torch.as_tensor(features).to(device))
    features = torch.as_tensor(features).to(device, torch.float32)
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                              device=device)
    B, _, T = features.shape
    phys = T if extent is None else int(extent)
    keep = torch.arange(T, device=device) < phys
    features = features * keep

    if config.model != 'transformer':
        # The raw-audio models (Wav2Vec2.0, W2V2FC: (B, 1, S) audio and
        # sample counts) and the convolution model take the inputs as they
        # are: no chunking (ppgs_tpu/core.py:121-125)
        logits = model(features, lengths)
    elif not legacy_mode and T > config.chunk_length:
        logits = _chunked(model, features, lengths, phys, config)
    else:
        logits = transformer_model.forward(
            model, features, lengths,
            phys_lengths=torch.full((B,), phys, device=device))
    return torch.softmax(logits, dim=1) if softmax else logits


def _chunked(model, features, lengths, phys, config):
    """The chunked forward; with a > 1 'seq' axis on the config's mesh, its
    context-parallel form: each rank runs its slice of the time windows
    (``parallel/context.py``), and the logits are gathered."""
    if 'seq' in config.mesh_axis_names:
        mesh = parallel.make_mesh(config.mesh_shape, config.mesh_axis_names)
        n_seq = mesh.shape.get('seq', 1)
        if n_seq > 1:
            padded, _ = parallel.pad_frames_for_context(features, config,
                                                        n_seq)
            local = parallel.context.shard_frames(padded, mesh, 'seq')
            logits = parallel.context_parallel_chunked_forward(
                model, local, lengths, mesh, 'seq', true_frames=phys)
            logits = parallel.context.gather_frames(logits, mesh, 'seq')
            return logits[..., :features.shape[-1]]
    return transformer_model.chunked_forward(model, features, lengths,
                                             true_frames=phys)


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
    """Infer PPGs from audio files and save each as .npy (reference
    ppgs/core.py:207-272).

    ``num_workers=0``: a file at a time. Otherwise frame-budget batches of
    at most ``max_frames`` (default ``config.max_inference_frames``) from
    the data loader, with ``num_workers // 2`` (at least 1) loader and save
    threads, through ``from_dataloader``; a file's PPGs then depend on the
    batch it lands in (its padding and window geometry), as in the JAX
    package."""
    device = devices.resolve(device)
    config = config_mod.get(config)
    representation = representation or config.representation
    if num_workers == 0:
        for audio_file, output_file in zip(audio_files, output_files):
            from_file_to_file(audio_file, output_file, representation,
                              checkpoint, legacy_mode, config, device)
        return

    from .data import loader as data_loader

    dataloader = data_loader(
        [Path(f) for f in audio_files],
        features=['audio', 'length', 'audio_file'],
        num_workers=max(1, num_workers // 2),
        max_frames=max_frames or config.max_inference_frames,
        config=config)
    # Duplicate audio paths fan out to all their outputs
    mapping = {}
    for audio_file, output_file in zip(audio_files, output_files):
        mapping.setdefault(str(audio_file), []).append(output_file)
    from_dataloader(
        dataloader, mapping, representation=representation,
        checkpoint=checkpoint, save_workers=max(1, num_workers // 2),
        legacy_mode=legacy_mode, config=config, device=device)


MAX_PENDING_SAVES = 100     # saves in flight before the loop waits


def from_dataloader(dataloader, output_files: Dict,
                    representation: str = None, checkpoint=None,
                    save_workers: int = 1, legacy_mode: bool = False,
                    config=None, device=None):
    """Infer PPGs for every batch of a dataloader yielding (audio, length,
    audio_file) and save one .npy per utterance (reference
    ppgs/core.py:280-391).

    ``output_files`` maps an audio filename to an output filename or a
    list of them. The frontend and the model run on ``device`` (None: the
    card, raising without one) on the padded batch, with the batch's
    longest true frame count as the model's extent, as in the JAX package;
    the PPGs come to the host once a batch, and a pool of ``save_workers``
    threads writes each row truncated to its frames.

    Data-parallel branch: in a process group (``parallel.multihost``),
    every rank walks the same batches, pads each to the config mesh's
    'data' axis and runs its own rows (the extent stays the whole batch's)
    and saves their files; the padded rows have none."""
    device = devices.resolve(device)
    config = config_mod.get(config)
    representation = representation or config.representation
    frontend = preprocess.get(representation)
    mesh = None
    if ('data' in config.mesh_axis_names
            and torch.distributed.is_initialized()):
        mesh = parallel.make_mesh(config.mesh_shape, config.mesh_axis_names)

    def extra(whole):
        # a rank's rows keep the whole batch's end reflection (mel,
        # spectrogram: the batch's longest row)
        if mesh is not None and 'valid_samples' in inspect.signature(
                frontend.from_audios).parameters:
            return {'valid_samples': int(np.max(whole))}
        return {}

    pending = []
    with concurrent.futures.ThreadPoolExecutor(max(1, save_workers)) as pool:
        for audios, lengths, batch_files in dataloader:
            audios, lengths = np.asarray(audios), np.asarray(lengths)
            whole = lengths
            if mesh is not None:
                audios, lengths = parallel.shard_batch(
                    mesh, parallel.pad_batch_to_multiple(
                        (audios, lengths), mesh.shape.get('data', 1)),
                    'data')
                first = mesh.index('data') * audios.shape[0]
                batch_files = list(batch_files)[first:first + len(audios)]
            features = frontend.from_audios(
                torch.from_numpy(audios).to(device), lengths,
                config=config, device=device, **extra(whole))
            feat_lengths = np.minimum(lengths // config.hopsize,
                                      features.shape[-1])
            extent = int(np.max(np.minimum(whole // config.hopsize,
                                           features.shape[-1])))
            result = from_features(
                features, feat_lengths, representation=representation,
                checkpoint=checkpoint, legacy_mode=legacy_mode,
                config=config, extent=extent, device=device)
            host = result.cpu().numpy()
            for i, audio_file in enumerate(batch_files):
                outs = output_files[str(audio_file)]
                if not isinstance(outs, (list, tuple)):
                    outs = [outs]
                for out in outs:
                    pending.append(pool.submit(
                        np.save, out, host[i, :, :int(feat_lengths[i])]))
            while len(pending) > MAX_PENDING_SAVES:
                done, not_done = concurrent.futures.wait(
                    pending, return_when=concurrent.futures.FIRST_COMPLETED)
                for future in done:
                    future.result()
                pending = list(not_done)
        for future in pending:
            future.result()


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
