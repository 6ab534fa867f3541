"""STFT and log-mel spectrogram as one strided convolution plus products.

Framing + Hann windowing + real DFT are one convolution whose filters are
the windowed DFT basis, re-blocked so that the audio enters as hop-sized
channels (see ``block_analysis_kernel``). The magnitude, the mel product and
the log compression follow as plain tensor ops. This runs in float32 on
both the fp32 and the bf16 configs, as the JAX package's production path
runs XLA, not a kernel. On the card, TF32 must be off for the convolution
(``devices.resolve`` turns it off), or cuDNN runs it at about three decimal
digits. The JAX package's opt-in bf16 kernel (``PPGS_TPU_FUSED_MEL=1``) is
B9, ``fused_log_mel``, at the end of this module.

(reference: ppgs/preprocess/spectrogram.py:14-74, ppgs/preprocess/mel.py:14-76;
JAX counterpart: ppgs_tpu/ops/stft.py)
"""

import functools

import numpy as np
import torch

from .. import kernels
from . import filterbank


###############################################################################
# DFT basis construction (host-side, cached)
###############################################################################


@functools.lru_cache(maxsize=4)
def dft_basis(num_fft: int, window_size: int):
    """Windowed real-DFT filters, shape (2 * n_freqs, num_fft).

    Rows [0, n_freqs) are cos terms (real part), rows [n_freqs, 2*n_freqs)
    are -sin terms (imag part), each pre-multiplied by the Hann window.
    """
    n_freqs = num_fft // 2 + 1
    n = np.arange(num_fft, dtype=np.float64)
    k = np.arange(n_freqs, dtype=np.float64)
    angle = 2.0 * np.pi * np.outer(k, n) / num_fft
    window = filterbank.hann_window(window_size, dtype=np.float64)
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=0) * window
    return basis.astype(np.float32)


@functools.lru_cache(maxsize=4)
def mel_basis(sample_rate: int, num_fft: int, num_mels: int):
    return filterbank.mel_filterbank(sample_rate, num_fft, num_mels)


def block_analysis_kernel(basis: np.ndarray, hopsize: int):
    """Re-block a framed-analysis basis (C_out, num_fft) for a hop-strided
    conv, shape (J, hop, C_out).

    A framed STFT is a conv with one input channel, kernel num_fft and
    stride hop. Re-blocking the audio into non-overlapping hop-sized
    channels makes the same product a stride-1 conv with C_in=hop and
    J=ceil(num_fft/hop) taps: window sample n = j*hop + c maps to tap j,
    channel c; columns past num_fft are zero.
    """
    taps = -(-basis.shape[1] // hopsize)
    padded = np.zeros((basis.shape[0], taps * hopsize), np.float32)
    padded[:, :basis.shape[1]] = basis
    # (C, J*hop) -> (C, J, hop) -> (J, hop, C)
    return np.ascontiguousarray(
        padded.reshape(basis.shape[0], taps, hopsize).transpose(1, 2, 0))


@functools.lru_cache(maxsize=4)
def blocked_dft_kernel(num_fft: int, window_size: int, hopsize: int):
    """Hann-windowed DFT basis re-blocked for a hop-strided conv (J, hop, 2F);
    see block_analysis_kernel."""
    return block_analysis_kernel(dft_basis(num_fft, window_size), hopsize)


@functools.lru_cache(maxsize=8)
def _conv_weight(num_fft, window_size, hopsize, device):
    """The blocked DFT kernel as a torch conv weight (2F, hop, J) on device,
    kept so that a call uploads no basis."""
    kernel = blocked_dft_kernel(num_fft, window_size, hopsize)
    return torch.from_numpy(
        np.ascontiguousarray(kernel.transpose(2, 1, 0))).to(device)


@functools.lru_cache(maxsize=8)
def _mel_weight(sample_rate, num_fft, num_mels, device):
    return torch.from_numpy(mel_basis(sample_rate, num_fft, num_mels)).to(
        device)


###############################################################################
# Spectrogram
###############################################################################


def _audio_to_blocks(audio, num_fft, hopsize, valid_samples=None):
    """(B, 1, S) audio -> ((B, T + J - 1, hop) hop-blocked samples, T).

    Frame t tap j channel c reads sample (t+j)*hop + c. The left reflection,
    the right reflection and the zero tail assemble in one concatenate.
    ``valid_samples`` places the end reflection at the true batch end
    instead of at S (see magnitude_spectrogram).
    """
    B, _, S = audio.shape
    size = (num_fft - hopsize) // 2
    P = S + 2 * size
    T = (P - num_fft) // hopsize + 1
    taps = -(-num_fft // hopsize)
    need = (T + taps - 1) * hopsize
    x = audio[:, 0]
    left = x[:, 1:size + 1].flip(1)
    if valid_samples is None:
        pieces = [left, x, x[:, -size - 1:-1].flip(1)]
    else:
        # Reflection xe[vm + i] = x[vm - 2 - i], i in [0, size); the start
        # indices clamp into range as jax.lax.dynamic_slice's do
        vm = int(valid_samples)
        xe = torch.cat([x, x.new_zeros((B, size))], dim=1)
        start = min(max(vm - size - 1, 0), S)
        seg = xe[:, start:start + size].flip(1)
        at = min(max(vm, 0), S)
        xe[:, at:at + size] = seg
        pieces = [left, xe[:, :S + size]]
    if need > P:
        pieces.append(x.new_zeros((B, need - P)))
    blocks = torch.cat(pieces, dim=1)[:, :need]
    return blocks.reshape(B, T + taps - 1, hopsize), T


def frame_count(num_samples, num_fft, hopsize):
    """Frames produced for audio of length num_samples (post reflect pad)."""
    padded = num_samples + (num_fft - hopsize) // 2 * 2
    return (padded - num_fft) // hopsize + 1


def magnitude_spectrogram(audio, num_fft=1024, hopsize=160, window_size=1024,
                          valid_samples=None):
    """Magnitude STFT of (B, 1, S) audio -> (B, n_freqs, T), float32.

    Matches the reference: reflect pad (num_fft - hop)//2, center=False
    STFT, magnitude sqrt(re^2 + im^2 + 1e-6). ``valid_samples`` is the true
    signal end when S has been right-padded past it: the end reflection is
    written there, so the longest item's final frames match the reference's
    batched STFT (which reflects at the true batch max).
    """
    audio = audio.float()
    weight = _conv_weight(num_fft, window_size, hopsize, audio.device)
    blocks, _ = _audio_to_blocks(audio, num_fft, hopsize, valid_samples)
    out = torch.nn.functional.conv1d(blocks.transpose(1, 2), weight)
    n_freqs = num_fft // 2 + 1
    real, imag = out[:, :n_freqs], out[:, n_freqs:]
    return torch.sqrt(real * real + imag * imag + 1e-6)


def log_mel_spectrogram(audio, sample_rate=16000, num_fft=1024, hopsize=160,
                        window_size=1024, num_mels=80, valid_samples=None):
    """Log-mel spectrogram of (B, 1, S) audio -> (B, num_mels, T), float32.

    Mel projection + dynamic range compression log(clamp(mel, 1e-5)) as in
    the reference (ppgs/preprocess/mel.py:56-76).
    """
    spec = magnitude_spectrogram(audio, num_fft, hopsize, window_size,
                                 valid_samples=valid_samples)
    basis = _mel_weight(sample_rate, num_fft, num_mels, spec.device)
    mel = torch.einsum('mf,bft->bmt', basis, spec)
    return torch.log(torch.clamp(mel, min=1e-5))


###############################################################################
# Fused log-mel (B9, kernels/csrc/fused_mel.cu): the bf16 opt-in
###############################################################################
#
# Counterpart of ppgs_tpu/ops/stft.py _fused_log_mel: bf16 windows times
# the cos and -sin bases, sqrt(re^2 + im^2 + 1e-6), the magnitude in bf16
# times the mel basis, log(max(mel, 1e-5)), fp32 sums. preprocess/mel.py
# takes it for a bf16 config when PPGS_TPU_FUSED_MEL=1, as the JAX package
# does; otherwise the fp32 frontend above runs.

FUSED_MEL_FFT, FUSED_MEL_MELS = 1024, 80    # the kernel's geometry
_F_PAD = 576                                # 513 frequencies, zero-padded


def mel_kernel_host(sample_rate, num_fft, window_size, hopsize, num_mels):
    """((J*hop, F) cos basis, (J*hop, F) -sin basis, (F, M) transposed mel
    basis), as ``ppgs_tpu/ops/stft.py::_mel_kernel_host`` builds them (its
    mel basis zero-padded to 128 lanes): basis row j*hop + c is window
    sample j*hop + c."""
    basis = blocked_dft_kernel(num_fft, window_size, hopsize)  # (J, hop, 2F)
    taps, hop, _ = basis.shape
    n_freqs = num_fft // 2 + 1
    flat = basis.reshape(taps * hop, 2 * n_freqs)
    return (np.ascontiguousarray(flat[:, :n_freqs]),
            np.ascontiguousarray(flat[:, n_freqs:]),
            np.ascontiguousarray(mel_basis(sample_rate, num_fft, num_mels).T))


def fused_log_mel_reference(blocks, T, sample_rate, num_fft, window_size,
                            hopsize, num_mels):
    """Plain version of ``fused_log_mel``: the TPU kernel's im2col windows
    and bases, bf16-rounded, in fp32 products."""
    basis_re, basis_im, mel_t = (
        torch.from_numpy(a).to(blocks.device, torch.bfloat16).float()
        for a in mel_kernel_host(sample_rate, num_fft, window_size, hopsize,
                                 num_mels))
    taps = basis_re.shape[0] // hopsize
    B = blocks.shape[0]
    idx = (torch.arange(T, device=blocks.device)[:, None]
           + torch.arange(taps, device=blocks.device)[None])
    windows = blocks[:, idx].reshape(B, T, taps * hopsize).to(
        torch.bfloat16).float()
    re, im = windows @ basis_re, windows @ basis_im
    mag = torch.sqrt(re * re + im * im + 1e-6)
    mel = mag.to(torch.bfloat16).float() @ mel_t
    return torch.log(torch.clamp(mel, min=1e-5)).transpose(1, 2)


def interleave_bases(basis_re, basis_im):
    """The (K, 576) cos and -sin bases (frequencies zero-padded to 576)
    as one (K, 1152) array, interleaved by 8 columns: columns 16j .. 16j +
    7 hold the cos terms of frequencies 8j .. 8j + 7, columns 16j + 8 ..
    16j + 15 their -sin terms. So an accumulator of the kernel holds re and
    im of the same frequencies."""
    rows = basis_re.shape[0]
    pair = np.zeros((rows, _F_PAD // 8, 2, 8), np.float32)
    for half, basis in enumerate((basis_re, basis_im)):
        padded = np.zeros((rows, _F_PAD), np.float32)
        padded[:, :basis.shape[1]] = basis
        pair[:, :, half] = padded.reshape(rows, _F_PAD // 8, 8)
    return pair.reshape(rows, 2 * _F_PAD)


@functools.lru_cache(maxsize=8)
def _fused_mel_weights(sample_rate, num_fft, window_size, hopsize, device):
    """The kernel's bf16 operands on ``device``: the cos and -sin bases
    interleaved by ``interleave_bases`` as (1024, 1152) (window samples past
    n_fft dropped: their rows are zero) and the mel basis as (80, 576),
    zero past the 513 frequencies."""
    basis_re, basis_im, mel_t = mel_kernel_host(
        sample_rate, num_fft, window_size, hopsize, FUSED_MEL_MELS)
    mel = np.zeros((FUSED_MEL_MELS, _F_PAD), np.float32)
    mel[:, :mel_t.shape[0]] = mel_t.T
    return tuple(torch.from_numpy(a).to(device, torch.bfloat16) for a in (
        interleave_bases(basis_re[:num_fft], basis_im[:num_fft]), mel))


# The kernel's shared memory at 128 frames: 1024 bytes of alignment, a
# 4-stage ring of 16 KB basis stages, two 10 KB mel slots, 128 bytes of
# barriers and 40 fp32 mel sums a thread (256), then the stretch; at most
# 232,448 bytes a block
_SMEM_MAX = 232448
_SMEM_FIXED = 1024 + 4 * 16384 + 2 * 10240 + 128 + 40 * 256 * 4


def fused_mel_plan(hopsize, num_fft=FUSED_MEL_FFT):
    """(frames a block, the stretch's row pitch in samples) of the B9
    kernel at ``hopsize``. A block's 128 windows (64 when they do not fit
    beside the rings, hop >= 396) are one stretch of the blocked stream, its
    rows of hop samples padded to a pitch of 8 mod 16 (hop 160: 168) so that
    8 frames a row apart lie in 8 bank groups. The C entry point refuses any
    other plan."""
    pitch = hopsize + (24 - hopsize % 16) % 16
    taps = -(-num_fft // hopsize)
    fits = _SMEM_FIXED + (128 + taps - 1) * pitch * 2 <= _SMEM_MAX
    return (128 if fits else 64), pitch


def fused_log_mel(blocks, T, sample_rate, num_fft, window_size, hopsize,
                  num_mels):
    """B9: (B, T + taps - 1, hop) hop-blocked fp32 audio -> (B, num_mels, T)
    fp32 log-mel (``kernels/csrc/fused_mel.cu``). The kernel takes n_fft =
    1024, 80 mels and hop % 4 == 0; on a CPU tensor the plain version runs.
    """
    if blocks.device.type == 'cpu':
        return fused_log_mel_reference(blocks, T, sample_rate, num_fft,
                                       window_size, hopsize, num_mels)
    dev = blocks.device
    if (num_fft, num_mels) != (FUSED_MEL_FFT, FUSED_MEL_MELS) or (
            hopsize % 4 or hopsize > num_fft):
        raise ValueError(f'fused_mel kernel takes n_fft {FUSED_MEL_FFT}, '
                         f'{FUSED_MEL_MELS} mels and a hop % 4 == 0; got '
                         f'{num_fft}, {num_mels}, {hopsize}')
    B = blocks.shape[0]
    taps = -(-num_fft // hopsize)
    kernels.require(blocks, 'blocks', torch.float32, dev,
                    (B, T + taps - 1, hopsize))
    if blocks.data_ptr() % 16:
        raise ValueError('blocks: the kernel reads 16-byte aligned rows')
    basis, mel = _fused_mel_weights(sample_rate, num_fft, window_size,
                                    hopsize, dev)
    frames, pitch = fused_mel_plan(hopsize)
    out = torch.empty((B, num_mels, T), dtype=torch.float32, device=dev)
    kernels.launch('ppgs_fused_mel', blocks.data_ptr(),
                   (T + taps - 1) * hopsize, hopsize, T, B, frames, pitch,
                   basis.data_ptr(), mel.data_ptr(), out.data_ptr(),
                   device=dev)
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0


def fused_log_mel_spectrogram(audio, sample_rate=16000, num_fft=1024,
                              hopsize=160, window_size=1024, num_mels=80,
                              valid_samples=None):
    """``log_mel_spectrogram`` through B9 (the bf16 opt-in): the same
    reflect padding and blocking, then ``fused_log_mel``."""
    blocks, T = _audio_to_blocks(audio.float(), num_fft, hopsize,
                                 valid_samples)
    return fused_log_mel(blocks.contiguous(), T, sample_rate, num_fft,
                         window_size, hopsize, num_mels)
