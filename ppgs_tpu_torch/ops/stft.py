"""STFT and log-mel spectrogram as one strided convolution plus products.

Framing + Hann windowing + real DFT are one convolution whose filters are
the windowed DFT basis, re-blocked so that the audio enters as hop-sized
channels (see ``block_analysis_kernel``). The magnitude, the mel product and
the log compression follow as plain tensor ops. Everything runs in float32
on both the fp32 and the bf16 configs: the JAX package leaves this frontend
to XLA, not to a kernel, and a bf16 frontend is a later question. On the
card, TF32 must be off for the convolution (``devices.resolve`` turns it
off), or cuDNN runs it at about three decimal digits.

(reference: ppgs/preprocess/spectrogram.py:14-74, ppgs/preprocess/mel.py:14-76;
JAX counterpart: ppgs_tpu/ops/stft.py)
"""

import functools

import numpy as np
import torch

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
