"""The fused log-mel kernel B9 (``ops/stft.py::fused_log_mel``): its plain
version against the JAX package's Pallas kernel in interpret mode, and the
mel frontend's opt-in (``PPGS_TPU_FUSED_MEL=1`` with a bf16 config), on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu_torch
from ppgs_tpu.ops import stft as jax_stft
from ppgs_tpu_torch.ops import stft
from ppgs_tpu_torch.preprocess import mel


def _audio(seed, batch, samples):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, 1, samples))).astype(np.float32)


def test_mel_kernel_host_matches_jax():
    """The same bases; JAX's mel basis is zero-padded to 128 lanes."""
    want = jax_stft._mel_kernel_host(16000, 1024, 1024, 160, 80)
    got = stft.mel_kernel_host(16000, 1024, 1024, 160, 80)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w[:, :g.shape[1]])
    assert not want[2][:, 80:].any()


@pytest.mark.parametrize('samples', [12345, 16000])
def test_fused_log_mel_matches_jax_kernel(samples):
    """Both round the windows, the bases and the magnitude to bf16 and sum
    in fp32, so they differ only where the order of the fp32 sums flips a
    magnitude's bf16 rounding: one bf16 ulp, 2^-8 to 2^-7 of it, so a mel
    value (a sum of positive terms) moves by at most 2^-7 of itself and its
    log by at most 7.8e-3. Held at atol 8e-3 with 99.9% of the values within
    1e-4 (2.2e-3 and 99.95% within 1e-5 read), where tests/test_stft.py
    holds the JAX kernel to the fp32 frontend at atol 6e-2 / rtol 2e-2."""
    audio = _audio(samples, 2, samples)
    blocks, T = jax_stft._audio_to_blocks(jnp.asarray(audio), 1024, 160)
    want = np.asarray(jax_stft._fused_log_mel(
        blocks, T, 16000, 1024, 1024, 160, 80, interpret=True))
    got = stft.fused_log_mel(torch.tensor(np.asarray(blocks)), T, 16000,
                             1024, 1024, 160, 80).numpy()
    assert got.shape == want.shape == (2, 80, T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-3)
    assert np.mean(np.abs(got - want) <= 1e-4) >= 0.999


def test_opt_in_takes_the_fused_path(monkeypatch):
    """With PPGS_TPU_FUSED_MEL=1 and a bf16 config, from_audios runs B9 (its
    plain version here) and agrees with the JAX package's opt-in; without
    it, or with an fp32 config, the fp32 frontend runs, its numbers
    bit for bit those of ops.stft.log_mel_spectrogram."""
    audio = _audio(3, 2, 9999)
    lengths = np.array([9999, 7000])
    calls = []
    fused = stft.fused_log_mel
    monkeypatch.setattr(stft, 'fused_log_mel',
                        lambda *a: calls.append(1) or fused(*a))
    bf16 = ppgs_tpu_torch.config.get()
    fp32 = bf16.replace(compute_dtype='float32')
    plain = stft.log_mel_spectrogram(torch.from_numpy(audio),
                                     valid_samples=9999)
    for config in (bf16, fp32):
        got = mel.from_audios(audio, lengths, config=config, device='cpu')
        assert torch.equal(got, plain)
    assert calls == []

    monkeypatch.setenv('PPGS_TPU_FUSED_MEL', '1')
    assert torch.equal(mel.from_audios(audio, lengths, config=fp32,
                                       device='cpu'), plain)
    assert calls == []
    got = mel.from_audios(audio, lengths, config=bf16, device='cpu').numpy()
    assert calls == [1]
    blocks, T = jax_stft._audio_to_blocks(jnp.asarray(audio), 1024, 160,
                                          jnp.int32(9999))
    want = np.asarray(jax_stft._fused_log_mel(
        blocks, T, 16000, 1024, 1024, 160, 80, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-3)
    # And it stays within the JAX test's bf16 envelope of the fp32 frontend
    np.testing.assert_allclose(got, plain.numpy(), atol=6e-2, rtol=2e-2)


@pytest.mark.parametrize('hop', [160, 100, 320])
def test_fused_mel_weights_deinterleave_to_the_host_bases(hop):
    """The kernel's (1024, 1152) bases, de-interleaved (columns 16j .. 16j
    + 7 the cos terms of frequencies 8j .., the next 8 their -sin terms),
    are mel_kernel_host's cos and -sin bases in bf16, zero past 513
    frequencies; its (80, 576) mel basis is the transposed one's."""
    basis, mel_basis = stft._fused_mel_weights(16000, 1024, 1024, hop, 'cpu')
    want_re, want_im, want_mel = (
        torch.from_numpy(a).to(torch.bfloat16)
        for a in stft.mel_kernel_host(16000, 1024, 1024, hop, 80))
    assert basis.shape == (1024, 1152) and basis.dtype == torch.bfloat16
    pairs = basis.reshape(1024, 72, 2, 8)
    re = pairs[:, :, 0].reshape(1024, 576)
    im = pairs[:, :, 1].reshape(1024, 576)
    assert torch.equal(re[:, :513], want_re[:1024])
    assert torch.equal(im[:, :513], want_im[:1024])
    assert not re[:, 513:].any() and not im[:, 513:].any()
    assert mel_basis.shape == (80, 576)
    assert torch.equal(mel_basis[:, :513], want_mel.T)
    assert not mel_basis[:, 513:].any()


@pytest.mark.parametrize('hop,T', [(100, 100), (100, 129), (320, 128),
                                   (320, 129), (160, 129)])
def test_fused_log_mel_matches_jax_kernel_at_other_hops(hop, T):
    """The plain version against the JAX kernel at a hop of 100 (the
    kernel's 32-bit-load form) and 320, a tile's 128 frames and one more
    (a ragged tile), on a hop-blocked stream of random samples: the limits
    of test_fused_log_mel_matches_jax_kernel."""
    taps = -(-1024 // hop)
    rng = np.random.default_rng(hop + T)
    blocks = (0.3 * rng.standard_normal((3, T + taps - 1, hop))).astype(
        np.float32)
    want = np.asarray(jax_stft._fused_log_mel(
        jnp.asarray(blocks), T, 16000, 1024, 1024, hop, 80, interpret=True))
    got = stft.fused_log_mel(torch.from_numpy(blocks), T, 16000, 1024, 1024,
                             hop, 80).numpy()
    assert got.shape == want.shape == (3, 80, T)
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-3)
    assert np.mean(np.abs(got - want) <= 1e-4) >= 0.999


@pytest.mark.parametrize('hop', [4, 100, 160, 320, 392, 396, 512, 1024])
def test_fused_mel_plan(hop):
    """The stretch's rows are padded to a pitch of 8 mod 16 samples (8
    frames a row apart in 8 different 16-byte bank groups), by less than
    16; a block takes 128 frames where their stretch fits beside the rings
    and the mel sums, else 64."""
    frames, pitch = stft.fused_mel_plan(hop)
    assert pitch % 16 == 8 and 0 <= pitch - hop < 16 and pitch % 4 == 0
    assert len({(f * pitch * 2 // 16) % 8 for f in range(8)}) == 8
    taps = -(-1024 // hop)
    need = stft._SMEM_FIXED + (127 + taps) * pitch * 2
    assert frames == (128 if need <= stft._SMEM_MAX else 64)
    assert frames == (128 if hop <= 392 else 64)
