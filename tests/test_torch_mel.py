"""The port's log-mel frontend against the JAX package's fp32 ('highest')
frontend on the CPU, at the golden-parity tolerance of 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu.ops import stft as jax_stft
from ppgs_tpu_torch.ops import stft


def _audio(seed, batch, samples):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, 1, samples))).astype(np.float32)


@pytest.mark.parametrize('samples,valid', [
    (16000, None),          # a multiple of the hop
    (12345, None),          # not a multiple of the hop
    (16000, 11111),         # end reflection at the true batch end
    (8003, 8003),
    (4000, 2500),
])
def test_log_mel_matches_jax(samples, valid):
    audio = _audio(samples, 2, samples)
    want = np.asarray(jax_stft.log_mel_spectrogram(
        jnp.asarray(audio), precision='highest',
        valid_samples=None if valid is None else jnp.int32(valid)))
    got = stft.log_mel_spectrogram(torch.from_numpy(audio),
                                   valid_samples=valid).numpy()
    assert got.shape == want.shape == (2, 80, stft.frame_count(
        samples, 1024, 160))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_frontend_with_per_row_lengths_matches_jax():
    audio = _audio(7, 3, 9600)
    lengths = np.array([9600, 7000, 3210])
    config = ppgs_tpu.config.get()
    want = np.asarray(ppgs_tpu.preprocess.get('mel').from_audios(
        jnp.asarray(audio), lengths,
        config=config.replace(compute_dtype='float32')))
    got = ppgs_tpu_torch.preprocess.get('mel').from_audios(
        torch.from_numpy(audio), lengths, device='cpu').numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_frame_count_and_dft_basis_match_jax():
    for samples in (1, 159, 160, 16000, 12345):
        assert stft.frame_count(samples, 1024, 160) == (
            jax_stft.frame_count(samples, 1024, 160))
    np.testing.assert_array_equal(stft.blocked_dft_kernel(1024, 1024, 160),
                                  jax_stft.blocked_dft_kernel(1024, 1024, 160))
    np.testing.assert_array_equal(stft.mel_basis(16000, 1024, 80),
                                  jax_stft.mel_basis(16000, 1024, 80))
