"""The port's log-mel frontend against the JAX package's fp32 ('highest')
frontend on the CPU, at the golden-parity tolerance of 1e-4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
import ppgs_tpu_torch.data.audio
import ppgs_tpu_torch.preprocess.mel
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


def _configs():
    jax_config = ppgs_tpu.config.get().replace(compute_dtype='float32')
    return jax_config, ppgs_tpu_torch.Config(**dataclasses.asdict(jax_config))


def test_from_audio_takes_the_sample_rate_second():
    """preprocess.mel.from_audio(audio, 16000, ...) as the JAX package's
    (the sample rate taken second and ignored)."""
    jax_config, port_config = _configs()
    audio = _audio(9, 1, 12345)[0]
    want = np.asarray(ppgs_tpu.preprocess.get('mel').from_audio(
        audio, 16000, config=jax_config))
    got = ppgs_tpu_torch.preprocess.get('mel').from_audio(
        audio, 16000, config=port_config, device='cpu').numpy()
    assert got.shape == want.shape == (1, 80, 77)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_file_entry_points_match_jax(tmp_path):
    """preprocess.mel's from_file and from_file_to_file (float32 .npy)
    against the JAX package's."""
    from ppgs_tpu.preprocess import mel as jax_mel
    from ppgs_tpu_torch.preprocess import mel as port_mel

    jax_config, port_config = _configs()
    wav = tmp_path / 'speech.wav'
    ppgs_tpu_torch.data.audio.save_wav(wav, _audio(10, 1, 9600)[0])
    want = np.asarray(jax_mel.from_file(wav, jax_config))
    got = port_mel.from_file(wav, port_config, device='cpu').numpy()
    assert got.shape == want.shape == (1, 80, 60)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jax_mel.from_file_to_file(wav, tmp_path / 'jax.npy', jax_config)
    port_mel.from_file_to_file(wav, tmp_path / 'port.npy', port_config,
                               device='cpu')
    a, b = np.load(tmp_path / 'jax.npy'), np.load(tmp_path / 'port.npy')
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('call', [
    lambda audio, wav, **kw: ppgs_tpu_torch.preprocess.mel.from_audio(
        audio, 16000, **kw),
    lambda audio, wav, **kw: ppgs_tpu_torch.preprocess.mel.from_file(
        wav, **kw),
    lambda audio, wav, **kw: ppgs_tpu_torch.preprocess.mel.from_file_to_file(
        wav, wav.with_suffix('.npy'), **kw),
], ids=['from_audio', 'from_file', 'from_file_to_file'])
def test_frontend_runs_on_the_card_unless_told(monkeypatch, tmp_path, call):
    """The mel frontend's entry points run on the card by default: without
    CUDA they raise, and with device='cpu' they run on the CPU."""
    monkeypatch.setattr(ppgs_tpu_torch.devices.torch.cuda, 'is_available',
                        lambda: False)
    audio = _audio(11, 1, 4000)[0]
    wav = tmp_path / 'speech.wav'
    ppgs_tpu_torch.data.audio.save_wav(wav, audio)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(audio, wav)
    out = call(audio, wav, device='cpu')
    if out is not None:
        assert out.device.type == 'cpu' and out.shape == (1, 80, 25)
