"""The port's inference API against the JAX package's, end to end on the
CPU: ``from_audio`` (and the file entry points) on one random-init npz and
the same audio, in the three length regimes (one window, chunked windows,
and ``legacy_mode`` past the 1024-frame stack), with per-row lengths.

Tolerances are docs/GOLDEN_PARITY.md's: fp32 PPGs at 1e-4; bf16 PPGs at
atol 2e-2 with argmax agreement >= 99.5% on the valid frames. The JAX
package rounds T up to a multiple of the 400-frame stride for its compile
cache and the port does not; the frame counts here (300, 430, 730, 1100)
are not multiples of 400, so the tests also show that dropping that
bucketing leaves the output unchanged.
"""

import dataclasses

import jax
import numpy as np
import pytest

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
import ppgs_tpu_torch.data.audio
from ppgs_tpu.models import transformer as jax_transformer

HOP = 160


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp('slice') / 'random-mel.npz'
    params = jax_transformer.init(jax.random.PRNGKey(0), ppgs_tpu.Config())
    ppgs_tpu.load.save_params(path, params)
    return path


def _configs(compute_dtype):
    config = ppgs_tpu.config.get().replace(compute_dtype=compute_dtype)
    return config, ppgs_tpu_torch.Config(**dataclasses.asdict(config))


def _compare(got, want, compute_dtype, frames):
    """PPGs of both packages agree on each row's first ``frames[i]``."""
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    for i, n in enumerate(frames):
        g, w = got[i, :, :n], want[i, :, :n]
        if compute_dtype == 'float32':
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-2)
            agree = (g.argmax(0) == w.argmax(0)).mean()
            assert agree >= 0.995, agree


@pytest.mark.parametrize('compute_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('seconds,cut,legacy', [
    (3.0, 0.7, False),        # T = 300: one window
    (4.3, 0.55, False),       # T = 430: one window (JAX buckets it to 800)
    (7.3, 0.8, False),        # T = 730: two chunked windows
    (11.0, 0.45, True),       # T = 1100, legacy_mode: the per-layer path
])
def test_from_audio_matches_jax(checkpoint, compute_dtype, seconds, cut,
                                legacy):
    samples = int(seconds * 16000)
    rng = np.random.default_rng(samples)
    audio = (0.1 * rng.standard_normal((2, 1, samples))).astype(np.float32)
    lengths = np.array([samples, int(cut * samples)])
    audio[1, :, lengths[1]:] = 0.0
    jax_config, port_config = _configs(compute_dtype)

    want = np.asarray(ppgs_tpu.from_audio(
        audio, lengths=lengths, checkpoint=checkpoint, legacy_mode=legacy,
        config=jax_config))
    got = ppgs_tpu_torch.from_audio(
        audio, lengths=lengths, checkpoint=checkpoint, legacy_mode=legacy,
        config=port_config, device='cpu').numpy()
    assert got.shape[-1] == ppgs_tpu_torch.ops.stft.frame_count(
        samples, 1024, HOP)
    _compare(got, want, compute_dtype, lengths // HOP)


def test_from_audio_resamples_like_jax(checkpoint):
    rate = 22050
    rng = np.random.default_rng(5)
    audio = (0.1 * rng.standard_normal((2, 1, 2 * rate))).astype(np.float32)
    lengths = np.array([2 * rate, rate])
    jax_config, port_config = _configs('float32')
    want = np.asarray(ppgs_tpu.from_audio(
        audio, sample_rate=rate, lengths=lengths, checkpoint=checkpoint,
        config=jax_config))
    got = ppgs_tpu_torch.from_audio(
        audio, sample_rate=rate, lengths=lengths, checkpoint=checkpoint,
        config=port_config, device='cpu').numpy()
    _compare(got, want, 'float32', [want.shape[-1]] * 2)


def test_file_entry_points_match_jax(checkpoint, tmp_path):
    rng = np.random.default_rng(6)
    wav = tmp_path / 'speech.wav'
    ppgs_tpu_torch.data.audio.save_wav(
        wav, (0.1 * rng.standard_normal((1, 24000))).astype(np.float32))
    jax_config, port_config = _configs('float32')
    ppgs_tpu.from_file_to_file(wav, tmp_path / 'jax.npy',
                               checkpoint=checkpoint, config=jax_config)
    ppgs_tpu_torch.from_file_to_file(wav, tmp_path / 'port.npy',
                                     checkpoint=checkpoint,
                                     config=port_config, device='cpu')
    want, got = np.load(tmp_path / 'jax.npy'), np.load(tmp_path / 'port.npy')
    assert got.shape == want.shape == (40, 150)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        ppgs_tpu_torch.from_file(wav, checkpoint=checkpoint,
                                 config=port_config, device='cpu').numpy(),
        got)
