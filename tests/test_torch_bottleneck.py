"""The bottleneck slice on the CPU: the port's frontend DSP against the JAX
package's, and ``ppgs_tpu_torch.from_audio(..., representation='bottleneck')``
against ``ppgs_tpu.from_audio`` on the same conformer and head weights.

Both packages read one JAX-init conformer npz (2 blocks at full width,
the JAX package's ``_params`` and the port's ``BOTTLENECK_CHECKPOINT``
pointed at it and ``conformer.BOTTLENECK`` patched in both, as
tests/test_structural_goldens.py:206-220 does for the JAX package) and one
head npz. Tolerances: the DSP at tests/test_bottleneck.py's own (log-mel
rtol/atol 1e-3 with exact olens, MVN rtol 1e-4 / atol 1e-5); fp32 PPGs at
1e-4 and bf16 PPGs at atol 2e-2 with argmax agreement >= 99.5% on the
frames bf16 decides (docs/GOLDEN_PARITY.md; the decided frames as in
tests/test_torch_w2v2fb.py). In bf16 the JAX conformer runs as on its chip:
the fused attention kernel in interpret mode, in a freshly jitted
``_forward``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppgs_tpu
import ppgs_tpu_torch
import ppgs_tpu_torch.data.audio
from ppgs_tpu import core as jax_core
from ppgs_tpu.models import conformer as jax_conformer
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.ops import flash_attention as jax_fa
from ppgs_tpu.preprocess import bottleneck as jax_bottleneck
from ppgs_tpu_torch import core as port_core
from ppgs_tpu_torch.preprocess import bottleneck as port_bottleneck

HOP = 160


def _patch(monkeypatch, tmp_path, params, jcfg):
    """Point both packages' bottleneck frontends at one conformer npz."""
    path = tmp_path / 'conformer.npz'
    ppgs_tpu.load.save_params(path, params)
    monkeypatch.setattr(jax_bottleneck, '_params',
                        lambda: ppgs_tpu.load.load_params(path))
    monkeypatch.setattr(jax_bottleneck.conformer, 'BOTTLENECK', jcfg)
    monkeypatch.setattr(port_bottleneck, 'BOTTLENECK_CHECKPOINT', path)
    monkeypatch.setattr(
        port_bottleneck.conformer, 'BOTTLENECK',
        port_bottleneck.conformer.ConformerConfig(**dataclasses.asdict(jcfg)))
    jax_core._MODEL_CACHE.clear()
    port_core._MODEL_CACHE.clear()


def _jax_chip_path(monkeypatch):
    """The JAX conformer's chip path: its fused attention kernel in
    interpret mode, in a freshly jitted ``_forward`` (a trace made before
    the patches would keep the XLA branch)."""
    kernel = jax_fa.fused_attention_bias
    monkeypatch.setattr(jax_fa, 'fused_attention_bias', functools.wraps(
        kernel)(lambda *a, **k: kernel(*a, **{**k, 'interpret': True})))
    monkeypatch.setattr(jax_conformer, '_use_fused_rel_attention',
                        lambda t: True)
    monkeypatch.setattr(jax_bottleneck, '_forward', jax.jit(
        jax_bottleneck._forward.__wrapped__,
        static_argnames=('compute_dtype',)))


def _setup(monkeypatch, tmp_path, compute_dtype, seed=0, hidden=64):
    jcfg = jax_conformer.ConformerConfig(num_blocks=2)
    _patch(monkeypatch, tmp_path,
           jax_conformer.init(jax.random.PRNGKey(seed), jcfg), jcfg)
    config = ppgs_tpu.Config(
        config=f'bottleneck-test-{compute_dtype}', representation='bottleneck',
        input_channels=144, hidden_channels=hidden, num_hidden_layers=2,
        compute_dtype=compute_dtype)
    ckpt = tmp_path / 'head.npz'
    ppgs_tpu.load.save_params(ckpt, jax_transformer.init(
        jax.random.PRNGKey(seed + 1), config))
    return config, ppgs_tpu_torch.Config(**dataclasses.asdict(config)), ckpt


###############################################################################
# The frontend DSP
###############################################################################


@pytest.fixture
def audio():
    rng = np.random.default_rng(0)
    t = np.arange(8000) / 16000
    return np.stack([
        0.4 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(8000),
        rng.standard_normal(8000) * 0.2,
    ]).astype(np.float32)


def test_log_mel_power_matches_jax(audio):
    lengths = np.array([8000, 6000])
    audio[1, 6000:] = 0
    want, want_olens = jax_bottleneck.log_mel_power(
        jnp.asarray(audio), jnp.asarray(lengths))
    got, olens = port_bottleneck.log_mel_power(torch.from_numpy(audio),
                                               torch.from_numpy(lengths))
    np.testing.assert_array_equal(olens.numpy(), np.asarray(want_olens))
    assert got.shape == want.shape == (2, 44, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    with pytest.raises(ValueError, match='too short'):
        port_bottleneck.log_mel_power(torch.zeros(1, 1000),
                                      torch.tensor([1000]))


def test_utterance_mvn_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 80)).astype(np.float32)
    olens = np.array([40, 25])
    want = jax_bottleneck.utterance_mvn(jnp.asarray(x), jnp.asarray(olens))
    got = port_bottleneck.utterance_mvn(torch.from_numpy(x),
                                        torch.from_numpy(olens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_dft_basis_matches_jax():
    np.testing.assert_array_equal(port_bottleneck._dft_basis(),
                                  jax_bottleneck._dft_basis())
    assert port_bottleneck.PAD == jax_bottleneck.PAD == 432


###############################################################################
# The slice
###############################################################################


def _compare(got, want, frames, want32=None):
    """fp32 (``want32`` None): 1e-4 on each row's valid frames. bf16: atol
    2e-2 on them, and argmax agreement >= 99.5% on the valid frames where
    the JAX package's bf16 ``want`` and fp32 ``want32`` agree."""
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    same, decided = [], []
    for i, n in enumerate(frames):
        g, w = got[i, :, :n], want[i, :, :n]
        if want32 is None:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2)
        same.append(g.argmax(0) == w.argmax(0))
        decided.append(w.argmax(0) == want32[i, :, :n].argmax(0))
    if want32 is not None:
        same, decided = np.concatenate(same), np.concatenate(decided)
        assert decided.mean() > 0.95, decided.mean()
        assert same[decided].mean() >= 0.995, same[decided].mean()


@pytest.mark.parametrize('compute_dtype,samples,cuts', [
    ('float32', 16000, ()),                 # one utterance, T = 100
    ('float32', 35000, (0.61, 0.37)),       # ragged, lengths off the hop
    # bf16: 4 rows, T = 304 (the JAX kernel needs T % 8 == 0), 955 valid
    # frames, lengths off the hop
    ('bfloat16', 304 * HOP, (0.82, 0.63, 0.49)),
])
def test_from_audio_matches_jax(monkeypatch, tmp_path, compute_dtype,
                                samples, cuts):
    config, port_config, ckpt = _setup(
        monkeypatch, tmp_path, compute_dtype,
        hidden=256 if compute_dtype == 'bfloat16' else 64)
    if compute_dtype == 'bfloat16':
        _jax_chip_path(monkeypatch)
    rng = np.random.default_rng(samples)
    B = 1 + len(cuts)
    audio = (0.1 * rng.standard_normal((B, 1, samples))).astype(np.float32)
    lengths = None
    frames = [samples // HOP] * B
    if cuts:
        lengths = np.array([samples] + [int(c * samples) + 7 for c in cuts])
        for i in range(1, B):
            audio[i, :, lengths[i]:] = 0.0
        frames = list(lengths // HOP)
    call = dict(lengths=lengths, checkpoint=ckpt,
                representation='bottleneck')
    want = np.asarray(ppgs_tpu.from_audio(audio, config=config, **call))
    want32 = None
    if compute_dtype == 'bfloat16':
        want32 = np.asarray(ppgs_tpu.from_audio(
            audio, config=config.replace(compute_dtype='float32'), **call))
    calls = []
    kernel = port_bottleneck.conformer.fa.rel_attention
    monkeypatch.setattr(port_bottleneck.conformer.fa, 'rel_attention',
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    got = ppgs_tpu_torch.from_audio(audio, config=port_config, device='cpu',
                                    **call).numpy()
    assert got.shape == (B, 40, samples // HOP)
    assert len(calls) == (2 if compute_dtype == 'bfloat16' else 0)
    _compare(got, want, frames, want32)


def test_structural_golden_reads_the_same(monkeypatch, tmp_path):
    """The recorded bottleneck structural golden (seed-derived JAX weights,
    the stored audio and PPG), read by path: the port reproduces it at the
    golden test's own tolerance."""
    jcfg = jax_conformer.ConformerConfig(num_blocks=2)
    _patch(monkeypatch, tmp_path,
           jax_conformer.init(jax.random.PRNGKey(13), jcfg), jcfg)
    config = ppgs_tpu_torch.Config(
        config='bottleneck-structural-golden', representation='bottleneck',
        input_channels=144, hidden_channels=64, num_hidden_layers=2,
        compute_dtype='float32')
    ckpt = tmp_path / 'bottleneck-head.npz'
    ppgs_tpu.load.save_params(ckpt, jax_transformer.init(
        jax.random.PRNGKey(14),
        ppgs_tpu.Config(**dataclasses.asdict(config))))
    golden = ppgs_tpu.config.ASSETS_DIR / 'goldens' / 'structural' / (
        'bottleneck-structural.npz')
    with np.load(golden) as data:
        audio, want = data['audio'], data['ppg']
    got = ppgs_tpu_torch.from_audio(audio, 16000, checkpoint=ckpt,
                                    config=config, device='cpu').numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_frontend_entry_points_match_jax(monkeypatch, tmp_path):
    """preprocess.bottleneck's from_audio and from_file_to_file (fp16 .npy)
    against the JAX package's, fp32 compute."""
    jcfg = jax_conformer.ConformerConfig(num_blocks=2)
    _patch(monkeypatch, tmp_path,
           jax_conformer.init(jax.random.PRNGKey(5), jcfg), jcfg)
    jax_config = ppgs_tpu.config.get().replace(compute_dtype='float32')
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(jax_config))
    rng = np.random.default_rng(6)
    audio = (0.1 * rng.standard_normal((1, 12345))).astype(np.float32)
    want = np.asarray(jax_bottleneck.from_audio(audio, config=jax_config))
    got = port_bottleneck.from_audio(audio, config=port_config,
                                     device='cpu').numpy()
    assert got.shape == want.shape == (1, 144, 77)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    wav = tmp_path / 'speech.wav'
    ppgs_tpu_torch.data.audio.save_wav(wav, audio)
    jax_bottleneck.from_file_to_file(wav, tmp_path / 'jax.npy', jax_config)
    port_bottleneck.from_file_to_file(wav, tmp_path / 'port.npy', port_config,
                                      device='cpu')
    a, b = np.load(tmp_path / 'jax.npy'), np.load(tmp_path / 'port.npy')
    assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
    np.testing.assert_allclose(b.astype(np.float32), a.astype(np.float32),
                               rtol=1e-3, atol=4e-3)


@pytest.mark.parametrize('call', [
    lambda audio, wav, **kw: port_bottleneck.from_audios(audio, **kw),
    lambda audio, wav, **kw: port_bottleneck.from_audio(audio[0], **kw),
    lambda audio, wav, **kw: port_bottleneck.from_file(wav, **kw),
    lambda audio, wav, **kw: port_bottleneck.from_file_to_file(
        wav, wav.with_suffix('.npy'), **kw),
], ids=['from_audios', 'from_audio', 'from_file', 'from_file_to_file'])
def test_frontend_runs_on_the_card_unless_told(monkeypatch, tmp_path, call):
    """The frontend's entry points run on the card by default: without CUDA
    they raise, and with device='cpu' they run on the CPU."""
    jcfg = jax_conformer.ConformerConfig(num_blocks=2)
    _patch(monkeypatch, tmp_path,
           jax_conformer.init(jax.random.PRNGKey(7), jcfg), jcfg)
    monkeypatch.setattr(ppgs_tpu_torch.devices.torch.cuda, 'is_available',
                        lambda: False)
    audio = (0.1 * np.random.default_rng(8).standard_normal(
        (1, 1, 4000))).astype(np.float32)
    wav = tmp_path / 'speech.wav'
    ppgs_tpu_torch.data.audio.save_wav(wav, audio[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(audio, wav)
    out = call(audio, wav, device='cpu')
    if out is not None:
        assert out.device.type == 'cpu' and out.shape == (1, 144, 25)


def test_missing_conformer_weights_name_the_converter(monkeypatch, tmp_path):
    monkeypatch.setattr(port_bottleneck, 'BOTTLENECK_CHECKPOINT',
                        tmp_path / 'conformer-24epoch.npz')
    with pytest.raises(FileNotFoundError, match='convert_conformer.py'):
        port_bottleneck._checkpoint()


def test_load_model_has_no_default_bottleneck_checkpoint():
    """As in the JAX package (ppgs_tpu/load.py:121): the bottleneck config
    resolves to the C = 256 head, which has no published checkpoint."""
    with pytest.raises(ValueError, match='No default checkpoints'):
        ppgs_tpu.load.model(representation='bottleneck')
    with pytest.raises(ValueError, match='No default checkpoints'):
        ppgs_tpu_torch.load.model(representation='bottleneck', device='cpu')
    assert ppgs_tpu_torch.config.get('bottleneck').hidden_channels == 256


def test_from_audio_takes_the_sample_rate_second(monkeypatch, tmp_path):
    """preprocess.bottleneck.from_audio(audio, 16000, ...) as the JAX
    package's (the sample rate taken second and ignored), fp32 compute."""
    jcfg = jax_conformer.ConformerConfig(num_blocks=2)
    _patch(monkeypatch, tmp_path,
           jax_conformer.init(jax.random.PRNGKey(9), jcfg), jcfg)
    jax_config = ppgs_tpu.config.get().replace(compute_dtype='float32')
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(jax_config))
    audio = (0.1 * np.random.default_rng(10).standard_normal(
        (1, 8000))).astype(np.float32)
    want = np.asarray(jax_bottleneck.from_audio(audio, 16000,
                                                config=jax_config))
    got = port_bottleneck.from_audio(audio, 16000, config=port_config,
                                     device='cpu').numpy()
    assert got.shape == want.shape == (1, 144, 50)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
