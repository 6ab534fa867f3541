"""The w2v2fb slice end to end on the CPU: ``ppgs_tpu_torch.from_audio(...,
representation='w2v2fb')`` against ``ppgs_tpu.from_audio`` on the same
weights and audio.

Both packages read one JAX-init trunk npz (the JAX package's ``_params``
and the port's ``W2V2FB_CHECKPOINT`` pointed at it, ``w2v2.BASE`` patched
to a narrow trunk in both, as tests/test_structural_goldens.py:187-203 does
for the JAX package), and one head npz. Tolerances are
docs/GOLDEN_PARITY.md's: fp32 PPGs at 1e-4 on each row's valid frames;
bf16 PPGs at atol 2e-2 on them, with argmax agreement >= 99.5%.

In bf16 the JAX side runs its trunk as it runs on its chip: the streamed
encoder kernel (and, opted in, the conv-stack kernel) in interpret mode,
as tests/test_w2v2.py and tests/test_conv_stack.py run them. That is the
function the port's kernels compute (an fp32 residual across the layers).

The argmax agreement is counted on the frames that bf16 decides: those
where the JAX package's own bf16 and fp32 PPGs pick the same phoneme.
Random weights give near-uniform PPGs (the largest ~0.12), and on about
1% of the frames the top two phonemes are closer than the trunk's bf16
rounding (its output is rounded to bf16, ~1 ulp apart between any two
bf16 computations): there the JAX package's bf16 run disagrees with its
own fp32 run as often as with the port's (99.1-99.3% agreement over 1,600
frames either way), so such a frame is a tie, not a test of the port.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
import ppgs_tpu_torch.data.audio
from ppgs_tpu import core as jax_core
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.models import w2v2 as jax_w2v2
from ppgs_tpu.ops import conv_stack as jax_conv_stack
from ppgs_tpu.ops import encoder_layer_kernel as jax_elk
from ppgs_tpu.preprocess import w2v2fb as jax_w2v2fb
from ppgs_tpu_torch import core as port_core
from ppgs_tpu_torch.preprocess import w2v2fb as port_w2v2fb

HOP = 160
# bf16: a trunk whose 2 heads of 64 take the GELU stack (K2 at d_head 64),
# and the w2v2fb head's own width (C = 512, 2 heads of 256); fp32: the
# structural golden's narrow trunk and head
TRUNKS = {
    'bfloat16': dict(conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2),
                     conv_stride=(5, 2, 2), hidden_size=128, num_layers=2,
                     num_heads=2, intermediate_size=256,
                     num_conv_pos_embeddings=16,
                     num_conv_pos_embedding_groups=4),
    'float32': dict(conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2),
                    conv_stride=(5, 2, 2), hidden_size=48, num_layers=2,
                    num_heads=4, intermediate_size=96,
                    num_conv_pos_embeddings=16,
                    num_conv_pos_embedding_groups=4),
}
HEADS = {'bfloat16': dict(hidden_channels=512, num_hidden_layers=2),
         'float32': dict(hidden_channels=64, num_hidden_layers=2)}


def _patch(monkeypatch, tmp_path, trunk_params, jcfg):
    """Point both packages' w2v2fb frontends at one trunk npz."""
    path = tmp_path / 'trunk.npz'
    ppgs_tpu.load.save_params(path, trunk_params)
    monkeypatch.setattr(jax_w2v2fb, '_params',
                        lambda: ppgs_tpu.load.load_params(path))
    monkeypatch.setattr(jax_w2v2fb.w2v2, 'BASE', jcfg)
    monkeypatch.setattr(port_w2v2fb, 'W2V2FB_CHECKPOINT', path)
    monkeypatch.setattr(port_w2v2fb.w2v2, 'BASE',
                        port_w2v2fb.w2v2.W2V2Config(**dataclasses.asdict(jcfg)))
    jax_core._MODEL_CACHE.clear()
    port_core._MODEL_CACHE.clear()


def _interpret(fn):
    return functools.wraps(fn)(lambda *a, **k: fn(*a, **{**k,
                                                         'interpret': True}))


def _jax_chip_path(monkeypatch, conv_stack=False):
    """Run the JAX trunk through its TPU kernels in interpret mode (its
    chip path): the streamed encoder and, with ``conv_stack``, the conv
    stack."""
    monkeypatch.setattr(jax_elk, 'encoder_stack_streamed',
                        _interpret(jax_elk.encoder_stack_streamed))
    monkeypatch.setattr(jax_w2v2, '_use_flash', lambda d, h, t: True)
    if conv_stack:
        monkeypatch.setattr(jax_conv_stack, 'feature_encoder_stack',
                            _interpret(jax_conv_stack.feature_encoder_stack))
        monkeypatch.setattr(jax_conv_stack, 'supported', lambda config: True)
    # A trace made before the patches would be reused: jit a new function
    traced = jax_w2v2fb._forward.__wrapped__

    def forward(params, audio, lengths, out_frames, compute_dtype):
        return traced(params, audio, lengths, out_frames, compute_dtype)

    monkeypatch.setattr(jax_w2v2fb, '_forward', jax.jit(
        forward, static_argnames=('out_frames', 'compute_dtype')))


def _setup(monkeypatch, tmp_path, compute_dtype, seed=0):
    jcfg = jax_w2v2.W2V2Config(**TRUNKS[compute_dtype])
    _patch(monkeypatch, tmp_path,
           jax_w2v2.init(jax.random.PRNGKey(seed), jcfg), jcfg)
    config = ppgs_tpu.Config(
        config=f'w2v2fb-test-{compute_dtype}', representation='w2v2fb',
        input_channels=jcfg.hidden_size, compute_dtype=compute_dtype,
        **HEADS[compute_dtype])
    ckpt = tmp_path / 'head.npz'
    ppgs_tpu.load.save_params(ckpt, jax_transformer.init(
        jax.random.PRNGKey(seed + 1), config))
    return config, ppgs_tpu_torch.Config(**dataclasses.asdict(config)), ckpt


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
        agree = same[decided].mean()
        assert agree >= 0.995, agree


def _jax_ppgs(audio, config, **kwargs):
    """The JAX package's PPGs, and with bf16 also its fp32 PPGs of the same
    weights (the frames bf16 decides)."""
    want = np.asarray(ppgs_tpu.from_audio(audio, config=config, **kwargs))
    if config.compute_dtype == 'float32':
        return want, None
    return want, np.asarray(ppgs_tpu.from_audio(
        audio, config=config.replace(compute_dtype='float32'), **kwargs))


@pytest.mark.parametrize('compute_dtype,seconds,cuts', [
    ('float32', 1.5, ()),               # one utterance, T = 150
    ('float32', 2.2, (0.6,)),           # a ragged batch
    # bf16: a ragged batch of 1,160 valid frames, enough that the
    # agreement rate is a rate (one flip is 0.09% of it)
    ('bfloat16', 4.0, (0.8, 0.6, 0.5)),
])
def test_from_audio_matches_jax(monkeypatch, tmp_path, compute_dtype,
                                seconds, cuts):
    config, port_config, ckpt = _setup(monkeypatch, tmp_path, compute_dtype)
    _jax_chip_path(monkeypatch)
    samples = int(seconds * 16000)
    rng = np.random.default_rng(samples)
    B = 1 + len(cuts)
    audio = (0.1 * rng.standard_normal((B, 1, samples))).astype(np.float32)
    lengths = None
    frames = [samples // HOP] * B
    if cuts:
        lengths = np.array([samples] + [int(c * samples) for c in cuts])
        for i in range(1, B):
            audio[i, :, lengths[i]:] = 0.0
        frames = list(lengths // HOP)
    want, want32 = _jax_ppgs(audio, config, lengths=lengths,
                             checkpoint=ckpt)
    got = ppgs_tpu_torch.from_audio(
        audio, lengths=lengths, checkpoint=ckpt, config=port_config,
        device='cpu').numpy()
    assert got.shape == (B, 40, samples // HOP)
    _compare(got, want, frames, want32)


def test_conv_stack_opt_in_matches_jax(monkeypatch, tmp_path):
    """PPGS_TPU_CONV_STACK=1 takes the conv-stack kernels' path (their plain
    versions here), against the JAX package's opt-in conv-stack kernel:
    the trunk's features within bf16 rounding (a few ulps of values near
    1, as tests/test_conv_stack.py holds the JAX kernel to its XLA path)
    and the PPGs at the bf16 atol. The argmax is not counted: the conv
    chain's rounding adds to the trunk's, and with these random weights
    about 0.5% of the decided frames are then near enough a tie to flip."""
    config, port_config, ckpt = _setup(monkeypatch, tmp_path, 'bfloat16',
                                       seed=3)
    _jax_chip_path(monkeypatch, conv_stack=True)
    monkeypatch.setenv('PPGS_TPU_CONV_STACK', '1')
    calls = []
    stack = port_w2v2fb.w2v2.conv_stack.feature_encoder_stack
    monkeypatch.setattr(port_w2v2fb.w2v2.conv_stack, 'feature_encoder_stack',
                        lambda *a: calls.append(1) or stack(*a))
    rng = np.random.default_rng(4)
    audio = (0.1 * rng.standard_normal((1, 1, 24000))).astype(np.float32)
    want = np.asarray(jax_w2v2fb.from_audios(audio, config=config))
    got = port_w2v2fb.from_audios(audio, config=port_config,
                                  device='cpu').numpy()
    assert calls == [1]
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-2)
    assert np.isclose(got, want, rtol=0, atol=2e-2).mean() > 0.99
    want = np.asarray(ppgs_tpu.from_audio(audio, checkpoint=ckpt,
                                          config=config))
    got = ppgs_tpu_torch.from_audio(audio, checkpoint=ckpt,
                                    config=port_config, device='cpu').numpy()
    assert calls == [1, 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def test_structural_golden_reads_the_same(monkeypatch, tmp_path):
    """The recorded w2v2fb structural golden (seed-derived JAX weights, the
    stored audio and PPG), read by path: the port reproduces it at the
    golden test's own tolerance."""
    jcfg = jax_w2v2.W2V2Config(**TRUNKS['float32'])
    _patch(monkeypatch, tmp_path,
           jax_w2v2.init(jax.random.PRNGKey(11), jcfg), jcfg)
    config = ppgs_tpu_torch.Config(
        config='w2v2fb-structural-golden', representation='w2v2fb',
        input_channels=48, hidden_channels=64, num_hidden_layers=2,
        compute_dtype='float32')
    ckpt = tmp_path / 'w2v2fb-head.npz'
    ppgs_tpu.load.save_params(ckpt, jax_transformer.init(
        jax.random.PRNGKey(12),
        ppgs_tpu.Config(**dataclasses.asdict(config))))
    golden = ppgs_tpu.config.ASSETS_DIR / 'goldens' / 'structural' / (
        'w2v2fb-structural.npz')
    with np.load(golden) as data:
        audio, want = data['audio'], data['ppg']
    got = ppgs_tpu_torch.from_audio(audio, 16000, checkpoint=ckpt,
                                    config=config, device='cpu').numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_frontend_entry_points_match_jax(monkeypatch, tmp_path):
    """preprocess.w2v2fb's from_audio and from_file_to_file (fp16 .npy)
    against the JAX package's, fp32 compute."""
    jcfg = jax_w2v2.W2V2Config(**TRUNKS['float32'])
    _patch(monkeypatch, tmp_path, jax_w2v2.init(jax.random.PRNGKey(5), jcfg),
           jcfg)
    jax_config = ppgs_tpu.config.get().replace(compute_dtype='float32')
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(jax_config))
    rng = np.random.default_rng(6)
    audio = (0.1 * rng.standard_normal((1, 12000))).astype(np.float32)
    want = np.asarray(jax_w2v2fb.from_audio(audio, config=jax_config))
    got = port_w2v2fb.from_audio(audio, config=port_config,
                                 device='cpu').numpy()
    assert got.shape == want.shape == (1, 48, 75)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    wav = tmp_path / 'speech.wav'
    ppgs_tpu_torch.data.audio.save_wav(wav, audio)
    jax_w2v2fb.from_file_to_file(wav, tmp_path / 'jax.npy', jax_config)
    port_w2v2fb.from_file_to_file(wav, tmp_path / 'port.npy', port_config,
                                  device='cpu')
    a, b = np.load(tmp_path / 'jax.npy'), np.load(tmp_path / 'port.npy')
    assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
    np.testing.assert_allclose(b.astype(np.float32), a.astype(np.float32),
                               rtol=0, atol=4e-3)


def test_missing_default_checkpoint_names_the_file(monkeypatch):
    """Without a checkpoint, load.model looks for the converted w2v2fb
    checkpoint under its published name, as the JAX package does, and
    raises FileNotFoundError naming it."""
    monkeypatch.setattr(ppgs_tpu_torch.config, 'CHECKPOINT_DIR',
                        ppgs_tpu_torch.config.ASSETS_DIR / 'no-such-dir')
    with pytest.raises(FileNotFoundError, match='w2v2fb-425k.npz'):
        ppgs_tpu_torch.load.model(representation='w2v2fb', device='cpu')


@pytest.mark.parametrize('call', [
    lambda audio, wav, **kw: port_w2v2fb.from_audios(audio, **kw),
    lambda audio, wav, **kw: port_w2v2fb.from_audio(audio[0], **kw),
    lambda audio, wav, **kw: port_w2v2fb.from_file(wav, **kw),
    lambda audio, wav, **kw: port_w2v2fb.from_file_to_file(
        wav, wav.with_suffix('.npy'), **kw),
], ids=['from_audios', 'from_audio', 'from_file', 'from_file_to_file'])
def test_frontend_runs_on_the_card_unless_told(monkeypatch, tmp_path, call):
    """The frontend's entry points run on the card by default: without CUDA
    they raise, and with device='cpu' they run on the CPU."""
    jcfg = jax_w2v2.W2V2Config(**TRUNKS['float32'])
    _patch(monkeypatch, tmp_path, jax_w2v2.init(jax.random.PRNGKey(7), jcfg),
           jcfg)
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
        assert out.device.type == 'cpu' and out.shape == (1, 48, 25)


def test_from_audio_takes_the_sample_rate_second(monkeypatch, tmp_path):
    """preprocess.w2v2fb.from_audio(audio, 16000, ...) as the JAX
    package's (the sample rate taken second and ignored), fp32 compute."""
    jcfg = jax_w2v2.W2V2Config(**TRUNKS['float32'])
    _patch(monkeypatch, tmp_path, jax_w2v2.init(jax.random.PRNGKey(9), jcfg),
           jcfg)
    jax_config = ppgs_tpu.config.get().replace(compute_dtype='float32')
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(jax_config))
    audio = (0.1 * np.random.default_rng(10).standard_normal(
        (1, 8000))).astype(np.float32)
    want = np.asarray(jax_w2v2fb.from_audio(audio, 16000, config=jax_config))
    got = port_w2v2fb.from_audio(audio, 16000, config=port_config,
                                 device='cpu').numpy()
    assert got.shape == want.shape == (1, 48, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
