"""The wav2vec2 models (W2V2, W2V2FC), their frontends (w2v2fc, w2v2ft)
and wav2vec2's train mode in the port against the JAX package on the CPU:
the same npz weights, the same numpy inputs.

Both packages run a narrow trunk with wav2vec2-base's structure and the
100 Hz final stride (tests/test_w2v2_ppg.py's SMALL: 3 feature convs of
32 channels, 2 layers of C = 48, 4 heads), patched in through
``w2v2_ppg.w2v2_100hz_config`` (and the JAX w2v2fc frontend's own import
of it). The JAX side runs its XLA paths: its train mode reaches no Pallas
kernel (``ppgs_tpu/models/w2v2.py:329``, ``:417``), and neither does the
port's.

The port's dropout, spec-augment and LayerDrop draw from Philox sites
(``ops/dropout.py::w2v2_site``), the JAX package's from
``jax.random.split`` streams: their bits cannot agree. So the train path
is compared at every rate 0 with spec-augment off, and the draws are
checked by their statistics and by replay.

Tolerances: fp32 logits and PPGs at 1e-4 (docs/GOLDEN_PARITY.md); the
gradients at rtol 1e-4 with an atol of 1e-4 of each tensor's largest
gradient (a gradient near 0 has no relative precision) plus 1e-9 (the key
bias's gradient is 0 in exact arithmetic, the softmax does not see it, and
~1e-13 of rounding on both sides); the parameters
after one Adam step at 1e-4; the bf16 conv stack at the w2v2 hidden-state
envelope, atol 2e-3.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu import core as jax_core
from ppgs_tpu.convert import w2v2_weights as jax_w2v2_weights
from ppgs_tpu.models import w2v2 as jax_w2v2
from ppgs_tpu.models import w2v2_ppg as jax_w2v2_ppg
from ppgs_tpu.preprocess import core as jax_preprocess_core
from ppgs_tpu.preprocess import w2v2fc as jax_w2v2fc
from ppgs_tpu.preprocess import w2v2ft as jax_w2v2ft
from ppgs_tpu.train import core as jax_train_core
from ppgs_tpu_torch import convert, core as port_core, models
from ppgs_tpu_torch.models import w2v2, w2v2_ppg
from ppgs_tpu_torch.ops import dropout
from ppgs_tpu_torch.preprocess import core as port_preprocess_core
from ppgs_tpu_torch.preprocess import w2v2fc, w2v2ft
from ppgs_tpu_torch.train import core as train_core

SMALL = dict(conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2),
             conv_stride=(5, 2, 1), hidden_size=48, num_layers=2,
             num_heads=4, intermediate_size=96, num_conv_pos_embeddings=16,
             num_conv_pos_embedding_groups=4)
# Every regularizer off: the train path against JAX's
RATES_OFF = dict(hidden_dropout=0.0, activation_dropout=0.0,
                 attention_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
                 apply_spec_augment=False)
HOP = 160


def _configs(**fields):
    """(JAX trunk config, the port's) with SMALL's fields and ``fields``."""
    jcfg = jax_w2v2.W2V2Config(**{**SMALL, **fields})
    return jcfg, w2v2.W2V2Config(**dataclasses.asdict(jcfg))


def _patch_trunk(monkeypatch, jcfg, pcfg):
    """Both packages' 100 Hz trunk config -> the narrow one."""
    monkeypatch.setattr(jax_w2v2_ppg, 'w2v2_100hz_config',
                        lambda *a, **k: jcfg)
    monkeypatch.setattr(jax_w2v2fc, 'w2v2_100hz_config',
                        lambda *a, **k: jcfg)
    monkeypatch.setattr(w2v2_ppg, 'w2v2_100hz_config', lambda *a, **k: pcfg)


def _model_config(model, **fields):
    config = ppgs_tpu.Config(model=model, compute_dtype='float32', **fields)
    return config, ppgs_tpu_torch.Config(**dataclasses.asdict(config))


def _jax_params(model, jcfg, seed):
    key_trunk, key_head = jax.random.split(jax.random.PRNGKey(seed))
    trunk = jax_w2v2.init(key_trunk, jcfg)
    if model == 'Wav2Vec2.0':
        head = jax_w2v2_ppg._conv_init(key_head, 5, jcfg.hidden_size, 40)
    else:
        head = {'weight': 0.3 * jax.random.normal(
                    key_head, (jcfg.hidden_size, 42)),
                'bias': 0.1 * jnp.arange(42, dtype=jnp.float32) / 42}
    return {'w2v2': trunk, 'head': head}


def _setup(monkeypatch, tmp_path, model, seed=0, **fields):
    """(JAX params, JAX config, the port's model on the CPU, its config,
    the npz) for ``model`` on the narrow trunk."""
    jcfg, pcfg = _configs(**fields)
    _patch_trunk(monkeypatch, jcfg, pcfg)
    config, port_config = _model_config(model)
    params = _jax_params(model, jcfg, seed)
    path = tmp_path / f'{model}.npz'
    ppgs_tpu.load.save_params(path, params)
    module, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=port_config,
                                          device='cpu')
    return (ppgs_tpu.load.load_params(path), config, module, port_config,
            path)


def _audio(seed, B, S, lengths=None):
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, 1, S))).astype(np.float32)
    lengths = np.full(B, S) if lengths is None else np.asarray(lengths)
    for i, n in enumerate(lengths):
        audio[i, :, n:] = 0.0
    return audio, lengths


def _trainable(module):
    """A copy of a loaded (inference) module whose parameters want
    gradients but the frozen feature convs'."""
    module.requires_grad_(True)
    module.w2v2.feature_encoder.requires_grad_(False)
    return module


###############################################################################
# Dispatch, configs and conversion
###############################################################################


def test_models_get_dispatches_every_model():
    """models.get gives the port's (init, forward) for the four models of
    the JAX package's factory; models.build their modules; another name
    raises as JAX's does."""
    want = {'transformer': (models.transformer.init,
                            models.transformer.forward,
                            models.transformer.Transformer),
            'convolution': (models.convolution.init,
                            models.convolution.forward,
                            models.convolution.Convolution),
            'Wav2Vec2.0': (w2v2_ppg.init, w2v2_ppg.forward, w2v2_ppg.W2V2),
            'W2V2FC': (w2v2_ppg.fc_init, w2v2_ppg.fc_forward,
                       w2v2_ppg.W2V2FC)}
    for name, (init, forward, module) in want.items():
        config = ppgs_tpu_torch.Config(model=name, num_hidden_layers=1)
        assert models.get(config) == (init, forward)
        assert callable(ppgs_tpu.models.get(ppgs_tpu.Config(model=name))[1])
        if name in ('transformer', 'convolution'):
            assert isinstance(models.build(config), module)
    assert models.get(ppgs_tpu_torch.config.get('w2v2ft'))[0] is w2v2_ppg.init
    assert (models.get(ppgs_tpu_torch.config.get('w2v2fc-pretrained'))[1]
            is w2v2_ppg.fc_forward)
    with pytest.raises(ValueError, match='nope'):
        models.get(ppgs_tpu_torch.Config(model='nope'))
    with pytest.raises(ValueError):
        ppgs_tpu.models.get(ppgs_tpu.Config(model='nope'))


def test_100hz_and_mask_configs_match_jax():
    """with_final_stride(1), the 100 Hz config and the stride-2 mask
    config: wav2vec2-base's, at 8 s of padded audio 800 frames whose W2V2
    key mask covers 400."""
    assert dataclasses.asdict(w2v2.BASE.with_final_stride(1)) == (
        dataclasses.asdict(jax_w2v2.BASE.with_final_stride(1)))
    for dtype in ('float32', 'bfloat16'):
        got = w2v2_ppg.w2v2_100hz_config(dtype)
        want = jax_w2v2_ppg.w2v2_100hz_config(dtype)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(w2v2_ppg._mask_config(got)) == (
            dataclasses.asdict(jax_w2v2_ppg._mask_config(want)))
    assert w2v2_ppg.PADDING == jax_w2v2_ppg.PADDING == 120
    config = w2v2_ppg.w2v2_100hz_config()
    samples = 8 * 16000 + 2 * w2v2_ppg.PADDING
    assert w2v2.feat_extract_output_lengths(samples, config) == 800
    assert w2v2.feat_extract_output_lengths(
        samples, w2v2_ppg._mask_config(config)) == 400


@pytest.mark.parametrize('model', ['Wav2Vec2.0', 'W2V2FC'])
def test_init_has_the_jax_layout(monkeypatch, model):
    """init / fc_init give the JAX package's pytree on the narrow trunk.
    The JAX heads take 768 inputs whatever the trunk (wav2vec2-base's
    width); the port's take the trunk's width, which is 768 at BASE."""
    _patch_trunk(monkeypatch, *_configs())
    _, port_config = _model_config(model)
    config = ppgs_tpu.Config(model=model)
    want = ppgs_tpu.load.flatten_params(
        ppgs_tpu.models.get(config)[0](jax.random.PRNGKey(0), config))
    got = ppgs_tpu_torch.load.flatten_params(
        models.get(port_config)[0](port_config,
                                   torch.Generator().manual_seed(0)))
    want = {k: tuple(v.shape) for k, v in want.items()}
    want['head.weight'] = tuple(48 if n == 768 else n
                                for n in want['head.weight'])
    assert {k: v.shape for k, v in got.items()} == want
    assert w2v2.BASE.hidden_size == 768
    module = models.build(port_config)
    assert set(convert.model_params_from_jax(port_config, got)) == set(
        module.state_dict())


@pytest.mark.parametrize('model', ['Wav2Vec2.0', 'W2V2FC', 'convolution'])
def test_params_map_to_jax_and_back_exactly(tmp_path, model):
    """model_params_from_jax and model_params_to_jax are inverses on a JAX
    npz: every leaf, bit for bit."""
    if model == 'convolution':
        config = ppgs_tpu.Config(model=model)
        params = ppgs_tpu.models.convolution.init(jax.random.PRNGKey(2),
                                                  config)
    else:
        jcfg, _ = _configs()
        config = ppgs_tpu.Config(model=model)
        params = _jax_params(model, jcfg, 2)
    flat = {k: np.asarray(v)
            for k, v in ppgs_tpu.load.flatten_params(params).items()}
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
    state = convert.model_params_from_jax(port_config, flat)
    back = convert.model_params_to_jax(port_config, state)
    assert set(back) == set(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    if model == 'Wav2Vec2.0':
        np.testing.assert_array_equal(state['head.weight'].numpy(),
                                      flat['head.weight'].transpose(2, 1, 0))
    if model != 'convolution':
        with pytest.raises(ValueError, match='Unmapped'):
            convert.w2v2_ppg_params_from_jax(
                {**flat, 'extra.x': np.zeros(1)}, model == 'Wav2Vec2.0')


def _hf_state_dict(rng, parametrized, with_embed, feat=3, layers=2, c=48,
                   conv=32, k_pos=16, groups=4):
    """A synthetic transformers Wav2Vec2Model state dict (numpy arrays)."""
    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {}
    kernels = (10, 3, 2)
    for i in range(feat):
        sd[f'feature_extractor.conv_layers.{i}.conv.weight'] = normal(
            conv, 1 if i == 0 else conv, kernels[i])
    sd['feature_extractor.conv_layers.0.layer_norm.weight'] = normal(conv)
    sd['feature_extractor.conv_layers.0.layer_norm.bias'] = normal(conv)
    sd['feature_projection.layer_norm.weight'] = normal(conv)
    sd['feature_projection.layer_norm.bias'] = normal(conv)
    sd['feature_projection.projection.weight'] = normal(c, conv)
    sd['feature_projection.projection.bias'] = normal(c)
    if with_embed:
        sd['masked_spec_embed'] = normal(c)
    base = 'encoder.pos_conv_embed.conv'
    g, v = normal(1, 1, k_pos), normal(c, c // groups, k_pos)
    if parametrized:
        sd[f'{base}.parametrizations.weight.original0'] = g
        sd[f'{base}.parametrizations.weight.original1'] = v
    else:
        sd[f'{base}.weight_g'], sd[f'{base}.weight_v'] = g, v
    sd[f'{base}.bias'] = normal(c)
    sd['encoder.layer_norm.weight'] = normal(c)
    sd['encoder.layer_norm.bias'] = normal(c)
    for i in range(layers):
        p = f'encoder.layers.{i}'
        for name in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
            sd[f'{p}.attention.{name}.weight'] = normal(c, c)
            sd[f'{p}.attention.{name}.bias'] = normal(c)
        for name in ('layer_norm', 'final_layer_norm'):
            sd[f'{p}.{name}.weight'] = normal(c)
            sd[f'{p}.{name}.bias'] = normal(c)
        sd[f'{p}.feed_forward.intermediate_dense.weight'] = normal(2 * c, c)
        sd[f'{p}.feed_forward.intermediate_dense.bias'] = normal(2 * c)
        sd[f'{p}.feed_forward.output_dense.weight'] = normal(c, 2 * c)
        sd[f'{p}.feed_forward.output_dense.bias'] = normal(c)
    return sd


@pytest.mark.parametrize('parametrized,with_embed', [
    (False, True), (True, True), (True, False)])
def test_w2v2_params_from_state_dict_matches_jax(parametrized, with_embed):
    """The numpy copy of convert/w2v2_weights.py on a synthetic HF-keyed
    dict: the same pytree, bit for bit (weight_g/weight_v or the
    parametrizations; masked_spec_embed given or defaulted to 0.5)."""
    sd = _hf_state_dict(np.random.default_rng(int(parametrized) + 2
                                              * int(with_embed)),
                        parametrized, with_embed)
    want = jax_w2v2_weights.w2v2_params_from_state_dict(
        sd, num_feat_layers=3, num_layers=2)
    got = convert.w2v2_params_from_state_dict(sd, num_feat_layers=3,
                                              num_layers=2)
    want, got = (ppgs_tpu.load.flatten_params(t) for t in (want, got))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    if not with_embed:
        np.testing.assert_array_equal(got['masked_spec_embed'],
                                      np.full(48, 0.5, np.float32))
    # And the trunk loads: every leaf mapped
    module = w2v2.Wav2Vec2(_configs(conv_stride=(5, 2, 2),
                                    intermediate_size=96)[1])
    module.load_state_dict(convert.w2v2_params_from_jax(got), strict=True)


def test_w2v2_config_from_hf_matches_jax():
    hf = types.SimpleNamespace(
        conv_dim=[64] * 3, conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2],
        hidden_size=96, num_hidden_layers=3, num_attention_heads=4,
        intermediate_size=192, num_conv_pos_embeddings=32,
        num_conv_pos_embedding_groups=8, layer_norm_eps=1e-6,
        hidden_dropout=0.2, activation_dropout=0.05, attention_dropout=0.0,
        feat_proj_dropout=0.1, layerdrop=0.05, apply_spec_augment=False,
        mask_time_prob=0.065, mask_time_length=5)
    got = convert.w2v2_config_from_hf(hf, compute_dtype='bfloat16')
    want = jax_w2v2_weights.w2v2_config_from_hf(hf, compute_dtype='bfloat16')
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_load_model_w2v2fc_pretrained(tmp_path, monkeypatch):
    """load.model under w2v2fc-pretrained reads the Charsiu weights with no
    PPG checkpoint (reference ppgs/load.py:54-56), and names the converter
    when they are missing, as the JAX package does."""
    config = ppgs_tpu_torch.config.get('w2v2fc-pretrained')
    monkeypatch.setattr(w2v2fc, 'W2V2FC_CHECKPOINT', tmp_path / 'nope.npz')
    with pytest.raises(FileNotFoundError, match='convert_w2v2'):
        ppgs_tpu_torch.load.model(config=config, device='cpu')
    jcfg, pcfg = _configs()
    _patch_trunk(monkeypatch, jcfg, pcfg)
    path = tmp_path / 'charsiu.npz'
    ppgs_tpu_torch.load.save_params(path, w2v2_ppg.fc_init(
        config, torch.Generator().manual_seed(0)))
    monkeypatch.setattr(w2v2fc, 'W2V2FC_CHECKPOINT', path)
    module, out_config = ppgs_tpu_torch.load.model(config=config,
                                                   device='cpu')
    assert isinstance(module, w2v2_ppg.W2V2FC)
    assert out_config.model == 'W2V2FC'
    assert module.w2v2.feature_prepared.w0.dtype == torch.float32
    assert not any(p.requires_grad for p in module.parameters())
    # A W2V2 model without a checkpoint: no default exists for 'wav'
    with pytest.raises(ValueError, match='No default checkpoints'):
        ppgs_tpu_torch.load.model(config='w2v2ft', device='cpu')
    with pytest.raises(ValueError, match='.pt checkpoints'):
        ppgs_tpu_torch.load.model(checkpoint=tmp_path / 'w.pt',
                                  config='w2v2ft', device='cpu')


###############################################################################
# Inference
###############################################################################


@pytest.mark.parametrize('model', ['Wav2Vec2.0', 'W2V2FC'])
def test_forward_matches_jax(monkeypatch, tmp_path, model):
    """The W2V2 (its key mask from the stride-2 config: about the first
    half of the 100 Hz frames) and W2V2FC forwards, fp32, a ragged batch,
    at 1e-4 on every frame."""
    params, config, module, _, _ = _setup(monkeypatch, tmp_path, model)
    audio, lengths = _audio(1, 2, 3200, [3200, 2000])
    forward = (jax_w2v2_ppg.forward if model == 'Wav2Vec2.0'
               else jax_w2v2_ppg.fc_forward)
    want = np.asarray(forward(params, jnp.asarray(audio),
                              jnp.asarray(lengths), config,
                              precision='highest'))
    got = module(torch.from_numpy(audio), torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (2, 40, 342)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('model', ['Wav2Vec2.0', 'W2V2FC'])
def test_key_mask_of_each_model(monkeypatch, tmp_path, model):
    """W2V2's trunk takes the stride-2 config's key mask, about the first
    half of its 100 Hz frames (``_mask_config``, a transformers artifact of
    the trained model); W2V2FC's takes its own convs' mask."""
    _, _, module, _, _ = _setup(monkeypatch, tmp_path, model)
    masks = []
    inference = w2v2._inference
    monkeypatch.setattr(w2v2, '_inference',
                        lambda m, f, mask, c: masks.append(mask)
                        or inference(m, f, mask, c))
    audio, lengths = _audio(2, 2, 3200, [3200, 2000])
    with torch.no_grad():
        module(torch.from_numpy(audio), torch.from_numpy(lengths))
    wcfg = module.w2v2.config
    samples = lengths + 2 * w2v2_ppg.PADDING
    mask_config = (w2v2_ppg._mask_config(wcfg) if model == 'Wav2Vec2.0'
                   else wcfg)
    want = [int(w2v2.feat_extract_output_lengths(n, mask_config))
            for n in samples]
    assert masks[0].shape == (2, 342)
    assert masks[0].sum(1).tolist() == want
    if model == 'Wav2Vec2.0':
        assert want == [171, 111]
        assert want == [int(jax_w2v2.feat_extract_output_lengths(
            n, jax_w2v2_ppg._mask_config(jax_w2v2_ppg.w2v2_100hz_config())))
            for n in samples]
    else:
        assert want == [342, 222]


@pytest.mark.parametrize('model,config_name', [('Wav2Vec2.0', 'w2v2ft'),
                                               ('W2V2FC',
                                                'w2v2fc-pretrained')])
def test_from_features_matches_jax(monkeypatch, tmp_path, model,
                                   config_name):
    """The raw-audio models through from_features / infer (no chunking;
    audio and sample counts as they are), fp32, against the JAX
    package's."""
    params, _, _, _, path = _setup(monkeypatch, tmp_path, model, seed=4)
    config = ppgs_tpu.config.get(config_name).replace(
        compute_dtype='float32')
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
    audio, lengths = _audio(5, 2, 4000, [4000, 2500])
    jax_core._MODEL_CACHE.clear()
    port_core._MODEL_CACHE.clear()
    want = np.asarray(ppgs_tpu.from_features(
        audio, lengths, checkpoint=path, config=config))
    got = ppgs_tpu_torch.from_features(
        audio, lengths, checkpoint=path, config=port_config,
        device='cpu').numpy()
    assert got.shape == want.shape == (2, 40, 422)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _charsiu(monkeypatch, tmp_path, seed=6):
    """Point both packages' w2v2fc frontends at one narrow W2V2FC npz."""
    params, _, _, _, path = _setup(monkeypatch, tmp_path, 'W2V2FC',
                                   seed=seed)
    monkeypatch.setattr(jax_w2v2fc, '_params',
                        lambda: ppgs_tpu.load.load_params(path))
    monkeypatch.setattr(jax_w2v2fc, 'W2V2FC_CHECKPOINT', path)
    monkeypatch.setattr(w2v2fc, 'W2V2FC_CHECKPOINT', path)
    # A trace made with another trunk would be reused: jit a new function
    monkeypatch.setattr(jax_w2v2fc, '_forward', jax.jit(
        jax_w2v2fc._forward.__wrapped__, static_argnames=('compute_dtype',)))
    jax_core._MODEL_CACHE.clear()
    port_core._MODEL_CACHE.clear()
    return path


def test_w2v2fc_frontend_matches_jax(monkeypatch, tmp_path):
    """preprocess.get('w2v2fc'): the 100 Hz trunk's hidden states with the
    plain mask, (B, 768, S // hop), fp32 at the w2v2 envelope; from_audio
    and from_file_to_file too."""
    _charsiu(monkeypatch, tmp_path)
    config, port_config = _model_config('transformer', config='w2v2fc',
                                        representation='w2v2fc')
    audio, lengths = _audio(7, 2, 3300, [3300, 2100])
    want = np.asarray(jax_w2v2fc.from_audios(audio, lengths, config=config))
    frontend = ppgs_tpu_torch.preprocess.get('w2v2fc')
    assert frontend is w2v2fc
    got = frontend.from_audios(audio, lengths, config=port_config,
                               device='cpu').numpy()
    assert got.shape == want.shape == (2, 48, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    one = audio[0]
    np.testing.assert_allclose(
        w2v2fc.from_audio(one, config=port_config, device='cpu').numpy(),
        np.asarray(jax_w2v2fc.from_audio(one, config=config)), rtol=0,
        atol=2e-3)
    ppgs_tpu_torch.data.audio.save_wav(tmp_path / 'a.wav', one, 16000)
    w2v2fc.from_file_to_file(tmp_path / 'a.wav', tmp_path / 'port.npy',
                             config=port_config, device='cpu')
    jax_w2v2fc.from_file_to_file(tmp_path / 'a.wav', tmp_path / 'jax.npy',
                                 config=config)
    port, jax_out = (np.load(tmp_path / f'{n}.npy') for n in ('port', 'jax'))
    assert port.dtype == jax_out.dtype == np.float16
    np.testing.assert_allclose(port.astype(np.float32),
                               jax_out.astype(np.float32), atol=4e-3)


def test_w2v2fc_from_audio_matches_jax(monkeypatch, tmp_path):
    """Path 1 in fp32: from_audio(config='w2v2fc') runs the w2v2fc frontend
    and the transformer head (a narrow one here) on its 100 Hz latents."""
    _charsiu(monkeypatch, tmp_path, seed=8)
    config, port_config = _model_config(
        'transformer', config='w2v2fc', representation='w2v2fc',
        input_channels=48, hidden_channels=64, num_hidden_layers=2)
    ckpt = tmp_path / 'head.npz'
    ppgs_tpu.load.save_params(ckpt, ppgs_tpu.models.transformer.init(
        jax.random.PRNGKey(9), config))
    audio, lengths = _audio(10, 2, 4800, [4800, 3000])
    want = np.asarray(ppgs_tpu.from_audio(audio, lengths=lengths,
                                          checkpoint=ckpt, config=config))
    got = ppgs_tpu_torch.from_audio(audio, lengths=lengths, checkpoint=ckpt,
                                    config=port_config, device='cpu').numpy()
    assert got.shape == want.shape == (2, 40, 30)
    for i, n in enumerate(lengths // HOP):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=1e-4,
                                   atol=1e-4)


def test_from_audio_refusals_match_jax(monkeypatch, tmp_path):
    """The two from_audio configs that the JAX package refuses raise the
    same way: w2v2fc-pretrained feeds the trunk's (B, 768, T) features to
    W2V2FC, which takes audio; w2v2ft's representation 'wav' names no
    frontend."""
    _charsiu(monkeypatch, tmp_path)
    audio, _ = _audio(11, 1, 3200)
    for package, kwargs in ((ppgs_tpu, {}), (ppgs_tpu_torch,
                                             {'device': 'cpu'})):
        config = package.config.get('w2v2fc-pretrained').replace(
            compute_dtype='float32')
        with pytest.raises(ValueError, match='squeeze'):
            package.from_audio(audio, 16000, config=config, **kwargs)
        with pytest.raises(ValueError, match='Unknown representation wav'):
            package.from_audio(audio, 16000, config='w2v2ft', **kwargs)


@pytest.mark.parametrize('sample_rate', [None, 16000, 22050])
def test_w2v2ft_frontend_matches_jax(sample_rate):
    """preprocess.get('w2v2ft'): the audio padded by 120 samples a side,
    resampled to 16 kHz first by from_audio."""
    audio, lengths = _audio(12, 2, 1000)
    got = w2v2ft.from_audios(audio, lengths, device='cpu').numpy()
    want = np.asarray(jax_w2v2ft.from_audios(audio, lengths))
    assert got.shape == want.shape == (2, 1240)
    np.testing.assert_array_equal(got, want)
    got = ppgs_tpu_torch.preprocess.get('w2v2ft').from_audio(
        audio[0], sample_rate, device='cpu').numpy()
    want = np.asarray(jax_w2v2ft.from_audio(audio[0], sample_rate))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize('representation', ['w2v2ft', 'wav', 'w2v2fc',
                                            'mel'])
def test_valid_length_matches_jax(representation):
    for samples in (0, 159, 160, 16000, 128037):
        assert port_preprocess_core._valid_length(
            representation, samples, HOP) == (
            jax_preprocess_core._valid_length(representation, samples, HOP))


def test_preprocess_caches_w2v2ft_padded_samples(tmp_path):
    """Caching the raw-audio passthrough keeps each file's samples and the
    padding (``_valid_length``), as the JAX package's caches do."""
    config, port_config = _model_config('Wav2Vec2.0')
    files = []
    for i, n in enumerate((1700, 3100)):
        audio, _ = _audio(13 + i, 1, n)
        files.append(tmp_path / f'f{i}.wav')
        ppgs_tpu_torch.data.audio.save_wav(files[-1], audio[0], 16000)
    for package, name, kwargs in ((ppgs_tpu, 'jax', {}),
                                  (ppgs_tpu_torch, 'port',
                                   {'device': 'cpu'})):
        package.preprocess.from_files_to_files(
            files, [tmp_path / f'{name}{i}' for i in range(2)], ['w2v2ft'],
            config=config if package is ppgs_tpu else port_config,
            num_workers=0, **kwargs)
    for i, n in enumerate((1700, 3100)):
        got = np.load(tmp_path / f'port{i}-w2v2ft.npy')
        want = np.load(tmp_path / f'jax{i}-w2v2ft.npy')
        assert got.shape == want.shape == (n + 240,)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('samples', [4000, 7337])
def test_conv_stack_at_final_stride_1_matches_jax(monkeypatch, samples):
    """PPGS_TPU_CONV_STACK=1 at the 100 Hz trunk's final stride 1: the
    conv-stack kernels' plain versions (conv_gelu at k = 2, s = 1 last)
    against the JAX package's XLA feature encoder in bf16, at atol
    2e-3."""
    jcfg, pcfg = _configs(compute_dtype='bfloat16')
    params = jax_w2v2.init(jax.random.PRNGKey(14), jcfg)
    path_flat = {k: np.asarray(v) for k, v in
                 ppgs_tpu.load.flatten_params(params).items()}
    module = w2v2.Wav2Vec2(pcfg)
    module.load_state_dict(convert.w2v2_params_from_jax(path_flat))
    convert.prepare_w2v2(module)
    monkeypatch.setenv('PPGS_TPU_CONV_STACK', '1')
    calls = []
    stack = w2v2.conv_stack.feature_encoder_stack
    monkeypatch.setattr(w2v2.conv_stack, 'feature_encoder_stack',
                        lambda *a: calls.append(a[-1]) or stack(*a))
    audio, _ = _audio(15, 2, samples)
    audio = audio[:, 0]
    want = np.asarray(jax_w2v2.feature_encoder(params, jnp.asarray(audio),
                                               jcfg))
    got = w2v2.feature_encoder(module, torch.from_numpy(audio),
                               pcfg).numpy()
    assert calls == [(5, 2, 1)]
    T = (((samples - 10) // 5 + 1) - 3) // 2 + 1 - 1
    assert got.shape == want.shape == (2, T, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


###############################################################################
# Train mode
###############################################################################


def _loss_inputs(module, audio, lengths, seed=16):
    with torch.no_grad():
        T = module(torch.from_numpy(audio),
                   torch.from_numpy(lengths)).shape[-1]
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 40, (audio.shape[0], T))
    targets[1, T - 7:] = -100
    return targets


def _port_grads(module, config):
    """The module's gradients in the JAX layout, zeros where none came."""
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in module.named_parameters()}
    return convert.model_params_to_jax(config, grads)


def test_train_forward_at_rate_0_matches_jax_with_gradients(monkeypatch,
                                                            tmp_path):
    """The train forward with every rate 0 and spec-augment off against
    JAX's train forward (train=True, an rng): the logits at 1e-4, and
    every gradient of the masked CE loss against jax.grad's, the frozen
    feature encoder's exactly 0 in both."""
    params, config, module, port_config, _ = _setup(
        monkeypatch, tmp_path, 'Wav2Vec2.0', seed=17, **RATES_OFF)
    module = _trainable(module)
    audio, lengths = _audio(18, 2, 3200, [3200, 2400])
    targets = _loss_inputs(module, audio, lengths)

    def loss_fn(p):
        logits = jax_w2v2_ppg.forward(p, jnp.asarray(audio),
                                      jnp.asarray(lengths), config,
                                      train=True, rng=jax.random.PRNGKey(0),
                                      precision='highest')
        return jax_train_core.loss(logits, jnp.asarray(targets), config), \
            logits

    (want_loss, want_logits), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    logits = module(torch.from_numpy(audio), torch.from_numpy(lengths),
                    train=True, seed=0)
    loss = train_core.loss(logits, torch.from_numpy(targets), port_config)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = _port_grads(module, port_config)
    want = ppgs_tpu.load.flatten_params(want_grads)
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        scale = np.abs(value).max()
        np.testing.assert_allclose(got[key], value, rtol=1e-4,
                                   atol=1e-4 * scale + 1e-9, err_msg=key)
        if key.startswith('w2v2.feature_encoder.'):
            assert scale == 0 and not got[key].any()
    for p in module.w2v2.feature_encoder.parameters():
        assert p.grad is None
    assert all(p.grad is not None
               for p in module.w2v2.encoder.parameters())


def test_train_step_matches_jax(monkeypatch, tmp_path):
    """One make_train_step on the W2V2 model (the w2v2ft config's) against
    the JAX package's jitted step, every rate 0: the loss, the gradient
    statistics (the frozen convs' zeros counted) and every parameter after
    Adam at 1e-4; the frozen convs bit for bit as they were."""
    params, config, module, port_config, _ = _setup(
        monkeypatch, tmp_path, 'Wav2Vec2.0', seed=19, **RATES_OFF)
    module = _trainable(module)
    audio, lengths = _audio(20, 2, 3200, [3200, 2800])
    targets = _loss_inputs(module, audio, lengths, seed=21)

    optimizer = jax_train_core.make_optimizer(config)
    step = jax_train_core.make_train_step(config, optimizer)
    new_params, _, want_loss, want_stats = step(
        params, optimizer.init(params), jnp.asarray(audio),
        jnp.asarray(targets), jnp.asarray(lengths), jax.random.PRNGKey(3),
        with_stats=True)

    before = {n: p.detach().clone()
              for n, p in module.w2v2.feature_encoder.named_parameters()}
    port_step = train_core.make_train_step(
        module, port_config,
        train_core.make_optimizer(module.parameters(), port_config))
    loss, stats = port_step(torch.from_numpy(audio),
                            torch.from_numpy(targets),
                            torch.from_numpy(lengths), 3, with_stats=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for key, value in want_stats.items():
        np.testing.assert_allclose(float(stats[key]), float(value),
                                   rtol=1e-4, err_msg=key)
    assert float(stats['gradients/min']) <= 0 <= float(stats['gradients/max'])
    got = convert.model_params_to_jax(port_config, module.state_dict())
    want = ppgs_tpu.load.flatten_params(new_params)
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], np.asarray(value), rtol=0,
                                   atol=1e-4, err_msg=key)
    for name, p in module.w2v2.feature_encoder.named_parameters():
        assert torch.equal(p, before[name]), name


def test_train_and_resume_write_the_jax_layout(monkeypatch, tmp_path):
    """train(config=w2v2ft) from a loader_fn on the CPU: the steps, the
    step-0 evaluation (the model's inference forward), a checkpoint whose
    keys are the JAX package's params and Adam state, and a resume from
    it."""
    jcfg, pcfg = _configs()
    _patch_trunk(monkeypatch, jcfg, pcfg)
    config = ppgs_tpu_torch.config.get('w2v2ft').replace(
        compute_dtype='float32', evaluation_interval=2,
        checkpoint_interval=100)
    audio, lengths = _audio(22, 2, 3200, [3200, 2600])
    targets = np.random.default_rng(23).integers(0, 40, (2, 342))

    def loader_fn(partition):
        return iter([(audio, targets, lengths)] * 2)

    directory = tmp_path / 'run'
    ppgs_tpu_torch.train.train(directory=directory, config=config,
                               max_steps=2, loader_fn=loader_fn,
                               device='cpu')
    flat = np.load(directory / '00000002.npz')
    jax_config = ppgs_tpu.config.get('w2v2ft')
    want = set(ppgs_tpu.load.flatten_params(jax_w2v2_ppg.init(
        jax.random.PRNGKey(0), jax_config)))
    params = {k[len('params.'):] for k in flat.files
              if k.startswith('params.')}
    assert params == want
    assert {k[len('opt_state.mu.'):] for k in flat.files
            if k.startswith('opt_state.mu.')} == want
    assert int(flat['opt_state.count']) == 2
    model = ppgs_tpu_torch.train.train(directory=directory, config=config,
                                       max_steps=3, loader_fn=loader_fn,
                                       device='cpu')
    assert (directory / '00000003.npz').exists()
    assert isinstance(model, w2v2_ppg.W2V2)
    assert not model.w2v2.feature_encoder[0].conv.weight.requires_grad


def _recorded_drops(monkeypatch):
    calls = []
    original = dropout.dropout

    def recorder(x, seed, site_id, rate):
        out = original(x, seed, site_id, rate)
        calls.append((site_id, rate, x.detach(), out.detach()))
        return out

    monkeypatch.setattr(dropout, 'dropout', recorder)
    return calls


def test_dropout_sites_keep_share_and_scale(monkeypatch, tmp_path):
    """Train mode draws at each of wav2vec2's sites (the feature
    projection, after the positional conv, and four a layer) at its rate;
    each keeps 1 - rate of the elements (within 5 sigma of the binomial),
    scaled by 1 / (1 - rate), and zeroes the rest."""
    _, _, module, _, _ = _setup(
        monkeypatch, tmp_path, 'Wav2Vec2.0', seed=24, layerdrop=0.0,
        apply_spec_augment=False, feat_proj_dropout=0.2)
    calls = _recorded_drops(monkeypatch)
    audio, lengths = _audio(25, 2, 6400)
    with torch.no_grad():
        module(torch.from_numpy(audio), torch.from_numpy(lengths),
               train=True, seed=7)
    config = module.w2v2.config
    want = {dropout.w2v2_site('projection'): 0.2,
            dropout.w2v2_site('pos_conv'): config.hidden_dropout}
    for i in range(config.num_layers):
        want.update({dropout.w2v2_site('probs', i): config.attention_dropout,
                     dropout.w2v2_site('attention', i): config.hidden_dropout,
                     dropout.w2v2_site('activation', i):
                         config.activation_dropout,
                     dropout.w2v2_site('output', i): config.hidden_dropout})
    assert {site: rate for site, rate, _, _ in calls} == want
    assert len(calls) == len(want)
    for site, rate, x, out in calls:
        live = x != 0
        kept = (out != 0) & live
        n = int(live.sum())
        share = float(kept.sum()) / n
        sigma = (rate * (1 - rate) / n) ** 0.5
        assert abs(share - (1 - rate)) <= 5 * sigma + 1e-12, (site, share)
        torch.testing.assert_close(out[kept], x[kept] / (1 - rate),
                                   rtol=1e-6, atol=0)


def test_spec_augment_spans(monkeypatch):
    """Spec-augment: num = max(2, round(0.05 T / 10)) spans of 10 frames a
    row (the padded T's count), each start inside the row's valid starts,
    the spans' frames the embed vector exactly and the others untouched;
    over many seeds the starts cover their range uniformly."""
    _, config = _configs()
    B, T, C = 3, 400, 48
    gen = torch.Generator().manual_seed(26)
    hidden = torch.randn(B, T, C, generator=gen)
    embed = torch.randn(C, generator=gen)
    valid = torch.tensor([400, 250, 12])
    mask = torch.arange(T)[None] < valid[:, None]
    num = max(2, int(0.05 * T / 10 + 0.5))
    assert num == 2
    hi = torch.clamp(valid - 10, min=1)
    starts_seen = []
    for seed in range(300):
        out = w2v2._spec_augment(hidden, mask, seed, embed, config)
        draws = dropout.bits(B * num, seed, dropout.w2v2_site(
            'spec_augment')).view(B, num)
        starts = (draws * hi[:, None]) >> 32
        assert (starts >= 0).all() and (starts < hi[:, None]).all()
        spans = torch.zeros(B, T, dtype=torch.bool)
        for b in range(B):
            for s in starts[b].tolist():
                spans[b, s:s + 10] = True
        is_embed = (out == embed).all(-1)
        assert torch.equal(is_embed, spans)
        assert torch.equal(out[~spans], hidden[~spans])
        assert ((spans.sum(1) >= 10) & (spans.sum(1) <= 10 * num)).all()
        starts_seen.append(starts)
    starts = torch.stack(starts_seen).float()       # (seeds, B, num)
    for b in range(B):
        mean = starts[:, b].mean().item()
        want = (hi[b].item() - 1) / 2
        assert abs(mean - want) <= 0.1 * hi[b].item() + 0.5, (b, mean)
    # a row of T <= 10 frames is left as it is
    short = hidden[:, :10]
    assert torch.equal(w2v2._spec_augment(short, None, 0, embed, config),
                       short)


def test_layerdrop_rate_and_skip(monkeypatch, tmp_path):
    """LayerDrop keeps a layer with probability 1 - layerdrop over seeds
    (one draw a layer and step), and a dropped layer is not run: the
    train forward computes attention for the kept layers only."""
    kept = [w2v2.layer_kept(seed, layer, 0.1) for seed in range(400)
            for layer in range(12)]
    share = sum(kept) / len(kept)
    assert abs(share - 0.9) <= 5 * (0.09 / len(kept)) ** 0.5
    assert all(w2v2.layer_kept(s, 0, 0.0) for s in range(10))
    _, _, module, _, _ = _setup(monkeypatch, tmp_path, 'Wav2Vec2.0',
                                seed=27, layerdrop=0.5)
    attention = w2v2._attention_train
    runs = []
    monkeypatch.setattr(w2v2, '_attention_train',
                        lambda *a: runs.append(a[-1]) or attention(*a))
    audio, lengths = _audio(28, 1, 3200)
    for seed in range(8):
        runs.clear()
        with torch.no_grad():
            module(torch.from_numpy(audio), torch.from_numpy(lengths),
                   train=True, seed=seed)
        want = [dropout.w2v2_site('probs', i) for i in range(2)
                if w2v2.layer_kept(seed, i, 0.5)]
        assert runs == want


def test_train_mode_replays_from_its_seed(monkeypatch, tmp_path):
    """Train mode with every draw on is a function of its seed: two calls
    with one seed equal bit for bit, and so do their gradients; another
    seed differs; without train (or without a seed) the forward is the
    inference one, and it equals train mode at every rate 0."""
    _, _, module, _, _ = _setup(monkeypatch, tmp_path, 'Wav2Vec2.0',
                                seed=29, mask_time_prob=0.3,
                                mask_time_length=3)
    module = _trainable(module)
    audio, lengths = _audio(30, 2, 4000, [4000, 3000])
    x, n = torch.from_numpy(audio), torch.from_numpy(lengths)

    def run(seed):
        module.zero_grad(set_to_none=True)
        out = module(x, n, train=True, seed=seed)
        out.square().mean().backward()
        return out.detach(), [p.grad.clone() for p in module.parameters()
                              if p.grad is not None]

    a, ga = run(5)
    b, gb = run(5)
    assert torch.equal(a, b)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))
    assert not torch.allclose(a, run(6)[0])
    with torch.no_grad():
        plain = module(x, n)
        assert torch.equal(plain, module(x, n, train=True, seed=None))
    module.w2v2.config = dataclasses.replace(module.w2v2.config,
                                             **RATES_OFF)
    with torch.no_grad():
        torch.testing.assert_close(module(x, n, train=True, seed=5), plain,
                                   rtol=1e-6, atol=1e-6)


def test_w2v2fc_trains_its_trunk_without_draws(monkeypatch, tmp_path):
    """W2V2FC ignores train and seed, as the JAX package's fc_forward does;
    with gradients wanted its trunk takes the differentiable path (no
    draws), which equals the inference one."""
    _, _, module, _, _ = _setup(monkeypatch, tmp_path, 'W2V2FC', seed=31)
    audio, lengths = _audio(32, 1, 3200)
    x, n = torch.from_numpy(audio), torch.from_numpy(lengths)
    with torch.no_grad():
        plain = module(x, n)
    module = _trainable(module)
    out = module(x, n, train=True, seed=3)
    out.sum().backward()
    torch.testing.assert_close(out.detach(), plain, rtol=1e-5, atol=1e-5)
    assert module.w2v2.encoder.layers[0].attn.wqkv.grad is not None
    assert module.w2v2.feature_encoder[0].conv.weight.grad is None
