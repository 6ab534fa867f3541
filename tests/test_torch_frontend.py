"""The codebook frontends (encodec, dac) on the port against the JAX
package, on the CPU: ``decode_codes``, the npz assets, inference, two
train steps, the evaluation pass and the codec preprocessors (with a fake
codec model: the codec packages are optional and absent). Codebooks and
weights are seeded; fp32 at 1e-4 (the decode itself at rtol 1e-6, its
concat bit for bit)."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
from ppgs_tpu import frontend as jax_frontend
from ppgs_tpu import parallel
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.preprocess import dac as jax_dac
from ppgs_tpu.preprocess import encodec as jax_encodec
from ppgs_tpu.train import core as jax_train

import ppgs_tpu_torch as port
from ppgs_tpu_torch import convert
from ppgs_tpu_torch import frontend
from ppgs_tpu_torch.preprocess import dac as port_dac
from ppgs_tpu_torch.preprocess import encodec as port_encodec
from ppgs_tpu_torch.train import core as train_core

Q, V, D = 4, 16, 8      # quantizer levels, codebook size, embedding width
MODES = {'encodec': 'sum', 'dac': 'concat'}


def _codebooks(seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((Q, V, D)).astype(np.float32)


def _codes(B, T, seed, levels=Q):
    return np.random.default_rng(seed).integers(
        0, V, size=(B, levels, T)).astype(np.int32)


@pytest.fixture
def assets(tmp_path, monkeypatch):
    """Seeded codebook npz files for encodec ('sum') and dac ('concat') in
    tmp_path, where both packages' CODEBOOK_DIR point; the registries are
    emptied of both names before and after."""
    for name, mode in MODES.items():
        np.savez(tmp_path / f'{name}.npz', codebooks=_codebooks(len(name)),
                 mode=mode)
    for module in (frontend, jax_frontend):
        monkeypatch.setattr(module, 'CODEBOOK_DIR', tmp_path)
    names = tuple(MODES) + ('missing-codec',)
    for name in names:
        frontend.unregister(name)
        jax_frontend.unregister(name)
    yield tmp_path
    for name in names:
        frontend.unregister(name)
        jax_frontend.unregister(name)


def _config(name, **overrides):
    """The codec config at a small width, fp32: 2 layers of C = 64, a
    64-frame window (stride 48)."""
    width = D if MODES[name] == 'sum' else Q * D
    config = ppgs_tpu.config.get(name).replace(
        config=f'{name}-tiny', input_channels=width, num_hidden_layers=2,
        hidden_channels=64, ffn_channels=128, max_len=64, chunk_length=64,
        chunk_overlap=8, compute_dtype='float32', dropout=0.0, **overrides)
    return config, port.Config(**dataclasses.asdict(config))


###############################################################################
# decode_codes and the assets
###############################################################################


@pytest.mark.parametrize('mode', ['sum', 'concat'])
def test_decode_codes_matches_jax(mode):
    codebooks, codes = _codebooks(), _codes(3, 11, 1)
    want = np.asarray(jax_frontend.decode_codes(codes, codebooks, mode))
    got = frontend.decode_codes(torch.from_numpy(codes),
                                torch.from_numpy(codebooks), mode)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == ((3, D, 11) if mode == 'sum'
                                       else (3, Q * D, 11))
    if mode == 'concat':
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('mode', ['sum', 'concat'])
def test_decode_codes_single_utterance_and_float_codes(mode):
    """(Q, T) codes give (C, T); float codes (the collate path's padded
    buffers) decode as their int values; fewer levels than codebooks use
    the first ones, more raise."""
    codebooks, codes = _codebooks(), _codes(1, 9, 2)[0]
    want = np.asarray(jax_frontend.decode_codes(codes, codebooks, mode))
    got = frontend.decode_codes(codes, torch.from_numpy(codebooks), mode)
    assert got.shape == want.shape and got.ndim == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    as_float = frontend.decode_codes(codes.astype(np.float32), codebooks,
                                     mode)
    np.testing.assert_array_equal(as_float.numpy(), got.numpy())
    fewer = frontend.decode_codes(codes[:2], codebooks, mode)
    np.testing.assert_allclose(fewer.numpy(), np.asarray(
        jax_frontend.decode_codes(codes[:2], codebooks, mode)), rtol=1e-6,
        atol=1e-7)
    with pytest.raises(ValueError, match='quantizer levels'):
        frontend.decode_codes(_codes(1, 3, 3, levels=Q + 1), codebooks,
                              mode)


def test_load_reads_the_npz_as_jax_does(assets):
    for name, mode in MODES.items():
        want_books, want_mode = jax_frontend._load(name)
        got_books, got_mode = frontend._load(name)
        assert got_mode == want_mode == mode
        assert got_books.device.type == 'cpu'
        np.testing.assert_array_equal(got_books.numpy(),
                                      np.asarray(want_books))
        closure = frontend.maybe_frontend(port.config.get(name))
        assert closure is frontend.make_frontend(name)   # kept, moved once
        codes = _codes(2, 5, 4)
        np.testing.assert_allclose(
            closure(torch.from_numpy(codes)).numpy(),
            np.asarray(jax_frontend.make_frontend(name)(codes)), rtol=1e-6,
            atol=1e-7)
    assert frontend.maybe_frontend(port.config.get('mel')) is None
    for module in (frontend, jax_frontend):
        with pytest.raises(FileNotFoundError, match='convert_codebooks'):
            module.make_frontend('missing-codec')


###############################################################################
# Inference, training, evaluation
###############################################################################


def _checkpoint(tmp_path, config, seed=0):
    path = tmp_path / f'{config.config}-{seed}.npz'
    ppgs_tpu.load.save_params(path, jax_transformer.init(
        jax.random.PRNGKey(seed), config))
    return path


@pytest.mark.parametrize('case', ['ragged', 'two_windows'])
@pytest.mark.parametrize('name', list(MODES))
def test_from_features_decodes_as_jax_does(assets, name, case):
    """Codes through from_features under the codec config: ragged lengths
    (zero codes past a row's length reach the input conv as the sum of
    each level's code 0, in both packages) in one window, and T = 90 past
    chunk_length (two windows)."""
    jax_config, port_config = _config(name)
    checkpoint = _checkpoint(assets, jax_config)
    T = 40 if case == 'ragged' else 90
    codes = _codes(3, T, 5)
    lengths = np.array([T, T - 13, T // 3])
    for i, n in enumerate(lengths):
        codes[i, :, n:] = 0
    want = np.asarray(ppgs_tpu.from_features(
        codes, lengths, checkpoint=checkpoint, config=jax_config))
    got = port.from_features(codes, lengths, checkpoint=checkpoint,
                             config=port_config, device='cpu')
    assert got.shape == want.shape == (3, 40, T)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('name', list(MODES))
def test_other_representation_is_not_decoded(assets, monkeypatch, name):
    """Under a codec config, features of another representation ('mel')
    take that representation's model and reach it as they are."""
    mel = ppgs_tpu.config.get('mel').replace(
        num_hidden_layers=2, hidden_channels=64, ffn_channels=128,
        max_len=64, chunk_length=64, chunk_overlap=8,
        compute_dtype='float32')
    monkeypatch.setitem(ppgs_tpu.config.REGISTRY, 'mel', mel)
    monkeypatch.setitem(port.config.REGISTRY, 'mel',
                        port.Config(**dataclasses.asdict(mel)))
    jax_config, port_config = _config(name)
    checkpoint = _checkpoint(assets, mel, seed=3)
    features = np.random.default_rng(6).standard_normal(
        (2, 80, 30)).astype(np.float32)
    lengths = np.array([30, 21])
    want = np.asarray(ppgs_tpu.from_features(
        features, lengths, representation='mel', checkpoint=checkpoint,
        config=jax_config))
    got = port.from_features(features, lengths, representation='mel',
                             checkpoint=checkpoint, config=port_config,
                             device='cpu')
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _train_batch(seed, T=48):
    codes = _codes(3, T, seed)
    targets = np.random.default_rng(seed + 1).integers(
        0, 40, size=(3, T)).astype(np.int64)
    lengths = np.array([T, T - 9, 20], dtype=np.int64)
    for i, n in enumerate(lengths):
        codes[i, :, n:] = 0
        targets[i, n:] = -100
    return codes, targets, lengths


@pytest.mark.parametrize('name', list(MODES))
def test_two_train_steps_match_jax(assets, name):
    """Two steps at rate 0 from one init on code batches: the losses and
    the parameters after Adam, fp32. The port's step receives the codes as
    _to_device hands them over (fp32) and decodes them inside."""
    jax_config, port_config = _config(name)
    params = jax_transformer.init(jax.random.PRNGKey(0), jax_config)
    model = port.models.build(port_config)
    model.load_state_dict(convert.model_params_from_jax(
        port_config, port.load.flatten_params(jax.device_get(params))))
    convert.prepare_model(model)
    optimizer = jax_train.make_optimizer(jax_config)
    opt_state = optimizer.init(params)
    step_fn = jax_train.make_train_step(jax_config, optimizer)
    port_opt = train_core.make_optimizer(model.parameters(), port_config)
    step = train_core.make_train_step(model, port_config, port_opt)
    for i, seed in enumerate((7, 8)):
        codes, targets, lengths = _train_batch(seed)
        params, opt_state, want_loss, _ = step_fn(
            params, opt_state, jnp.asarray(codes), jnp.asarray(targets),
            jnp.asarray(lengths), jax.random.PRNGKey(i))
        features, targets_t, lengths_t = train_core._to_device(
            (codes, targets, lengths), torch.device('cpu'))
        assert features.dtype == torch.float32
        got_loss, _ = step(features, targets_t, lengths_t, seed=i)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-5)
    # The parameters after Adam. The key bias gets no gradient (softmax
    # ignores a shift of every score in a row): Adam turns its rounding
    # noise into steps of up to about lr in both packages, so it is held to
    # that reach, and every other parameter to 1e-4
    want = port.load.flatten_params(jax.device_get(params))
    got = convert.model_params_to_jax(port_config, model.state_dict())
    assert sorted(got) == sorted(want)
    reach = 2 * 2 * port_config.learning_rate
    for key in want:
        if key.endswith('.attn.bk'):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=reach, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


class _Capture:
    def update(self, step, scalars, figures=None):
        self.scalars, self.figures = scalars, dict(figures or {})


@pytest.mark.parametrize('name', list(MODES))
def test_evaluate_partition_matches_jax(assets, name):
    """The evaluation pass over two code batches: the scalars against the
    JAX package's pass on the same parameters, and the same figures."""
    jax_config, port_config = _config(name)
    params = jax_transformer.init(jax.random.PRNGKey(1), jax_config)
    model = port.models.build(port_config)
    model.load_state_dict(convert.model_params_from_jax(
        port_config, port.load.flatten_params(jax.device_get(params))))
    convert.prepare_model(model)
    batches = [_train_batch(seed) for seed in (9, 10)]

    def loader_fn(partition):
        return iter(batches)

    want, got = _Capture(), _Capture()
    jax_train.evaluate_partition(
        want, 0, params, jax_config, loader_fn, 'valid',
        parallel.make_mesh(shape=(1,), axis_names=('data',)), 1)
    scalars = train_core.evaluate_partition(got, 0, model, port_config,
                                            loader_fn, 'valid')
    assert scalars == got.scalars
    assert sorted(got.scalars) == sorted(want.scalars)
    for key, value in want.scalars.items():
        if key.startswith(('valid/Count/', 'valid/Total/')) or (
                'Accuracy' in key):
            assert got.scalars[key] == value, key
        else:
            assert got.scalars[key] == pytest.approx(value, rel=1e-5), key
    assert sorted(got.figures) == sorted(want.figures) == [
        'valid/ConfusionMatrix', 'valid/DistanceMatrix']


###############################################################################
# The codec preprocessors
###############################################################################


class _FakeEncodec(torch.nn.Module):
    """An EnCodec-like model: encode((B, 1, S)) -> [(codes (B, Q, S // 320),
    scale)], codes from the audio's sign pattern."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def encode(self, x):
        frames = x.shape[-1] // 320
        blocks = x[..., :frames * 320].reshape(x.shape[0], frames, 320)
        levels = [((blocks[..., q::Q] * self.scale > 0).sum(-1) + q) % 1024
                  for q in range(Q)]
        return [(torch.stack(levels, 1), None)]


class _FakeDac(torch.nn.Module):
    """A DAC-like model: preprocess pads to 512 samples; encode -> (z,
    codes (B, Q, S // 512), ...)."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def preprocess(self, x, sample_rate):
        assert sample_rate == 16000
        return torch.nn.functional.pad(x, (0, -x.shape[-1] % 512))

    def encode(self, x):
        frames = x.shape[-1] // 512
        blocks = x.reshape(x.shape[0], frames, 512) * self.scale
        codes = torch.stack([(blocks[..., q::Q].abs() * 997).sum(-1).long()
                             % 1024 for q in range(Q)], 1)
        return None, codes, None


@pytest.mark.parametrize('name,fake', [('encodec', _FakeEncodec),
                                       ('dac', _FakeDac)])
def test_codec_preprocessor_matches_jax(monkeypatch, name, fake):
    """from_audios with the same fake codec model in both packages: equal
    int32 codes, nearest-upsampled to S // hopsize frames."""
    jax_module, port_module = {'encodec': (jax_encodec, port_encodec),
                               'dac': (jax_dac, port_dac)}[name]
    model = fake()
    for module in (jax_module, port_module):
        monkeypatch.setattr(module, '_model', lambda: model)
    audio = (0.1 * np.random.default_rng(11).standard_normal(
        (2, 1, 16000 + 37))).astype(np.float32)
    want = jax_module.from_audios(audio, config=name)
    got = port_module.from_audios(torch.from_numpy(audio), config=name,
                                  device='cpu')
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.shape == want.shape == (2, Q, (16000 + 37) // 160)
    np.testing.assert_array_equal(got.numpy(), want)
    single = port_module.from_audio(audio[0], config=name, device='cpu')
    np.testing.assert_array_equal(single.numpy(), want[:1])
    assert port.preprocess.get(name) is port_module


@pytest.mark.parametrize('name,package', [('encodec', 'encodec'),
                                          ('dac', 'dac')])
def test_codec_preprocessor_without_its_package(monkeypatch, name, package):
    """Without the codec package, both packages raise the same
    ImportError, naming what to pip install."""
    monkeypatch.setitem(sys.modules, package, None)
    messages = []
    for module in ({'encodec': (jax_encodec, port_encodec),
                    'dac': (jax_dac, port_dac)}[name]):
        with pytest.raises(ImportError, match='pip install') as error:
            module._model()
        messages.append(str(error.value))
    assert messages[0] == messages[1]
