"""The port's inference API leftovers against the JAX package's, on the CPU:
``.pt`` checkpoints, the convolution model, the spectrogram frontend,
``from_files_to_files``, ``representation_file_extension`` and the CLI,
with the reference architecture in ``torch.nn`` as a second oracle.

Small fp32 configs (2 layers, C = 64, FFN 128, made with
``Config.replace``) unless a case needs the reference's widths. Inputs are
seeded numpy arrays. Tolerances (docs/GOLDEN_PARITY.md's fp32 envelope):
parameters exactly; logits, PPGs and magnitudes at rtol 1e-4, atol 1e-4.
"""

import dataclasses
import math
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
import ppgs_tpu_torch.__main__ as port_cli
import ppgs_tpu.__main__ as jax_cli
from ppgs_tpu.models import convolution as jax_convolution
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu_torch.data import audio as audio_io

TOL = dict(rtol=1e-4, atol=1e-4)


def configs(**fields):
    """The same config in both packages: the default one in fp32 with
    ``fields`` replaced."""
    config = ppgs_tpu.config.get().replace(compute_dtype='float32', **fields)
    return config, ppgs_tpu_torch.Config(**dataclasses.asdict(config))


SMALL = dict(num_hidden_layers=2, hidden_channels=64, ffn_channels=128)


class ReferencePositionalEncoding(torch.nn.Module):
    def __init__(self, channels, max_len=5000):
        super().__init__()
        index = torch.arange(max_len).unsqueeze(1)
        frequency = torch.exp(
            torch.arange(0, channels, 2) * (-math.log(10000.0) / channels))
        encoding = torch.zeros(max_len, 1, channels)
        encoding[:, 0, 0::2] = torch.sin(index * frequency)
        encoding[:, 0, 1::2] = torch.cos(index * frequency)
        self.register_buffer('encoding', encoding)

    def forward(self, x):
        return x + self.encoding[:x.size(0)]


class ReferenceTransformer(torch.nn.Module):
    """The reference architecture (ppgs/model/transformer.py:13-88) in
    eval mode: its state dict is the layout of the published .pt files."""

    def __init__(self, layers=2, hidden=64, ffn=128, inp=80, out=40,
                 heads=2, is_causal=False):
        super().__init__()
        self.position = ReferencePositionalEncoding(hidden)
        self.input_layer = torch.nn.Conv1d(inp, hidden, 5, padding='same')
        self.model = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(hidden, heads, ffn), layers)
        self.output_layer = torch.nn.Conv1d(hidden, out, 5, padding='same')
        self.is_causal = is_causal

    def forward(self, x, lengths):
        mask = (torch.arange(x.shape[-1])[None] < lengths[:, None])[:, None]
        causal = (torch.nn.Transformer.generate_square_subsequent_mask(
            int(lengths.max())) if self.is_causal else None)
        x = self.input_layer(x) * mask
        x = self.model(self.position(x.permute(2, 0, 1)), mask=causal,
                       src_key_padding_mask=~mask.squeeze(1))
        return self.output_layer(x.permute(1, 2, 0)) * mask


def reference_convolution(hidden=64):
    conv = dict(kernel_size=5, padding='same')
    return torch.nn.Sequential(
        torch.nn.Conv1d(80, hidden, **conv), torch.nn.ReLU(),
        torch.nn.Conv1d(hidden, hidden, **conv), torch.nn.ReLU(),
        torch.nn.Conv1d(hidden, 40, **conv)).eval()


def save_pt(path, module, nest):
    state = module.state_dict()
    torch.save({'model': state, 'step': 3} if nest else state, path)
    return path


def features(seed, B=3, T=120, C=80, lengths=(120, 77, 40)):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, C, T)).astype(np.float32)
    lengths = np.array(lengths)
    for i, n in enumerate(lengths):
        feats[i, :, n:] = 0
    return feats, lengths


@pytest.mark.parametrize('nest', [False, True])
def test_pt_checkpoint_loads_as_in_jax(tmp_path, nest):
    """A reference state dict saved with torch.save (flat, or nested under
    'model' beside other entries) loads to the same parameters in both
    packages, exactly; ``from_features`` then agrees."""
    torch.manual_seed(0)
    path = save_pt(tmp_path / 'ref.pt', ReferenceTransformer(), nest)
    jax_config, port_config = configs(**SMALL)
    params, _ = ppgs_tpu.load.model(checkpoint=path, config=jax_config)
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=port_config,
                                         device='cpu')
    want = ppgs_tpu.load.flatten_params(params)
    got = ppgs_tpu_torch.convert.params_to_jax(model.state_dict())
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)

    feats, lengths = features(1)
    np.testing.assert_allclose(
        ppgs_tpu_torch.from_features(feats, lengths, checkpoint=path,
                                     config=port_config,
                                     device='cpu').numpy(),
        np.asarray(ppgs_tpu.from_features(feats, lengths, checkpoint=path,
                                          config=jax_config)), **TOL)


@pytest.mark.parametrize('is_causal', [False, True])
def test_forward_matches_torch_transformer_encoder(tmp_path, is_causal):
    """The port against ``torch.nn.TransformerEncoder`` (the reference
    architecture) on its own .pt weights, 2 layers at the reference's
    widths (C = 256, FFN 2048)."""
    torch.manual_seed(2)
    reference = ReferenceTransformer(hidden=256, ffn=2048,
                                     is_causal=is_causal).eval()
    path = save_pt(tmp_path / 'ref.pt', reference, nest=False)
    _, config = configs(num_hidden_layers=2, is_causal=is_causal)
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=config,
                                         device='cpu')
    feats, lengths = features(3)
    with torch.no_grad():
        want = reference(torch.from_numpy(feats),
                         torch.from_numpy(lengths)).numpy()
    got = ppgs_tpu_torch.models.transformer.forward(
        model, torch.from_numpy(feats), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_convolution_model_matches_jax_and_torch(tmp_path):
    """The convolution model from the reference's .pt (an nn.Sequential)
    and from the JAX layout's npz: against the Sequential itself and
    against JAX, the forward and ``from_features`` (softmax, extent)."""
    torch.manual_seed(4)
    reference = reference_convolution()
    pt = save_pt(tmp_path / 'conv.pt', reference, nest=False)
    jax_config, port_config = configs(config='convolution',
                                      model='convolution', hidden_channels=64)
    feats, lengths = features(5)
    with torch.no_grad():
        want = reference(torch.from_numpy(feats)).numpy()
    model, _ = ppgs_tpu_torch.load.model(checkpoint=pt, config=port_config,
                                         device='cpu')
    assert isinstance(model, ppgs_tpu_torch.models.convolution.Convolution)
    got = ppgs_tpu_torch.models.convolution.forward(
        model, torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    params = jax_convolution.init(jax.random.PRNGKey(0), jax_config)
    npz = tmp_path / 'conv.npz'
    ppgs_tpu.load.save_params(npz, params)
    np.testing.assert_allclose(
        ppgs_tpu_torch.from_features(feats, lengths, checkpoint=npz,
                                     config=port_config, extent=100,
                                     device='cpu').numpy(),
        np.asarray(ppgs_tpu.from_features(feats, lengths, checkpoint=npz,
                                          config=jax_config, extent=100)),
        **TOL)

    # The port's init draws the JAX layout
    port_params = ppgs_tpu_torch.load.flatten_params(
        ppgs_tpu_torch.models.convolution.init(
            port_config, torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in port_params.items()} == {
        k: tuple(v.shape)
        for k, v in ppgs_tpu.load.flatten_params(params).items()}
    assert ppgs_tpu_torch.models.get(port_config)[0] is (
        ppgs_tpu_torch.models.convolution.init)


def test_spectrogram_frontend_matches_jax():
    rng = np.random.default_rng(6)
    audio = (0.1 * rng.standard_normal((2, 1, 16000))).astype(np.float32)
    lengths = np.array([16000, 11000])
    audio[1, :, 11000:] = 0
    want = np.asarray(ppgs_tpu.preprocess.get('spectrogram').from_audios(
        audio, lengths))
    frontend = ppgs_tpu_torch.preprocess.get('spectrogram')
    got = frontend.from_audios(audio, lengths, device='cpu')
    assert got.dtype == torch.float32 and got.shape == want.shape == (
        2, 513, 100)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        frontend.from_audio(audio[0], device='cpu').numpy(),
        np.asarray(ppgs_tpu.preprocess.get('spectrogram').from_audio(
            audio[0])), **TOL)


def write_wavs(directory, seconds, seed):
    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, s in enumerate(seconds):
        path = directory / f'utt{i}.wav'
        audio_io.save_wav(path, (0.1 * rng.standard_normal(
            (1, int(s * 16000)))).astype(np.float32))
        paths.append(path)
    return paths


@pytest.fixture(scope='module')
def small_checkpoint(tmp_path_factory):
    jax_config, _ = configs(**SMALL)
    path = tmp_path_factory.mktemp('api') / 'small.npz'
    ppgs_tpu.load.save_params(
        path, jax_transformer.init(jax.random.PRNGKey(7), jax_config))
    return path


def test_from_files_to_files_matches_jax(tmp_path, small_checkpoint):
    """The file loop (num_workers=0) against JAX's, one file past the
    500-frame window (chunked)."""
    wavs = write_wavs(tmp_path / 'in', (1.0, 2.55, 6.0), seed=8)
    jax_config, port_config = configs(**SMALL)
    jax_out = [tmp_path / f'jax{i}.npy' for i in range(len(wavs))]
    port_out = [tmp_path / f'port{i}.npy' for i in range(len(wavs))]
    ppgs_tpu.from_files_to_files(wavs, jax_out, checkpoint=small_checkpoint,
                                 config=jax_config)
    ppgs_tpu_torch.from_files_to_files(
        wavs, port_out, checkpoint=small_checkpoint, config=port_config,
        device='cpu')
    for got, want, frames in zip(port_out, jax_out, (100, 255, 600)):
        got, want = np.load(got), np.load(want)
        assert got.shape == want.shape == (40, frames)
        np.testing.assert_allclose(got, want, **TOL)


def test_representation_file_extension_matches_jax():
    for name, config in ppgs_tpu.config.REGISTRY.items():
        assert (ppgs_tpu_torch.representation_file_extension(
            ppgs_tpu_torch.config.get(name))
            == ppgs_tpu.representation_file_extension(config)), name
    assert ppgs_tpu_torch.representation_file_extension() == '-ppg.npy'


def test_cli_writes_what_jax_cli_writes(tmp_path, monkeypatch):
    """``python -m ppgs_tpu_torch`` (its ``main``) with ``--device cpu`` on
    a directory writes the JAX CLI's files: <stem>-ppg.npy beside each
    input, here with the convolution config and a seeded npz."""
    for module in (ppgs_tpu.config, ppgs_tpu_torch.config):
        monkeypatch.setattr(module, '_default', module._default)
    params = jax_convolution.init(jax.random.PRNGKey(9),
                                  ppgs_tpu.config.get('convolution'))
    checkpoint = tmp_path / 'conv.npz'
    ppgs_tpu.load.save_params(checkpoint, params)
    wavs = write_wavs(tmp_path / 'jax', (0.5, 1.2), seed=10)
    shutil.copytree(tmp_path / 'jax', tmp_path / 'port')
    args = ['--checkpoint', str(checkpoint), '--config', 'convolution']

    monkeypatch.setattr(sys, 'argv', ['ppgs_tpu', '--input_paths',
                                      str(tmp_path / 'jax'), *args])
    jax_cli.main()
    port_cli.main(['--input_paths', str(tmp_path / 'port'), *args,
                   '--device', 'cpu'])
    for wav in wavs:
        want = np.load(wav.with_name(wav.stem + '-ppg.npy'))
        got = np.load(tmp_path / 'port' / f'{wav.stem}-ppg.npy')
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_refusals(tmp_path, monkeypatch, small_checkpoint):
    """The worker path batches through the data loader as JAX's does: the
    API's and the CLI's outputs match JAX's (the CLI with the convolution
    config). Without a card the file loop raises unless the CPU is named,
    before any file is read."""
    for module in (ppgs_tpu.config, ppgs_tpu_torch.config):
        monkeypatch.setattr(module, '_default', module._default)
    wavs = write_wavs(tmp_path / 'jax', (0.5, 1.3, 0.8), seed=11)
    shutil.copytree(tmp_path / 'jax', tmp_path / 'port')
    jax_config, port_config = configs(**SMALL)
    outs = {name: [tmp_path / f'{name}{i}.npy' for i in range(len(wavs))]
            for name in ('jax', 'port')}
    ppgs_tpu.from_files_to_files(wavs, outs['jax'],
                                 checkpoint=small_checkpoint, num_workers=2,
                                 max_frames=150, config=jax_config)
    ppgs_tpu_torch.from_files_to_files(
        wavs, outs['port'], checkpoint=small_checkpoint, num_workers=2,
        max_frames=150, config=port_config, device='cpu')
    for got, want in zip(outs['port'], outs['jax']):
        got, want = np.load(got), np.load(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    conv = tmp_path / 'conv.npz'
    ppgs_tpu.load.save_params(conv, jax_convolution.init(
        jax.random.PRNGKey(9), ppgs_tpu.config.get('convolution')))
    args = ['--num-workers', '2', '--checkpoint', str(conv), '--config',
            'convolution']
    monkeypatch.setattr(sys, 'argv', ['ppgs_tpu', '--input_paths',
                                      str(tmp_path / 'jax'), *args])
    jax_cli.main()
    port_cli.main(['--input_paths', str(tmp_path / 'port'), *args,
                   '--device', 'cpu'])
    for wav in wavs:
        got = np.load(tmp_path / 'port' / f'{wav.stem}-ppg.npy')
        want = np.load(wav.with_name(wav.stem + '-ppg.npy'))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    wavs = wavs[:1]
    (tmp_path / 'out.npy').unlink(missing_ok=True)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppgs_tpu_torch.from_files_to_files(
            wavs, [tmp_path / 'out.npy'], checkpoint=small_checkpoint,
            config=port_config)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppgs_tpu_torch.load.model(checkpoint=small_checkpoint,
                                  config=port_config)
    assert not (tmp_path / 'out.npy').exists()
