"""The port's package skeleton against the JAX package: imports, config,
phonemes, parameter files and the entry points' device rule (CPU only)."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu.models import transformer as jax_transformer

REPO = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_and_ppgs_tpu_out():
    """In a fresh interpreter that refuses to import jax or ppgs_tpu, the
    port imports, and neither is loaded afterwards."""
    script = '\n'.join([
        'import importlib.abc, sys',
        'class Refuse(importlib.abc.MetaPathFinder):',
        '    def find_spec(self, name, path=None, target=None):',
        "        top = name.split('.')[0]",
        "        if top in ('jax', 'jaxlib', 'ppgs_tpu'):",
        "            raise ImportError('refused: ' + name)",
        'for name in list(sys.modules):',
        "    if name.split('.')[0] in ('jax', 'jaxlib', 'ppgs_tpu'):",
        '        del sys.modules[name]',
        'sys.meta_path.insert(0, Refuse())',
        'import ppgs_tpu_torch, ppgs_tpu_torch.train, ppgs_tpu_torch.evaluate',
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ppgs_tpu')]",
        'assert not bad, bad',
        "print('ok')",
    ])
    result = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == 'ok'


def test_sources_never_import_jax_or_ppgs_tpu():
    pattern = re.compile(
        r'^\s*(?:from|import)\s+(?:jax|jaxlib|ppgs_tpu)(?:[.\s,]|$)', re.M)
    files = sorted((REPO / 'ppgs_tpu_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_config_registry_matches_jax():
    assert set(ppgs_tpu_torch.config.REGISTRY) == set(
        ppgs_tpu.config.REGISTRY)
    for name, want in ppgs_tpu.config.REGISTRY.items():
        got = ppgs_tpu_torch.config.REGISTRY[name]
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert [f.name for f in dataclasses.fields(ppgs_tpu_torch.Config)] == [
        f.name for f in dataclasses.fields(ppgs_tpu.Config)]
    assert ppgs_tpu_torch.config.get() == ppgs_tpu_torch.config.REGISTRY[
        'ppgs']


def test_phoneme_tables_match_jax():
    for name in ('PHONEMES', 'PHONEME_TO_INDEX_MAPPING', 'NUM_PHONEMES',
                 'VOICED', 'CHARSIU_PERMUTE', 'TIMIT_TO_ARCTIC_MAPPING',
                 'SILENCE'):
        assert getattr(ppgs_tpu_torch, name) == getattr(ppgs_tpu, name), name


def _jax_params(tmp_path, config, seed=0):
    params = jax_transformer.init(jax.random.PRNGKey(seed), config)
    path = tmp_path / 'params.npz'
    ppgs_tpu.load.save_params(path, params)
    return path


def test_npz_round_trip_is_exact(tmp_path):
    path = _jax_params(tmp_path, ppgs_tpu.Config(num_hidden_layers=2))
    want = ppgs_tpu.load.flatten_params(ppgs_tpu.load.load_params(path))
    got = ppgs_tpu_torch.load.flatten_params(
        ppgs_tpu_torch.load.load_params(path))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    # And back: a file the port writes reads identically in JAX
    back = tmp_path / 'back.npz'
    ppgs_tpu_torch.load.save_params(back, ppgs_tpu_torch.load.load_params(
        path))
    again = ppgs_tpu.load.flatten_params(ppgs_tpu.load.load_params(back))
    for key in want:
        np.testing.assert_array_equal(np.asarray(again[key]),
                                      np.asarray(want[key]))


def test_params_from_jax_maps_every_leaf(tmp_path):
    config = ppgs_tpu.Config(num_hidden_layers=3)
    path = _jax_params(tmp_path, config, seed=1)
    flat = ppgs_tpu_torch.load.load_flat(path)
    state = ppgs_tpu_torch.convert.params_from_jax(flat)
    module = ppgs_tpu_torch.models.transformer.Transformer(
        ppgs_tpu_torch.Config(**dataclasses.asdict(config)))
    assert set(state) == set(module.state_dict())
    module.load_state_dict(state, strict=True)
    # The relayouts: QKV fused along the output axis, convs to (O, I, K)
    layer = module.layers[2].attn
    np.testing.assert_array_equal(
        layer.wqkv.detach().numpy()[:, 256:512], flat['layers.2.attn.wk'])
    np.testing.assert_array_equal(
        module.input_conv.weight.detach().numpy(),
        flat['input_conv.weight'].transpose(2, 1, 0))
    with pytest.raises(ValueError, match='Unmapped'):
        ppgs_tpu_torch.convert.params_from_jax(
            {**flat, 'layers.0.attn.extra': np.zeros(1)})


def test_init_has_the_jax_layout():
    config = ppgs_tpu.Config(num_hidden_layers=2, hidden_channels=64,
                             ffn_channels=128)
    want = ppgs_tpu.load.flatten_params(
        jax_transformer.init(jax.random.PRNGKey(0), config))
    got = ppgs_tpu_torch.load.flatten_params(
        ppgs_tpu_torch.models.transformer.init(
            ppgs_tpu_torch.Config(**dataclasses.asdict(config)),
            torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    audio = np.zeros((1, 1, 16000), np.float32)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppgs_tpu_torch.from_audio(audio, checkpoint=tmp_path / 'none.npz')
    with pytest.raises(RuntimeError, match='CUDA'):
        ppgs_tpu_torch.from_features(np.zeros((1, 80, 10), np.float32), [10])


def test_load_model_defaults_to_cuda(monkeypatch, tmp_path):
    """load.model, a public entry point too, runs on the card unless told
    otherwise; with device='cpu' it gives a CPU model with its prepared
    (non-persistent) encoder weights."""
    path = _jax_params(tmp_path, ppgs_tpu.Config(num_hidden_layers=1))
    config = ppgs_tpu_torch.Config(num_hidden_layers=1)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        ppgs_tpu_torch.load.model(checkpoint=path, config=config)
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=config,
                                         device='cpu')
    prepared = model.layers[0].prepared
    assert prepared.wqkv_folded.device.type == 'cpu'
    assert prepared.wqkv_folded.dtype == torch.bfloat16
    assert not any('prepared' in key for key in model.state_dict())


def test_unported_width_raises_on_the_card(monkeypatch):
    """The card's kernels take the mel model's width and the w2v2fb head's
    (C = 512, d_head = 256). A width that the JAX rule sends to its kernels
    and the card's kernels do not take (C = 1024, d_head = 512) raises
    before any work, asked for the card, instead of running plain torch."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    for name in ('mel', 'w2v2fb'):
        config = ppgs_tpu_torch.config.get(name)
        assert ppgs_tpu_torch.models.transformer.use_kernels(config, 'cuda')
    wide = ppgs_tpu_torch.config.get('w2v2fb').replace(hidden_channels=1024)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        ppgs_tpu_torch.from_features(
            np.zeros((1, 768, 10), np.float32), [10], config=wide,
            device='cuda')


def test_only_the_transformer_is_ported():
    """The transformer and convolution models and the mel, w2v2fb,
    bottleneck and spectrogram frontends are ported; another model (the
    wav2vec2 ones) or representation raises, naming ROADMAP.md."""
    for name in ('w2v2fc-pretrained', 'w2v2ft'):
        with pytest.raises(ValueError, match='ROADMAP.md'):
            ppgs_tpu_torch.models.get(ppgs_tpu_torch.config.get(name))
    assert ppgs_tpu_torch.models.get(
        ppgs_tpu_torch.config.get('convolution'))[1] is (
        ppgs_tpu_torch.models.convolution.forward)
    assert (ppgs_tpu_torch.preprocess.get('w2v2fb')
            is ppgs_tpu_torch.preprocess.w2v2fb)
    assert (ppgs_tpu_torch.preprocess.get('spectrogram')
            is ppgs_tpu_torch.preprocess.spectrogram)
    assert (ppgs_tpu_torch.preprocess.get('bottleneck')
            is ppgs_tpu_torch.preprocess.bottleneck)
    with pytest.raises(ValueError, match='ROADMAP.md'):
        ppgs_tpu_torch.preprocess.get('w2v2fc')
