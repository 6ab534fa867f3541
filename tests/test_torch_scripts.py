"""The port's command-line tools against the JAX package on the CPU: the
three converters (scripts/torch_convert_*.py, which need neither JAX nor
the network) against ppgs_tpu/convert/* on seeded state dicts, and
run_torch.sh, run.sh step for step on the port's CLIs."""

import contextlib
import importlib
import importlib.util
import io
import re
import shlex
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
from ppgs_tpu.convert import conformer_weights as jax_conformer_weights
from ppgs_tpu.convert import transformer_params_from_state_dict
from ppgs_tpu.convert import w2v2_weights as jax_w2v2_weights
from ppgs_tpu.models import conformer as jax_conformer

from test_torch_conformer import TINY as CONFORMER_TINY, _espnet_names
from test_torch_w2v2_ppg import _hf_state_dict

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / 'scripts'


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_same_npz(path, want_tree):
    want = ppgs_tpu.load.flatten_params(want_tree)
    with np.load(path) as got:
        assert sorted(got.files) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)


def test_scripts_never_import_jax_or_ppgs_tpu():
    pattern = re.compile(
        r'^\s*(?:from|import)\s+(?:jax|jaxlib|ppgs_tpu)(?:[.\s,]|$)', re.M)
    files = sorted(SCRIPTS.glob('torch_*.py'))
    assert {f.name for f in files} >= {
        'torch_convert_checkpoint.py', 'torch_convert_conformer.py',
        'torch_convert_w2v2.py'}
    assert not [f.name for f in files if pattern.search(f.read_text())]


def _reference_state_dict(layers=2, C=64, F=128, heads=2):
    """The reference transformer's state dict, seeded torch init."""
    with torch.random.fork_rng():
        torch.manual_seed(4)
        model = torch.nn.Module()
        model.input_layer = torch.nn.Conv1d(80, C, 5, padding='same')
        model.model = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(C, heads, dim_feedforward=F),
            layers, enable_nested_tensor=False)
        model.output_layer = torch.nn.Conv1d(C, 40, 5, padding='same')
    return model.state_dict()


@pytest.mark.parametrize('nested', [False, True])
def test_convert_checkpoint_matches_jax(tmp_path, nested):
    """A reference .pt (flat, or under 'model') -> the JAX converter's
    npz; run as a script in a subprocess for the flat one."""
    state = _reference_state_dict()
    source = tmp_path / 'model.pt'
    torch.save({'model': state} if nested else state, source)
    out = tmp_path / 'out' / 'model.npz'
    if nested:
        _script('torch_convert_checkpoint').main([str(source), str(out)])
    else:
        result = subprocess.run(
            [sys.executable, str(SCRIPTS / 'torch_convert_checkpoint.py'),
             str(source), str(out)], cwd=tmp_path, capture_output=True,
            text=True, timeout=120)
        assert result.returncode == 0, result.stderr
        assert '(2 layers)' in result.stdout
    sd = {k: v.numpy() for k, v in state.items()}
    _assert_same_npz(out, transformer_params_from_state_dict(sd,
                                                             num_layers=2))


def test_convert_conformer_matches_jax(tmp_path):
    """A 24epoch.pth-style file ('encoder.' tensors beside others) -> the
    JAX converter's pytree; the block count from the keys."""
    rng = np.random.default_rng(12)
    flat = ppgs_tpu.load.flatten_params(jax_conformer.init(
        jax.random.PRNGKey(3), jax_conformer.ConformerConfig(
            **CONFORMER_TINY)))
    esp = _espnet_names({k: rng.standard_normal(np.shape(v)).astype(
        np.float32) for k, v in flat.items()})
    source = tmp_path / '24epoch.pth'
    torch.save({'encoder.' + k: torch.from_numpy(v) for k, v in esp.items()}
               | {'decoder.w': torch.zeros(1)}, source)
    out = tmp_path / 'conformer.npz'
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        _script('torch_convert_conformer').main([str(source), str(out)])
    assert '(2 blocks)' in printed.getvalue()
    _assert_same_npz(out, jax_conformer_weights.conformer_params_from_state_dict(
        esp, num_blocks=2))


@pytest.mark.parametrize('charsiu', [False, True])
def test_convert_w2v2_matches_jax(tmp_path, charsiu):
    """A Wav2Vec2Model state dict, or Charsiu's ('wav2vec2.' trunk and
    'cls_head'), -> the JAX converter's trunk (and head, as
    scripts/convert_w2v2.py --charsiu writes it)."""
    sd = _hf_state_dict(np.random.default_rng(13), charsiu, True)
    trunk = jax_w2v2_weights.w2v2_params_from_state_dict(
        sd, num_feat_layers=3, num_layers=2)
    state = {k: torch.from_numpy(v) for k, v in sd.items()}
    if charsiu:
        head = np.random.default_rng(14).standard_normal(
            (40, 48)).astype(np.float32)
        state = {f'wav2vec2.{k}': v for k, v in state.items()}
        state['cls_head.weight'] = torch.from_numpy(head)
        state['cls_head.bias'] = torch.arange(40.0)
        want = {'w2v2': trunk, 'head': {'weight': head.T,
                                        'bias': np.arange(40.0, dtype='f4')}}
    else:
        want = trunk
    source = tmp_path / 'pytorch_model.bin'
    torch.save(state, source)
    out = tmp_path / 'w2v2.npz'
    _script('torch_convert_w2v2').main(
        [str(source), str(out)] + (['--charsiu'] if charsiu else []))
    _assert_same_npz(out, want)


###############################################################################
# run_torch.sh
###############################################################################


def _commands(path):
    """The `python -m` commands of a run script, continuation lines
    joined, with the loop's representation set to encodec."""
    text = path.read_text().replace('\\\n', ' ')
    return [shlex.split(line.strip().replace('"$rep"', 'encodec').replace(
        '"${REPRESENTATIONS[@]}"', 'mel w2v2fb w2v2fc bottleneck encodec'))
        for line in text.splitlines() if line.strip().startswith('python')]


def test_run_torch_is_run_sh_on_the_port():
    """Every step of run.sh, in order, with ppgs_tpu_torch's module; every
    module exists in the port and its CLI takes the step's flags."""
    want = _commands(REPO / 'run.sh')
    got = _commands(REPO / 'run_torch.sh')
    assert len(got) == len(want) == 6
    for command, jax_command in zip(got, want):
        assert command[:2] == ['python', '-m']
        module = command[2]
        assert module == jax_command[2].replace('ppgs_tpu', 'ppgs_tpu_torch',
                                                1)
        assert command[3:] == jax_command[3:]
        assert importlib.util.find_spec(f'{module}.__main__') is not None
        cli = importlib.import_module(f'{module}.__main__')
        help_text = io.StringIO()
        with contextlib.redirect_stdout(help_text), \
                pytest.raises(SystemExit) as exit_info:
            cli.main(['--help'])
        assert exit_info.value.code == 0
        for flag in (a for a in command[3:] if a.startswith('--')):
            assert flag in help_text.getvalue(), (module, flag)
    assert 'encodec' in (REPO / 'run_torch.sh').read_text()
