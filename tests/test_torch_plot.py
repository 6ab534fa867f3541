"""The port's plotting layer against the JAX package on the CPU: PPG images
(plain, a second PPG, a TextGrid) pixel for pixel, the video's geometry,
the file entry points (a PPG inferred from audio with device='cpu'), the
accuracy chart, both CLIs, the metric figures and evaluate's figure
files."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
from ppgs_tpu import plot as jax_plot
from ppgs_tpu.evaluate import core as jax_evaluate
from ppgs_tpu.evaluate.metrics import Metrics as JaxMetrics
from ppgs_tpu.models import transformer as jax_transformer

import ppgs_tpu_torch as port
from ppgs_tpu_torch import plot
from ppgs_tpu_torch.evaluate import core as port_evaluate
from ppgs_tpu_torch.evaluate.metrics import Metrics
from ppgs_tpu_torch.plot import __main__ as plot_cli
from ppgs_tpu_torch.plot.accuracy import __main__ as accuracy_cli
from ppgs_tpu_torch.plot.core import CELL_HEIGHT, CELL_WIDTH, LABEL_WIDTH

REPO = Path(__file__).resolve().parents[1]


def random_ppg(seed=0, frames=30):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, frames)).astype(np.float32)
    exp = np.exp(logits - logits.max(axis=0, keepdims=True))
    return exp / exp.sum(axis=0, keepdims=True)


def _textgrid(path, seconds=0.2):
    from ppgs_tpu_torch.data import textgrid

    phones = [textgrid.Phoneme('aa', 0.0, 0.07),
              textgrid.Phoneme('[SIL]', 0.07, 0.12),
              textgrid.Phoneme('IY', 0.12, seconds)]
    textgrid.Alignment([textgrid.Word('x', phones)]).save(path)
    return path


def _pixels(path):
    from PIL import Image

    with Image.open(path) as image:
        return np.asarray(image.convert('RGB'))


###############################################################################
# Images and video
###############################################################################


@pytest.mark.parametrize('overlay', ['plain', 'second_ppg', 'textgrid'])
def test_ppg_image_matches_jax(tmp_path, overlay):
    ppg = random_ppg(frames=20)
    kwargs = {'plain': {}, 'second_ppg': {'second_ppg': random_ppg(1, 20)},
              'textgrid': {'textgrid_file': _textgrid(tmp_path / 'a.TextGrid')}
              }[overlay]
    want = np.asarray(jax_plot.from_ppg_to_image(ppg, **kwargs))
    got = np.asarray(plot.from_ppg_to_image(ppg, **kwargs))
    assert got.shape == (40 * CELL_HEIGHT, LABEL_WIDTH + 20 * CELL_WIDTH, 3)
    np.testing.assert_array_equal(got, want)
    # Each cell holds its probability's intensity in white (+ overlays)
    cells = got[::CELL_HEIGHT, LABEL_WIDTH::CELL_WIDTH].astype(np.int32)
    intensity = (np.clip(ppg, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(cells[..., 0], intensity)
    if overlay == 'textgrid':
        assert (cells[..., 1] == 255).sum(0).min() == 1   # one phone a frame
    out = tmp_path / 'ppg.png'
    plot.from_ppg_to_image_file(ppg, out, **kwargs)
    np.testing.assert_array_equal(_pixels(out), got)


def test_ppg_video_matches_jax(tmp_path):
    """The scrolling video: 50 fps, a frame every 2 PPG frames, 40 rows +
    a 10 px bar at x16, written by both packages alike."""
    cv2 = pytest.importorskip('cv2')
    frames = 60
    ppg = random_ppg(frames=frames)
    outs = [tmp_path / 'jax.mp4', tmp_path / 'port.mp4']
    jax_plot.from_ppg_to_video_file(ppg, None, outs[0])
    plot.from_ppg_to_video_file(ppg, None, outs[1])
    geometry = []
    for out in outs:
        capture = cv2.VideoCapture(str(out))
        geometry.append(tuple(int(round(capture.get(p))) for p in (
            cv2.CAP_PROP_FRAME_COUNT, cv2.CAP_PROP_FPS,
            cv2.CAP_PROP_FRAME_HEIGHT, cv2.CAP_PROP_FRAME_WIDTH)))
        capture.release()
    assert geometry[1] == geometry[0] == (frames // 2, 50, 50 * 16, 100 * 16)
    assert outs[1].read_bytes() == outs[0].read_bytes()


@pytest.fixture
def mel_checkpoint(tmp_path):
    """A 2-layer fp32 mel config of both packages and its seeded npz."""
    config = ppgs_tpu.config.get('mel').replace(
        config='mel-tiny', num_hidden_layers=2, hidden_channels=64,
        ffn_channels=128, compute_dtype='float32')
    path = tmp_path / 'mel.npz'
    ppgs_tpu.load.save_params(path, jax_transformer.init(
        jax.random.PRNGKey(0), config))
    return config, port.Config(**dataclasses.asdict(config)), path


def test_files_to_files_from_audio(tmp_path, monkeypatch, mel_checkpoint):
    """Plotting from audio infers the PPG with the port's from_file on the
    given device: the image is that PPG's, and within one intensity level
    of the JAX package's (the PPGs agree to fp32 rounding)."""
    jax_config, port_config, checkpoint = mel_checkpoint
    wavs = []
    for i, seconds in enumerate((0.6, 0.9)):
        wavs.append(tmp_path / f'a{i}.wav')
        audio = 0.1 * np.random.default_rng(i).standard_normal(
            (1, int(seconds * 16000)))
        port.data.audio.save_wav(wavs[-1], audio.astype(np.float32))
    outs = [tmp_path / f'a{i}.png' for i in range(2)]
    textgrids = [_textgrid(tmp_path / f'a{i}.TextGrid') for i in range(2)]
    plot.from_files_to_files(outs, audio_files=wavs, textgrid_files=textgrids,
                             checkpoint=checkpoint, config=port_config,
                             device='cpu')
    want = tmp_path / 'jax.png'
    for wav, out, textgrid in zip(wavs, outs, textgrids):
        ppg = port.from_file(wav, checkpoint=checkpoint, config=port_config,
                             device='cpu').numpy()
        np.testing.assert_array_equal(_pixels(out), np.asarray(
            plot.from_ppg_to_image(ppg, textgrid_file=textgrid)))
        jax_plot.from_file_to_file(None, want, textgrid_file=textgrid,
                                   audio_file=wav, checkpoint=checkpoint,
                                   config=jax_config)
        apart = np.abs(_pixels(out).astype(int) - _pixels(want).astype(int))
        assert apart.max() <= 1
    # Without device, the inference runs on the card, or raises without one
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plot.from_files_to_files(outs[:1], audio_files=wavs[:1],
                                 checkpoint=checkpoint, config=port_config)


def test_plot_cli_matches_api(tmp_path):
    ppgs = [random_ppg(i, 25) for i in range(2)]
    sources = []
    for i, ppg in enumerate(ppgs):
        sources.append(tmp_path / f'p{i}.npy')
        np.save(sources[-1], ppg)
    second = tmp_path / 'second.npy'
    np.save(second, random_ppg(5, 25))
    outs = [str(tmp_path / f'p{i}.jpg') for i in range(2)]
    plot_cli.main(['--output_paths', *outs, '--ppg_paths',
                   *map(str, sources), '--second_ppg_paths', str(second),
                   str(second)])
    want = tmp_path / 'want.jpg'
    for ppg, out in zip(ppgs, outs):
        jax_plot.from_ppg_to_image_file(ppg, want, second_ppg=np.load(second))
        np.testing.assert_array_equal(_pixels(out), _pixels(want))
    args = plot_cli.parse_args(['--output_paths', 'x.png', '--audio_paths',
                                'x.wav', '--device', 'cpu'])
    assert args.device == 'cpu'


###############################################################################
# The accuracy chart
###############################################################################


def _eval_results(root):
    rng = np.random.default_rng(0)
    for representation in ('mel', 'w2v2fb', 'encodec'):
        (root / representation).mkdir(parents=True)
        for dataset in ('timit', 'arctic'):
            with open(root / representation / f'{dataset}.json', 'w') as f:
                json.dump({'Accuracy': float(rng.uniform(0.4, 0.85))}, f)


def test_accuracy_chart_and_cli_match_jax(tmp_path, monkeypatch):
    eval_dir = tmp_path / 'eval'
    for module in (ppgs_tpu.config, port.config):
        monkeypatch.setattr(module, 'EVAL_DIR', eval_dir)
    _eval_results(eval_dir)
    kwargs = dict(datasets=['timit', 'arctic'],
                  representations=['mel', 'w2v2fb', 'encodec', 'dac'])
    jax_plot.accuracy.from_eval(tmp_path / 'jax.png', **kwargs)
    assert plot.accuracy.from_eval(tmp_path / 'port.png', **kwargs) == (
        tmp_path / 'port.png')
    np.testing.assert_array_equal(_pixels(tmp_path / 'port.png'),
                                  _pixels(tmp_path / 'jax.png'))
    accuracy_cli.main(['--output_file', str(tmp_path / 'cli.png'),
                       '--datasets', 'timit', 'arctic', '--representations',
                       'mel', 'w2v2fb', 'encodec', 'dac'])
    np.testing.assert_array_equal(_pixels(tmp_path / 'cli.png'),
                                  _pixels(tmp_path / 'jax.png'))
    monkeypatch.setattr(port.config, 'EVAL_DIR', tmp_path / 'nothing')
    with pytest.raises(FileNotFoundError, match='No evaluation results'):
        plot.accuracy.from_eval(tmp_path / 'x.png')


###############################################################################
# The metric figures and evaluate's files
###############################################################################


def _rendered(figure):
    figure.canvas.draw()
    return np.asarray(figure.canvas.buffer_rgba()).copy()


def _state(seed):
    """Accumulated metrics of two seeded batches in both packages."""
    jm, pm = JaxMetrics(include_figures=True), Metrics(include_figures=True)
    for s in (seed, seed + 1):
        rng = np.random.default_rng(s)
        logits = rng.standard_normal((2, 40, 30)).astype(np.float32) * 3
        targets = rng.integers(0, 40, size=(2, 30))
        targets[1, 20:] = -100
        jm.update(logits, targets)
        pm.update(torch.from_numpy(logits), torch.from_numpy(targets))
    return jm, pm


@pytest.mark.parametrize('figure', ['ConfusionMatrix', 'DistanceMatrix'])
def test_metric_figures_match_jax(figure):
    """Each figure draws the same matrix as the JAX package's: the images
    equal pixel for pixel."""
    import matplotlib.pyplot as plt

    jm, pm = _state(3)
    want, got = jm()[figure], pm()[figure]
    try:
        np.testing.assert_array_equal(_rendered(got), _rendered(want))
    finally:
        plt.close('all')


def test_save_artifacts_writes_the_jax_files(tmp_path):
    jm, pm = _state(5)
    jax_evaluate.save_artifacts(jm(), jm.state, 'timit', tmp_path / 'jax')
    port_evaluate.save_artifacts(pm(), pm.state, 'timit', tmp_path / 'port')
    names = sorted(p.name for p in (tmp_path / 'jax' / 'timit').iterdir())
    assert names == ['ConfusionMatrix.jpg', 'ConfusionMatrix.pdf',
                     'DistanceMatrix.jpg', 'DistanceMatrix.pdf',
                     'tensors.npz']
    assert sorted(p.name for p in (tmp_path / 'port' / 'timit').iterdir()
                  ) == names
    for name in names[:4:2]:
        np.testing.assert_array_equal(
            _pixels(tmp_path / 'port' / 'timit' / name),
            _pixels(tmp_path / 'jax' / 'timit' / name))
    with np.load(tmp_path / 'jax' / 'timit' / 'tensors.npz') as want, \
            np.load(tmp_path / 'port' / 'timit' / 'tensors.npz') as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_import_leaves_the_drawing_packages_out():
    """Importing the port (plot and evaluate among it) loads no drawing
    package: PIL, matplotlib and cv2 load only when a figure is drawn."""
    script = ('import sys, ppgs_tpu_torch, ppgs_tpu_torch.plot.accuracy, '
              'ppgs_tpu_torch.utils.profiling\n'
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('PIL', 'matplotlib', 'cv2')]\n"
              'assert not bad, bad\n'
              "print('ok')")
    result = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == 'ok'
