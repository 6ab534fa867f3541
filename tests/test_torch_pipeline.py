"""The port's data-driven entry points against the JAX package's, on the
CPU: feature caching (``preprocess.from_files_to_files``,
``preprocess.datasets``), the worker path (``from_files_to_files(
num_workers > 0)``, ``from_dataloader``), training from a dataset (the
default loaders, a resume), ``evaluate.datasets``, the CLIs, and the
refusal of each entry point without a card.

Tiny fp32 configs (2 layers, C = 64, FFN 128, 64-frame windows) and the
same npz weights on both sides; seeded corpora (``torch_corpus``) in
temporary directories that both packages' config modules point at.
Tolerances: caches within one float16 ulp (the frontends agree at fp32
1e-4, and a float16 save can round one ulp apart); PPGs and parameters at
fp32 1e-4; evaluation counts exactly, its float sums at rtol 1e-6."""

import dataclasses
import importlib
import json
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.train import core as jax_train
from ppgs_tpu_torch.train import core as train_core

from torch_corpus import point_configs, write_corpus

jax_loader = importlib.import_module('ppgs_tpu.data.loader')
loader = importlib.import_module('ppgs_tpu_torch.data.loader')

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = ppgs_tpu.Config(
    config='mel', num_hidden_layers=2, hidden_channels=64, ffn_channels=128,
    chunk_length=64, chunk_overlap=8, max_len=512, compute_dtype='float32',
    max_training_frames=600, evaluation_interval=5, checkpoint_interval=10,
    default_evaluation_steps=2, num_workers=0, datasets=('commonvoice',))
# Lengths about the tiny config's 64-frame window: a batch's padded T
# (collate's 100-frame multiple, so > 64) and its true T fall on either
# side of the window edge, and some rows are past it
SECONDS = (0.31, 0.45, 0.58, 0.63, 0.66, 0.72, 0.95, 1.04, 1.37, 0.5)


def configs(config=TINY, **fields):
    config = config.replace(**fields)
    return config, ppgs_tpu_torch.Config(**dataclasses.asdict(config))


@pytest.fixture(scope='module')
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp('pipeline') / 'tiny.npz'
    ppgs_tpu.load.save_params(
        path, jax_transformer.init(jax.random.PRNGKey(3), TINY))
    return path


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """'commonvoice' with wavs, alignments and seeded float16 mel caches,
    partitioned by the JAX package."""
    point_configs(monkeypatch, tmp_path)
    stems = write_corpus(tmp_path, 'commonvoice', SECONDS, seed=9,
                         mel_cache=True)
    ppgs_tpu.partition.datasets(['commonvoice'])
    return tmp_path, stems


def assert_fp16_ulp(got, want):
    """Within one float16 ulp of the reference value, elementwise."""
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape
    ulp = np.spacing(np.abs(want)).astype(np.float32)
    err = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (err <= ulp).all(), float((err / ulp).max())


###############################################################################
# Feature caching
###############################################################################


def test_preprocess_caches_match_jax(corpus):
    root, stems = corpus
    cache = root / 'cache' / 'commonvoice'
    files = [cache / f'{stem}.wav' for stem in stems]
    jax_config, port_config = configs(max_preprocess_frames=150)
    (root / 'jax').mkdir()
    (root / 'port').mkdir()
    ppgs_tpu.preprocess.from_files_to_files(
        files, [root / 'jax' / s for s in stems], ['mel'], jax_config,
        num_workers=0)
    ppgs_tpu_torch.preprocess.from_files_to_files(
        files, [root / 'port' / s for s in stems], ['mel'], port_config,
        num_workers=2, device='cpu')
    for stem, seconds in zip(stems, SECONDS):
        got = np.load(root / 'port' / f'{stem}-mel.npy')
        assert got.shape == (80, int(seconds * 16000) // 160)
        assert_fp16_ulp(got, np.load(root / 'jax' / f'{stem}-mel.npy'))

    # preprocess.datasets caches beside the audio: JAX's first, then the
    # port's over them
    ppgs_tpu.preprocess.datasets(['commonvoice'], ['mel'], jax_config)
    want = {s: np.load(cache / f'{s}-mel.npy') for s in stems}
    for stem in stems:
        (cache / f'{stem}-mel.npy').unlink()
    ppgs_tpu_torch.preprocess.datasets(['commonvoice'], ['mel'], port_config,
                                       device='cpu')
    for stem in stems:
        assert_fp16_ulp(np.load(cache / f'{stem}-mel.npy'), want[stem])


###############################################################################
# The worker path
###############################################################################


def test_worker_path_matches_jax(corpus, checkpoint):
    """from_files_to_files(num_workers=2) and from_dataloader on the same
    frame-budget batches as JAX's: one output per file, at fp32 1e-4."""
    root, stems = corpus
    files = [root / 'cache' / 'commonvoice' / f'{s}.wav' for s in stems]
    jax_config, port_config = configs()
    outs = {name: [root / name / f'{s}.npy' for s in stems]
            for name in ('jax', 'port', 'port-loader')}
    for directory in outs:
        (root / directory).mkdir()
    ppgs_tpu.from_files_to_files(files, outs['jax'], checkpoint=checkpoint,
                                 num_workers=2, max_frames=250,
                                 config=jax_config)
    ppgs_tpu_torch.from_files_to_files(
        files, outs['port'], checkpoint=checkpoint, num_workers=2,
        max_frames=250, config=port_config, device='cpu')
    batches = loader.loader(files, features=['audio', 'length', 'audio_file'],
                            num_workers=1, max_frames=250,
                            config=port_config)
    assert len(batches) > 2
    ppgs_tpu_torch.from_dataloader(
        batches, {str(f): o for f, o in zip(files, outs['port-loader'])},
        checkpoint=checkpoint, save_workers=2, config=port_config,
        device='cpu')
    for i, seconds in enumerate(SECONDS):
        want = np.load(outs['jax'][i])
        assert want.shape == (40, int(seconds * 16000) // 160)
        for name in ('port', 'port-loader'):
            got = np.load(outs[name][i])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    # A batch whose padded frames are chunked (past the 64-frame window)
    # while its true frames are not, and one whose true frames are too
    extents = [(int(lengths.max()) // 160, audio.shape[-1] // 160)
               for audio, lengths, _ in batches]
    assert any(true <= 64 < padded for true, padded in extents)
    assert any(64 < true for true, _ in extents)


def test_from_dataloader_fans_out_duplicates(corpus, checkpoint):
    root, stems = corpus
    wav = root / 'cache' / 'commonvoice' / f'{stems[0]}.wav'
    _, port_config = configs()
    outs = [root / 'a.npy', root / 'b.npy']
    ppgs_tpu_torch.from_files_to_files([wav, wav], outs, checkpoint=checkpoint,
                                       num_workers=2, config=port_config,
                                       device='cpu')
    np.testing.assert_array_equal(np.load(outs[0]), np.load(outs[1]))


###############################################################################
# Training and evaluation
###############################################################################


def jax_start(directory, config):
    """A step-0 checkpoint of the JAX package's init and Adam state, from
    which both packages' runs resume."""
    params = jax_transformer.init(jax.random.PRNGKey(5), config)
    optimizer = jax_train.make_optimizer(config)
    jax_train.checkpoint_state(directory, 0, 0, params,
                               optimizer.init(params))


def records(directory):
    return [json.loads(line) for line in
            (directory / 'metrics.jsonl').read_text().splitlines()]


def test_train_from_dataset_matches_jax(corpus):
    """train(dataset) with the default loaders, dropout 0, from the same
    step-0 checkpoint: the parameters after 3 steps and the step-0
    validation scalars."""
    root, _ = corpus
    jax_config, port_config = configs(dropout=0.0, evaluation_interval=2)
    for name in ('jax', 'port'):
        jax_start(root / name, jax_config)
    want = jax_train.train('commonvoice', root / 'jax', config=jax_config,
                           max_steps=3)
    model = train_core.train('commonvoice', root / 'port', port_config,
                             max_steps=3, device='cpu')
    want = ppgs_tpu.load.flatten_params(jax.device_get(want))
    got = ppgs_tpu_torch.convert.params_to_jax(model.state_dict())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)
    with np.load(root / 'port' / '00000003.npz') as saved:
        assert int(saved['opt_state.count']) == 3
    got, want = records(root / 'port'), records(root / 'jax')
    assert ([r['step'] for r in got if 'valid/loss' in r]
            == [r['step'] for r in want if 'valid/loss' in r] == [0, 2])
    for g, w in zip(got, want):
        for key in ('train/loss', 'valid/loss', 'valid/Accuracy'):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                           err_msg=key)


def test_resume_continues_the_batch_order(corpus, monkeypatch):
    """A run of one epoch's steps, then a resume for 2 more: the batches
    taken are those of an uninterrupted run, drawn from the JAX package's
    loader epoch by epoch."""
    root, _ = corpus
    jax_config, port_config = configs(max_training_frames=300)
    want = []
    epochs = jax_loader.loader('commonvoice', 'train', config=jax_config)
    for epoch in range(3):
        epochs.batch_sampler.set_epoch(epoch)
        want += [tuple(batch[2].tolist()) for batch in epochs]
    per_epoch = len(epochs)
    assert per_epoch >= 2

    taken = []
    original = train_core.make_train_step

    def make_train_step(*args, **kwargs):
        step = original(*args, **kwargs)

        def recorded(features, targets, lengths, *rest, **kw):
            taken.append(tuple(lengths.tolist()))
            return step(features, targets, lengths, *rest, **kw)
        return recorded

    monkeypatch.setattr(train_core, 'make_train_step', make_train_step)
    train_core.train('commonvoice', root / 'run', port_config,
                     max_steps=per_epoch, device='cpu')
    assert taken == want[:per_epoch]
    train_core.train('commonvoice', root / 'run', port_config,
                     max_steps=per_epoch + 2, device='cpu')
    assert taken == want[:per_epoch + 2]
    with open(root / 'run' / f'{per_epoch + 2:08d}.json') as file:
        assert json.load(file) == {'step': per_epoch + 2, 'epoch': 2}


@pytest.fixture
def tinyset(tmp_path, monkeypatch):
    """tests/test_e2e.py's synthetic_dataset (mel only): 8 utterances of
    0.5-0.7 s with two-phoneme alignments and seeded float16 mel caches,
    5/1/2 train/valid/test."""
    from ppgs_tpu_torch.data import textgrid

    point_configs(monkeypatch, tmp_path)
    cache = tmp_path / 'cache' / 'tinyset'
    cache.mkdir(parents=True)
    (tmp_path / 'partitions').mkdir()
    rng = np.random.default_rng(0)
    stems = []
    for i in range(8):
        stem = f'utt{i:02d}'
        seconds = 0.5 + 0.1 * (i % 3)
        samples = int(seconds * 16000)
        ppgs_tpu_torch.data.audio.save_wav(
            cache / f'{stem}.wav',
            rng.uniform(-0.3, 0.3, (1, samples)).astype(np.float32))
        phones = [textgrid.Phoneme('aa', 0.0, seconds / 2),
                  textgrid.Phoneme('iy', seconds / 2, seconds)]
        textgrid.Alignment([textgrid.Word('ai', phones)]).save(
            cache / f'{stem}.TextGrid')
        np.save(cache / f'{stem}-mel.npy', rng.standard_normal(
            (80, samples // 160)).astype(np.float16))
        stems.append(stem)
    (tmp_path / 'partitions' / 'tinyset.json').write_text(json.dumps(
        {'train': stems[:5], 'valid': stems[5:6], 'test': stems[6:]}))
    return tmp_path


def assert_results_match(got, want):
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for key, value in want[name].items():
            if key.startswith(('Count/', 'Total/')):
                assert got[name][key] == value, (name, key)
            else:
                assert got[name][key] == pytest.approx(
                    value, rel=1e-6, abs=1e-9), (name, key)


@pytest.mark.parametrize('batched', [True, False])
def test_evaluate_matches_jax(tinyset, checkpoint, batched):
    """evaluate.datasets on the test partition: the results dict, the JSON
    files, tensors.npz and the figure files; batched and batch-1
    evaluation agree."""
    jax_config, port_config = configs(datasets=('tinyset',),
                                      batched_test_eval=batched)
    ppgs_tpu.core._MODEL_CACHE.clear()
    want = ppgs_tpu.evaluate.datasets(['tinyset'], checkpoint=checkpoint,
                                      config=jax_config)
    eval_dir = tinyset / 'eval' / 'mel'
    want_files = {p.name: json.loads(p.read_text())
                  for p in eval_dir.glob('*.json')}
    want_tensors = {name: dict(np.load(eval_dir / name / 'tensors.npz'))
                    for name in ('tinyset', 'overall')}
    want_figures = sorted(str(p.relative_to(eval_dir))
                          for p in eval_dir.rglob('*Matrix.*'))
    shutil.rmtree(eval_dir)
    got = ppgs_tpu_torch.evaluate.datasets(
        ['tinyset'], checkpoint=checkpoint, config=port_config, device='cpu')
    assert_results_match(got, want)
    assert sorted(p.name for p in eval_dir.glob('*.json')) == sorted(
        want_files) == ['overall.json', 'tinyset.json']
    assert_results_match(
        {n: json.loads((eval_dir / n).read_text()) for n in want_files},
        want_files)
    for name, tensors in want_tensors.items():
        saved = np.load(eval_dir / name / 'tensors.npz')
        assert sorted(saved.files) == sorted(tensors)
        for key, value in tensors.items():
            np.testing.assert_allclose(saved[key], value, rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        np.testing.assert_array_equal(saved['confusion'],
                                      tensors['confusion'])
    # The figures, under the JAX package's names (jpg and pdf of each)
    assert sorted(str(p.relative_to(eval_dir))
                  for p in eval_dir.rglob('*Matrix.*')) == want_figures
    assert len(want_figures) == 8
    other = ppgs_tpu_torch.evaluate.datasets(
        ['tinyset'], checkpoint=checkpoint, device='cpu',
        config=port_config.replace(batched_test_eval=not batched))
    assert_results_match(other, got)


###############################################################################
# The CLIs and the refusals
###############################################################################


def test_clis(corpus, checkpoint, monkeypatch, capsys):
    """python -m ppgs_tpu_torch.{preprocess,train,evaluate} through
    main(argv), with a registered tiny config."""
    from ppgs_tpu_torch.evaluate import __main__ as evaluate_cli
    from ppgs_tpu_torch.preprocess import __main__ as preprocess_cli
    from ppgs_tpu_torch.train import __main__ as train_cli

    root, stems = corpus
    _, port_config = configs(config=TINY.replace(config='tiny'))
    monkeypatch.setitem(ppgs_tpu_torch.config.REGISTRY, 'tiny', port_config)
    monkeypatch.setattr(ppgs_tpu_torch.config, '_default',
                        ppgs_tpu_torch.config._default)
    cache = root / 'cache' / 'commonvoice'
    before = {s: np.load(cache / f'{s}-mel.npy') for s in stems}
    preprocess_cli.main(['--datasets', 'commonvoice', '--representations',
                         'mel', '--config', 'tiny', '--device', 'cpu'])
    for stem, seconds in zip(stems, SECONDS):
        cached = np.load(cache / f'{stem}-mel.npy')
        assert cached.shape == (80, int(seconds * 16000) // 160)
        assert not np.array_equal(cached, before[stem])
    train_cli.main(['--config', 'tiny', '--steps', '2', '--device', 'cpu'])
    run = root / 'runs' / 'tiny'
    assert (run / '00000002.npz').exists()
    assert 'Config(' in (run / 'config.txt').read_text()
    results = evaluate_cli.main(['--checkpoint', str(run / '00000002.npz'),
                                 '--config', 'tiny', '--device', 'cpu'])
    assert (root / 'eval' / 'tiny' / 'commonvoice.json').exists()
    assert 0 <= results['commonvoice']['Accuracy'] <= 1
    assert 'commonvoice: accuracy=' in capsys.readouterr().out


def test_refusals_without_a_card(corpus, checkpoint, monkeypatch):
    """Without CUDA every new entry point raises unless the CPU is named,
    and reads or writes no file first."""
    import ppgs_tpu_torch.__main__ as port_cli
    from ppgs_tpu_torch.train import __main__ as train_cli

    root, stems = corpus
    files = [root / 'cache' / 'commonvoice' / f'{s}.wav' for s in stems]
    _, port_config = configs()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)

    def poisoned(*args, **kwargs):
        raise AssertionError('a file was read before the device check')

    monkeypatch.setattr(loader, 'Dataset', poisoned)
    monkeypatch.setattr(ppgs_tpu_torch.data, 'Dataset', poisoned)
    before = sorted(root.rglob('*'))
    calls = [
        lambda: ppgs_tpu_torch.from_files_to_files(
            files, [root / 'o.npy'] * len(files), checkpoint=checkpoint,
            num_workers=2, config=port_config),
        lambda: ppgs_tpu_torch.from_dataloader(
            [], {}, checkpoint=checkpoint, config=port_config),
        lambda: train_core.train('commonvoice', root / 'run', port_config,
                                 max_steps=1),
        lambda: ppgs_tpu_torch.evaluate.datasets(
            ['commonvoice'], checkpoint=checkpoint, config=port_config),
        lambda: ppgs_tpu_torch.preprocess.datasets(
            ['commonvoice'], ['mel'], port_config),
        lambda: ppgs_tpu_torch.preprocess.from_files_to_files(
            files, [root / 'o'] * len(files), ['mel'], port_config),
        lambda: ppgs_tpu_torch.preprocess.from_dataloader(
            [], {}, ['mel'], config=port_config),
        lambda: port_cli.main(['--input_paths', str(files[0]),
                               '--num-workers', '2', '--checkpoint',
                               str(checkpoint)]),
        lambda: train_cli.main(['--steps', '1', '--directory',
                                str(root / 'cli-run')]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match='CUDA'):
            call()
    assert sorted(root.rglob('*')) == before
