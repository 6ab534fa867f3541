"""The port's data pipeline against the JAX package's, on the CPU: the
native WAV reader, audio loading, collate, the samplers, dataset items and
their lengths cache, the loader, partitions, dataset statistics, the
computed phoneme weights and the notification decorator.

Every comparison is exact: these modules are numpy and file work, and the
port must yield the JAX package's batches index for index."""

import importlib
import json
import shutil
import warnings

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu import native as jax_native
from ppgs_tpu.data import audio as jax_audio
from ppgs_tpu.data import collate as jax_collate
from ppgs_tpu.data import dataset as jax_dataset
from ppgs_tpu_torch import native
from ppgs_tpu_torch.data import audio
from ppgs_tpu_torch.data import collate
from ppgs_tpu_torch.data import dataset

from torch_corpus import point_configs, write_corpus

# The packages' data/__init__ binds the names loader and sampler to
# functions, so the modules are looked up by name
jax_loader = importlib.import_module('ppgs_tpu.data.loader')
jax_sampler = importlib.import_module('ppgs_tpu.data.sampler')
loader = importlib.import_module('ppgs_tpu_torch.data.loader')
sampler = importlib.import_module('ppgs_tpu_torch.data.sampler')

SECONDS = (0.35, 1.2, 0.8, 2.05, 0.5, 1.75, 0.95, 3.1, 0.65, 1.4, 2.6, 0.2,
           1.05, 0.45, 2.3, 1.9)


def configs(**fields):
    config = ppgs_tpu.config.get('mel').replace(**fields)
    return config, ppgs_tpu_torch.config.get('mel').replace(**fields)


def assert_same(got, want):
    """Nested lists/tuples of arrays, strings and paths, equal exactly (an
    array's dtype too)."""
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        assert str(got) == str(want) and type(got) is type(want)


###############################################################################
# The native reader and audio loading
###############################################################################


@pytest.fixture
def wavs(tmp_path):
    """tests/test_native.py's cases."""
    rng = np.random.default_rng(0)
    paths = []
    for i, samples in enumerate([16000, 8000, 24000]):
        path = tmp_path / f'{i}.wav'
        jax_audio.save_wav(path, rng.uniform(-0.8, 0.8, (1, samples)).astype(
            np.float32), 16000)
        paths.append(path)
    return paths


@pytest.fixture
def built():
    """The port's native library, built from its own copy of the source;
    skips only where no compiler builds it, as the JAX package's tests
    do."""
    if not native.available():
        pytest.skip('the native library does not build here (no g++)')
    assert native.library_path().parent.name == 'build'
    assert 'ppgs_tpu_torch' in native.library_path().parts


def test_native_wav_info_and_read(wavs, built):
    for path, samples in zip(wavs, (16000, 8000, 24000)):
        assert native.wav_info(path) == (samples, 16000)
        ours, rate = native.wav_read(path)
        ref, ref_rate = jax_audio.load_wav(path)
        assert rate == ref_rate
        np.testing.assert_array_equal(ours, ref[0])
        if jax_native.available():
            want, _ = jax_native.wav_read(path)
            np.testing.assert_array_equal(ours, want)
    ours, _ = native.wav_read(wavs[2], max_samples=1000)
    np.testing.assert_array_equal(ours, jax_audio.load_wav(wavs[2])[0][0,
                                                                        :1000])


def test_native_wav_read_batch(wavs, built):
    arena, lengths, rates = native.wav_read_batch(wavs, 24000, 2)
    assert arena.shape == (3, 24000)
    assert lengths.tolist() == [16000, 8000, 24000]
    assert set(rates.tolist()) == {16000}
    assert arena[1, 8000:].sum() == 0
    for row, path in zip(arena, wavs):
        ref = jax_audio.load_wav(path)[0][0]
        np.testing.assert_array_equal(row[:ref.shape[0]], ref)


def test_native_invalid(tmp_path, built):
    bad = tmp_path / 'bad.wav'
    bad.write_bytes(b'not a wav at all')
    assert native.wav_read(bad) is None
    assert native.wav_info(bad) is None
    arena, lengths, _ = native.wav_read_batch([bad], 10)
    assert lengths.tolist() == [-1]


def test_native_framewise_indices(built):
    ends = np.array([0.1, 0.2, 0.35])
    labels = np.array([5, 7, 9])
    times = np.array([0.05, 0.1, 0.15, 0.3, 0.4])
    out = native.framewise_indices(ends, labels, times)
    assert out.tolist() == [5, 7, 7, 9, 9]
    from ppgs_tpu.data import textgrid as jax_textgrid

    phones = [jax_textgrid.Phoneme('a', 0.0, 0.1),
              jax_textgrid.Phoneme('b', 0.1, 0.2),
              jax_textgrid.Phoneme('c', 0.2, 0.35)]
    want = jax_textgrid.Alignment([jax_textgrid.Word('w', phones)]) \
        .framewise_phoneme_indices({'a': 5, 'b': 7, 'c': 9}, 0.01, times)
    np.testing.assert_array_equal(out, want)


def test_native_falls_back_without_a_compiler(wavs, monkeypatch):
    """Without the library the Python reader serves, with the same
    samples."""
    monkeypatch.setattr(native, 'library', lambda: None)
    assert native.wav_read(wavs[0]) is None
    got = audio.load(wavs[0])
    np.testing.assert_array_equal(got, jax_audio.load(wavs[0]))
    arena, lengths = audio.load_batch(wavs)
    want, want_lengths = jax_audio.load_batch(wavs)
    np.testing.assert_array_equal(arena, want)
    np.testing.assert_array_equal(lengths, want_lengths)


def test_audio_load_matches_jax(wavs, tmp_path):
    for path in wavs:
        got = audio.load(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_audio.load(path))
    arena, lengths = audio.load_batch(wavs, num_threads=2)
    want, want_lengths = jax_audio.load_batch(wavs)
    assert arena.shape == (3, 1, 24000)
    np.testing.assert_array_equal(arena, want)
    np.testing.assert_array_equal(lengths, want_lengths)
    # A rate other than the target: resampled, and counted at the target
    other = tmp_path / 'other.wav'
    jax_audio.save_wav(other, np.random.default_rng(3).uniform(
        -0.5, 0.5, (1, 22050)).astype(np.float32), 22050)
    np.testing.assert_array_equal(audio.load(other), jax_audio.load(other))
    np.testing.assert_array_equal(audio.load_batch([other, wavs[1]])[0],
                                  jax_audio.load_batch([other, wavs[1]])[0])
    for path in (*wavs, other):
        assert (audio.info_num_samples(path)
                == jax_audio.info_num_samples(path))


###############################################################################
# Collate and the samplers
###############################################################################


def test_collate_matches_jax():
    assert collate.FRAME_MULTIPLE == jax_collate.FRAME_MULTIPLE == 100
    assert collate.SAMPLE_MULTIPLE == jax_collate.SAMPLE_MULTIPLE == 16000
    rng = np.random.default_rng(4)
    features = ('audio', 'phonemes', 'mel', 'encodec', 'stem', 'audio_file',
                'length')
    batch = []
    for i, frames in enumerate((37, 100, 101, 250)):
        mel = rng.standard_normal((80, frames)).astype(np.float16)
        batch.append((
            rng.standard_normal((1, frames * 160 + i)).astype(np.float32),
            rng.integers(0, 40, frames), mel,
            rng.integers(0, 8, (2, frames)).astype(np.int32),
            f'utt{i}', f'/data/utt{i}.wav', frames))
    got = collate.Collate(features)(batch)
    want = jax_collate.Collate(features)(batch)
    assert_same(got, want)
    assert got[0].shape == (4, 1, 48000) and got[1].shape == (4, 300)
    assert (got[1][0, 37:] == -100).all()
    assert got[2].dtype == np.float16 and got[3].dtype == np.int32
    for length, multiple in ((0, 100), (1, 100), (100, 100), (101, 100),
                             (16001, 16000)):
        assert (collate.quantize(length, multiple)
                == jax_collate.quantize(length, multiple))


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Wav files (no cache) for file-list datasets."""
    root = tmp_path_factory.mktemp('corpus')
    write_corpus(root, 'files', SECONDS, seed=5)
    return sorted((root / 'cache' / 'files').glob('*.wav'))


@pytest.mark.parametrize('kind', ['sampler', 'sequential', 'batched'])
@pytest.mark.parametrize('buckets', [1, 3])
@pytest.mark.parametrize('seed', [0, 1234, 77])
def test_samplers_match_jax(corpus, kind, buckets, seed):
    """The same batches for three epochs, index for index."""
    jax_config, port_config = configs(random_seed=seed, buckets=buckets,
                                      max_training_frames=700,
                                      max_inference_frames=600)
    jax_data = jax_dataset.Dataset(corpus, config=jax_config)
    port_data = dataset.Dataset(corpus, config=port_config)
    assert port_data.lengths == jax_data.lengths
    assert_same(port_data.buckets(), jax_data.buckets())
    if kind == 'sampler':
        got = sampler.Sampler(port_data, config=port_config)
        want = jax_sampler.Sampler(jax_data, config=jax_config)
    elif kind == 'sequential':
        got = sampler.SequentialSampler(port_data)
        want = jax_sampler.SequentialSampler(jax_data)
    else:
        got = sampler.BatchedSequentialSampler(port_data, config=port_config)
        want = jax_sampler.BatchedSequentialSampler(jax_data,
                                                    config=jax_config)
    orders = []
    for epoch in range(3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert list(got) == list(want)
        assert len(got) == len(want)
        orders.append(list(got))
    if kind == 'sampler':
        assert orders[0] != orders[1]       # reshuffled each epoch
        assert all(sorted(sum(o, [])) == list(range(len(corpus)))
                   for o in orders)


@pytest.mark.parametrize('partition', ['train', 'valid', 'test',
                                       'test-batch1'])
def test_sampler_by_partition_matches_jax(corpus, partition):
    jax_config, port_config = configs(
        max_inference_frames=500,
        batched_test_eval=partition != 'test-batch1')
    jax_data = jax_dataset.Dataset(corpus, config=jax_config)
    port_data = dataset.Dataset(corpus, config=port_config)
    got = sampler.sampler(port_data, partition, port_config)
    want = jax_sampler.sampler(jax_data, partition, jax_config)
    assert type(got).__name__ == type(want).__name__
    assert list(got) == list(want)
    with pytest.raises(ValueError, match='not defined'):
        sampler.sampler(port_data, 'nosuch', port_config)


###############################################################################
# Datasets, partitions, the loader
###############################################################################


@pytest.fixture
def named(tmp_path, monkeypatch):
    """A corpus named 'commonvoice' with mel caches, its partition written
    by the JAX package, both packages pointed at it."""
    point_configs(monkeypatch, tmp_path)
    stems = write_corpus(tmp_path, 'commonvoice', SECONDS, seed=6,
                         mel_cache=True)
    ppgs_tpu.partition.datasets(['commonvoice'])
    return tmp_path, stems


def test_partitions_match_jax(named):
    root, stems = named
    for name, seconds in (('arctic', (0.3, 0.4)), ('timit', (0.5,))):
        write_corpus(root, name, seconds, seed=7)
    want = {name: json.loads((root / 'partitions' / f'{name}.json')
                             .read_text())
            for name in ('commonvoice',)}
    ppgs_tpu.partition.datasets(['arctic', 'timit'])
    want.update({name: json.loads((root / 'partitions' / f'{name}.json')
                                  .read_text())
                 for name in ('arctic', 'timit')})
    shutil.rmtree(root / 'partitions')
    ppgs_tpu_torch.partition.datasets(['commonvoice', 'arctic', 'timit'])
    for name, partition in want.items():
        got = json.loads((root / 'partitions' / f'{name}.json').read_text())
        assert got == partition
        assert ppgs_tpu_torch.load.partition(name) == partition
    cv = want['commonvoice']
    assert [len(cv[p]) for p in ('train', 'valid', 'test')] == [12, 2, 2]
    assert sorted(sum(cv.values(), [])) == stems
    with pytest.raises(ValueError, match='not defined'):
        ppgs_tpu_torch.partition.datasets(['nosuch'])


def test_dataset_items_match_jax(named):
    """Every feature of every item, and the lengths cache each package
    writes; the max_frames drop warns in scan order."""
    root, _ = named
    cache = root / 'cache' / 'commonvoice'
    features = ['audio', 'phonemes', 'mel', 'length', 'stem', 'audio_file']
    got_items, got_lengths = {}, {}
    for partition in ('train', 'valid', 'test'):
        got = dataset.Dataset('commonvoice', partition, features)
        got_items[partition] = [got[i] for i in range(len(got))]
        got_lengths[partition] = json.loads(
            (cache / f'{partition}-lengths.json').read_text())
        (cache / f'{partition}-lengths.json').unlink()
    for partition in ('train', 'valid', 'test'):
        want = jax_dataset.Dataset('commonvoice', partition, features)
        assert_same(got_items[partition], [want[i] for i in range(len(want))])
        assert got_lengths[partition] == json.loads(
            (cache / f'{partition}-lengths.json').read_text())
    # The cache is read when present: a length edited there is used
    lengths = json.loads((cache / 'train-lengths.json').read_text())
    first = sorted(lengths)[0]
    lengths[first] = 5
    (cache / 'train-lengths.json').write_text(json.dumps(lengths))
    got = dataset.Dataset('commonvoice', 'train', ['phonemes'])
    want = jax_dataset.Dataset('commonvoice', 'train', ['phonemes'])
    assert got.lengths == want.lengths and 5 in got.lengths
    assert_same(got[got.stems.index(first)], want[want.stems.index(first)])
    with warnings.catch_warnings(record=True) as got_warnings:
        warnings.simplefilter('always')
        got = dataset.Dataset('commonvoice', 'train', max_frames=150)
    with warnings.catch_warnings(record=True) as want_warnings:
        warnings.simplefilter('always')
        want = jax_dataset.Dataset('commonvoice', 'train', max_frames=150)
    assert got.stems == want.stems and len(got.stems) < 12
    assert ([str(w.message) for w in got_warnings]
            == [str(w.message) for w in want_warnings])


@pytest.mark.parametrize('num_workers', [0, 2])
def test_loader_matches_jax(named, num_workers):
    """Batches of each partition and of a file list, in order."""
    root, _ = named
    jax_config, port_config = configs(max_training_frames=500,
                                      max_inference_frames=400)
    for source, partition in (('commonvoice', 'train'),
                              ('commonvoice', 'valid'),
                              ('commonvoice', 'test'),
                              (sorted((root / 'cache' / 'commonvoice')
                                      .glob('*.wav')), None)):
        features = (['audio', 'length', 'audio_file'] if partition is None
                    else None)
        got = loader.loader(source, partition, features, num_workers,
                            config=port_config)
        want = jax_loader.loader(source, partition, features, num_workers,
                                 config=jax_config)
        assert len(got) == len(want)
        assert_same(list(got), list(want))
        # A second pass draws the same (one epoch's) batches
        assert_same(list(got), list(want))


def test_loader_raises_a_worker_error_in_the_caller(named):
    root, stems = named
    (root / 'cache' / 'commonvoice' / f'{stems[3]}-mel.npy').unlink()
    _, port_config = configs(max_training_frames=300)
    batches = loader.loader('commonvoice', 'train', num_workers=2,
                            config=port_config)
    with pytest.raises(FileNotFoundError, match=f'{stems[3]}-mel.npy'):
        list(batches)


def test_loader_stops_its_thread_when_the_consumer_stops(named):
    """A consumer that takes one batch and stops leaves no thread
    waiting on the full queue."""
    import threading

    _, port_config = configs(max_training_frames=100)
    ldr = loader.Loader(dataset.Dataset('commonvoice', 'train', ['mel']),
                        [[i] for i in range(12)], collate.Collate(['mel']),
                        num_workers=1, prefetch=1)
    before = threading.active_count()
    batches = iter(ldr)
    next(batches)
    batches.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_stats_match_jax(named, capsys):
    got = ppgs_tpu_torch.data.stats.process(['commonvoice'])
    want = ppgs_tpu.data.stats.process(['commonvoice'])
    assert got == want
    assert got['commonvoice']['files'] == len(SECONDS)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def test_phoneme_weights_computed_as_in_jax(named):
    """With no weights file both count the train partition's framewise
    targets (and write the file); the port then reads it back."""
    root, _ = named
    config = ppgs_tpu_torch.config.get('mel')
    got = ppgs_tpu_torch.load.phoneme_weights(config)
    written = np.load(root / 'phoneme_weights.npz')['weights']
    (root / 'phoneme_weights.npz').unlink()
    want = np.asarray(ppgs_tpu.load.phoneme_weights(
        ppgs_tpu.config.get('mel')))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(written, want)
    counts = np.zeros(40, np.int64)
    data = dataset.Dataset('commonvoice', 'train', ['phonemes', 'length'])
    for i in range(len(data)):
        phonemes, length = data[i]
        counts += np.bincount(phonemes[:length], minlength=40)
    np.testing.assert_array_equal(
        want, (counts.min() / np.maximum(counts, 1)).astype(np.float32))
    np.testing.assert_array_equal(
        ppgs_tpu_torch.load.phoneme_weights(config).numpy(), want)


def test_cli_partition_and_stats(named, capsys):
    root, _ = named
    shutil.rmtree(root / 'partitions')
    from ppgs_tpu_torch.data.stats import __main__ as stats_cli
    from ppgs_tpu_torch.partition import __main__ as partition_cli

    partition_cli.main(['--datasets', 'commonvoice'])
    got = json.loads((root / 'partitions' / 'commonvoice.json').read_text())
    assert got == ppgs_tpu.partition.commonvoice()
    stats_cli.main(['--datasets', 'commonvoice'])
    assert 'commonvoice dataset contains' in capsys.readouterr().out


###############################################################################
# Notifications
###############################################################################


def test_notify(monkeypatch):
    """The decorator posts the job's end or failure to the URL in
    PPGS_NOTIFICATION_URL, and never raises for a delivery failure."""
    from ppgs_tpu_torch.utils import notify

    sent = []

    def urlopen(request, timeout):
        sent.append((request.full_url, json.loads(request.data)['text']))

    monkeypatch.setattr(notify.urllib.request, 'urlopen', urlopen)

    @notify.notify('job')
    def job(fail):
        if fail:
            raise ValueError('bad')
        return 3

    monkeypatch.delenv(notify.ENV_VAR, raising=False)
    assert job(False) == 3 and sent == []
    monkeypatch.setenv(notify.ENV_VAR, 'http://hook.invalid/x')
    assert job(False) == 3
    with pytest.raises(ValueError):
        job(True)
    assert [url for url, _ in sent] == ['http://hook.invalid/x'] * 2
    assert sent[0][1].startswith('job finished in')
    assert sent[1][1].startswith('job failed after') and 'bad' in sent[1][1]

    def broken(request, timeout):
        raise OSError('unreachable')

    monkeypatch.setattr(notify.urllib.request, 'urlopen', broken)
    assert job(False) == 3
    assert notify.send('x') is False
