"""The port's dataset formatting against the JAX package's, on the CPU:
SPHERE conversion, the TIMIT phone map, Needleman-Wunsch word alignment,
the phone/word merge into TextGrids, the Arctic id map, and each corpus's
``format`` on a synthetic source tree (TIMIT, Arctic, a Common Voice
utterance), compared file for file. Nothing is downloaded: the fetch
functions are not called, and the word dictionary is a stub."""

import csv

import numpy as np
import pytest

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu.data import datasets as jax_datasets
from ppgs_tpu.data import download as jax_download
from ppgs_tpu_torch.data import datasets
from ppgs_tpu_torch.data import download
from ppgs_tpu_torch.data import textgrid
from ppgs_tpu_torch.data.audio import load_wav, save_wav
from ppgs_tpu_torch.phonemes import SILENCE


def make_sphere(path, samples, sample_rate=16000):
    """A NIST SPHERE file with int16 PCM (tests/test_datasets.py's)."""
    pcm = samples.astype('<i2').tobytes()
    header_body = '\n'.join([
        f'sample_count -i {len(samples)}', 'sample_n_bytes -i 2',
        'channel_count -i 1', f'sample_rate -i {sample_rate}',
        'sample_byte_format -s2 01', 'end_head'])
    header = b'NIST_1A\n   1024\n' + header_body.encode() + b'\n'
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(header.ljust(1024, b' ') + pcm)


def tree(root):
    """{relative path: bytes} of every file under root."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


@pytest.fixture
def roots(tmp_path, monkeypatch):
    """Separate directories for each package's output."""
    out = {}
    for name, module in (('jax', ppgs_tpu.config),
                         ('port', ppgs_tpu_torch.config)):
        root = tmp_path / name
        for attr, sub in (('SOURCES_DIR', 'sources'), ('DATA_DIR', 'data'),
                          ('CACHE_DIR', 'cache')):
            monkeypatch.setattr(module, attr, root / sub)
        out[name] = root
    return out


@pytest.fixture
def dictionary():
    lookup = {'cat': [['K', 'AE1', 'T']], 'sat': [['S', 'AE1', 'T']],
              'on': [['AA1', 'N']], 'mat': [['M', 'AE1', 'T']]}
    for module in (jax_datasets.words, datasets.words):
        module.get_word_phones.lookup = lookup
    yield lookup
    for module in (jax_datasets.words, datasets.words):
        del module.get_word_phones.lookup


###############################################################################
# Functions on tests/test_datasets.py's inputs
###############################################################################


def test_sphere_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    samples = (rng.uniform(-0.4, 0.4, 1600) * 32767).astype(np.int16)
    make_sphere(tmp_path / 'x.wav', samples)
    got = datasets.timit.sphere_to_wav(tmp_path / 'x.wav')
    assert got == jax_datasets.timit.sphere_to_wav(tmp_path / 'x.wav')
    with open(tmp_path / 'x.wav', 'rb') as file:
        header = datasets.timit.sphere_header(file)
    with open(tmp_path / 'x.wav', 'rb') as file:
        assert header == jax_datasets.timit.sphere_header(file)
    (tmp_path / 'out.wav').write_bytes(got)
    loaded, rate = load_wav(tmp_path / 'out.wav')
    assert rate == 16000
    np.testing.assert_allclose(loaded[0], samples / 32768.0, atol=1e-6)
    (tmp_path / 'bad.wav').write_bytes(b'RIFF....not sphere')
    for module in (datasets.timit, jax_datasets.timit):
        with pytest.raises(ValueError, match='SPHERE'):
            module.sphere_to_wav(tmp_path / 'bad.wav')


@pytest.mark.parametrize('rows,backfill', [
    ([('0', '1600', 'h#'), ('1600', '3200', 'ax'), ('3200', '4800', 'q'),
      ('4800', '6400', 'h#')], True),
    ([('0', '1600', 'kcl'), ('1600', '3200', 'k'), ('3200', '4800', 'iy')],
     True),
    ([('0', '1600', 'bcl'), ('1600', '3200', 'iy')], True),
    ([('0', '1600', 'bcl'), ('1600', '3200', 'iy')], False)])
def test_ipa_to_cmu_matches_jax(rows, backfill):
    got = datasets.timit.ipa_to_cmu(rows, backfill)
    assert got == jax_datasets.timit.ipa_to_cmu(rows, backfill)


def test_word_alignment_matches_jax(dictionary):
    words, jax_words = datasets.words, jax_datasets.words
    for seq0, seq1 in ((list('abc'), list('abc')), (list('abcd'), list('abd')),
                       (list('kitten'), list('sitting'))):
        assert (words.needleman_wunsch(seq0, seq1)
                == jax_words.needleman_wunsch(seq0, seq1))
    mapping = {'cat': ['k', 'ae', 't'], 'dog': ['d', 'ao', 'g']}
    for phones in (['k', 'ae', 't', 'd', 'ao', 'g'],
                   ['k', 'eh', 't', 'd', 'ao', 'g']):
        for as_splits in (False, True):
            assert (words.align_one_to_many(['cat', 'dog'], mapping, phones,
                                            as_splits)
                    == jax_words.align_one_to_many(['cat', 'dog'], mapping,
                                                   phones, as_splits))
    args = (['pau', 'k', 'ae', 't', 's', 'ae', 't', 'pau'],
            [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7],
            [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    for word_seq in (['cat', 'sat'], None):
        assert (words.from_sequence_data(*args, word_seq)
                == jax_words.from_sequence_data(*args, word_seq))
    prompt = 'The cat, sat - on "mats". Don\'t well-known'
    assert words.tokenize_prompt(prompt) == jax_words.tokenize_prompt(prompt)
    assert words.get_word_phones('cat') == jax_words.get_word_phones('cat')


def test_word_files_match_jax(tmp_path, dictionary):
    """words.from_files_to_files with a prompt file, a prompt that fails
    to align (recovered from the phones alone) and a stem without one."""
    (tmp_path / 'in').mkdir()
    phones = {'a1': [(0.1, 'pau'), (0.2, 'k'), (0.3, 'ae'), (0.4, 't'),
                     (0.5, 's'), (0.6, 'ae'), (0.7, 't'), (0.8, 'pau')],
              'a2': [(0.1, 'pau'), (0.2, 'aa'), (0.3, 'n'), (0.45, 'pau')],
              'a3': [(0.2, 'm'), (0.3, 'ae'), (0.4, 't')]}
    files = []
    for stem, rows in phones.items():
        files.append(tmp_path / 'in' / f'{stem}.csv')
        with open(files[-1], 'w') as file:
            writer = csv.writer(file)
            writer.writerow(['timestamp', 'phoneme'])
            writer.writerows(rows)
    prompts = tmp_path / 'prompts.csv'
    with open(prompts, 'w') as file:
        writer = csv.writer(file)
        writer.writerow(['id', 'prompt'])
        writer.writerows([('a1', 'Cat sat.'), ('a2', 'Cat on mat.')])
    for name, module in (('jax', jax_datasets.words),
                         ('port', datasets.words)):
        (tmp_path / name).mkdir()
        module.from_files_to_files(
            files, [tmp_path / name / f.name for f in files], prompts)
    assert tree(tmp_path / 'port') == tree(tmp_path / 'jax')
    assert len(tree(tmp_path / 'port')) == 3


def test_align_matches_jax(tmp_path):
    phones = [[0.0, 0.1, 'pau'], [0.1, 0.2, 'k'], [0.2, 0.3, 'ae'],
              [0.3, 0.4, 't'], [0.4, 0.5, 'pau']]
    for words in ([[0.1, 0.4, 'cat']], [[0.1, 0.3, 'ca'], [0.3, 0.4, 't']],
                  [[0.1, 0.2, 'k'], [0.2, 0.4, 'at']]):
        got = download.align.from_sequence_data(
            [list(p) for p in phones], [list(w) for w in words])
        want = jax_download.align.from_sequence_data(
            [list(p) for p in phones], [list(w) for w in words])
        assert ([(str(p), p.start, p.end) for p in got.phonemes()]
                == [(str(p), p.start, p.end) for p in want.phonemes()])
        assert ([str(w) for w in got.words()]
                == [str(w) for w in want.words()])
    for module in (download.align, jax_download.align):
        with pytest.raises(ValueError, match='Unaligned phone ae'):
            module.from_sequence_data([list(p) for p in phones],
                                      [[0.1, 0.25, 'ca'], [0.35, 0.4, 't']])
    assert ([str(w) for w in download.align.from_sequence_data(
        [list(p) for p in phones], [[0.1, 0.4, 'cat']]).words()]
        == [SILENCE, 'cat', SILENCE])
    # Files: one merge that works and one without its word file
    for stem in ('utt', 'orphan'):
        with open(tmp_path / f'{stem}.csv', 'w') as file:
            writer = csv.writer(file)
            writer.writerow(['timestamp', 'phoneme'])
            writer.writerows([[0.1, 'pau'], [0.2, 'k'], [0.3, 'ae'],
                              [0.4, 't'], [0.5, 'pau']])
    (tmp_path / 'word').mkdir()
    with open(tmp_path / 'word' / 'utt.csv', 'w') as file:
        writer = csv.writer(file)
        writer.writerow(['start', 'end', 'word'])
        writer.writerows([[0.1, 0.4, 'cat']])
    csvs = [tmp_path / 'utt.csv', tmp_path / 'orphan.csv']
    download.align.from_files_to_files(csvs, tmp_path / 'word',
                                       tmp_path / 'port')
    jax_download.align.from_files_to_files(csvs, tmp_path / 'word',
                                           tmp_path / 'jax')
    assert tree(tmp_path / 'port') == tree(tmp_path / 'jax')
    assert list(tree(tmp_path / 'port')) == ['utt.TextGrid']


def test_arctic_id_map_matches_jax():
    v90 = '( arctic_0001 "Hello there." )\n( arctic_0002 "Second one." )\n'
    v95 = ('( arctic_a0001 "Hello there." )\n'
           '( arctic_a0002 "Second one." )\n')
    for stem in ('arctic_0001', 'arctic_0002', 'arctic_0009'):
        assert (datasets.arctic.version_90_to_version_95(stem, v90, v95)
                == jax_datasets.arctic.version_90_to_version_95(stem, v90,
                                                                v95))


def test_download_helpers_match_jax(tmp_path):
    for ext in ('wav', 'TextGrid', 'PHN'):
        assert download.ci_fmt(ext) == jax_download.ci_fmt(ext)
    for name in ('a.WAV', 'b.wav', 'sub/c.Wav', 'd.phn'):
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_bytes(b'')
    assert (sorted(download.files_with_extension('wav', tmp_path))
            == sorted(jax_download.files_with_extension('wav', tmp_path)))
    with pytest.raises(ValueError, match='does not exist'):
        download.datasets(['nosuch'], format_only=True)


###############################################################################
# format on synthetic source trees
###############################################################################


def test_timit_format_matches_jax(roots):
    """A speaker with three SPHERE utterances, one of whose alignment
    disagrees with its audio (skipped), and the prompts file."""
    for root in roots.values():
        speaker = root / 'data' / 'timit' / 'TIMIT' / 'TRAIN' / 'DR1' / 'MABC0'
        for i, (samples, end) in enumerate(((8000, 8000), (6400, 6400),
                                            (9600, 2000))):
            pcm = (np.random.default_rng(i).uniform(-0.3, 0.3, samples)
                   * 32767).astype(np.int16)
            make_sphere(speaker / f'SA{i}.WAV', pcm)
            third = end // 3
            (speaker / f'SA{i}.PHN').write_text(
                f'0 {third} h#\n{third} {2 * third} kcl\n'
                f'{2 * third} {end} k\n')
            (speaker / f'SA{i}.WRD').write_text(f'{third} {end} cat\n')
        doc = root / 'data' / 'timit' / 'TIMIT' / 'DOC'
        doc.mkdir(parents=True)
        (doc / 'PROMPTS.TXT').write_text('A cat. (sa0)\nA cat again. (sa1)\n')
    jax_datasets.timit.format()
    datasets.timit.format()
    got = tree(roots['port'] / 'cache')
    assert got == tree(roots['jax'] / 'cache')
    assert tree(roots['port'] / 'data') == tree(roots['jax'] / 'data')
    assert sorted(got) == ['timit/MABC0/SA0.TextGrid', 'timit/MABC0/SA0.wav',
                           'timit/MABC0/SA1.TextGrid', 'timit/MABC0/SA1.wav',
                           'timit/MABC0/SA2.wav']


def test_arctic_format_matches_jax(roots, dictionary):
    """One v0.95 speaker with two utterances (one whose labels disagree
    with its audio), aligned through the stub dictionary."""
    for root in roots.values():
        source = root / 'sources' / 'arctic'
        speaker = source / 'cmu_us_bdl_arctic'
        (speaker / 'lab').mkdir(parents=True)
        (speaker / 'wav').mkdir()
        (source / 'sentences.txt').write_text(
            '( arctic_a0001 "Cat sat." )\n( arctic_a0002 "On mat." )\n')
        for i, (stem, seconds) in enumerate((('arctic_a0001', 0.8),
                                             ('arctic_a0002', 0.6))):
            save_wav(speaker / 'wav' / f'{stem}.wav',
                     np.random.default_rng(i).uniform(
                         -0.3, 0.3, int(seconds * 16000)).astype(np.float32))
            labels = ([(0.1, 'pau'), (0.2, 'k'), (0.3, 'ae'), (0.4, 't'),
                       (0.5, 's'), (0.6, 'ae'), (0.7, 't'), (0.8, 'pau')]
                      if i == 0 else [(0.1, 'pau'), (0.3, 'aa'), (0.4, 'n')])
            (speaker / 'lab' / f'{stem}.lab').write_text(
                'separator ;\nnfields 1\n#\n' + ''.join(
                    f'{t:.6f} 125 {p}\n' for t, p in labels))
    jax_datasets.arctic.format()
    datasets.arctic.format()
    got = tree(roots['port'] / 'cache')
    assert got == tree(roots['jax'] / 'cache')
    assert tree(roots['port'] / 'data') == tree(roots['jax'] / 'data')
    assert 'arctic/cmu_us_bdl_arctic/arctic_a0001.TextGrid' in got


def test_commonvoice_utterance_matches_jax(roots):
    """mp3_textgrid on a Charsiu short-form TextGrid (the audio given as
    a WAV: decoding mp3 needs ffmpeg)."""
    for root in roots.values():
        source = root / 'sources' / 'commonvoice'
        (source / 'alignments').mkdir(parents=True)
        (source / 'alignments' / 'clip.TextGrid').write_text(
            'File type = "ooTextFile short"\n"TextGrid"\n\n0\n0.5\n'
            '<exists>\n2\n"IntervalTier"\n"words"\n0\n0.5\n2\n0\n0.25\n'
            '"[SIL]"\n0.25\n0.5\n"cat"\n"IntervalTier"\n"phones"\n0\n0.5\n'
            '3\n0\n0.25\n"[SIL]"\n0.25\n0.4\n"K"\n0.4\n0.5\n"AE"\n')
        audio = root / 'data' / 'clip.wav'
        audio.parent.mkdir(parents=True)
        save_wav(audio, np.random.default_rng(2).uniform(
            -0.3, 0.3, 24000).astype(np.float32), 48000)
        (root / 'cache').mkdir()
    for name, module in (('jax', jax_datasets.commonvoice),
                         ('port', datasets.commonvoice)):
        root = roots[name]
        module.mp3_textgrid(root / 'data' / 'clip.wav', root / 'cache',
                            root / 'cache', root / 'sources' / 'commonvoice')
    got = tree(roots['port'] / 'cache')
    assert got == tree(roots['jax'] / 'cache')
    alignment = textgrid.Alignment(roots['port'] / 'cache' / 'clip.TextGrid')
    assert [str(p) for p in alignment.phonemes()] == [SILENCE, 'K', 'AE']
    assert alignment.duration() == pytest.approx(0.5)
