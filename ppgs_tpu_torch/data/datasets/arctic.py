"""CMU Arctic dataset adapter
(reference: ppgs/data/datasets/arctic/core.py:16-204).

Downloads seven speakers' tarballs + the sentence list; parses festival .lab
phone alignments; maps v0.90 utterance ids to v0.95; aligns words via
CMUdict + Needleman-Wunsch; merges into TextGrids.
"""

import csv
import re
import shutil

from ... import config as config_mod
from ...phonemes import PHONEMES, SILENCE
from .. import download as download_mod
from . import words as words_mod

SPEAKERS = ['bdl', 'slt', 'awb', 'jmk', 'ksp', 'clb', 'rms']


def download(speakers=SPEAKERS):
    """Download the CMU Arctic database."""
    source_directory = config_mod.SOURCES_DIR / 'arctic'
    source_directory.mkdir(parents=True, exist_ok=True)

    # Arctic quirk: one text file is read-only and breaks re-extraction
    (source_directory / 'cmu_us_ksp_arctic' / 'etc' /
     'txt.done.data').unlink(missing_ok=True)

    for speaker in speakers:
        url = ('http://festvox.org/cmu_arctic/cmu_arctic/packed/'
               f'cmu_us_{speaker}_arctic-0.95-release.tar.bz2')
        download_mod.download_tarbz2(url, source_directory)

    download_mod.download_file(
        'http://festvox.org/cmu_arctic/cmuarctic.data',
        source_directory / 'sentences.txt')


def format(speakers=None):
    """Format the CMU Arctic database into the cache."""
    from ..audio import load as load_audio

    config = config_mod.default()
    source_directory = config_mod.SOURCES_DIR / 'arctic'
    data_directory = config_mod.DATA_DIR / 'arctic'
    cache_directory = config_mod.CACHE_DIR / 'arctic'
    data_directory.mkdir(parents=True, exist_ok=True)
    cache_directory.mkdir(parents=True, exist_ok=True)

    # Sentences -> CSV
    sentences_file = source_directory / 'sentences.txt'
    new_sentences_file = data_directory / 'sentences.csv'
    with open(sentences_file) as file:
        content = file.read()
    rows = re.findall(
        r'\( (arctic_[ab][0-9][0-9][0-9][0-9]) \"(.+)\" \)',
        content, re.MULTILINE)
    with open(new_sentences_file, 'w') as file:
        writer = csv.writer(file)
        writer.writerow(['id', 'prompt'])
        writer.writerows(rows)

    if speakers is None:
        speaker_dirs = sorted(source_directory.glob('cmu_us_*_arctic'))
    else:
        speaker_dirs = [source_directory / f'cmu_us_{s}_arctic'
                        for s in speakers]

    for speaker in speaker_dirs:
        # v0.90 releases use different utterance ids; map via the prompt
        if speaker.name == 'cmu_us_awb_arctic':
            with open(speaker / 'etc' / 'txt.done.data') as file:
                v90 = file.read()
            with open(sentences_file) as file:
                v95 = file.read()

            def id_map(stem):
                return version_90_to_version_95(stem, v90, v95)
        else:
            def id_map(stem):
                return stem

        new_speaker_dir = data_directory / speaker.name
        cache_speaker_dir = cache_directory / speaker.name
        cache_speaker_dir.mkdir(parents=True, exist_ok=True)
        new_lab_dir = new_speaker_dir / 'lab'
        new_lab_dir.mkdir(parents=True, exist_ok=True)

        new_phone_files = []
        for lab_file in download_mod.files_with_extension(
                'lab', speaker / 'lab'):
            if lab_file.stem == '*':
                continue

            with open(lab_file) as file:
                lines = file.readlines()
            non_header = lines[lines.index('#\n') + 1:]
            parsed = [line.split() for line in non_header
                      if len(line) >= 5]
            timestamps = [row[0] for row in parsed]
            phonemes = [row[2] for row in parsed]

            # Unknown tokens -> silence
            phonemes = [p if p in PHONEMES else SILENCE for p in phonemes]

            audio = load_audio(speaker / 'wav' / f'{lab_file.stem}.wav',
                               config.sample_rate)
            audio_duration = audio.shape[-1] / config.sample_rate
            # Skip utterances whose durations disagree
            if abs(audio_duration - float(timestamps[-1])) > 0.1:
                continue

            stem = id_map(lab_file.stem)
            if stem is None:
                continue

            timestamps[-1] = str(audio_duration)
            new_phone_file = new_lab_dir / f'{stem}.csv'
            new_phone_files.append(new_phone_file)
            with open(new_phone_file, 'w') as file:
                writer = csv.writer(file)
                writer.writerow(['timestamp', 'phoneme'])
                # Our align stage expects 'pau' for silence
                writer.writerows(
                    (t, 'pau' if p == SILENCE else p)
                    for t, p in zip(timestamps, phonemes))

        # Copy audio into the cache under mapped ids
        for wav_file in download_mod.files_with_extension(
                'wav', speaker / 'wav'):
            stem = id_map(wav_file.stem)
            if stem is None:
                continue
            shutil.copy(wav_file, cache_speaker_dir / f'{stem}.wav')

        # Word alignment + TextGrid merge
        new_word_dir = new_speaker_dir / 'word'
        new_word_dir.mkdir(parents=True, exist_ok=True)
        new_word_files = [
            new_word_dir / f.name for f in new_phone_files]
        words_mod.from_files_to_files(
            new_phone_files, new_word_files, new_sentences_file)
        download_mod.align.from_files_to_files(
            new_phone_files, new_word_dir, cache_speaker_dir)


def version_90_to_version_95(stem, v90_sentences, v95_sentences):
    """Map an Arctic v0.90 utterance id to its v0.95 id via the prompt."""
    match = re.search(rf'\( {stem} \"(.+)\" \)', v90_sentences)
    if match is None:
        return None
    sentence = re.escape(match.group(1))
    match = re.search(
        rf'\( (arctic_[ab][0-9][0-9][0-9][0-9]) \"{sentence}\" \)',
        v95_sentences)
    return match.group(1) if match else None
