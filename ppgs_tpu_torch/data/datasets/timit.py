"""TIMIT dataset adapter (reference: ppgs/data/datasets/timit/core.py:18-276).

User-supplied LDC tarball; NIST SPHERE -> WAV conversion in pure Python;
TIMIT phone set mapped to ours with stop-closure backfill; phone and word
CSVs merged into TextGrid alignments.
"""

import csv
import re
import struct
import tarfile
from pathlib import Path

from ... import config as config_mod
from ...phonemes import SILENCE, TIMIT_TO_ARCTIC_MAPPING
from .. import download as download_mod


POSSIBLE_SOURCES = [
    'timit', 'timit.tar', 'timit_LDC93S1.tgz', 'timit_LDC9321.tar.gz',
    'timit.tgz', 'timit.tar.gz']


def download_dataset():
    """Locate the user-supplied TIMIT tarball and extract it."""
    source_directory = config_mod.SOURCES_DIR / 'timit'
    source_directory.mkdir(parents=True, exist_ok=True)
    candidates = [source_directory / name for name in POSSIBLE_SOURCES]
    source = next((p for p in candidates if p.exists()), None)
    if source is None:
        raise FileNotFoundError(
            f'TIMIT dataset not found. Please download TIMIT via '
            f'https://catalog.ldc.upenn.edu/LDC93s1 and place it in '
            f'{source_directory} as one of {POSSIBLE_SOURCES}.')
    with tarfile.open(source) as archive:
        archive.extractall(config_mod.DATA_DIR)


# Reference-compatible entry point names
download = download_dataset


def format():
    """Format TIMIT into the cache."""
    from ..audio import load as load_audio

    config = config_mod.default()
    data_directory = config_mod.DATA_DIR / 'timit'
    cache_directory = config_mod.CACHE_DIR / 'timit'

    sphere_files = download_mod.files_with_extension('wav', data_directory)
    word_files = download_mod.files_with_extension('wrd', data_directory)
    phone_files = download_mod.files_with_extension('phn', data_directory)

    # SPHERE -> WAV
    for sphere_file in sphere_files:
        output_dir = cache_directory / sphere_file.parent.name
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / f'{sphere_file.stem}.wav', 'wb') as file:
            file.write(sphere_to_wav(sphere_file))

    # Phone labels -> CSV with CMU phones
    for phone_file in phone_files:
        output_dir = data_directory / phone_file.parent.name / 'lab'
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(phone_file) as file:
            rows = list(csv.reader(file, delimiter=' '))
        start_times, end_times, phonemes = zip(*rows)

        audio_file = (cache_directory / phone_file.parent.name /
                      f'{phone_file.stem}.wav')
        audio = load_audio(audio_file, config.sample_rate)
        audio_duration = audio.shape[-1] / config.sample_rate
        alignment_duration = float(end_times[-1]) / config.sample_rate
        # Skip utterances whose durations disagree
        if abs(audio_duration - alignment_duration) > 0.25:
            continue

        end_times = list(end_times)
        end_times[-1] = str(audio.shape[-1])
        rows = zip(start_times, end_times, phonemes)
        with open(output_dir / f'{phone_file.stem}.csv', 'w') as file:
            writer = csv.writer(file)
            writer.writerow(['timestamp', 'phoneme'])
            writer.writerows(ipa_to_cmu(rows))

    # Word alignments -> CSV in seconds
    for word_file in word_files:
        output_dir = data_directory / word_file.parent.name / 'word'
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(word_file) as file:
            rows = list(csv.reader(file, delimiter=' '))
        with open(output_dir / f'{word_file.stem}.csv', 'w') as file:
            writer = csv.writer(file)
            writer.writerow(['start', 'end', 'word'])
            writer.writerows(
                [[float(r[0]) / 16000, float(r[1]) / 16000, r[2]]
                 for r in rows])

    # Prompts
    prompt_file = data_directory / 'TIMIT' / 'DOC' / 'PROMPTS.TXT'
    if prompt_file.exists():
        with open(prompt_file) as file:
            content = file.read()
        rows = [tuple(reversed(m)) for m in
                re.findall(r'(.*) \((.*)\)', content, re.MULTILINE)]
        with open(data_directory / 'TIMIT' / 'sentences.csv', 'w') as file:
            writer = csv.writer(file)
            writer.writerow(['id', 'prompt'])
            writer.writerows(rows)

    # Merge phone and word alignments into TextGrids
    for speaker in data_directory.iterdir():
        if speaker.name in ['CONVERT', 'README.DOC', 'SPHERE', 'TIMIT']:
            continue
        if not speaker.is_dir():
            continue
        phone_csvs = list((speaker / 'lab').glob('*.csv'))
        download_mod.align.from_files_to_files(
            phone_csvs, speaker / 'word', cache_directory / speaker.name)


###############################################################################
# NIST SPHERE -> WAV
###############################################################################


def sphere_header(file_object):
    """Parse the NIST SPHERE ASCII header into a typed dict."""
    file_object.seek(0)
    if file_object.readline() != b'NIST_1A\n':
        raise ValueError('Not a NIST SPHERE file')
    header_size = int(file_object.readline().decode().strip())
    file_object.seek(16)
    lines = file_object.read(header_size - 16).decode('utf-8').split('\n')
    lines = lines[:lines.index('end_head')]
    converters = {'i': int, 'r': float, 's': str}
    header = {}
    for line in lines:
        if not line or line[0] == ';':
            continue
        name, type_tag, value = line.split(' ', 2)
        header[name] = converters[type_tag[1]](value)
    return header, header_size


def sphere_to_wav(sphere_file):
    """Convert a SPHERE file's PCM payload to a RIFF/WAVE byte string."""
    with open(sphere_file, 'rb') as file:
        header, header_size = sphere_header(file)
        file.seek(header_size)
        samples = file.read()

    sample_bytes = header['sample_count'] * header['sample_n_bytes']
    riff = struct.pack(
        '<4sI4s4sIHHIIHH4sI',
        b'RIFF',
        sample_bytes + 36,
        b'WAVE',
        b'fmt ',
        16,
        1,
        header['channel_count'],
        header['sample_rate'],
        header['sample_rate'] * header['sample_n_bytes'],
        header['sample_n_bytes'],
        header['sample_n_bytes'] * 8,
        b'data',
        sample_bytes)
    return riff + samples


###############################################################################
# TIMIT phone set -> CMU
###############################################################################


def ipa_to_cmu(rows, backfill=True):
    """Map TIMIT phones to our CMU-style set; backfill stop closures with
    the following release phone (reference timit/core.py:183-217)."""
    transposed = list(zip(*rows))
    phones = [
        TIMIT_TO_ARCTIC_MAPPING.get(p.lower(), SILENCE)
        for p in transposed[2]]

    if backfill:
        for idx, phone in enumerate(phones):
            if phone[:3] != 'bck':
                continue
            assert phone[3] == '<' and phone[-1] == '>'
            candidates = phone[4:-1].split(',')
            if idx < len(phones) - 1 and phones[idx + 1] in candidates:
                phones[idx] = 'bck'
            else:
                phones[idx] = candidates[0]
        for i in range(len(phones)):
            if phones[i] == 'bck':
                phones[i] = phones[i + 1]

    phone_ends = [int(sample) / 16000 for sample in transposed[1]]
    return list(zip(phone_ends, phones))
