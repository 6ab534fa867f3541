"""Common Voice dataset adapter
(reference: ppgs/data/datasets/commonvoice/core.py:17-150).

Charsiu forced alignments (Google Drive zip, gdown-gated) + the user-supplied
Common Voice corpus tarball. mp3s matching an alignment are extracted,
decoded (ffmpeg) and resampled to 16 kHz WAV; TextGrid headers are repaired,
[SIL] tokens normalized, and the final phoneme end time snapped to the audio
duration.
"""

import concurrent.futures
import tarfile
from pathlib import Path

from ... import config as config_mod
from ...phonemes import SILENCE
from .. import download as download_mod
from ..textgrid import Alignment

ALIGNMENTS_URL = (
    'https://drive.google.com/uc?id=1J_IN8HWPXaKVYHaAf7IXzUd6wyiL9VpP')


def download():
    """Download Charsiu alignments; extract matching corpus mp3s."""
    source_directory = config_mod.SOURCES_DIR / 'commonvoice'
    source_directory.mkdir(parents=True, exist_ok=True)
    data_directory = config_mod.DATA_DIR / 'commonvoice'
    data_directory.mkdir(parents=True, exist_ok=True)

    alignment_directory = source_directory / 'alignments'
    alignment_directory.mkdir(parents=True, exist_ok=True)
    download_mod.core.download_google_drive_zip(
        ALIGNMENTS_URL, alignment_directory)

    mp3_dir = data_directory / 'mp3'
    mp3_dir.mkdir(exist_ok=True)
    corpus_files = (list(source_directory.glob('cv-corpus*.tar.gz'))
                    + list(source_directory.glob('cv-corpus*.tgz')))
    if not corpus_files:
        raise FileNotFoundError(
            f'The Common Voice dataset can only be officially downloaded '
            f'via https://commonvoice.mozilla.org/en; please place the '
            f'cv-corpus tar.gz in {source_directory}.')
    corpus_file = sorted(corpus_files)[-1]
    stems = {f.stem for f in download_mod.files_with_extension(
        'TextGrid', alignment_directory)}
    with tarfile.open(corpus_file, 'r|gz') as corpus:
        for info in corpus:
            stem = Path(info.name).stem
            if stem in stems:
                stems.discard(stem)
                with open(mp3_dir / f'{stem}.mp3', 'wb') as file:
                    file.write(corpus.extractfile(info).read())


def format(num_workers=8):
    """Format Common Voice into the cache."""
    source_directory = config_mod.SOURCES_DIR / 'commonvoice'
    cache_directory = config_mod.CACHE_DIR / 'commonvoice'
    cache_directory.mkdir(exist_ok=True, parents=True)

    textgrid_stems = {f.stem for f in download_mod.files_with_extension(
        'TextGrid', source_directory)}
    mp3_files = [
        f for f in download_mod.files_with_extension(
            'mp3', config_mod.DATA_DIR / 'commonvoice' / 'mp3')
        if f.stem in textgrid_stems]

    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        futures = [
            pool.submit(mp3_textgrid, f, cache_directory, cache_directory,
                        source_directory)
            for f in mp3_files]
        for future in futures:
            future.result()


def mp3_textgrid(mp3_file, audio_directory, alignment_directory,
                 source_directory):
    """Convert one (mp3, TextGrid) pair into the cache format."""
    from ..audio import load as load_audio, save_wav

    config = config_mod.default()
    audio = load_audio(mp3_file, config.sample_rate)
    save_wav(audio_directory / f'{mp3_file.stem}.wav', audio,
             config.sample_rate)
    duration = audio.shape[-1] / config.sample_rate

    textgrid_file = (Path(source_directory) / 'alignments' /
                     f'{mp3_file.stem}.TextGrid')

    # Charsiu files carry a broken header over a short-form body; our
    # parser handles short form directly
    alignment = Alignment(textgrid_file)
    for word in alignment.words():
        if word.word == '[SIL]':
            word.word = SILENCE
        for phoneme in word:
            if phoneme.phoneme == '[SIL]':
                phoneme.phoneme = SILENCE

    # Snap the final phoneme end to the audio duration
    phones = list(alignment.phonemes())
    if phones:
        phones[-1].end = duration

    alignment.save(Path(alignment_directory) / textgrid_file.name)
