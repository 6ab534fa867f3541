"""Dataset and metadata (reference: ppgs/data/dataset.py:19-217); a copy
of the JAX package's.

Host-side: reads partition JSONs, cached .npy features, and TextGrid
alignments; produces numpy feature tuples. Padding happens in collate,
device placement with the consumer.
"""

import json
from pathlib import Path

import numpy as np

from .. import config as config_mod
from ..phonemes import PHONEME_TO_INDEX_MAPPING, SILENCE
from . import audio as audio_io
from .textgrid import Alignment


class Metadata:

    def __init__(self, name_or_files, partition=None, max_frames=None,
                 config=None):
        config = config_mod.get(config)
        self.config = config

        if isinstance(name_or_files, str):
            self.name = name_or_files
            self.cache = config_mod.CACHE_DIR / self.name
            if partition is not None:
                with open(config_mod.PARTITION_DIR /
                          f'{self.name}.json') as file:
                    self.stems = json.load(file)[partition]
            else:
                self.stems = [f.stem for f in self.cache.glob('*.wav')]
            self.audio_files = [
                self.cache / f'{stem}.wav' for stem in self.stems]

            # Lengths cache (frames at 100 Hz)
            lengths_file = self.cache / f'{partition}-lengths.json'
            if lengths_file.exists():
                with open(lengths_file) as file:
                    lengths = json.load(file)
            else:
                lengths = {}
                for stem, audio_file in zip(self.stems, self.audio_files):
                    lengths[stem] = (
                        audio_io.info_num_samples(
                            audio_file, config.sample_rate)
                        // config.hopsize)
                try:
                    with open(lengths_file, 'w') as file:
                        json.dump(lengths, file)
                except OSError:
                    pass
            self.lengths = [lengths[stem] for stem in self.stems]
        else:
            # Explicit list of audio files
            self.name = '<files>'
            self.audio_files = [Path(f) for f in name_or_files]
            self.stems = [f.stem for f in self.audio_files]
            self.cache = (self.audio_files[0].parent
                          if self.audio_files else Path('.'))
            self.lengths = [
                audio_io.info_num_samples(f, config.sample_rate)
                // config.hopsize
                for f in self.audio_files]

        # Drop over-long utterances (reference dataset.py:193-198)
        if max_frames is not None:
            keep = [i for i, l in enumerate(self.lengths) if l <= max_frames]
            if len(keep) < len(self.lengths):
                import warnings

                # Warn in scan order (deterministic, diffable across runs)
                for i, length in enumerate(self.lengths):
                    if length > max_frames:
                        warnings.warn(
                            f'File {self.audio_files[i]} of length '
                            f'{length} exceeds max_frames of '
                            f'{max_frames}. Skipping.')
            self.stems = [self.stems[i] for i in keep]
            self.audio_files = [self.audio_files[i] for i in keep]
            self.lengths = [self.lengths[i] for i in keep]


class Dataset:
    """Map-style dataset over cached features."""

    def __init__(self, name_or_files, partition=None, features=('audio',),
                 max_frames=None, config=None):
        config = config_mod.get(config)
        self.config = config
        self.features = ([features] if isinstance(features, str)
                         else list(features))
        self.metadata = Metadata(name_or_files, partition, max_frames, config)
        self.cache = self.metadata.cache
        self.stems = self.metadata.stems
        self.audio_files = self.metadata.audio_files
        self.lengths = self.metadata.lengths

    def __len__(self):
        return len(self.stems)

    def __getitem__(self, index):
        stem = self.stems[index]
        config = self.config
        values = []
        for feature in self.features:
            if feature == 'audio':
                values.append(audio_io.load(
                    self.audio_files[index], config.sample_rate))
            elif feature == 'phonemes':
                values.append(self._phoneme_indices(index))
            elif feature == 'stem':
                values.append(stem)
            elif feature == 'audio_file':
                values.append(self.audio_files[index])
            elif feature == 'length':
                prev = values[-1]
                values.append(prev.shape[-1] if hasattr(prev, 'shape')
                              else len(prev))
            else:
                values.append(np.load(self.cache / f'{stem}-{feature}.npy'))
        return values

    def _phoneme_indices(self, index):
        """Framewise phoneme targets from the TextGrid alignment
        (reference dataset.py:52-81)."""
        config = self.config
        stem = self.stems[index]
        alignment = Alignment(self.cache / f'{stem}.TextGrid')

        # Normalize labels: [SIL] -> silence token, lowercase
        for word in alignment.words():
            if word.word == '[SIL]':
                word.word = SILENCE
            for phoneme in word:
                if phoneme.phoneme == '[SIL]':
                    phoneme.phoneme = SILENCE
                else:
                    phoneme.phoneme = phoneme.phoneme.lower()

        hopsize = config.hopsize / config.sample_rate
        num_frames = self.metadata.lengths[index]
        times = np.linspace(
            hopsize / 2,
            (num_frames - 1) * hopsize + hopsize / 2,
            num_frames)
        if num_frames:
            times[-1] = alignment.duration()
        return alignment.framewise_phoneme_indices(
            PHONEME_TO_INDEX_MAPPING, hopsize, times)

    def buckets(self):
        """Length-sorted index buckets (reference dataset.py:105-121)."""
        size = max(1, len(self) // self.config.buckets)
        order = np.argsort(self.lengths)
        lengths = np.sort(self.lengths)
        return [
            np.stack((order[i:i + size], lengths[i:i + size])).T
            for i in range(0, len(self), size)]
