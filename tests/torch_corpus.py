"""A seeded speech corpus for the data pipeline's tests, and both
packages' directories pointed at it.

``write_corpus`` writes ``<root>/cache/<name>/<stem>.wav`` (16 kHz noise)
with a ``<stem>.TextGrid`` of seeded phoneme intervals over the 40
phonemes, silence included, and optionally a seeded float16 mel cache
``<stem>-mel.npy`` beside each; ``point_configs`` monkeypatches CACHE_DIR,
PARTITION_DIR, CLASS_WEIGHT_FILE, EVAL_DIR and RUNS_DIR of both packages'
config modules under ``root``, so that no test writes the JAX package's
tracked assets."""

import numpy as np

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu_torch.data import audio as audio_io
from ppgs_tpu_torch.data import textgrid
from ppgs_tpu_torch.phonemes import PHONEMES, SILENCE


def alignment(duration, rng):
    """Words of 1-4 phonemes over [0, duration], silence among them."""
    edges = np.sort(rng.uniform(0, duration, max(1, int(duration / 0.08))))
    edges = np.concatenate([[0.0], edges, [duration]])
    phonemes = [textgrid.Phoneme(
        SILENCE if rng.random() < 0.15 else str(rng.choice(PHONEMES)),
        float(a), float(b)) for a, b in zip(edges[:-1], edges[1:])]
    words, i = [], 0
    while i < len(phonemes):
        n = int(rng.integers(1, 5))
        group = phonemes[i:i + n]
        words.append(textgrid.Word(
            SILENCE if group[0].phoneme == SILENCE else f'w{i}', group))
        i += n
    return textgrid.Alignment(words)


def write_corpus(root, name, seconds, seed, mel_cache=False):
    """The corpus ``name`` under ``root/cache``; returns its stems."""
    cache = root / 'cache' / name
    cache.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    stems = []
    for i, s in enumerate(seconds):
        stem = f'utt{i:03d}'
        samples = int(s * 16000)
        audio_io.save_wav(cache / f'{stem}.wav', (0.1 * rng.standard_normal(
            (1, samples))).astype(np.float32))
        alignment(samples / 16000, rng).save(cache / f'{stem}.TextGrid')
        if mel_cache:
            np.save(cache / f'{stem}-mel.npy', rng.standard_normal(
                (80, samples // 160)).astype(np.float16))
        stems.append(stem)
    return stems


def point_configs(monkeypatch, root):
    for module in (ppgs_tpu.config, ppgs_tpu_torch.config):
        monkeypatch.setattr(module, 'CACHE_DIR', root / 'cache')
        monkeypatch.setattr(module, 'PARTITION_DIR', root / 'partitions')
        monkeypatch.setattr(module, 'CLASS_WEIGHT_FILE',
                            root / 'phoneme_weights.npz')
        monkeypatch.setattr(module, 'EVAL_DIR', root / 'eval')
        monkeypatch.setattr(module, 'RUNS_DIR', root / 'runs')
