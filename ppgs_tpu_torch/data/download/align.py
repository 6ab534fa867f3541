"""Merge phone and word interval CSVs into TextGrid alignments
(reference: ppgs/data/download/align/core.py:12-177).

Behavior preserved: silence tokens normalized, word-timeline gaps filled with
silence, misaligned boundary/intermediate silences split recursively,
monotonicity asserted, result saved as a .TextGrid.
"""

import csv
from pathlib import Path

from ...phonemes import SILENCE
from ..textgrid import Alignment, Phoneme, Word


def from_sequence_data(phone_seq, word_seq):
    """Merge [(start, end, phone)] and [(start, end, word)] into Alignment."""
    phone_seq = [
        [s, e, SILENCE if p == 'pau' else p] for s, e, p in phone_seq]
    word_seq = [
        [s, e, SILENCE if w == 'pau' else w] for s, e, w in word_seq]

    # Fill word-timeline gaps with silence
    if word_seq[0][0] > 0:
        word_seq.insert(0, [0.0, word_seq[0][0], SILENCE])
    i = 1
    while i < len(word_seq):
        if word_seq[i - 1][1] < word_seq[i][0]:
            word_seq.insert(
                i, [word_seq[i - 1][1], word_seq[i][0], SILENCE])
            i += 1
        i += 1
    if word_seq[-1][1] < phone_seq[-1][1]:
        assert phone_seq[-1][2] == SILENCE
        word_seq.append([word_seq[-1][1], phone_seq[-1][1], SILENCE])

    # Assign each phone to the containing word
    def assign():
        buckets = [-1] * len(phone_seq)
        for i, (ps, pe, _) in enumerate(phone_seq):
            for j, (ws, we, _) in enumerate(word_seq):
                if ps >= ws and pe <= we:
                    buckets[i] = j
        return buckets

    buckets = assign()

    # Repair misaligned silences by splitting them at word boundaries
    if -1 in buckets:
        idx = buckets.index(-1)
        start, end, phone = phone_seq[idx]
        if phone == SILENCE:
            if idx == 0:
                first_word_end = word_seq[0][1]
                phone_seq[0] = [0.0, first_word_end, SILENCE]
                phone_seq.insert(
                    1, [first_word_end, phone_seq[1][0], SILENCE])
            elif idx == len(buckets) - 1:
                last_word = word_seq[-1]
                prev_end = phone_seq[-2][1]
                phone_seq[-1] = [last_word[0], last_word[1], SILENCE]
                phone_seq.insert(-1, [prev_end, last_word[0], SILENCE])
            else:
                prev_word = word_seq[buckets[idx - 1]]
                next_word = word_seq[buckets[idx - 1] + 1]
                phone_seq[idx] = [start, prev_word[1], SILENCE]
                phone_seq.insert(
                    idx + 1, [next_word[0], end, SILENCE])
            # Recurse with the split silence
            return from_sequence_data(phone_seq, word_seq)

    if -1 in buckets:
        idx = buckets.index(-1)
        raise ValueError(
            f'Unaligned phone {phone_seq[idx][2]} at index {idx} '
            f'with words {word_seq}')

    # Monotonicity
    for i in range(1, len(buckets)):
        assert buckets[i - 1] <= buckets[i]

    # Build the alignment
    phones = [Phoneme(p, s, e) for s, e, p in phone_seq]
    words = []
    for j, (_, _, label) in enumerate(word_seq):
        members = [phones[i] for i, b in enumerate(buckets) if b == j]
        if members:
            words.append(Word(label, members))
    return Alignment(words)


def from_files(phone_file, word_file):
    """Load phone CSV (timestamp, phoneme) and word CSV (start, end, word)."""
    with open(phone_file) as file:
        reader = csv.reader(file)
        next(reader)
        rows = list(reader)
    phone_seq = []
    prev = 0.0
    for end, phone in rows:
        phone_seq.append([prev, float(end), phone])
        prev = float(end)

    with open(word_file) as file:
        reader = csv.reader(file)
        next(reader)
        word_seq = [[float(s), float(e), w] for s, e, w in reader]
    return from_sequence_data(phone_seq, word_seq)


def from_files_to_files(phone_files, word_directory, output_directory):
    """Merge phone CSVs with matching word CSVs; save .TextGrid files.

    Skips utterances whose merge fails (reference behavior: bad utterances
    are dropped, not fatal)."""
    word_directory = Path(word_directory)
    output_directory = Path(output_directory)
    output_directory.mkdir(parents=True, exist_ok=True)
    for phone_file in phone_files:
        phone_file = Path(phone_file)
        word_file = word_directory / phone_file.name
        try:
            alignment = from_files(phone_file, word_file)
            alignment.save(output_directory / f'{phone_file.stem}.TextGrid')
        except (ValueError, AssertionError, FileNotFoundError,
                IndexError):
            continue
