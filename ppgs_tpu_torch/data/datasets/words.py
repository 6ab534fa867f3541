"""Word-phoneme alignment via CMUdict + Needleman-Wunsch
(reference: ppgs/data/datasets/arctic/words/{core,align}.py).

Given a word sequence (tokenized prompt) and a phone sequence with timings,
finds word boundaries by aligning the dictionary pronunciations of the words
against the observed phones with a one-to-many Needleman-Wunsch pass, then
fills timeline gaps with silence.
"""

import csv
import re

import numpy as np


END = '<end>'

GAP_PENALTY = -2
MATCH_SCORE = 2
MISMATCH_SCORE = -1
END_MISMATCH_SCORE = -4


###############################################################################
# Needleman-Wunsch one-to-many alignment
###############################################################################


def _score(symbol0, symbol1, direction):
    """Score stepping (up=gap in seq1, left=gap in seq0, diag=match)."""
    if direction == 0:            # consume seq0 symbol only
        return 0 if symbol0 == END else GAP_PENALTY
    if direction == 1:            # consume seq1 symbol only
        return GAP_PENALTY
    if symbol0 == END:            # diagonal onto a boundary marker
        return END_MISMATCH_SCORE
    return MATCH_SCORE if symbol0 == symbol1 else MISMATCH_SCORE


def needleman_wunsch(seq0, seq1):
    """Global alignment; returns two same-length lists with None gaps."""
    n0, n1 = len(seq0), len(seq1)
    # table[i, j, d]: best score reaching (i, j) via direction d
    table = np.fromfunction(
        lambda x, y, z: -2.0 * (x + y), (n0 + 1, n1 + 1, 3))
    for i in range(1, n0 + 1):
        for j in range(1, n1 + 1):
            best_prev = table[[i - 1, i, i - 1], [j, j - 1, j - 1]].max(
                axis=1)
            scores = np.array([
                _score(seq0[i - 1], seq1[j - 1], d) for d in range(3)])
            table[i, j] = best_prev + scores

    # Backtrack
    pos = np.array([n0, n1])
    path = [pos]
    while (pos != 0).all():
        direction = int(np.argmax(table[pos[0], pos[1]]))
        steps = [np.array([1, 0]), np.array([0, 1]), np.array([1, 1])]
        pos = pos - steps[direction]
        path.append(pos)
    path.append(np.array([0, 0]))
    path = list(reversed(path))

    out0, out1 = [], []
    old = path[0]
    for pos in path[1:]:
        delta = pos - old
        if (delta == [1, 1]).all():
            out0.append(seq0[pos[0] - 1])
            out1.append(seq1[pos[1] - 1])
        elif (delta == [1, 0]).all():
            out0.append(seq0[pos[0] - 1])
            out1.append(None)
        elif (delta == [0, 1]).all():
            out0.append(None)
            out1.append(seq1[pos[1] - 1])
        old = pos
    return out0, out1


def align_one_to_many(one_seq, one_to_many_mapping, many_seq,
                      as_splits=False):
    """Align words (each expanding to several phones) against a phone
    sequence; returns per-word phone sublists or split indices."""
    expanded = [END]
    for symbol in one_seq:
        expanded.extend(one_to_many_mapping[symbol])
        expanded.append(END)

    out0, out1 = needleman_wunsch(expanded, list(many_seq))

    split_indices = []
    idx = 0
    while idx < len(out0):
        if out0[idx] == END:
            if out1[idx] is not None:
                raise ValueError('Failed alignment')
            split_indices.append(idx)
            del out0[idx], out1[idx]
        elif out1[idx] is None:
            del out0[idx], out1[idx]
        else:
            idx += 1

    if as_splits:
        return split_indices
    return [
        many_seq[split_indices[i - 1]:split_indices[i]]
        for i in range(1, len(split_indices))]


###############################################################################
# CMU pronouncing dictionary
###############################################################################


def get_word_phones(word):
    """Dictionary pronunciations of a word as lists of lowercase phones.

    Requires the optional nltk package + cmudict corpus (as in the
    reference). Hyphenated words and possessives get simple fallbacks.
    """
    if not hasattr(get_word_phones, 'lookup'):
        try:
            import nltk
        except ImportError as error:
            raise ImportError(
                "The 'nltk' package is required for word alignment: "
                'pip install nltk') from error
        try:
            get_word_phones.lookup = nltk.corpus.cmudict.dict()
        except LookupError:
            nltk.download('cmudict')
            get_word_phones.lookup = nltk.corpus.cmudict.dict()

    try:
        pronunciations = get_word_phones.lookup[word.lower()]
    except KeyError:
        if '-' in word:
            parts = word.split('-')
            return [get_word_phones(parts[0])[0]
                    + get_word_phones(parts[1])[0]]
        if word[-2:] == "'s":
            return [get_word_phones(word[:-2])[0] + ['s']]
        raise KeyError(word)

    # Strip stress digits, lowercase
    return [
        [''.join(c for c in phn if c.isalpha()).lower() for phn in pron]
        for pron in pronunciations]


def word_align_phones(word_seq, phone_seq):
    """Split indices of phone_seq at word boundaries."""
    mapping = {word: get_word_phones(word)[0] for word in word_seq}
    return align_one_to_many(word_seq, mapping, phone_seq, as_splits=True)


###############################################################################
# Word-boundary extraction from phone timings + prompt
###############################################################################


def from_sequence_data(phone_seq, phone_start, phone_end, word_seq=None):
    """Word intervals [(start, end, word)] from phone timings; silence-filled
    (reference arctic/words/core.py:13-70)."""
    if not word_seq:
        return list(zip(phone_start, phone_end, phone_seq))

    duration = phone_end[-1]

    # Drop silence phones before alignment
    phone_seq = list(phone_seq)
    phone_start = list(phone_start)
    phone_end = list(phone_end)
    idx = 0
    while idx < len(phone_seq):
        if phone_seq[idx] == 'pau':
            del phone_seq[idx], phone_start[idx], phone_end[idx]
        else:
            idx += 1

    splits = word_align_phones(word_seq, phone_seq)
    if len(splits) != len(word_seq) + 1:
        raise ValueError('Word alignment failed')

    words = []
    for i in range(1, len(splits)):
        words.append([phone_start[splits[i - 1]],
                      phone_end[splits[i] - 1],
                      word_seq[i - 1]])

    # Fill gaps with silence
    silences = []
    for i in range(len(words) + 1):
        prior = 0 if i == 0 else words[i - 1][1]
        current = duration if i == len(words) else words[i][0]
        if current - prior > 1e-3:
            silences.append(([prior, current, 'pau'], i))
    for silence, idx in reversed(silences):
        words.insert(idx, silence)
    return words


def tokenize_prompt(prompt):
    """Lowercased word tokens; single non-alpha tokens dropped."""
    tokens = re.findall(r"[A-Za-z']+(?:-[A-Za-z']+)*|\S", prompt)
    return [t.lower() for t in tokens
            if not (len(t) == 1 and not t.isalpha())]


def from_file(phone_file, prompt=None):
    words = tokenize_prompt(prompt) if prompt is not None else None
    with open(phone_file) as file:
        reader = csv.reader(file)
        next(reader)
        rows = list(reader)
    phone_end = [float(end) for end, _ in rows]
    phone_seq = [phone for _, phone in rows]
    phone_start = [0.0] + phone_end[:-1]
    return from_sequence_data(phone_seq, phone_start, phone_end, words)


def from_file_to_file(phone_file, output_file, prompt=None):
    alignment = from_file(phone_file, prompt)
    with open(output_file, 'w') as file:
        writer = csv.writer(file)
        writer.writerow(['start', 'end', 'word'])
        writer.writerows(alignment)


def from_files_to_files(phone_files, output_files, prompt_file=None):
    prompts = None
    if prompt_file is not None:
        with open(prompt_file) as file:
            reader = csv.reader(file)
            next(reader)
            prompts = dict(reader)

    for phone_file, output_file in zip(phone_files, output_files):
        if prompts:
            try:
                from_file_to_file(
                    phone_file, output_file,
                    prompt=prompts[phone_file.stem])
            except (KeyError, ValueError):
                # Recover word boundaries from the phones alone
                from_file_to_file(phone_file, output_file)
        else:
            from_file_to_file(phone_file, output_file)
