"""Praat TextGrid parsing and forced-alignment containers.

A framework-free copy of ``ppgs_tpu/data/textgrid.py``: the host-side
replacement for the pypar dependency (reference uses pypar.Alignment in
ppgs/data/dataset.py:52-81 and ppgs/edit/grid.py). Supports long-form
TextGrid read/write with 'words' and 'phones' interval tiers, short-form
reading, and framewise phoneme index extraction at frame-center times.
"""

import re
from pathlib import Path

import numpy as np

from ..phonemes import SILENCE


class Phoneme:
    __slots__ = ('phoneme', 'start', 'end')

    def __init__(self, phoneme, start, end):
        self.phoneme = phoneme
        self.start = float(start)
        self.end = float(end)

    def duration(self):
        return self.end - self.start

    def __str__(self):
        return self.phoneme

    def __repr__(self):
        return f'Phoneme({self.phoneme!r}, {self.start}, {self.end})'


class Word:
    def __init__(self, word, phonemes):
        self.word = word
        self._phonemes = list(phonemes)

    def start(self):
        return self._phonemes[0].start

    def end(self):
        return self._phonemes[-1].end

    def duration(self):
        return self.end() - self.start()

    def __len__(self):
        return len(self._phonemes)

    def __getitem__(self, index):
        return self._phonemes[index]

    def __str__(self):
        return self.word

    def __repr__(self):
        return f'Word({self.word!r}, {self._phonemes!r})'


class Alignment:
    """A word/phoneme forced alignment."""

    def __init__(self, source):
        if isinstance(source, (str, Path)):
            self._words = _parse_textgrid(Path(source))
        else:
            self._words = list(source)

    def __len__(self):
        return len(self._words)

    def __getitem__(self, index):
        return self._words[index]

    def duration(self):
        return self._words[-1].end() if self._words else 0.0

    def start(self):
        return self._words[0].start() if self._words else 0.0

    def phonemes(self):
        for word in self._words:
            yield from word

    def words(self):
        return list(self._words)

    def framewise_phoneme_indices(self, mapping, hopsize, times):
        """Phoneme index active at each time (sec). Boundary frames belong to
        the following phoneme; times past the end clamp to the last phoneme."""
        phones = list(self.phonemes())
        ends = np.array([p.end for p in phones])
        idx = np.searchsorted(ends, np.asarray(times), side='right')
        idx = np.clip(idx, 0, len(phones) - 1)
        return np.array([mapping[phones[i].phoneme] for i in idx],
                        dtype=np.int64)

    def save(self, path):
        """Write long-form TextGrid with words and phones tiers."""
        words = self._words
        phones = list(self.phonemes())
        xmin = self.start()
        xmax = self.duration()

        def tier(name, items, label_of):
            lines = [
                f'    item [{{}}]:',
                '        class = "IntervalTier"',
                f'        name = "{name}"',
                f'        xmin = {xmin}',
                f'        xmax = {xmax}',
                f'        intervals: size = {len(items)}',
            ]
            for i, item in enumerate(items):
                start = item.start() if callable(
                    getattr(item, 'start', None)) else item.start
                end = item.end() if callable(
                    getattr(item, 'end', None)) else item.end
                lines += [
                    f'        intervals [{i + 1}]:',
                    f'            xmin = {start}',
                    f'            xmax = {end}',
                    f'            text = "{label_of(item)}"',
                ]
            return lines

        header = [
            'File type = "ooTextFile"',
            'Object class = "TextGrid"',
            '',
            f'xmin = {xmin}',
            f'xmax = {xmax}',
            'tiers? <exists>',
            'size = 2',
            'item []:',
        ]
        body = (tier('words', words, lambda w: w.word)
                + tier('phones', phones, lambda p: p.phoneme))
        # Fill item numbers
        out, n = [], 0
        for line in header + body:
            if line.endswith('item [{}]:'):
                n += 1
                line = line.format(n)
            out.append(line)
        Path(path).write_text('\n'.join(out) + '\n')


###############################################################################
# Parsing
###############################################################################


_NUM = re.compile(r'(xmin|xmax)\s*=\s*([-\d.e+]+)')
_TEXT = re.compile(r'text\s*=\s*"(.*)"')
_NAME = re.compile(r'name\s*=\s*"(.*)"')
_SIZE = re.compile(r'intervals:\s*size\s*=\s*(\d+)')


def _parse_tiers(path):
    """Parse all interval tiers: name -> list of (xmin, xmax, text).

    Supports both long-form and short-form ooTextFile TextGrids (Charsiu's
    Common Voice alignments are short-form)."""
    text = Path(path).read_text(errors='replace')
    if 'ooTextFile short' in text.splitlines()[0] or (
            'IntervalTier' in text and 'item [' not in text
            and 'item[' not in text):
        return _parse_short_tiers(text)
    tiers = {}
    # Split on tier items
    chunks = re.split(r'item\s*\[\d+\]\s*:', text)
    for chunk in chunks[1:]:
        name_match = _NAME.search(chunk)
        if name_match is None or 'IntervalTier' not in chunk:
            continue
        name = name_match.group(1)
        intervals = []
        for m in re.finditer(
            r'intervals\s*\[\d+\]\s*:\s*\n\s*xmin\s*=\s*([-\d.e+]+)\s*\n'
            r'\s*xmax\s*=\s*([-\d.e+]+)\s*\n\s*text\s*=\s*"(.*)"',
            chunk,
        ):
            intervals.append(
                (float(m.group(1)), float(m.group(2)), m.group(3)))
        tiers[name] = intervals
    return tiers


def _parse_short_tiers(text):
    """Parse short-form TextGrid: a flat token stream of values."""
    # Tokens: every non-blank line is one value
    lines = [line.strip() for line in text.splitlines()]
    lines = [line for line in lines if line]
    # Skip the 2-line header, global xmin/xmax, <exists>, tier count
    idx = 2
    values = lines[idx:]

    def unquote(s):
        return s[1:-1] if len(s) >= 2 and s[0] == '"' and s[-1] == '"' \
            else s

    # global xmin, xmax
    pos = 2
    if values[pos].startswith('<'):
        pos += 1            # <exists>
    num_tiers = int(values[pos]); pos += 1

    tiers = {}
    for _ in range(num_tiers):
        tier_class = unquote(values[pos]); pos += 1
        name = unquote(values[pos]); pos += 1
        pos += 2            # tier xmin, xmax
        size = int(values[pos]); pos += 1
        intervals = []
        for _ in range(size):
            xmin = float(values[pos]); pos += 1
            xmax = float(values[pos]); pos += 1
            label = unquote(values[pos]); pos += 1
            intervals.append((xmin, xmax, label))
        if tier_class == 'IntervalTier':
            tiers[name] = intervals
    return tiers


def _parse_textgrid(path):
    """Build Word/Phoneme structure from words+phones tiers."""
    tiers = _parse_tiers(path)
    phone_tier = None
    word_tier = None
    for name, intervals in tiers.items():
        low = name.lower()
        if 'phone' in low:
            phone_tier = intervals
        elif 'word' in low:
            word_tier = intervals
    if phone_tier is None:
        raise ValueError(f'No phone tier found in {path}')

    phones = [
        Phoneme(text if text else SILENCE, start, end)
        for start, end, text in phone_tier]

    if word_tier is None:
        return [Word(SILENCE, phones)]

    # Assign phones to words by containment of the phone midpoint
    words = []
    for start, end, text in word_tier:
        members = [p for p in phones
                   if start - 1e-9 <= (p.start + p.end) / 2 <= end + 1e-9]
        if members:
            words.append(Word(text if text else SILENCE, members))
    return words
