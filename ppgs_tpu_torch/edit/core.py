"""PPG editing API (reference: ppgs/edit/core.py:15-219).

Counterpart of ``ppgs_tpu/edit/core.py``, functional as it is: every op
returns a new tensor and never writes the caller's. The argmax runs where
the PPG lies; its run-length decode and the regex match over it run on
the host (python ``re``), and the probability moves are tensor ops on the
PPG's device. A numpy PPG goes to ``devices.resolve(device)``.
"""

import re
import struct
from typing import List, Optional

import numpy as np
import torch

from ..ops.algebra import as_tensor
from ..phonemes import PHONEMES


def reallocate(ppg, source: str, target: str, value: Optional[float] = None,
               device=None):
    """Move probability mass from the source phoneme to the target phoneme.

    If value is None, move everything; otherwise move at most ``value``.
    """
    source_index = PHONEMES.index(source)
    target_index = PHONEMES.index(target)
    ppg = as_tensor(ppg, device).clone()
    row = ppg[source_index].clone()
    if value is None:
        moved = row
        ppg[source_index] = 0.0
    else:
        moved = torch.clamp(row, max=value)
        ppg[source_index] = torch.clamp(row - value, min=0.0)
    ppg[target_index] += moved
    return ppg


def _unique_consecutive(indices: np.ndarray):
    """numpy equivalent of torch.unique_consecutive(return_inverse=True)."""
    if len(indices) == 0:
        return indices, np.zeros(0, dtype=np.int64)
    change = np.concatenate([[True], indices[1:] != indices[:-1]])
    unique = indices[change]
    inverse = np.cumsum(change) - 1
    return unique, inverse


def _find_spans(indices: np.ndarray, source_indices: List[int]):
    """Regex-match a phoneme index sequence against the run-length decode."""
    unique, inverse = _unique_consecutive(indices)
    pattern = re.escape(
        struct.pack('b' * len(source_indices), *source_indices))
    string = struct.pack('b' * len(unique), *[int(u) for u in unique])
    return [m.span() for m in re.finditer(pattern, string)], inverse


def _argmax(ppg):
    """The per-frame argmax (the first maximum, as jnp.argmax takes), on
    the host."""
    return torch.argmax(ppg, dim=0).cpu().numpy()


def regex_find(ppg, find_phonemes: List[str], device=None):
    """Find frame spans whose argmax decode matches a phoneme sequence.

    Returns a list of [start_frame, end_frame) pairs.
    """
    source_indices = [PHONEMES.index(p) for p in find_phonemes]
    indices = _argmax(as_tensor(ppg, device))
    spans, inverse = _find_spans(indices, source_indices)
    results = []
    for start, end in spans:
        frame_start = int(np.argwhere(inverse == start)[0, 0])
        frame_end = int(np.argwhere(inverse == end - 1)[-1, 0]) + 1
        results.append([frame_start, frame_end])
    return results


def regex(ppg, source_phonemes: List[str], target_phonemes: List[str],
          reallocate: bool = False, device=None):
    """Match source phoneme sequences (argmax decode) and swap/reallocate
    their probabilities with the target sequence, position by position."""
    source_indices = [PHONEMES.index(p) for p in source_phonemes]
    target_indices = [PHONEMES.index(p) for p in target_phonemes]
    if len(source_indices) != len(target_indices):
        raise ValueError('source and target phoneme sequences differ in '
                         'length')

    ppg = as_tensor(ppg, device).clone()
    spans, inverse = _find_spans(_argmax(ppg), source_indices)
    match_starts = np.array([s for s, _ in spans], dtype=np.int64)

    for i in range(len(source_phonemes)):
        # Frames belonging to the ith phoneme run of any match
        slicing = torch.as_tensor(np.isin(inverse, match_starts + i),
                                  device=ppg.device)
        src, tgt = source_indices[i], target_indices[i]
        src_row, tgt_row = ppg[src].clone(), ppg[tgt].clone()
        if reallocate:
            ppg[src] = torch.where(slicing, 0.0, src_row)
            ppg[tgt] = torch.where(slicing, tgt_row + src_row, tgt_row)
        else:
            ppg[src] = torch.where(slicing, tgt_row, src_row)
            ppg[tgt] = torch.where(slicing, src_row, tgt_row)
    return ppg


def shift(ppg, phoneme: str, value: float, device=None):
    """Shift probability of a phoneme; renormalize others proportionally."""
    index = PHONEMES.index(phoneme)
    ppg = as_tensor(ppg, device)

    if value > 0:
        frame_values = torch.clamp(1.0 - ppg[index], max=value)
    else:
        frame_values = torch.clamp(ppg[index], min=value)

    residual_mask = torch.ones(ppg.shape[0], dtype=torch.bool,
                               device=ppg.device)
    residual_mask[index] = False
    return torch.where(residual_mask[:, None],
                       ppg - ppg * frame_values[None, :],
                       ppg + frame_values[None, :])


def swap(ppg, phoneme_a: str, phoneme_b: str, device=None):
    """Swap the probabilities of two phonemes."""
    index_a = PHONEMES.index(phoneme_a)
    index_b = PHONEMES.index(phoneme_b)
    ppg = as_tensor(ppg, device)
    out = ppg.clone()
    out[index_a] = ppg[index_b]
    out[index_b] = ppg[index_a]
    return out
