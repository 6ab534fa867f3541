"""Grid-based PPG time-stretching (reference: ppgs/edit/grid.py:13-126).

Counterpart of ``ppgs_tpu/edit/grid.py``: ``sample`` is a gather and a
lerp on the PPG's device; the grids are float32 tensors on the PPG's
device (``from_alignments``: on ``devices.resolve(device)``).
``from_alignments`` takes parsed alignments (``data.textgrid``).
"""

import numpy as np
import torch

from .. import devices
from ..ops.algebra import as_tensor, interpolate


def sample(ppg, grid, device=None):
    """Interpolate a (..., T) PPG at float-valued frame indices ``grid``."""
    ppg = as_tensor(ppg, device)
    grid = torch.as_tensor(grid, dtype=torch.float32, device=ppg.device)
    interp = grid - torch.floor(grid)

    # searchsorted over the frame axis (float32, as jnp.searchsorted
    # promotes it), right side: for integral g this gives i = g + 1,
    # pairing frames (g, g + 1)
    xp = torch.arange(ppg.shape[-1], dtype=torch.float32, device=ppg.device)
    i = torch.searchsorted(xp, grid, right=True)

    # Replicate the final frame so i == T is valid
    padded = torch.cat([ppg, ppg[..., -1:]], dim=-1)
    return interpolate(padded[..., i - 1], padded[..., i], interp)


def constant(ppg, ratio: float, device=None):
    """Constant-ratio time-stretch grid; lower ratio is slower."""
    return of_length(ppg, round(ppg.shape[-1] / ratio + 1e-4), device)


def of_length(ppg, length: int, device=None):
    """Grid resampling a PPG to a specified length, on the PPG's device
    (``devices.resolve(device)`` for an array that is not a tensor)."""
    if isinstance(ppg, torch.Tensor):
        device = ppg.device
    return torch.linspace(0.0, ppg.shape[-1] - 1.0, length,
                          dtype=torch.float32,
                          device=devices.resolve(device))


def from_alignments(source, target, sample_rate: int = 16000,
                    hopsize: int = 160, device=None):
    """Time-stretch grid converting a source forced alignment to a target.

    ``source``/``target`` are data.textgrid.Alignment objects. Mirrors the
    reference's use of pypar.compare.per_frame_rate: the per-frame ratio of
    corresponding phoneme durations, integrated into fractional indices.
    """
    source_frames = int((source.duration() * sample_rate) / hopsize)
    target_frames = int((target.duration() * sample_rate) / hopsize)

    rates = per_frame_rate(target, source, sample_rate, hopsize, target_frames)

    indices = np.cumsum(np.asarray(rates, dtype=np.float64))
    indices = indices - indices[0]
    indices = indices * (source_frames - 1) / indices[-1]
    return torch.as_tensor(indices.astype(np.float32),
                           device=devices.resolve(device))


def per_frame_rate(target, source, sample_rate, hopsize, target_frames):
    """Relative speed (source phone duration / target phone duration) at each
    target frame center, matching pypar.compare.per_frame_rate semantics."""
    source_phones = list(source.phonemes())
    target_phones = list(target.phonemes())
    if len(source_phones) != len(target_phones):
        raise ValueError(
            'Alignments must have the same number of phonemes '
            f'({len(source_phones)} vs {len(target_phones)})')

    hop_seconds = hopsize / sample_rate
    rates = []
    j = 0
    for frame in range(target_frames):
        time = frame * hop_seconds
        while (j < len(target_phones) - 1 and
               time >= target_phones[j].end):
            j += 1
        tgt_dur = max(target_phones[j].duration(), 1e-9)
        src_dur = source_phones[j].duration()
        rates.append(src_dur / tgt_dur)
    return rates
