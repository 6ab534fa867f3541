"""Length masking (reference: ppgs/model/transformer.py:104-114)."""

import torch


def mask_from_lengths(lengths, max_length, padding=0):
    """Boolean mask (batch, max_length): True where the frame index is valid.

    Matches the reference semantics ``arange(T) - 2*padding < lengths``.
    """
    x = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return (x[None, :] - 2 * padding) < lengths[:, None]
