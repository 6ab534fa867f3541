"""Context parallelism: long inputs split in time over ranks, with halo
exchange (counterpart of ``ppgs_tpu/parallel/context.py``).

``models.transformer.chunked_forward`` folds 500-frame windows with
50-frame halos into the batch (the reference's sequential loop,
ppgs/model/transformer.py:49-64). Here each rank along the 'seq' axis
holds a contiguous slice of the time dimension (whole windows' strides),
exchanges ``overlap``-frame halos with its neighbours (``comm.ppermute``,
JAX's ``jax.lax.ppermute``), and runs its local windows through the port's
``transformer.forward``, so K1-K4 run on them on the card. The output
frames stay split over the same axis: no rank holds the whole sequence
(only ``core.infer`` gathers it, to return the whole PPGs).

The window geometry is the single-process fold's: rank 0 replicate-pads
its left edge (the reference's edge padding), the last rank's right halo
is zeros (the final window's zero fill), interior halos are exactly the
neighbour's frames, and the windows' valid and physical lengths come from
their global block ids. On the CPU the logits equal ``chunked_forward``'s
bit for bit; on the card the windows' batch differs, and cuDNN picks the
input conv's algorithm by batch.
"""

import torch
import torch.nn.functional as F

from ..models import transformer


def pad_frames_for_context(features, config, num_shards: int):
    """Right-zero-pad (B, C, T) so that T divides into ``num_shards``
    equal slices of whole windows' strides. Returns (padded, true
    frames)."""
    stride = config.chunk_length - 2 * config.chunk_overlap
    T = features.shape[-1]
    multiple = stride * num_shards
    padded_t = -(-T // multiple) * multiple
    if padded_t != T:
        features = F.pad(features, (0, padded_t - T))
    return features, T


def shard_frames(features, mesh, axis='seq', batch_axis=None):
    """This rank's (rows, time) block of padded (B, C, T) features: its
    slice of T over ``axis`` and, with ``batch_axis``, its rows."""
    n, i = mesh.shape[axis], mesh.index(axis)
    t_local = features.shape[-1] // n
    block = features[..., i * t_local:(i + 1) * t_local]
    if batch_axis is not None:
        from . import batch_sharding

        block = batch_sharding(mesh, batch_axis).block(block)
    return block


def gather_frames(local, mesh, axis='seq', batch_axis=None):
    """The inverse of ``shard_frames`` on (B, P, T) outputs: every rank's
    blocks joined (no gradient)."""
    from . import gather_batch

    out = gather_batch(local, mesh, axis, dim=-1)
    if batch_axis is not None:
        out = gather_batch(out, mesh, batch_axis, dim=0)
    return out


@torch.no_grad()
def context_parallel_chunked_forward(model, features, lengths, mesh,
                                     axis: str = 'seq',
                                     batch_axis: str = None,
                                     true_frames=None):
    """The chunked transformer forward with the time dim split over
    ``axis``.

    ``features``: this rank's (B_local, C, T_local) block
    (``shard_frames`` of features padded by ``pad_frames_for_context``),
    T_local a multiple of the stride; ``lengths``: the global frame counts
    of those rows; ``true_frames``: the global T before padding (defaults
    to the padded T). Returns this rank's (B_local, output_channels,
    T_local) logits block. ``batch_axis`` names the rows' split (DP x CP);
    the caller cuts the rows (``shard_frames``)."""
    config = model.config
    overlap = config.chunk_overlap
    chunk_len = config.chunk_length
    stride = chunk_len - 2 * overlap
    n, idx = mesh.shape[axis], mesh.index(axis)
    group = mesh.group(axis)
    B, C, t_local = features.shape
    if t_local % stride:
        raise ValueError(
            f'T={t_local * n} must be a multiple of stride*shards='
            f'{stride * n}; pad with pad_frames_for_context')
    local_blocks = t_local // stride
    if true_frames is None:
        true_frames = t_local * n
    device = features.device
    features = features.float().contiguous()
    lengths = torch.as_tensor(lengths, device=device).long()

    # Halo exchange: my right edge -> the right neighbour's left halo, my
    # left edge -> the left neighbour's right halo
    from .comm import ppermute

    left_halo, right_halo = ppermute(
        [features[..., -overlap:], features[..., :overlap]],
        [[(i, i + 1) for i in range(n - 1)],
         [(i + 1, i) for i in range(n - 1)]], group, 'halo')
    # Rank 0 replicate-pads its first frame; the last rank's right halo,
    # past the final window's edge, is ppermute's zeros
    if idx == 0:
        left_halo = features[..., :1].expand(B, C, overlap)
    padded = torch.cat([left_halo, features, right_halo], dim=2)

    # Local windows folded into the batch: (B * local_blocks, C, chunk)
    starts = torch.arange(local_blocks, device=device) * stride
    widx = starts[:, None] + torch.arange(chunk_len, device=device)[None, :]
    windows = padded[:, :, widx].permute(0, 2, 1, 3).reshape(
        B * local_blocks, C, chunk_len)

    # Global block ids: the single-process fold's valid and physical
    # window lengths (models/transformer.py chunked_forward)
    block_ids = idx * local_blocks + torch.arange(local_blocks,
                                                  device=device)
    remaining = lengths[:, None] - block_ids[None, :] * stride
    chunk_lengths = torch.clamp(remaining + overlap, 0, chunk_len)
    chunk_lengths = torch.where(chunk_lengths == overlap, 0, chunk_lengths)
    chunk_lengths = chunk_lengths.reshape(B * local_blocks)
    phys = torch.clamp(true_frames + overlap - block_ids * stride, 0,
                       chunk_len)
    phys = phys[None, :].expand(B, local_blocks).reshape(-1)

    logits = transformer.forward(model, windows, chunk_lengths,
                                 phys_lengths=phys)
    logits = logits.reshape(B, local_blocks, -1, chunk_len)
    inner = logits[..., overlap:chunk_len - overlap]
    return inner.permute(0, 2, 1, 3).reshape(B, -1, local_blocks * stride)
