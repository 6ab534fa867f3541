"""Pipeline parallelism: encoder layers staged over a mesh axis
(counterpart of ``ppgs_tpu/parallel/pipeline.py``).

A GPipe schedule, the JAX package's: each rank along the ``pipe`` axis
owns ``num_hidden_layers / n`` consecutive layers, and microbatches flow
stage to stage over the ring (``comm.ppermute``, JAX's
``jax.lax.ppermute``):

- the schedule runs ``M + n - 1`` ticks (M microbatches); every tick each
  stage applies its layers to its current activation and passes the
  result one hop along the ring. Bubble ticks compute on stale data and
  are masked at the write, branch-free, as in JAX: every tick's exchange
  stays in the autograd graph on every rank, so every rank joins every
  exchange of the backward;
- ingest is round-robin on the reverse ring: stage s owns microbatches
  k = s mod n and injects its next one every n ticks into a one-slot feed
  register, which moves one hop toward stage 0 a tick, so microbatch t
  reaches stage 0 at tick t;
- the output drains from the last stage: its buffer is broadcast to the
  stages (``comm.broadcast``), and the output conv runs on each;
- the backward is autograd through the exchanges: the backward of a send
  to the next stage is a receive from it, the reverse schedule, as JAX
  gets it from transposing ``ppermute``;
- the stage body is the port's per-layer path: in inference
  ``transformer._encoder_layer`` (K2 and K4 on the card), in training
  ``transformer._encoder_layer_train`` (the whole-layer kernel B4 where T
  % 8 == 0 and T <= 1024, else the attention and FFN train kernels B5 and
  B6), as JAX's stage body calls ``transformer._encoder_layer``;
- dropout sites are keyed by the global (layer, microbatch, site) on the
  Philox stream (``ops/dropout.py::pipeline_site``), so the masks do not
  depend on the stage count. They are other sites than the sequential
  forward's, so pipelined and sequential training are not bit-identical
  under dropout, as in JAX;
- ``batch_axis`` splits each microbatch's rows over a second axis (DP x
  PP); a model that ``parallel.shard_module`` sharded over ``tp_axis``
  gathers each stage layer's weights before it runs (TP x PP).

Every stage keeps the whole parameter set: the train step sums the
gradients over the stages (a stage's gradient of another stage's layer is
zero), so that Adam's update and the checkpoints are one process's. The
input conv and the positional encoding run on every stage for the rows it
holds, outside the staged region, as in JAX.
"""

import contextlib

import torch

from ..models import transformer
from ..ops import dropout
from ..ops.masking import mask_from_lengths
from . import comm


def stack_layer_params(layers):
    """{parameter name: (num_layers, ...) tensor}: the layers' parameters
    stacked on a leading layer dim, JAX's stacked tree flattened."""
    named = [dict(layer.named_parameters()) for layer in layers]
    return {name: torch.stack([p[name] for p in named])
            for name in named[0]}


def pipeline_rows(batch, microbatches, mesh, batch_axis=None):
    """The global rows, in order, of the logits ``pipeline_forward`` gives
    this rank: every row, or with ``batch_axis`` this rank's block of each
    microbatch's rows."""
    rows = torch.arange(batch).reshape(microbatches, -1)
    if batch_axis is not None:
        from . import batch_sharding

        rows = batch_sharding(mesh, batch_axis).block(rows.T).T
    return rows.reshape(-1)


def pipeline_forward(model, features, lengths, mesh, axis: str = 'pipe',
                     batch_axis: str = None, tp_axis: str = None,
                     num_microbatches: int = None, train: bool = False,
                     seed: int = None):
    """The transformer forward with its encoder layers pipelined over
    ``axis``.

    ``features``: the global (B, C_in, T), T <= config.max_len, and
    ``lengths`` (B,), on every rank. ``num_hidden_layers`` must divide
    into ``mesh.shape[axis]`` stages, B into ``num_microbatches`` (default
    one a stage), and the microbatches into the stages. Returns the
    (rows, output_channels, T) logits of ``pipeline_rows`` (all rows
    without ``batch_axis``), the same on every stage.

    ``train=True``: the differentiable training forward with dropout at
    config.dropout from the Philox stream of ``seed``. ``tp_axis``: the
    axis that ``model``, a ``parallel.shard_module`` view, is split over
    (TP x PP); each stage layer's weights are gathered before it runs."""
    n = mesh.shape[axis]
    stage, group = mesh.index(axis), mesh.group(axis)
    if (tp_axis is not None and mesh.shape.get(tp_axis, 1) > 1
            and not hasattr(model, '_dims')):
        raise ValueError(f'TP x PP takes the model sharded over {tp_axis!r}:'
                         f' pass parallel.shard_module\'s view of it')
    config = model.config
    num_layers = len(model.layers)
    if num_layers % n:
        raise ValueError(
            f'num_hidden_layers={num_layers} must divide evenly over '
            f'{n} pipeline stages')
    B, _, T = features.shape
    M = num_microbatches or n
    if B % M:
        raise ValueError(f'batch {B} must divide into {M} microbatches')
    if M % n:
        raise ValueError(
            f'microbatches {M} must divide into {n} pipeline stages '
            f'(round-robin stage ingest)')
    if batch_axis is not None and (B // M) % mesh.shape[batch_axis]:
        raise ValueError(
            f'microbatch size {B // M} must divide over '
            f"mesh axis {batch_axis!r} ({mesh.shape[batch_axis]} ranks)")

    with (contextlib.nullcontext() if train else torch.no_grad()):
        return _schedule(model, features, lengths, mesh, stage, group, n, M,
                         batch_axis, train, seed)


def _schedule(model, features, lengths, mesh, stage, group, n, M,
              batch_axis, train, seed):
    config = model.config
    num_layers = len(model.layers)
    B, _, T = features.shape
    rows = pipeline_rows(B, M, mesh, batch_axis).to(features.device)
    features = features[rows].float()
    lengths = torch.as_tensor(lengths, device=features.device).long()[rows]
    rate = config.dropout if train else 0.0
    seed = 0 if seed is None else int(seed)
    cd = getattr(torch, config.compute_dtype)
    mask = mask_from_lengths(lengths, T)

    # Input conv + positional encoding, outside the staged region
    x = transformer.conv1d_same(features, model.input_conv.weight,
                                model.input_conv.bias)
    x = x.transpose(1, 2) * mask[..., None]
    x = (x + model.pe[:T]).contiguous()
    if train:
        x = dropout.dropout(x, seed, dropout.PE_SITE, rate)

    # Microbatches, round-robin over the stages: stage s owns k = s mod n
    mb = x.shape[0] // M
    xm = x.reshape(M, mb, T, x.shape[-1])
    maskm = mask.reshape(M, mb, T)
    owned = xm[stage::n]
    per_stage = num_layers // n
    layers = [model.layers[stage * per_stage + j] for j in range(per_stage)]
    kernel = transformer.use_kernels(config, x.device, train=train)
    heads, causal = config.attention_heads, config.is_causal

    def run_layers(h, key_mask, microbatch):
        for j, layer in enumerate(layers):
            if train:
                global_layer = stage * per_stage + j
                drop = dropout.Drop(seed, dropout.pipeline_site(
                    global_layer, microbatch, M), rate)
                h = transformer._encoder_layer_train(
                    h, layer, key_mask, causal, heads, cd, kernel, drop)
            else:
                h = transformer._encoder_layer(h, layer, key_mask, causal,
                                               heads, cd, kernel)
        return h

    def flag(value):
        return torch.tensor(bool(value), device=x.device)

    ring = [(i, (i + 1) % n) for i in range(n)]
    reverse_ring = [(i, (i - 1) % n) for i in range(n)]
    state = torch.zeros_like(owned[0])
    feed = torch.zeros_like(owned[0])
    out_buf = [torch.zeros_like(owned[0]) for _ in range(M)]
    is_first, is_last = flag(stage == 0), stage == n - 1
    ticks = M + n - 1
    for t in range(ticks):
        # Every n ticks each stage loads its next owned microbatch
        # into the feed register (ticks past M load stale data that
        # is never written); stage 0 ingests from the register, the
        # others from the ring. where() keeps every exchange in the
        # graph, as JAX's branch-free schedule does.
        feed = torch.where(flag(t % n == 0),
                           owned[min(t // n, owned.shape[0] - 1)], feed)
        inp = torch.where(is_first, feed, state)
        microbatch = min(max(t - stage, 0), M - 1)
        y = run_layers(inp, maskm[microbatch], microbatch)
        write = is_last and 0 <= t - stage < M
        out_buf[microbatch] = torch.where(flag(write), y.to(
            out_buf[microbatch].dtype), out_buf[microbatch])
        if t + 1 < ticks:
            state, feed = comm.ppermute(
                [y.to(state.dtype), feed], [ring, reverse_ring], group,
                'pipeline')
    # Drain: the last stage's buffer, on every stage
    out = comm.broadcast(torch.stack(out_buf), group, n - 1,
                         'pipeline_drain')
    x = out.reshape(-1, T, out.shape[-1])
    x = transformer.conv1d_same(x.transpose(1, 2), model.output_conv.weight,
                                model.output_conv.bias)
    return x * mask[:, None, :]
