"""Frame-wise Transformer PPG encoder (PyTorch).

Counterpart of ``ppgs_tpu/models/transformer.py`` (reference:
ppgs/model/transformer.py:13-114): a k=5 input conv, a sinusoidal PE,
post-LN encoder layers with the semantics of
``torch.nn.TransformerEncoderLayer`` (ReLU FFN, packed QKV), and a k=5
output conv. The public layout is (B, C, T) as in the JAX package; the
encoder runs on (B, T, C).

Parameters live in ``nn.Module``s in the JAX package's ``x @ W``
orientation, with the QKV projection fused into one (C, 3C) matrix; convs
hold torch's (O, I, K) weights. ``convert.params_from_jax`` maps a JAX
parameter file onto this state.

Long inputs fold 500-frame windows with 50-frame halos into the batch
(``chunked_forward``), exactly as the JAX package does.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..ops import encoder_layer_kernel as elk
from ..ops import flash_attention as fa
from ..ops import fused_ffn
from ..ops.masking import mask_from_lengths


###############################################################################
# Modules
###############################################################################


class Norm(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class Attention(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.wqkv = nn.Parameter(torch.zeros(channels, 3 * channels))
        self.bqkv = nn.Parameter(torch.zeros(3 * channels))
        self.wo = nn.Parameter(torch.zeros(channels, channels))
        self.bo = nn.Parameter(torch.zeros(channels))


class FFN(nn.Module):
    def __init__(self, channels, ffn_channels):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(channels, ffn_channels))
        self.b1 = nn.Parameter(torch.zeros(ffn_channels))
        self.w2 = nn.Parameter(torch.zeros(ffn_channels, channels))
        self.b2 = nn.Parameter(torch.zeros(channels))


class Prepared(nn.Module):
    """One layer's weights as the encoder's products read them, built from
    its parameters by ``convert.prepare``: non-persistent buffers."""

    def __init__(self, tensors):
        super().__init__()
        for name, tensor in tensors.items():
            self.register_buffer(name, tensor, persistent=False)


class EncoderLayer(nn.Module):
    def __init__(self, channels, ffn_channels):
        super().__init__()
        self.attn = Attention(channels)
        self.norm1 = Norm(channels)
        self.ffn = FFN(channels, ffn_channels)
        self.norm2 = Norm(channels)


class Transformer(nn.Module):
    """The PPG encoder for one config; ``forward`` is the module-level
    function of the same name. It runs once ``convert.prepare`` has given
    its layers their ``prepared`` weights (``load.model`` does)."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        c, k = config.hidden_channels, config.kernel_size
        self.input_conv = nn.Conv1d(config.input_channels, c, k)
        self.layers = nn.ModuleList(
            EncoderLayer(c, config.ffn_channels)
            for _ in range(config.num_hidden_layers))
        self.output_conv = nn.Conv1d(c, config.output_channels, k)
        self.register_buffer(
            'pe', torch.from_numpy(positional_encoding(config.max_len, c)),
            persistent=False)

    def forward(self, features, lengths, phys_lengths=None):
        return forward(self, features, lengths, phys_lengths)


def init(config: Config, generator=None):
    """Random parameters in the JAX package's layout (a nested dict of
    numpy arrays, as ``ppgs_tpu.models.transformer.init`` returns), so that
    ``load.save_params`` writes a checkpoint both packages read. The
    distributions are the JAX package's (kaiming-uniform convs, xavier-
    uniform matrices, zero biases, unit LayerNorms), drawn from
    ``generator``; the numbers are not JAX's."""
    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return ((2 * u - 1) * bound).float().numpy()

    def xavier(fan_in, fan_out):
        return uniform((fan_in, fan_out), math.sqrt(6.0 / (fan_in + fan_out)))

    def conv(c_in, c_out):
        bound = 1.0 / math.sqrt(c_in * k)
        return {'weight': uniform((k, c_in, c_out), bound),
                'bias': uniform((c_out,), bound)}

    d, f, k = config.hidden_channels, config.ffn_channels, config.kernel_size
    zeros, ones = np.zeros(d, np.float32), np.ones(d, np.float32)
    params = {'input_conv': conv(config.input_channels, d),
              'output_conv': conv(d, config.output_channels),
              'layers': []}
    for _ in range(config.num_hidden_layers):
        params['layers'].append({
            'attn': {**{f'w{n}': xavier(d, d) for n in 'qkvo'},
                     **{f'b{n}': zeros for n in 'qkvo'}},
            'norm1': {'scale': ones, 'bias': zeros},
            'norm2': {'scale': ones, 'bias': zeros},
            'ffn': {'w1': xavier(d, f), 'b1': np.zeros(f, np.float32),
                    'w2': xavier(f, d), 'b2': zeros},
        })
    return params


###############################################################################
# Building blocks
###############################################################################


@functools.lru_cache(maxsize=8)
def positional_encoding(max_len: int, channels: int):
    """Sinusoidal table (max_len, channels); reference transformer.py:92-102."""
    index = np.arange(max_len, dtype=np.float64)[:, None]
    frequency = np.exp(
        np.arange(0, channels, 2, dtype=np.float64)
        * (-math.log(10000.0) / channels))
    table = np.zeros((max_len, channels), dtype=np.float64)
    table[:, 0::2] = np.sin(index * frequency)
    table[:, 1::2] = np.cos(index * frequency)
    return table.astype(np.float32)


def _layer_norm(x, scale, bias):
    # Statistics in fp32 regardless of the activation dtype
    return fused_ffn.layer_norm(x.float(), scale, bias).to(x.dtype)


def conv1d_same(x, weight, bias):
    """'same'-padded 1D conv in (B, C, T) layout, padding ((k-1)//2, k//2);
    weight (O, I, K)."""
    k = weight.shape[-1]
    x = F.pad(x.to(weight.dtype), ((k - 1) // 2, k // 2))
    return F.conv1d(x, weight, bias)


def _attention(x, p, key_mask, causal, heads, compute_dtype, kernel):
    """Packed multi-head self-attention on (B, T, C); ``p`` is the layer's
    ``prepared`` weights.

    key_mask: (B, T) bool, True = valid key. Fully masked query rows give
    zeros (safe softmax) instead of the reference's NaNs. ``kernel`` runs the
    attention through the K2 kernel wrapper; the QKV and output products
    stay plain matmuls, as the JAX package leaves them to XLA here.
    """
    B, T, C = x.shape
    d_head = C // heads
    cd = compute_dtype
    qkv = fused_ffn.matmul(x.to(cd), p.wqkv).to(cd) + p.bqkv
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

    if kernel:
        out = fa.flash_attention(q, k, v, key_mask, heads, causal=causal)
    else:
        # The JAX package's XLA path: logits rounded to the compute dtype,
        # fp32 softmax with the key mask before the max, 1/denom before PV
        def heads_first(t):
            return t.reshape(B, T, heads, d_head).transpose(1, 2)

        q4, k4, v4 = heads_first(q), heads_first(k), heads_first(v)
        logits = fused_ffn.matmul(q4, k4.transpose(-1, -2)).to(cd).float()
        logits = logits * (1.0 / math.sqrt(d_head))
        mask = key_mask[:, None, None, :]
        if causal:
            mask = mask & torch.ones(T, T, dtype=torch.bool,
                                     device=x.device).tril()
        logits = logits.masked_fill(~mask, float('-inf'))
        logits_max = logits.amax(dim=-1, keepdim=True)
        logits_max = torch.where(torch.isfinite(logits_max), logits_max, 0.0)
        unnorm = torch.exp(logits - logits_max).masked_fill(~mask, 0.0)
        denom = unnorm.sum(dim=-1, keepdim=True)
        probs = unnorm * (1.0 / denom.clamp_min(1e-30))
        out = fused_ffn.matmul(probs.to(cd), v4).to(cd)
        out = out.transpose(1, 2).reshape(B, T, C)
    out = fused_ffn.matmul(out, p.wo).to(cd) + p.bo
    return out.to(x.dtype)


def _encoder_layer(x, layer, key_mask, causal, heads, compute_dtype, kernel):
    """Post-LN block: x = LN(x + SA(x)); x = LN(x + FFN(x)). ``kernel``
    runs the attention and the FFN half through the K2 and K4 wrappers."""
    cd, p = compute_dtype, layer.prepared
    sa = _attention(x, p, key_mask, causal, heads, cd, kernel)
    x = _layer_norm(x + sa, layer.norm1.scale, layer.norm1.bias)
    if kernel:
        return fused_ffn.ffn_residual_layernorm(
            x, p.w1, layer.ffn.b1, p.w2, layer.ffn.b2,
            layer.norm2.scale, layer.norm2.bias)
    h = torch.relu(fused_ffn.matmul(x.to(cd), p.w1).to(cd) + p.b1)
    h = (fused_ffn.matmul(h, p.w2).to(cd) + p.b2).to(x.dtype)
    return _layer_norm(x + h, layer.norm2.scale, layer.norm2.bias)


def use_kernels(config: Config, device) -> bool:
    """Whether the encoder runs through the kernel wrappers: the JAX
    package's rule (``ppgs_tpu/models/transformer.py:70-76, :446-448``),
    bf16 compute with d_head a multiple of 128.

    The fp32 config (the strict-parity path) and bf16 at other head widths
    run plain torch, on the card too, as the JAX package runs XLA there:
    a static choice from the config, not a fallback. A width that the rule
    sends to a kernel but the card's kernels do not take yet (they take
    C = 256 with d_head = 128, the mel model; not the C = 512, d_head = 256
    of w2v2fb and w2v2fc) raises on a CUDA device: ROADMAP.md queues it."""
    C, heads = config.hidden_channels, config.attention_heads
    d_head = C // heads
    kernel = config.compute_dtype == 'bfloat16' and d_head % 128 == 0
    if (kernel and torch.device(device).type == 'cuda'
            and (C, d_head) != (256, fa.D_HEAD)):
        raise NotImplementedError(
            f'The CUDA kernels take C = 256 with d_head = {fa.D_HEAD}; '
            f'config {config.config!r} has C = {C} with d_head = {d_head}, '
            f'which is not ported to the card yet (ROADMAP.md)')
    return kernel


###############################################################################
# Forward pass (single window)
###############################################################################


@torch.no_grad()
def forward(model, features, lengths, phys_lengths=None):
    """Core forward on (B, C, T) features -> (B, output_channels, T) logits.

    No chunking here: T must be <= config.max_len; ``chunked_forward``
    handles long inputs.

    ``phys_lengths`` (per-element physical sequence length) reproduces the
    reference's tensor-truncation semantics: positions beyond it are zeroed
    before the output conv, as if the tensor physically ended there.
    Padded-but-existing positions (>= lengths, < phys_lengths) leak into the
    output conv, matching the reference.
    """
    config = model.config
    compute_dtype = getattr(torch, config.compute_dtype)
    T = features.shape[-1]
    heads = config.attention_heads
    mask = mask_from_lengths(lengths, T)                    # (B, T)

    x = conv1d_same(features, model.input_conv.weight, model.input_conv.bias)
    x = x.transpose(1, 2) * mask[..., None]                 # (B, T, C)
    # Row-major (B, T, C) from here on: the kernels read whole rows
    x = (x + model.pe[:T]).contiguous()

    # Kernel dispatch, the JAX package's rule (transformer.py:446-482; see
    # use_kernels): the fp32 config runs plain torch on the card, as JAX
    # runs XLA there. That is a static choice from the config, not a
    # fallback: a kernel that is chosen launches or raises. Windows up to
    # MAX_SEQ frames take the four-kernel stack; longer ones (legacy_mode)
    # the per-layer path with K2 and K4.
    kernel = use_kernels(config, x.device)
    if kernel and T <= elk.MAX_SEQ:
        x = elk.encoder_stack(x, mask, model.layers, heads,
                              compute_dtype=compute_dtype,
                              causal=config.is_causal)
    else:
        for layer in model.layers:
            x = _encoder_layer(x, layer, mask, config.is_causal, heads,
                               compute_dtype, kernel)

    if phys_lengths is not None:
        phys_mask = mask_from_lengths(phys_lengths.to(lengths.dtype), T)
        x = x * phys_mask[..., None]

    x = conv1d_same(x.transpose(1, 2), model.output_conv.weight,
                    model.output_conv.bias)
    return x * mask[:, None, :]


###############################################################################
# Chunked forward for long inputs
###############################################################################


def chunk_layout(total_frames: int, chunk_length: int, overlap: int):
    """Static chunking geometry for the reference overlap-trim scheme."""
    stride = chunk_length - 2 * overlap
    num_blocks = max(1, math.ceil(total_frames / stride))
    return stride, num_blocks


@torch.no_grad()
def chunked_forward(model, features, lengths, true_frames=None):
    """Reference-equivalent chunked inference (transformer.py:49-64),
    batched.

    Windows of ``chunk_length`` frames with ``overlap`` halo on each side
    are gathered from the (replicate-left, zero-right padded) input and
    folded into the batch -> one forward pass -> inner frames concatenated
    and trimmed to T. ``true_frames`` (default T) is the un-padded sequence
    length, where the last window's physical truncation falls.
    """
    config = model.config
    B, C, T = features.shape
    overlap, chunk_len = config.chunk_overlap, config.chunk_length
    if T <= chunk_len:
        return forward(model, features, lengths)

    stride, num_blocks = chunk_layout(T, chunk_len, overlap)
    device = features.device

    # Replicate-pad left by overlap, zero-pad right to the last window edge
    right = (num_blocks - 1) * stride + chunk_len - (T + overlap)
    padded = F.pad(features.float(), (overlap, 0), mode='replicate')
    padded = F.pad(padded, (0, right))

    starts = torch.arange(num_blocks, device=device) * stride
    idx = starts[:, None] + torch.arange(chunk_len, device=device)[None, :]
    windows = padded[:, :, idx]                  # (B, C, nb, chunk_len)
    windows = windows.permute(0, 2, 1, 3).reshape(
        B * num_blocks, C, chunk_len)

    # Per-window lengths: clamp(lengths - i*stride + overlap, 0, chunk_len),
    # zeroed when the remaining span is only the halo (reference :58-59):
    # such windows are wholly masked
    block_ids = torch.arange(num_blocks, device=device)
    remaining = lengths[:, None] - block_ids[None, :] * stride
    chunk_lengths = torch.clamp(remaining + overlap, 0, chunk_len)
    chunk_lengths = torch.where(chunk_lengths == overlap, 0, chunk_lengths)
    chunk_lengths = chunk_lengths.reshape(B * num_blocks)

    # Physical window length: min(chunk_len, true_T + overlap - i*stride)
    if true_frames is None:
        true_frames = T
    phys = torch.clamp(true_frames + overlap - block_ids * stride, 0,
                       chunk_len)
    phys = phys[None, :].expand(B, num_blocks).reshape(-1)

    logits = forward(model, windows, chunk_lengths, phys_lengths=phys)
    logits = logits.reshape(B, num_blocks, -1, chunk_len)
    inner = logits[..., overlap:chunk_len - overlap]
    out = inner.permute(0, 2, 1, 3).reshape(B, -1, num_blocks * stride)
    return out[..., :T]
