"""Conformer ASR encoder in PyTorch (the 'bottleneck' frontend's model).

Counterpart of ``ppgs_tpu/models/conformer.py``, the reference's vendored
ESPnet ConformerEncoder (ppgs/preprocess/bottleneck/conformer_ppg_model/
encoder/*), inference only:

- Conv2dNoSubsampling input: two 5x5 'same' convs + ReLU over the
  (time, mel) map, flattened in (channel, mel) order, a linear projection,
  times sqrt(d);
- legacy Transformer-XL relative-position attention: the reversed
  sinusoid table built once at max_len 5000, pos_bias_u/v, legacy
  rel_shift;
- macaron half-FFNs with swish, the conv module (pointwise + GLU,
  depthwise k = 15, BatchNorm with running statistics, swish, pointwise),
  pre-norm LayerNorms (eps 1e-5), a per-block final LayerNorm and the
  stack-end after_norm; the residual is fp32 throughout.

The module tree carries the JAX pytree's names and layouts (``x @ W``
matrices, convs as (KH, KW, I, O) and (K, I, O)), so a JAX parameter file's
flat keys are its state-dict keys (``convert.conformer_params_from_jax``);
``convert.prepare_conformer`` derives the compute-dtype copies the products
read.

The attention follows the JAX dispatch: a bf16 config with T <= 2048 (and
d_k <= 64) runs the fused bias attention B8 (``ops/flash_attention.py::
fused_attention_bias``: the kernel on the card, its plain version on the
CPU); longer inputs and every fp32 config run the counterparts of the JAX
package's XLA branches in plain PyTorch, the bf16 one with its own rounding
(bf16 scores, fp32 row statistics, bf16 unnormalised p). The 5x5 convs,
the depthwise conv and the products run as PyTorch calls (cuDNN, cuBLAS),
as the JAX package leaves them to XLA. In bf16 a cuDNN conv or a cuBLAS
product rounds its output to bf16 before the fp32 bias, where JAX keeps
the fp32 sum (``preferred_element_type``); the bf16 envelope covers it.
"""

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops.masking import mask_from_lengths

MAX_FUSED_T = 2048        # the fused attention's limit (the JAX rule's)


###############################################################################
# Architecture config (a copy of the JAX package's)
###############################################################################


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    input_dim: int = 80
    dim: int = 144
    heads: int = 4
    ffn_dim: int = 576
    num_blocks: int = 16
    conv_kernel: int = 15
    compute_dtype: str = 'float32'


BOTTLENECK = ConformerConfig()


###############################################################################
# Modules (the JAX pytree, one parameter per leaf)
###############################################################################


class _Leaves(nn.Module):
    """One dict of the JAX pytree: a parameter per leaf, of its shape."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))


def _linear(n_in, n_out, bias=True):
    return _Leaves(weight=(n_in, n_out), **({'bias': (n_out,)} if bias
                                            else {}))


def _norm(d):
    return _Leaves(scale=(d,), bias=(d,))


class _FFN(nn.Module):
    def __init__(self, d, ffn):
        super().__init__()
        self.w1, self.w2 = _linear(d, ffn), _linear(ffn, d)


class _Attention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.q, self.k, self.v, self.out = (_linear(d, d) for _ in range(4))
        self.pos = _linear(d, d, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d // heads))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d // heads))


class _ConvModule(nn.Module):
    def __init__(self, d, kernel):
        super().__init__()
        self.pointwise1 = _Leaves(weight=(1, d, 2 * d), bias=(2 * d,))
        self.depthwise = _Leaves(weight=(kernel, 1, d), bias=(d,))
        self.batch_norm = _Leaves(scale=(d,), bias=(d,), mean=(d,), var=(d,))
        self.pointwise2 = _Leaves(weight=(1, d, d), bias=(d,))


class Block(nn.Module):
    def __init__(self, config: ConformerConfig):
        super().__init__()
        d = config.dim
        self.ff_macaron = _FFN(d, config.ffn_dim)
        self.norm_ff_macaron = _norm(d)
        self.attn = _Attention(d, config.heads)
        self.norm_mha = _norm(d)
        self.conv = _ConvModule(d, config.conv_kernel)
        self.norm_conv = _norm(d)
        self.ff = _FFN(d, config.ffn_dim)
        self.norm_ff = _norm(d)
        self.norm_final = _norm(d)


class Conformer(nn.Module):
    """The conformer for one ``ConformerConfig``. It runs once
    ``convert.prepare_conformer`` has given it its ``prepared`` weights
    (``preprocess.bottleneck`` does)."""

    def __init__(self, config: ConformerConfig = BOTTLENECK):
        super().__init__()
        self.config = config
        d = config.dim
        self.embed = nn.Module()
        self.embed.conv1 = _Leaves(weight=(5, 5, 1, d), bias=(d,))
        self.embed.conv2 = _Leaves(weight=(5, 5, d, d), bias=(d,))
        self.embed.out = _linear(d * config.input_dim, d)
        self.after_norm = _norm(d)
        self.blocks = nn.ModuleList(Block(config)
                                    for _ in range(config.num_blocks))

    def forward(self, features, lengths=None):
        return forward(self, features, lengths)


def init(config: ConformerConfig = BOTTLENECK, generator=None):
    """Random parameters in the JAX package's layout (a nested dict of numpy
    arrays, as ``ppgs_tpu.models.conformer.init`` returns): normal(0, 0.02)
    matrices, convs and position biases, zero biases, unit norms, BatchNorm
    statistics 0 and 1, drawn from ``generator``; the numbers are not
    JAX's."""
    def normal(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float64)
                * 0.02).float().numpy()

    d, ffn, H = config.dim, config.ffn_dim, config.heads
    zeros = functools.partial(np.zeros, dtype=np.float32)
    ones = functools.partial(np.ones, dtype=np.float32)

    def linear(n_in, n_out, bias=True):
        return {'weight': normal(n_in, n_out),
                **({'bias': zeros(n_out)} if bias else {})}

    def norm():
        return {'scale': ones(d), 'bias': zeros(d)}

    params = {
        'embed': {'conv1': {'weight': normal(5, 5, 1, d), 'bias': zeros(d)},
                  'conv2': {'weight': normal(5, 5, d, d), 'bias': zeros(d)},
                  'out': linear(d * config.input_dim, d)},
        'after_norm': norm(),
        'blocks': [],
    }
    for _ in range(config.num_blocks):
        params['blocks'].append({
            'ff_macaron': {'w1': linear(d, ffn), 'w2': linear(ffn, d)},
            'norm_ff_macaron': norm(),
            'attn': {'q': linear(d, d), 'k': linear(d, d), 'v': linear(d, d),
                     'out': linear(d, d), 'pos': linear(d, d, bias=False),
                     'pos_bias_u': normal(H, d // H),
                     'pos_bias_v': normal(H, d // H)},
            'norm_mha': norm(),
            'conv': {
                'pointwise1': {'weight': normal(1, d, 2 * d),
                               'bias': zeros(2 * d)},
                'depthwise': {'weight': normal(config.conv_kernel, 1, d),
                              'bias': zeros(d)},
                'batch_norm': {'scale': ones(d), 'bias': zeros(d),
                               'mean': zeros(d), 'var': ones(d)},
                'pointwise2': {'weight': normal(1, d, d), 'bias': zeros(d)}},
            'norm_conv': norm(),
            'ff': {'w1': linear(d, ffn), 'w2': linear(ffn, d)},
            'norm_ff': norm(),
            'norm_final': norm(),
        })
    return params


###############################################################################
# Relative positional encoding (legacy, reversed)
###############################################################################


@functools.lru_cache(maxsize=8)
def rel_pos_table(length: int, dim: int, max_len: int = 5000):
    """Reversed sinusoid table (embedding.py:56-77, reverse=True), in numpy
    float32 as the JAX package builds it (``torch.sin`` differs from numpy
    by about an ulp of arguments near 5000).

    The table is built once at max_len = 5000 (positions max_len-1 .. 0) and
    its FIRST ``length`` rows are used, so the positions are max_len - 1
    down to max_len - length; longer inputs rebuild it at T."""
    max_len = max(max_len, length)
    position = np.arange(max_len - 1, -1, -1.0, dtype=np.float32)[:, None]
    div_term = np.exp((np.arange(0, dim, 2).astype(np.float32)
                       * np.float32(-(math.log(10000.0) / dim))))
    angle = position * div_term
    pe = np.zeros((max_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(angle)
    pe[:, 1::2] = np.cos(angle)
    return pe[:length]


@functools.lru_cache(maxsize=8)
def _rel_pos_on(length: int, dim: int, device):
    """``rel_pos_table`` as a (1, length, dim) tensor on ``device``, copied
    there once."""
    return torch.from_numpy(rel_pos_table(length, dim))[None].to(device)


def rel_shift(x):
    """Legacy rel_shift (attention.py:127-143): pad a zero column, view
    (T2 + 1, T1), drop the first row, view (T1, T2)."""
    B, H, T1, T2 = x.shape
    padded = torch.cat([x.new_zeros((B, H, T1, 1)), x], dim=-1)
    return padded.view(B, H, T2 + 1, T1)[:, :, 1:].reshape(B, H, T1, T2)


def use_fused_rel_attention(T: int, d_k: int, compute_dtype) -> bool:
    """The JAX rule (``ppgs_tpu/models/conformer.py:158-168, :196-197``):
    bf16, d_k <= 64, T <= 2048. The TPU's T % 8 == 0 has no counterpart (B8
    takes any T), nor its backend check: on the CPU B8's plain version
    runs."""
    return (compute_dtype == torch.bfloat16 and d_k <= fa.REL_MAX_D
            and T <= MAX_FUSED_T)


###############################################################################
# Blocks
###############################################################################


def _layer_norm(x, p, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], p.scale, p.bias, eps)


def _compute_dtype(config):
    return getattr(torch, config.compute_dtype)


def attention_inputs(x, pos_emb, w, heads, cd):
    """A block's attention operands in the compute dtype: q_u, k and v as
    (B, T, H, d_k) (k and v views of the fused QKV product), q_v as (B, H,
    T, d_k) and the projected positions pos as (1, H, T, d_k)."""
    B, T, C = x.shape
    d_k = C // heads
    qkv = x.to(cd) @ w.wqkv + w.bqkv
    q = qkv[..., :C].unflatten(-1, (heads, d_k))
    k = qkv[..., C:2 * C].unflatten(-1, (heads, d_k))
    v = qkv[..., 2 * C:].unflatten(-1, (heads, d_k))
    pos = (pos_emb.to(cd) @ w.wpos).reshape(1, T, heads, d_k).transpose(1, 2)
    q_u = q + w.pos_bias_u
    q_v = (q + w.pos_bias_v).transpose(1, 2)
    return q_u, k, v, q_v, pos


def position_term(q_v, pos):
    """The legacy-shift bias of B8, (B, H, T + 1, T): the zero-column-padded,
    unshifted q_v . pos^T, a plain product in the compute dtype. The zero
    column comes from a zero row prepended to pos, so no copy makes it, and
    the (T, T + 1) result viewed (T + 1, T) is what the kernel shifts by
    reading its rows 1 .. T."""
    B, H, T, _ = q_v.shape
    pos_z = F.pad(pos, (0, 0, 1, 0))                      # (1, H, T + 1, d_k)
    return (q_v @ pos_z.transpose(-1, -2)).view(B, H, T + 1, T)


def _rel_attention(x, pos_emb, w, mask, heads, cd):
    """Rel-pos multi-head attention on (B, T, C) fp32 x; ``w`` the block's
    prepared attention weights, ``mask`` (B, T) bool valid keys. The branch
    follows ``use_fused_rel_attention``."""
    B, T, C = x.shape
    d_k = C // heads
    key_mask = (mask if mask is not None
                else torch.ones(B, T, dtype=torch.bool, device=x.device))
    q_u, k, v, q_v, pos = attention_inputs(x, pos_emb, w, heads, cd)
    if use_fused_rel_attention(T, d_k, cd):
        out = fa.fused_attention_bias(q_u, k, v, position_term(q_v, pos),
                                      key_mask, heads)
        return (out.reshape(B, T, C) @ w.wo + w.bo).to(x.dtype)

    q_u, k4, v4 = (t.transpose(1, 2) for t in (q_u, k, v))
    matrix_ac = q_u @ k4.transpose(-1, -2)
    matrix_bd = rel_shift(q_v @ pos.transpose(-1, -2))
    valid = key_mask[:, None, None, :]
    if cd == torch.float32:
        # Strict-parity path: fp32 scores
        scores = (matrix_ac + matrix_bd).float() / math.sqrt(d_k)
        scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1).masked_fill(~valid, 0.0)
    else:
        # The JAX package's bf16 path: scores in the compute dtype, only the
        # softmax statistics in fp32
        scores = (matrix_ac + matrix_bd) * torch.tensor(1.0 / math.sqrt(d_k),
                                                        dtype=cd)
        scores = scores.masked_fill(~valid, -1e30)
        row_max = scores.float().amax(dim=-1, keepdim=True)
        unnorm = torch.exp(scores.float() - row_max).to(cd)
        unnorm = unnorm.masked_fill(~valid, 0.0)
        denom = unnorm.sum(dim=-1, keepdim=True, dtype=torch.float32)
        attn = unnorm * (1.0 / denom.clamp_min(1e-30)).to(cd)
    out = (attn.to(cd) @ v4).transpose(1, 2).reshape(B, T, C)
    return (out @ w.wo + w.bo).to(x.dtype)


def _ffn(x, w, cd):
    h = F.silu(x.to(cd) @ w.w1 + w.b1)
    return (h @ w.w2 + w.b2).to(x.dtype)


def _conv_module(x, p, w, cd):
    """(B, T, C): pointwise -> GLU, depthwise k = 15, BatchNorm (running
    statistics, eps 1e-5), swish, pointwise; products in the compute dtype,
    biases and norms in fp32."""
    h = (x.to(cd) @ w.pw1).float() + p.pointwise1.bias
    h = F.glu(h, dim=-1)
    k = w.dw.shape[-1]
    h = F.conv1d(h.to(cd).transpose(1, 2), w.dw, padding=(k - 1) // 2,
                 groups=h.shape[-1]).transpose(1, 2).float()
    h = h + p.depthwise.bias
    bn = p.batch_norm
    h = (h - bn.mean) * torch.rsqrt(bn.var + 1e-5) * bn.scale + bn.bias
    h = F.silu(h)
    return ((h.to(cd) @ w.pw2).float() + p.pointwise2.bias).to(x.dtype)


def block(x, pos_emb, p, mask, config: ConformerConfig):
    """One conformer block on the fp32 residual (B, T, C)."""
    cd = _compute_dtype(config)
    w = p.prepared
    x = x + 0.5 * _ffn(_layer_norm(x, p.norm_ff_macaron), w.ff_macaron, cd)
    x = x + _rel_attention(_layer_norm(x, p.norm_mha), pos_emb, w.attn,
                           mask, config.heads, cd)
    x = x + _conv_module(_layer_norm(x, p.norm_conv), p.conv, w.conv, cd)
    x = x + 0.5 * _ffn(_layer_norm(x, p.norm_ff), w.ff, cd)
    return _layer_norm(x, p.norm_final)


###############################################################################
# Encoder
###############################################################################


def embed(model, features):
    """Conv2dNoSubsampling: (B, T, input_dim) -> ((B, T, d) fp32, pos_emb
    (1, T, d)). The 5x5 d -> d conv (most of the conformer's operations)
    runs in the compute dtype, channels-last."""
    config = model.config
    cd = _compute_dtype(config)
    p, w = model.embed, model.prepared
    x = features.float()[:, None].to(cd)                  # (B, 1, T, F)
    x = F.conv2d(x, w.conv1, padding=2).float()
    x = x.add_(p.conv1.bias[:, None, None]).relu_()
    x = x.to(cd, memory_format=torch.channels_last)
    x = F.conv2d(x, w.conv2, padding=2).float()
    x = x.add_(p.conv2.bias[:, None, None]).relu_()
    B, C, T, Fm = x.shape
    # torch flattens (C, F): (B, C, T, F) -> (B, T, C, F)
    x = x.to(cd).permute(0, 2, 1, 3).reshape(B, T, C * Fm)
    x = (x @ w.out + w.out_bias).float()
    x = x * math.sqrt(config.dim)
    return x, _rel_pos_on(T, config.dim, x.device)


@torch.no_grad()
def forward(model, features, lengths=None):
    """(B, T, input_dim) features -> (B, T, dim) fp32 latents, in the
    compute dtype of the model's config. ``lengths`` (B,) valid frames: the
    attention's key mask."""
    mask = None
    if lengths is not None:
        mask = mask_from_lengths(torch.as_tensor(lengths,
                                                 device=features.device),
                                 features.shape[1])
    x, pos_emb = embed(model, features)
    for p in model.blocks:
        x = block(x, pos_emb, p, mask, model.config)
    return _layer_norm(x, model.after_norm)
