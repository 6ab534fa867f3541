"""Masked multi-head attention on the (B, T, C) layout (K2,
``kernels/csrc/attention.cu``).

One CUDA kernel, with an online softmax over 64-key tiles, serves the three
places the JAX package runs attention in a TPU kernel at d_head = 128:
``ppgs_tpu/ops/flash_attention.py`` ``_fused_kernel`` (T <= 1024) and
``_flash_kernel`` (T > 1024), and the attention inside
``ppgs_tpu/ops/encoder_layer_kernel.py::_layer_body``. q, k and v are read
in place through a row stride, so the fused (B, T, 3C) QKV buffer needs no
split and no head transpose, and any T works without padding. Fully masked
query rows (and wholly masked windows) give exactly 0.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch the kernel or raise. The packed d_head < 128 variant of
the TPU kernel belongs to a later slice (ROADMAP.md). Bound, design and
rounding notes are in the CUDA source.
"""

import math

import torch

from .. import kernels

LOG2E = 1.4426950408889634
NEG_INF = -1e30
D_HEAD = 128        # the kernel's head width


def attention_reference(q, k, v, mask, heads, scale_log2, causal=False):
    """Plain version of ``attention`` (any device, any strides, q's dtype as
    the compute dtype).

    Scores in fp32 (times ``scale_log2``), the key and causal masks applied
    before the row max, p = exp2(s - max) in fp32, p in the compute dtype for
    the PV product, the row sum from the fp32 p, and the 1/sum scale after
    the product; a row sum of 0 gives 0.
    """
    B, T, C = q.shape
    d = C // heads
    cd = q.dtype

    def heads_first(t):
        return t.reshape(B, T, heads, d).transpose(1, 2).float()

    q4, k4, v4 = heads_first(q), heads_first(k), heads_first(v)
    s = (q4 @ k4.transpose(-1, -2)) * scale_log2          # (B, H, T, T)
    valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(T, T, dtype=torch.bool,
                                   device=q.device).tril()
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True)).masked_fill(~valid, 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    o = (p.to(cd).float() @ v4) / denom.clamp_min(1e-30)
    return o.transpose(1, 2).reshape(B, T, C).to(cd)


def _row_stride(t, T):
    """Row stride of a (B, T, width) view that the kernel can read in place
    (unit column stride, rows evenly spaced, 16-byte aligned), else raise."""
    rs = t.stride(1)
    if (t.stride(2) != 1 or t.stride(0) != T * rs or rs % 8
            or t.data_ptr() % 16):
        raise ValueError(
            f'attention kernel needs (B, T, C) views with unit column stride '
            f'and 16-byte aligned rows; got strides {t.stride()}')
    return rs


def attention(q, k, v, mask, heads, scale_log2, causal=False):
    """K2: q, k, v (B, T, H*128) bf16 (views of one buffer are fine),
    mask (B, T) bool, True = valid key. Returns a new (B, T, C) bf16 tensor.
    ``scale_log2`` multiplies the fp32 scores before exp2: log2(e)/sqrt(d)
    for raw q, 1 when that factor is folded into q's weights."""
    if q.device.type == 'cpu':
        return attention_reference(q, k, v, mask, heads, scale_log2, causal)
    B, T, C = q.shape
    if C != heads * D_HEAD:
        raise ValueError(f'attention kernel takes d_head={D_HEAD}; got '
                         f'C={C} with {heads} heads')
    dev = q.device
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.dtype != torch.bfloat16 or t.device != dev:
            raise ValueError(f'{name}: expected bfloat16 on {dev}, got '
                             f'{t.dtype} on {t.device}')
        if tuple(t.shape) != (B, T, C):
            raise ValueError(f'{name}: expected shape {(B, T, C)}, got '
                             f'{tuple(t.shape)}')
    rs = _row_stride(q, T)
    if _row_stride(k, T) != rs or _row_stride(v, T) != rs:
        raise ValueError('q, k and v must share one row stride')
    kernels.require(mask, 'mask', torch.bool, dev, (B, T))
    out = torch.empty((B, T, C), dtype=torch.bfloat16, device=dev)
    kernels.launch('ppgs_attention', q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   rs, mask.data_ptr(), out.data_ptr(), C, B, T, heads,
                   float(scale_log2), int(causal), device=dev)
    attention.launches += 1
    return out


attention.launches = 0


def flash_attention(q, k, v, mask, num_heads, causal=False):
    """Masked multi-head attention on (B, T, C) q, k, v (the per-layer
    path's ``ppgs_tpu/ops/flash_attention.py::flash_attention``); mask (B, T)
    bool, True = valid key. Any T (no block multiple needed)."""
    scale = LOG2E / math.sqrt(q.shape[-1] // num_heads)
    return attention(q, k, v, mask, num_heads, scale, causal)


def flash_attention_reference(q, k, v, mask, num_heads, causal=False):
    """Plain version of ``flash_attention``."""
    scale = LOG2E / math.sqrt(q.shape[-1] // num_heads)
    return attention_reference(q, k, v, mask, num_heads, scale, causal)
