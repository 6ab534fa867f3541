"""Masked multi-head attention on the (B, T, C) layout (K2,
``kernels/csrc/attention.cu``).

One CUDA kernel (wgmma + TMA: S, P and O stay in registers), with an
online softmax over 64-key tiles and one instance per head width (16, 32,
64, 128, 256), and a wide route for any d_head % 128 == 0 from 384 to
2048 (a cluster of blocks splits a head's columns and forms S once, its
ranks' partial scores added through distributed shared memory in
rank order), serves the places the JAX package runs attention in
a TPU kernel: ``ppgs_tpu/ops/flash_attention.py``
``_fused_kernel`` (T <= 1024), ``_flash_kernel`` (T > 1024) and
``_fused_kernel_packed`` (d_head < 128: wav2vec2's 12 heads of 64, which
the TPU packs 128 / d_head to a 128-lane block and the card runs one head
to a block), and the attention inside
``ppgs_tpu/ops/encoder_layer_kernel.py::_layer_body`` (``encoder_stack``
and ``encoder_stack_streamed``). q, k and v are read in place through a
row stride, so the fused (B, T, 3C) QKV buffer needs no split and no head
transpose, and any T works without padding. Fully masked query rows (and
wholly masked windows) give exactly 0.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch the kernel or raise. Bound, design and rounding notes
are in the CUDA source.

The conformer's rel-pos attention (``rel_attention``, B8,
``kernels/csrc/rel_attention.cu``) and the training attention with dropout
(``flash_attention_train``, the TPU's ``flash_attention_train``) follow.
"""

import collections
import math

import torch

from .. import kernels
from . import dropout

LOG2E = 1.4426950408889634
NEG_INF = -1e30
MAX_D_HEAD = 2048           # the widest head of the kernels' wide routes
TRAIN_MAX_T = 1024          # the train forward kernel's longest window


def d_head_ok(d):
    """Whether K2 takes heads of width d: 16, 32 and 64 (the heads a
    128-lane block packs, an instance each), and every d % 128 == 0 up to
    ``MAX_D_HEAD`` (128 and 256 an instance each, 384 on the wide
    route)."""
    return d in (16, 32, 64) or train_d_head_ok(d)


def train_d_head_ok(d):
    """Whether the train kernels take heads of width d: every d % 128 ==
    0 up to ``MAX_D_HEAD`` (the JAX train kernels' rule, D % 128 == 0, at
    the port's widest head)."""
    return d % 128 == 0 and 0 < d <= MAX_D_HEAD


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
    (unit column stride, rows evenly spaced, 16-byte aligned: what a TMA
    tensor map takes), else raise."""
    rs = t.stride(1)
    if (t.stride(2) != 1 or t.stride(0) != T * rs or rs % 8
            or t.data_ptr() % 16):
        raise ValueError(
            f'attention kernel needs (B, T, C) views with unit column stride '
            f'and 16-byte aligned rows; got strides {t.stride()}')
    return rs


def _attention_args(q, k, v, mask, heads):
    """Check K2's operands and return (d_head, row stride); raise
    ValueError on what the kernel does not take, before anything is
    launched: a d_head that ``d_head_ok`` refuses, q, k or v not bf16 of
    q's shape and device, views the kernel cannot read in place
    (``_row_stride``) or of different row strides, a mask that is not a
    contiguous (B, T) bool."""
    B, T, C = q.shape
    d_head = C // heads
    if C != heads * d_head or not d_head_ok(d_head):
        raise ValueError(f'attention kernel takes d_head in (16, 32, 64) or '
                         f'd_head % 128 == 0 up to {MAX_D_HEAD}; got C={C} '
                         f'with {heads} heads')
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
    return d_head, rs


def attention(q, k, v, mask, heads, scale_log2, causal=False):
    """K2: q, k, v (B, T, H*d_head) bf16 with d_head 16, 32, 64 or d_head
    % 128 == 0 up to 2048 (views of one buffer are fine), mask (B, T) bool,
    True = valid key. Returns a
    new (B, T, C) bf16 tensor. ``scale_log2`` multiplies the fp32 scores
    before exp2: log2(e)/sqrt(d) for raw q, 1 when that factor is folded
    into q's weights. ``attention.widths`` counts the launches per d_head."""
    if q.device.type == 'cpu':
        return attention_reference(q, k, v, mask, heads, scale_log2, causal)
    d_head, rs = _attention_args(q, k, v, mask, heads)
    B, T, C = q.shape
    dev = q.device
    out = torch.empty((B, T, C), dtype=torch.bfloat16, device=dev)
    kernels.launch('ppgs_attention', q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   rs, mask.data_ptr(), out.data_ptr(), C, B, T, heads,
                   d_head, float(scale_log2), int(causal), device=dev)
    attention.launches += 1
    attention.widths[d_head] += 1
    return out


attention.launches = 0
attention.widths = collections.Counter()


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


###############################################################################
# The conformer's rel-pos attention (B8)
###############################################################################
#
# Counterpart of ppgs_tpu/ops/flash_attention.py fused_attention_bias
# (kernel _fused_kernel_bias) in its legacy_shift form, together with the
# einsum that ppgs_tpu/models/conformer.py runs before it to form the
# position term: softmax((q_u k^T + rel_shift(q_v pos^T)) / sqrt(d_k)) v
# with a key mask, in kernels/csrc/rel_attention.cu. The JAX package hands
# the TPU kernel the zero-column-padded, unshifted term (B, H, T + 1, T);
# the card's kernel forms the shifted term inside from q_v and pos, so it
# is never written. Unlike K2, p is normalised before it is rounded for the
# PV product, as the TPU kernel does. Any T up to 2048 (the TPU kernel
# needs T % 8 == 0).

REL_MAX_D = 64                  # head widths the kernel's 64-column boxes hold
REL_MAX_T = 2048                # the kernel's longest window


def position_term(q_v, pos):
    """The legacy-shift bias of the JAX kernel's ``legacy_shift`` form, (B,
    H, T + 1, T), from q_v (B, H, T, d_k) and pos (1, H, T, d_k): the
    zero-column-padded, unshifted q_v . pos^T, a plain product in the
    compute dtype. The zero column comes from a zero row prepended to pos,
    so no copy makes it, and the (T, T + 1) result viewed (T + 1, T) is
    shifted by reading its rows 1 .. T. ``position_term.calls`` counts the
    calls: the card's path makes none."""
    B, H, T, _ = q_v.shape
    position_term.calls += 1
    pos_z = torch.nn.functional.pad(pos, (0, 0, 1, 0))   # (1, H, T + 1, d_k)
    return (q_v @ pos_z.transpose(-1, -2)).view(B, H, T + 1, T)


position_term.calls = 0


def fused_attention_bias_reference(q, k, v, bias, mask, num_heads):
    """The bias form of B8's function, softmax((q k^T + shift(bias)) *
    sm_scale) v, sm_scale = 1/sqrt(d_k) (any device; q's dtype is the
    compute dtype): bias the (B, H, T + 1, T) zero-column-padded unshifted
    position term (the JAX kernel's ``legacy_shift=True`` form), logits in
    fp32, masked keys -1e30, the row max clamped at -1e29, p = exp(logits -
    max), the denominator clamped at 1e-30, p / denom in the compute dtype
    for the PV product."""
    B, T, H, dk = q.shape
    bias = bias[:, :, 1:]                                 # (B, H, T, T)
    q4, k4, v4 = (t.transpose(1, 2).float() for t in (q, k, v))
    valid = mask.bool()[:, None, None, :]
    logits = ((q4 @ k4.transpose(-1, -2)) + bias.float()) * (
        1.0 / math.sqrt(dk))
    logits = logits.masked_fill(~valid, NEG_INF)
    row_max = logits.amax(dim=-1, keepdim=True).clamp_min(-1e29)
    p = torch.exp(logits - row_max).masked_fill(~valid, 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p / denom).to(q.dtype).float() @ v4
    return out.transpose(1, 2).to(q.dtype)


def rel_attention_reference(q_u, k, v, q_v, pos, mask, num_heads):
    """Plain version of ``rel_attention`` (any device): the position term
    by ``position_term``, then ``fused_attention_bias_reference``."""
    bias = position_term(q_v.transpose(1, 2), pos.transpose(0, 1)[None])
    return fused_attention_bias_reference(q_u, k, v, bias, mask, num_heads)


def _tma_rows(t, name, shape, dev):
    """The element step between the rows of the (rows, H d) matrix that a
    (B, T, H, d) or (T, H, d) view flattens to, the heads contiguous in
    rows a TMA tensor map can read in place (16-byte aligned base, the step
    a multiple of 8 elements), else raise. A dimension of size 1 carries any
    stride, so the step is that of the innermost row dimension of size > 1
    (H d for a single row)."""
    if t.dtype != torch.bfloat16 or t.device != dev:
        raise ValueError(f'{name}: expected bfloat16 on {dev}, got {t.dtype} '
                         f'on {t.device}')
    if tuple(t.shape) != shape:
        raise ValueError(f'{name}: expected shape {shape}, got '
                         f'{tuple(t.shape)}')
    H, d = shape[-2:]
    rows = [(n, st) for n, st in zip(shape[:-2], t.stride()[:-2]) if n > 1]
    rs = rows[-1][1] if rows else H * d
    if (t.stride(-1) != 1 or (H > 1 and t.stride(-2) != d) or rs % 8
            or t.data_ptr() % 16
            or (len(rows) == 2 and rows[0][1] != rows[1][0] * rs)):
        raise ValueError(f'{name}: rel_attention needs heads contiguous in '
                         f'16-byte aligned rows, row stride a multiple of 8; '
                         f'got strides {t.stride()}')
    return rs


def rel_attention(q_u, k, v, q_v, pos, mask, num_heads):
    """B8: softmax((q_u k^T + rel_shift(bf16(q_v pos^T))) * sm_scale) v,
    sm_scale = 1/sqrt(d_k), the legacy ESPnet rel_shift.

    q_u, k, v, q_v: (B, T, H, d_k) bf16 (k and v may be views of one buffer
    with their own row stride), d_k % 4 == 0 and d_k <= 64, T <= 2048; pos:
    (T, H, d_k) bf16, the projected positions, shared by the batch; mask
    (B, T) bool, True = valid key. Returns a new (B, T, H, d_k) tensor. On a
    CPU tensor it runs the plain version; on a CUDA tensor it launches the
    kernel, which forms the shifted position term itself, or raises."""
    if q_u.device.type == 'cpu':
        return rel_attention_reference(q_u, k, v, q_v, pos, mask, num_heads)
    B, T, H, dk = q_u.shape
    dev = q_u.device
    if H != num_heads or dk % 4 or not 4 <= dk <= REL_MAX_D:
        raise ValueError(f'rel_attention kernel takes d_k % 4 == 0 up to '
                         f'{REL_MAX_D}; got {H} heads of {dk} '
                         f'(num_heads={num_heads})')
    if T > REL_MAX_T:
        raise ValueError(f'rel_attention kernel takes T <= {REL_MAX_T}; '
                         f'got {T}')
    shape = (B, T, H, dk)
    q_rs = _tma_rows(q_u, 'q_u', shape, dev)
    kv_rs = _tma_rows(k, 'k', shape, dev)
    if _tma_rows(v, 'v', shape, dev) != kv_rs:
        raise ValueError('k and v must share one row stride')
    qv_rs = _tma_rows(q_v, 'q_v', shape, dev)
    pos_rs = _tma_rows(pos, 'pos', (T, H, dk), dev)
    kernels.require(mask, 'mask', torch.bool, dev, (B, T))
    out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    kernels.launch('ppgs_rel_attention', q_u.data_ptr(), q_rs, k.data_ptr(),
                   v.data_ptr(), kv_rs, q_v.data_ptr(), qv_rs,
                   pos.data_ptr(), pos_rs, mask.data_ptr(), out.data_ptr(),
                   H * dk, B, T, H, dk, LOG2E / math.sqrt(dk), device=dev)
    rel_attention.launches += 1
    return out


rel_attention.launches = 0


###############################################################################
# Training: attention with dropout, forward and backward (B5)
###############################################################################
#
# Counterpart of ppgs_tpu/ops/flash_attention.py flash_attention_train: the
# forward saves (o, lse), the backward recomputes the probabilities from
# lse and regenerates the dropout mask (ops/dropout.py), so no (T, T) tensor
# is kept between the passes; the kernels keep the forward's dropout bits
# for the backward (16.8 MB a layer at 256 x 512), the plain versions draw
# them again. Three kernels, each with its plain version below:
# attention_train_fwd and row_dot (d_row = rowsum(dO * O) per head) in
# kernels/csrc/attention_train.cu, and attention_train_bwd (a dq pass and a
# dk/dv pass on wgmma + TMA) in kernels/csrc/attention_train_bwd.cu. The
# JAX kernel pads T to a multiple of 8; these take any T. ``lse`` is in
# log2 units (m + log2(l) of the log2-scaled scores).


def _heads_first(t, heads):
    B, T, C = t.shape
    return t.reshape(B, T, heads, C // heads).transpose(1, 2).float()


def _heads_last(t):
    B, H, T, D = t.shape
    return t.transpose(1, 2).reshape(B, T, H * D)


def _valid(mask, T, causal):
    valid = mask.bool()[:, None, None, :]
    if causal:
        valid = valid & torch.ones(T, T, dtype=torch.bool,
                                   device=mask.device).tril()
    return valid


def attention_train_fwd_reference(q, k, v, mask, heads, scale_log2, causal,
                                  drop, want_f32=False):
    """Plain version of ``attention_train_fwd`` (q's dtype is the compute
    dtype). Its keep words are None: the plain backward draws the keep
    bits from ``drop`` itself."""
    B, T, C = q.shape
    cd = q.dtype
    q4, k4, v4 = (_heads_first(t, heads) for t in (q, k, v))
    valid = _valid(mask, T, causal)
    s = ((q4 @ k4.transpose(-1, -2)) * scale_log2).masked_fill(~valid,
                                                                NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    l = torch.exp2(s - m).masked_fill(~valid, 0.0).sum(dim=-1, keepdim=True)
    live = l > 0
    lse = torch.where(live, m + torch.log2(torch.where(live, l, 1.0)),
                      torch.zeros_like(l))
    pd = torch.exp2(s - lse).masked_fill(~valid, 0.0)
    if drop.on:
        pd = torch.where(drop.keep(pd.shape, q.device), pd * drop.scale,
                         torch.zeros_like(pd))
    o32 = _heads_last(pd.to(cd).float() @ v4)
    return o32.to(cd), (o32 if want_f32 else None), lse[..., 0], None


def keep_words_shape(B, heads, T):
    """The shape of the keep words that ``attention_train_fwd`` hands the
    backward: 2 ceil(T / 64) int32 words per query row, bit k of word w
    for key 32 w + k."""
    return (B, heads, T, 2 * ((T + 63) // 64))


def keep_words_reference(drop, B, heads, T, device=None):
    """Plain version of the keep words: ``drop.keep`` of the (B, heads, T,
    T) probabilities packed as ``keep_words_shape`` says, the bits past T
    0. The kernel's words hold the bits of the valid pairs only (key
    valid, not above the causal diagonal) and 0 elsewhere."""
    shape = keep_words_shape(B, heads, T)
    bits = torch.zeros((*shape[:3], shape[3] * 32), dtype=torch.int64,
                       device=device)
    bits[..., :T] = drop.keep((B, heads, T, T), device).long()
    words = (bits.view(*shape, 32)
             << torch.arange(32, device=device)).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def train_d_head(C, heads):
    """The head width of (B, T, C) train operands with ``heads`` heads;
    raise ValueError unless the train kernels take it
    (``train_d_head_ok``)."""
    d = C // heads
    if C != heads * d or not train_d_head_ok(d):
        raise ValueError(f'attention train kernels take d_head % 128 == 0 '
                         f'up to {MAX_D_HEAD}; got C={C} with {heads} heads')
    return d


def _attention_views(q, k, v, heads, dtype):
    """Check q, k, v (B, T, H*d) views of one row layout, d taken by
    ``train_d_head_ok``, and return their row stride."""
    B, T, C = q.shape
    train_d_head(C, heads)
    dev = q.device
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f'{name}: expected {dtype} on {dev}, got '
                             f'{t.dtype} on {t.device}')
        if tuple(t.shape) != (B, T, C):
            raise ValueError(f'{name}: expected shape {(B, T, C)}, got '
                             f'{tuple(t.shape)}')
    rs = _row_stride(q, T)
    if _row_stride(k, T) != rs or _row_stride(v, T) != rs:
        raise ValueError('q, k and v must share one row stride')
    return rs


def _train_fwd_args(q, k, v, mask, heads):
    """Check ``attention_train_fwd``'s operands and return the row stride of
    q, k and v; raise ValueError on what the kernel does not take, before
    anything is launched: a d_head that ``train_d_head_ok`` refuses, q, k
    or v not bf16 of q's shape and device, views its TMA maps cannot read
    in place (``_row_stride``) or of different row strides, a mask that is
    not a contiguous (B, T) bool, T past ``TRAIN_MAX_T``."""
    B, T, C = q.shape
    rs = _attention_views(q, k, v, heads, torch.bfloat16)
    kernels.require(mask, 'mask', torch.bool, q.device, (B, T))
    if T > TRAIN_MAX_T:
        raise ValueError(f'attention_train_fwd kernel takes T <= '
                         f'{TRAIN_MAX_T}; got T={T}')
    return rs


def attention_train_fwd(q, k, v, mask, heads, scale_log2, causal, drop,
                        want_f32=False):
    """Attention with dropout on the normalised probabilities
    (``kernels/csrc/attention_train.cu``): q, k, v (B, T, H*d) bf16 views,
    d % 128 == 0 up to ``MAX_D_HEAD``, T <= ``TRAIN_MAX_T``, mask (B, T)
    bool, ``drop`` the probabilities' Drop. Returns (o bf16, o fp32 or
    None, lse (B, H, T) fp32, the keep words for the backward
    (``keep_words_shape`` int32) or None when the dropout is off)."""
    if q.device.type == 'cpu':
        return attention_train_fwd_reference(q, k, v, mask, heads,
                                             scale_log2, causal, drop,
                                             want_f32)
    B, T, C = q.shape
    dev = q.device
    rs = _train_fwd_args(q, k, v, mask, heads)
    out = torch.empty((B, T, C), dtype=torch.bfloat16, device=dev)
    out32 = (torch.empty((B, T, C), dtype=torch.float32, device=dev)
             if want_f32 else None)
    lse = torch.empty((B, heads, T), dtype=torch.float32, device=dev)
    keep = (torch.empty(keep_words_shape(B, heads, T), dtype=torch.int32,
                        device=dev) if drop.on else None)
    kernels.launch('ppgs_attention_train_fwd', q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), rs, mask.data_ptr(), out.data_ptr(),
                   kernels.ptr(out32), C, lse.data_ptr(), kernels.ptr(keep),
                   B, T, heads, C // heads, float(scale_log2), int(causal),
                   *drop.c_args(), device=dev)
    attention_train_fwd.launches += 1
    return out, out32, lse, keep


attention_train_fwd.launches = 0


def row_dot_reference(x, y, heads):
    """Plain version of ``row_dot``."""
    B, T, C = x.shape
    prod = x.float() * y.float()
    return prod.reshape(B, T, heads, C // heads).sum(dim=-1).transpose(1, 2)


def row_dot(x, y, heads):
    """Per-head row sums of x * y over (B, T, H*d) views of one dtype (fp32
    or bf16), d % 128 == 0 up to ``MAX_D_HEAD`` -> (B, H, T) fp32: the
    backward's d_row."""
    if x.device.type == 'cpu':
        return row_dot_reference(x, y, heads)
    B, T, C = x.shape
    d = train_d_head(C, heads)
    if x.dtype != y.dtype or tuple(y.shape) != (
            B, T, C) or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'row_dot kernel takes two (B, T, H*{d}) views of '
                         f'one dtype, fp32 or bf16')
    ldx, ldy = _row_stride(x, T), _row_stride(y, T)
    out = torch.empty((B, heads, T), dtype=torch.float32, device=x.device)
    kernels.launch('ppgs_row_dot', x.data_ptr(), ldx, y.data_ptr(), ldy,
                   out.data_ptr(), B, T, heads, d,
                   int(x.dtype == torch.float32), device=x.device)
    row_dot.launches += 1
    return out


row_dot.launches = 0


def attention_train_bwd_reference(q, k, v, mask, lse, keep, dout, d_row,
                                  heads, scale_log2, sm_scale, causal, drop,
                                  want_c=True, want32=False):
    """Plain version of ``attention_train_bwd``; it draws the keep bits from
    ``drop`` and leaves ``keep`` unread."""
    B, T, C = q.shape
    cd = q.dtype
    q4, k4, v4, do4 = (_heads_first(t, heads) for t in (q, k, v, dout))
    valid = _valid(mask, T, causal)
    s = (q4 @ k4.transpose(-1, -2)) * scale_log2
    pn = torch.exp2(s - lse[..., None]).masked_fill(~valid, 0.0)
    gp = do4 @ v4.transpose(-1, -2)
    pd = pn
    if drop.on:
        keep = drop.keep(pn.shape, q.device)
        zero = torch.zeros_like(pn)
        gp = torch.where(keep, gp * drop.scale, zero)
        pd = torch.where(keep, pn * drop.scale, zero)
    dsc = (pn * (gp - d_row[..., None]) * sm_scale).to(cd).float()
    dq = dsc @ k4
    dk = dsc.transpose(-1, -2) @ q4
    dv = pd.to(cd).float().transpose(-1, -2) @ do4
    d32 = torch.cat([_heads_last(t) for t in (dq, dk, dv)], dim=-1)
    return (d32.to(cd) if want_c else None), (d32 if want32 else None)


def _train_bwd_args(q, k, v, mask, lse, keep, dout, d_row, heads, drop):
    """Check ``attention_train_bwd``'s operands and return (the row stride
    of q, k and v, dout's); raise ValueError on what the kernel does not
    take, before anything is launched: a d_head that ``train_d_head_ok``
    refuses, q, k, v or dout not bf16 of q's shape and device, views the
    kernel's TMA maps cannot read in place (``_row_stride``), q, k and v of
    different row strides, a mask that is not a contiguous (B, T) bool,
    lse or d_row not contiguous (B, H, T) fp32, with the dropout on keep
    words that are not the forward's contiguous ``keep_words_shape``
    int32."""
    B, T, C = q.shape
    dev = q.device
    rs = _attention_views(q, k, v, heads, torch.bfloat16)
    if dout.dtype != torch.bfloat16 or dout.device != dev:
        raise ValueError(f'dout: expected bfloat16 on {dev}, got '
                         f'{dout.dtype} on {dout.device}')
    if tuple(dout.shape) != (B, T, C):
        raise ValueError(f'dout: expected shape {(B, T, C)}, got '
                         f'{tuple(dout.shape)}')
    do_stride = _row_stride(dout, T)
    kernels.require(mask, 'mask', torch.bool, dev, (B, T))
    kernels.require(lse, 'lse', torch.float32, dev, (B, heads, T))
    kernels.require(d_row, 'd_row', torch.float32, dev, (B, heads, T))
    if drop.on:
        if keep is None:
            raise ValueError('keep: the forward\'s keep words are needed '
                             'with the dropout on')
        kernels.require(keep, 'keep', torch.int32, dev,
                        keep_words_shape(B, heads, T))
    return rs, do_stride


def attention_train_bwd(q, k, v, mask, lse, keep, dout, d_row, heads,
                        scale_log2, sm_scale, causal, drop, want_c=True,
                        want32=False):
    """The backward of ``attention_train_fwd`` given its lse and keep words,
    dout (B, T, C) bf16 and d_row (B, H, T): returns ([dq | dk | dv] (B, T,
    3C) in bf16 or None, the same in fp32 or None). On the card two
    deterministic launches, a dq pass and a dk/dv pass
    (``kernels/csrc/attention_train_bwd.cu``)."""
    if q.device.type == 'cpu':
        return attention_train_bwd_reference(
            q, k, v, mask, lse, keep, dout, d_row, heads, scale_log2,
            sm_scale, causal, drop, want_c, want32)
    B, T, C = q.shape
    dev = q.device
    rs, do_stride = _train_bwd_args(q, k, v, mask, lse, keep, dout, d_row,
                                    heads, drop)
    d16 = (torch.empty((B, T, 3 * C), dtype=torch.bfloat16, device=dev)
           if want_c else None)
    d32 = (torch.empty((B, T, 3 * C), dtype=torch.float32, device=dev)
           if want32 else None)

    def at(t, i):
        return None if t is None else t.data_ptr() + i * C * t.element_size()

    kernels.launch('ppgs_attention_train_bwd', q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), rs, mask.data_ptr(), lse.data_ptr(),
                   kernels.ptr(keep if drop.on else None), dout.data_ptr(),
                   do_stride, d_row.data_ptr(), at(d16, 0), at(d32, 0),
                   at(d16, 1), at(d32, 1), at(d16, 2), at(d32, 2), 3 * C, B,
                   T, heads, C // heads, float(scale_log2), float(sm_scale),
                   int(causal),
                   float(drop.scale), device=dev)
    attention_train_bwd.launches += 1
    return d16, d32


attention_train_bwd.launches = 0

# The three steps, as kernels (plain versions on CPU tensors) or plain
TRAIN_KERNELS = (attention_train_fwd, row_dot, attention_train_bwd)
TRAIN_PLAIN = (attention_train_fwd_reference, row_dot_reference,
               attention_train_bwd_reference)


class _FlashTrain(torch.autograd.Function):
    """q, k, v -> o with the forward saving (o, lse) and the backward
    recomputing the probabilities (the JAX custom_vjp's rules)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, heads, drop, causal, ops):
        scale_log2 = LOG2E / math.sqrt(q.shape[-1] // heads)
        o, _, lse, keep = ops[0](q, k, v, mask, heads, scale_log2, causal,
                                 drop)
        ctx.save_for_backward(q, k, v, mask, o, lse, keep)
        ctx.cfg = (heads, drop, causal, ops)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse, keep = ctx.saved_tensors
        heads, drop, causal, ops = ctx.cfg
        C = q.shape[-1]
        sm_scale = 1.0 / math.sqrt(C // heads)
        do = do.contiguous()
        d_row = ops[1](do, o, heads)
        d, _ = ops[2](q, k, v, mask, lse, keep, do, d_row, heads,
                      LOG2E * sm_scale, sm_scale, causal, drop)
        return (d[..., :C], d[..., C:2 * C], d[..., 2 * C:], None, None,
                None, None, None)


def flash_attention_train(q, k, v, mask, num_heads, dropout_rate=0.0,
                          seed=0, causal=False, site=1):
    """Differentiable masked multi-head attention with dropout on the
    normalised probabilities (``ppgs_tpu/ops/flash_attention.py::
    flash_attention_train``): q, k, v (B, T, C) in the compute dtype (views
    of one buffer are fine), mask (B, T) bool, True = valid key. The mask
    is drawn from the Philox stream of (seed, site). Fully masked query
    rows give 0 and 0 gradient."""
    drop = dropout.Drop(seed, site, float(dropout_rate))
    return _FlashTrain.apply(q, k, v, mask, num_heads, drop, causal,
                             TRAIN_KERNELS)


def flash_attention_train_reference(q, k, v, mask, num_heads,
                                    dropout_rate=0.0, seed=0, causal=False,
                                    site=1):
    """Plain version of ``flash_attention_train`` on any device."""
    drop = dropout.Drop(seed, site, float(dropout_rate))
    return _FlashTrain.apply(q, k, v, mask, num_heads, drop, causal,
                             TRAIN_PLAIN)
