"""One post-LN encoder layer for training, forward and backward (B4).

Counterpart of ``ppgs_tpu/ops/encoder_layer_train.py::encoder_layer_train``:

    a   = attention(x Wq, x Wk, x Wv)  with dropout on the probabilities
    od  = dropout(a @ Wo + bo)
    r   = LN1(x + od)
    hd  = dropout(relu(r @ W1 + b1))
    yd  = dropout(hd @ W2 + b2)
    out = LN2(r + yd)

The TPU kernel runs the layer as one Pallas kernel each way and recomputes
the whole forward in its backward, so that nothing but x and out reaches
HBM. A Hopper block has 227 KB of shared memory, not VMEM's megabytes, so
on the card the layer is a chain of kernels, and the (M, C)-sized
activations are saved between the passes (well under 1 GB a layer at
256 x 512 frames); only what is T x T (the probabilities) or M x F (the
FFN hidden) is recomputed:

    forward   qkv_proj (K1, unfolded weights), attention_train_fwd,
              out_proj_ln_train (K3 with its dropout site),
              ffn_train_fwd (K4 with its two dropout sites and LN2)
    backward  ln_dropout_bwd (LN2, keep_y), ffn_train_bwd, gemm (dW1,
              dW2), ln_dropout_bwd (LN1, keep_sa), gemm (da, dWo), row_dot,
              attention_train_bwd, gemm (dx, dWqkv), colsum for every sum
              over rows

The rounding points are the TPU kernel's (bf16 operands, fp32
accumulation, residual and LayerNorm statistics): qkv = bf16(dot) +
bf16(b); the hidden is dropped in bf16; the backward rounds each
cotangent to bf16 before its products, takes d_row = rowsum(da * a) from
the fp32 a, and returns the four matrix gradients rounded to bf16 (the
JAX rule casts them to the operand dtype) and the vector gradients in
fp32. Dropout masks come from the Philox stream (ops/dropout.py) at the
layer's four sites, the same as the per-layer path's.

``encoder_layer_train`` chains the kernel wrappers (each runs its plain
version on CPU tensors); ``encoder_layer_train_reference`` chains the
plain versions on any device. The backward is the JAX kernel's
hand-written rule in both, so the two differ only in each kernel's sums.
"""

import math

import torch

from . import backward, dropout
from . import flash_attention as fa
from . import fused_ffn
from .encoder_layer_kernel import (launch_out_proj_ln, qkv_proj,
                                   qkv_proj_reference)

MAX_T = 1024        # the whole-layer path's longest window (as on the TPU)


def out_proj_ln_train_reference(a, wo, bo, x, gamma, beta, drop):
    """Plain version of ``out_proj_ln_train``."""
    C = x.shape[-1]
    o1 = fused_ffn.matmul(a.reshape(-1, C), wo) + bo.float()
    if drop.on:
        o1 = torch.where(drop.keep(o1.shape, x.device), o1 * drop.scale,
                         torch.zeros_like(o1))
    z = x.reshape(-1, C).float() + o1
    zc = z - z.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((zc * zc).mean(dim=-1, keepdim=True)
                       + fused_ffn.LN_EPS)
    n = zc * rstd
    out = n * gamma + beta
    return out.reshape(x.shape), n.reshape(x.shape), rstd[:, 0]


def out_proj_ln_train(a, wo, bo, x, gamma, beta, drop):
    """r = LN1(x + drop(a @ wo + bo)) (K3, ``kernels/csrc/out_proj_ln.cu``,
    with its dropout site): a (..., 256) bf16, x (..., 256) fp32, ``drop``
    the attention output's Drop. Returns (r, the normalised rows, 1/std
    (M,)), fp32."""
    if a.device.type == 'cpu':
        return out_proj_ln_train_reference(a, wo, bo, x, gamma, beta, drop)
    result = launch_out_proj_ln(a, wo, bo, x, gamma, beta, drop, stats=True)
    out_proj_ln_train.launches += 1
    return result


out_proj_ln_train.launches = 0

# The chain's steps: kernel wrappers, or plain versions
KERNELS = dict(
    qkv=qkv_proj, attn_fwd=fa.attention_train_fwd,
    out_ln=out_proj_ln_train, ffn_fwd=fused_ffn.ffn_train_fwd,
    ln_bwd=backward.ln_dropout_bwd, ffn_bwd=fused_ffn.ffn_train_bwd,
    gemm=backward.gemm, colsum=backward.colsum, row_dot=fa.row_dot,
    attn_bwd=fa.attention_train_bwd)
PLAIN = dict(
    qkv=qkv_proj_reference, attn_fwd=fa.attention_train_fwd_reference,
    out_ln=out_proj_ln_train_reference,
    ffn_fwd=fused_ffn.ffn_train_fwd_reference,
    ln_bwd=backward.ln_dropout_bwd_reference,
    ffn_bwd=fused_ffn.ffn_train_bwd_reference,
    gemm=backward.gemm_reference, colsum=backward.colsum_reference,
    row_dot=fa.row_dot_reference, attn_bwd=fa.attention_train_bwd_reference)


class _LayerTrain(torch.autograd.Function):
    """The layer's forward chain, and the TPU kernel's backward rule as a
    chain."""

    @staticmethod
    def forward(ctx, x, mask, wqkv, bqkv, wo, bo, g1, be1, w1, b1, w2, b2,
                g2, be2, cfg):
        heads, causal, cd, drop, ops = cfg
        C = x.shape[-1]
        x = x.float().contiguous()
        wqkv_c, wo_c, w1_c, w2_c = (w.to(cd).contiguous()
                                    for w in (wqkv, wo, w1, w2))
        qkv = ops['qkv'](x, wqkv_c, bqkv)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        a16, a32, lse, keep = ops['attn_fwd'](
            q, k, v, mask, heads, fa.LOG2E / math.sqrt(C // heads), causal,
            drop, want_f32=True)
        r, n1, s1 = ops['out_ln'](a16, wo_c, bo, x, g1, be1,
                                  drop.at(drop.site + 1))
        out, n2, s2 = ops['ffn_fwd'](r, w1_c, b1, w2_c, b2,
                                     drop.at(drop.site + 2),
                                     drop.at(drop.site + 3), ln=(g2, be2))
        ctx.save_for_backward(x, mask, qkv, a16, a32, lse, keep, r, n1, s1,
                              n2, s2, wqkv_c, wo_c, w1_c, w2_c, b1, g1, g2)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g):
        (x, mask, qkv, a16, a32, lse, keep, r, n1, s1, n2, s2, wqkv_c, wo_c,
         w1_c, w2_c, b1, g1, g2) = ctx.saved_tensors
        heads, causal, cd, drop, ops = ctx.cfg
        B, T, C = x.shape
        M = B * T
        gemm, colsum = ops['gemm'], ops['colsum']

        def weight_grad(a, b):
            return backward.weight_grad(a.reshape(M, -1), b.reshape(M, -1),
                                        cd, gemm, colsum)

        # LN2 backward, then keep_y: dy0 (rounded for the products)
        dz2, dy0c, part = ops['ln_bwd'](g.float().contiguous(), n2, s2, g2,
                                        drop.at(drop.site + 3), cd)
        dg2, dbe2, db2 = colsum(part).reshape(3, C)
        # FFN backward, recomputing the hidden: dr = dz2 + bf16(dh) W1^T
        dr, hd, dh, db1_part = ops['ffn_bwd'](
            r, dy0c, w1_c, b1, w2_c, drop.at(drop.site + 2), residual=dz2)
        db1 = colsum(db1_part)
        dw1 = weight_grad(r, dh)
        dw2 = weight_grad(hd, dy0c)
        # LN1 backward, then keep_sa: do1 (rounded for the products)
        dz1, do1c, part = ops['ln_bwd'](dr, n1, s1, g1,
                                        drop.at(drop.site + 1), cd)
        dg1, dbe1, dbo = colsum(part).reshape(3, C)
        # Output projection: da = do1 Wo^T (fp32 for d_row, bf16 for the
        # attention backward's products)
        da32, da16 = gemm(do1c.reshape(M, C), wo_c, False, True, cd,
                          want16=True)
        dwo = weight_grad(a16, do1c)
        d_row = ops['row_dot'](da32.reshape(B, T, C), a32, heads)
        sm_scale = 1.0 / math.sqrt(C // heads)
        q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
        dqkv_c, dqkv32 = ops['attn_bwd'](
            q, k, v, mask, lse, keep, da16.reshape(B, T, C), d_row, heads,
            fa.LOG2E * sm_scale, sm_scale, causal, drop, want32=True)
        dbqkv = colsum(dqkv32.reshape(M, 3 * C))
        dx, _ = gemm(dqkv_c.reshape(M, 3 * C), wqkv_c, False, True, cd,
                     residual=dz1.reshape(M, C))
        dwqkv = weight_grad(x, dqkv_c)
        return (dx.reshape(B, T, C), None, dwqkv, dbqkv, dwo, dbo, dg1, dbe1,
                dw1, db1, dw2, db2, dg2, dbe2, None)


def _layer(x, mask, layer, heads, dropout_rate, seed, causal, site,
           compute_dtype, ops):
    a, f, n1, n2 = layer.attn, layer.ffn, layer.norm1, layer.norm2
    drop = dropout.Drop(seed, site, float(dropout_rate))
    cfg = (heads, bool(causal), compute_dtype, drop, ops)
    return _LayerTrain.apply(x, mask.bool().contiguous(), a.wqkv, a.bqkv,
                             a.wo, a.bo, n1.scale, n1.bias, f.w1, f.b1, f.w2,
                             f.b2, n2.scale, n2.bias, cfg)


def encoder_layer_train(x, mask, layer, heads, dropout_rate=0.0, seed=0,
                        causal=False, site=1, compute_dtype=torch.bfloat16):
    """Differentiable post-LN encoder layer on (B, T, C) fp32 x -> fp32.

    layer: the model's ``models.transformer.EncoderLayer``; its fp32
    parameters are cast to ``compute_dtype`` here, every call, so an
    optimizer step is seen at once (the model's ``prepared`` buffers are
    not read). mask: (B, T), True = valid key. The dropout sites are
    ``site`` .. ``site + 3`` of the Philox stream of ``seed``. On the card
    the kernels take bf16 with C = 256 and d_head = 128 and raise on
    anything else."""
    return _layer(x, mask, layer, heads, dropout_rate, seed, causal, site,
                  compute_dtype, KERNELS)


def encoder_layer_train_reference(x, mask, layer, heads, dropout_rate=0.0,
                                  seed=0, causal=False, site=1,
                                  compute_dtype=torch.bfloat16):
    """Plain version of ``encoder_layer_train`` on any device and compute
    dtype."""
    return _layer(x, mask, layer, heads, dropout_rate, seed, causal, site,
                  compute_dtype, PLAIN)
