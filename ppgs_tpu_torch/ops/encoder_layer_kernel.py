"""The post-LN encoder stack for inference, as a chain of CUDA kernels.

Counterpart of ``ppgs_tpu/ops/encoder_layer_kernel.py::encoder_stack``,
which runs all layers in ONE Pallas kernel with every layer's weights
resident in VMEM (~13 MB for the mel model), and of its
``encoder_stack_streamed``, which runs wav2vec2's 12 GELU layers over a
(batch block, layer) grid with each layer's weights streamed through VMEM
and the fp32 residual kept there. A Hopper block has 227 KB of shared
memory, so on the card both are the same chain: each layer is four
kernels, and the fp32 residual goes through device memory between them:

    K1 qkv_proj              qkv = bf16(bf16(x) @ Wqkv + bqkv)       (here)
    K2 attention             a   = softmax(mask(q k^T)) v per head
                             (ops/flash_attention.py; d_head 16, 32, 64,
                             or d_head % 128 == 0 up to 2048)
    K3 out_proj_residual_ln  r   = LN1(x + a @ Wo + bo)              (here;
                             with dropout and saved LN statistics it is
                             also the training layer's,
                             ops/encoder_layer_train.py)
    K4 ffn_residual_ln       x   = LN2(r + act(r @ W1 + b1) @ W2 + b2)
                             (ops/fused_ffn.py; ReLU or tanh-GELU)

K1, K3 and K4 take every width of the JAX kernels' rule up to 2048
(``width_ok``: C % 128 == 0, 128 <= C <= ``MAX_WIDTH``), K3 and K4 in their
train forms too, and their C entry points check the same rule.

As in ``encoder_stack_streamed``, the input is widened to fp32 once, the
residual stays fp32 across all layers, and the caller rounds the output
to its dtype; the TPU's ``block_b`` and VMEM budget are its tiling and
have no counterpart here.

As in the TPU kernel, the softmax scale times log2(e) is folded into the q
third of the fused QKV weight and bias (once, by ``convert.prepare`` when
the model is loaded), the residual and the LayerNorm
statistics are fp32, the operands bf16 and the accumulation fp32. On CPU
tensors every step runs its plain PyTorch version; on CUDA tensors every
step launches its kernel or raises. ``encoder_stack_reference`` is the
same chain through the plain versions on any device.
"""

import collections

import torch

from .. import kernels
from . import dropout
from .flash_attention import attention, attention_reference
from .fused_ffn import (MAX_WIDTH, ffn_residual_ln,
                        ffn_residual_ln_reference, layer_norm, matmul,
                        width_ok)

MAX_SEQ = 1024      # windows up to this length take the stack (as on the TPU)


def qkv_proj_reference(x, wqkv, bqkv):
    """Plain version of ``qkv_proj``; wqkv's dtype is the compute dtype."""
    cd = wqkv.dtype
    return matmul(x.to(cd), wqkv).to(cd) + bqkv.to(cd)


def qkv_proj_args(x, wqkv, bqkv):
    """Check K1's operands and return its row count; raise ValueError on
    what the kernel does not take, before anything is launched: wqkv not
    (K, 3K) with K under the width rule (``width_ok``), x not fp32 with
    last dim K, wqkv not bf16, bqkv not fp32 of shape (N,), any of them on
    another device than x or not contiguous, or one not 16-byte aligned
    (TMA and the kernel's 16-byte loads)."""
    if (wqkv.dim() != 2 or wqkv.shape[1] != 3 * wqkv.shape[0]
            or not width_ok(wqkv.shape[0])):
        raise ValueError(f'qkv_proj kernel takes wqkv (K, 3K) with K % 128 '
                         f'== 0, 128 <= K <= {MAX_WIDTH}; got '
                         f'{tuple(wqkv.shape)}')
    K, N = wqkv.shape
    dev = x.device
    kernels.require(x, 'x', torch.float32, dev)
    if x.shape[-1] != K:
        raise ValueError(f'x: expected last dim {K}, got {x.shape[-1]}')
    kernels.require(wqkv, 'wqkv', torch.bfloat16, dev)
    kernels.require(bqkv, 'bqkv', torch.float32, dev, (N,))
    for name, t in (('x', x), ('wqkv', wqkv), ('bqkv', bqkv)):
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: expected a 16-byte aligned tensor')
    return x.numel() // K


def qkv_proj(x, wqkv, bqkv):
    """K1 (``kernels/csrc/qkv_proj.cu``): x (..., K) fp32, wqkv (K, 3K)
    bf16, bqkv (3K,) fp32 -> (..., 3K) bf16, K under ``width_ok``.
    ``qkv_proj.widths`` counts the launches per K."""
    if x.device.type == 'cpu':
        return qkv_proj_reference(x, wqkv, bqkv)
    M = qkv_proj_args(x, wqkv, bqkv)
    K, N = wqkv.shape
    dev = x.device
    out = torch.empty(x.shape[:-1] + (N,), dtype=torch.bfloat16, device=dev)
    kernels.launch('ppgs_qkv_proj', x.data_ptr(), wqkv.data_ptr(),
                   bqkv.data_ptr(), out.data_ptr(), M, K, N, device=dev)
    qkv_proj.launches += 1
    qkv_proj.widths[K] += 1
    return out


qkv_proj.launches = 0
qkv_proj.widths = collections.Counter()


def out_proj_residual_ln_reference(a, wo, bo, x, scale, bias):
    """Plain version of ``out_proj_residual_ln``."""
    return layer_norm(x.float() + matmul(a, wo) + bo.float(),
                      scale.float(), bias.float())


def out_proj_ln_args(a, wo, bo, x, gamma, beta):
    """Check K3's operands and return its row count; raise ValueError on
    what the kernel does not take, before anything is launched, in either
    form: a C not under the width rule (``width_ok``), a not bf16 with last
    dim C, x not fp32 of a's shape, wo not bf16 (C, C), bo, gamma or beta
    not fp32 (C,), any of them on another device than a or not contiguous,
    or one not 16-byte aligned (TMA and the kernel's vector loads)."""
    C = wo.shape[0] if wo.dim() == 2 else 0
    if not width_ok(C):
        raise ValueError(f'out_proj_ln kernel takes C % 128 == 0, 128 <= C '
                         f'<= {MAX_WIDTH}; got wo {tuple(wo.shape)}')
    dev = a.device
    kernels.require(a, 'a', torch.bfloat16, dev)
    if a.shape[-1] != C:
        raise ValueError(f'a: expected last dim {C}, got {a.shape[-1]}')
    kernels.require(x, 'x', torch.float32, dev, a.shape)
    kernels.require(wo, 'wo', torch.bfloat16, dev, (C, C))
    for name, t in (('bo', bo), ('gamma', gamma), ('beta', beta)):
        kernels.require(t, name, torch.float32, dev, (C,))
    for name, t in (('a', a), ('wo', wo), ('bo', bo), ('x', x),
                    ('gamma', gamma), ('beta', beta)):
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: expected a 16-byte aligned tensor')
    return a.numel() // C


def out_proj_ln_plan(M, C):
    """K3's launch plan: (its width C, blocks of a cluster (ceil(C / 256),
    each a 256-column slice of the rows, the last 128 columns where C % 256
    == 128), row tiles of 128, clusters in the grid: one a tile)."""
    tiles = -(-M // 128)
    return C, -(-C // 256), tiles, tiles


def launch_out_proj_ln(a, wo, bo, x, gamma, beta, drop=dropout.OFF,
                       stats=False):
    """Check the operands (``out_proj_ln_args``) and launch K3
    (``kernels/csrc/out_proj_ln.cu``) on its plan (``out_proj_ln_plan``):
    LN1(x + drop(a @ wo + bo)) with a (..., C) bf16, x (..., C) fp32 on
    the card, ``drop`` a ``dropout.Drop``. Returns (out fp32, and with
    ``stats`` the normalised rows and 1/std (M,), else None, None)."""
    M = out_proj_ln_args(a, wo, bo, x, gamma, beta)
    dev = a.device
    C, _, _, clusters = out_proj_ln_plan(M, wo.shape[0])
    out = torch.empty_like(x)
    n = torch.empty_like(x) if stats else None
    rstd = (torch.empty(M, dtype=torch.float32, device=dev) if stats
            else None)
    kernels.launch('ppgs_out_proj_ln', a.data_ptr(), wo.data_ptr(),
                   bo.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                   beta.data_ptr(), out.data_ptr(), kernels.ptr(n),
                   kernels.ptr(rstd), M, C, clusters, *drop.c_args(),
                   device=dev)
    return out, n, rstd


def out_proj_residual_ln(a, wo, bo, x, scale, bias):
    """K3 (``kernels/csrc/out_proj_ln.cu``): LN1(x + a @ wo + bo) with
    a (..., C) bf16, x (..., C) fp32 -> fp32. ``out_proj_residual_ln.
    widths`` counts the launches per C."""
    if a.device.type == 'cpu':
        return out_proj_residual_ln_reference(a, wo, bo, x, scale, bias)
    out, _, _ = launch_out_proj_ln(a, wo, bo, x, scale, bias)
    out_proj_residual_ln.launches += 1
    out_proj_residual_ln.widths[wo.shape[0]] += 1
    return out


out_proj_residual_ln.launches = 0
out_proj_residual_ln.widths = collections.Counter()


def _stack(x, mask, layers, heads, compute_dtype, causal, activation, ops):
    qkv_fn, attention_fn, out_proj_fn, ffn_fn = ops
    C = x.shape[-1]
    x = x.float().contiguous()
    mask = mask.bool().contiguous()
    for layer in layers:
        # The weights convert.prepare made for this stack when the model
        # was loaded: the scale-folded QKV, the other matrices in the
        # compute dtype; the vectors are the fp32 parameters
        p = layer.prepared
        if p.wqkv_folded.dtype != compute_dtype:
            raise ValueError(
                f'the layers were prepared for {p.wqkv_folded.dtype}, not '
                f'{compute_dtype}: load the model with that compute dtype')
        ffn, n1, n2 = layer.ffn, layer.norm1, layer.norm2
        qkv = qkv_fn(x, p.wqkv_folded, p.bqkv_folded)
        a = attention_fn(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:],
                         mask, heads, 1.0, causal)
        r = out_proj_fn(a, p.wo, layer.attn.bo, x, n1.scale, n1.bias)
        x = ffn_fn(r, p.w1, ffn.b1, p.w2, ffn.b2, n2.scale, n2.bias,
                   activation=activation)
    return x


@torch.no_grad()
def encoder_stack(x, mask, layers, heads, compute_dtype=torch.bfloat16,
                  causal=False, activation='relu'):
    """The post-LN encoder stack on (B, T, C) activations -> fp32 (B, T, C).

    layers: encoder layers (``models.transformer.EncoderLayer``, which the
    PPG transformer and the wav2vec2 trunk both use), with the ``prepared``
    weights of ``convert.prepare_layers`` for ``compute_dtype``. mask:
    (B, T), True = valid key. ``activation``: the FFN's, 'relu' (the PPG
    transformer) or 'gelu' (wav2vec2: ``encoder_stack_streamed``'s
    ``activation='gelu'``). On the card the kernels take bf16 only, at
    any C % 128 == 0 from 128 to 2048 (``width_ok``) with ReLU or GELU and
    the head widths K2 takes (``flash_attention.d_head_ok``: 16, 32, 64,
    or d_head % 128 == 0 up to 2048); they raise on anything else."""
    return _stack(x, mask, layers, heads, compute_dtype, causal, activation,
                  (qkv_proj, attention, out_proj_residual_ln,
                   ffn_residual_ln))


@torch.no_grad()
def encoder_stack_reference(x, mask, layers, heads,
                            compute_dtype=torch.bfloat16, causal=False,
                            activation='relu'):
    """Plain version of ``encoder_stack`` on any device and compute dtype."""
    return _stack(x, mask, layers, heads, compute_dtype, causal, activation,
                  (qkv_proj_reference, attention_reference,
                   out_proj_residual_ln_reference,
                   ffn_residual_ln_reference))
