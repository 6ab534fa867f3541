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
                             (ops/flash_attention.py; d_head 64, 128, 256)
    K3 out_proj_residual_ln  r   = LN1(x + a @ Wo + bo)              (here;
                             C = 256, 512, 768; with dropout and saved LN
                             statistics it is also the training layer's,
                             ops/encoder_layer_train.py)
    K4 ffn_residual_ln       x   = LN2(r + act(r @ W1 + b1) @ W2 + b2)
                             (ops/fused_ffn.py; ReLU at C = 256 and 512,
                             tanh-GELU at C = 768)

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
from .fused_ffn import (ffn_residual_ln, ffn_residual_ln_reference,
                        layer_norm, matmul)

MAX_SEQ = 1024      # windows up to this length take the stack (as on the TPU)
OUT_PROJ_WIDTHS = (256, 512, 768)   # K3's instances: mel, w2v2fb, wav2vec2


def qkv_proj_reference(x, wqkv, bqkv):
    """Plain version of ``qkv_proj``; wqkv's dtype is the compute dtype."""
    cd = wqkv.dtype
    return matmul(x.to(cd), wqkv).to(cd) + bqkv.to(cd)


def qkv_proj(x, wqkv, bqkv):
    """K1 (``kernels/csrc/qkv_proj.cu``): x (..., C) fp32, wqkv (C, 3C)
    bf16, bqkv (3C,) fp32 -> (..., 3C) bf16. ``qkv_proj.widths`` counts
    the launches per C."""
    if x.device.type == 'cpu':
        return qkv_proj_reference(x, wqkv, bqkv)
    K, N = wqkv.shape
    if K % 64 or N % 128:
        raise ValueError(f'qkv_proj kernel takes K%64==0, N%128==0; got '
                         f'{(K, N)}')
    dev = x.device
    kernels.require(x, 'x', torch.float32, dev)
    if x.shape[-1] != K:
        raise ValueError(f'x: expected last dim {K}, got {x.shape[-1]}')
    kernels.require(wqkv, 'wqkv', torch.bfloat16, dev)
    kernels.require(bqkv, 'bqkv', torch.float32, dev, (N,))
    out = torch.empty(x.shape[:-1] + (N,), dtype=torch.bfloat16, device=dev)
    kernels.launch('ppgs_qkv_proj', x.data_ptr(), wqkv.data_ptr(),
                   bqkv.data_ptr(), out.data_ptr(), x.numel() // K, K, N,
                   device=dev)
    qkv_proj.launches += 1
    qkv_proj.widths[K] += 1
    return out


qkv_proj.launches = 0
qkv_proj.widths = collections.Counter()


def out_proj_residual_ln_reference(a, wo, bo, x, scale, bias):
    """Plain version of ``out_proj_residual_ln``."""
    return layer_norm(x.float() + matmul(a, wo) + bo.float(),
                      scale.float(), bias.float())


def launch_out_proj_ln(a, wo, bo, x, gamma, beta, drop=dropout.OFF,
                       stats=False):
    """Check the operands and launch K3 (``kernels/csrc/out_proj_ln.cu``):
    LN1(x + drop(a @ wo + bo)) with a (..., C) bf16, x (..., C) fp32 on
    the card, C in ``OUT_PROJ_WIDTHS``, ``drop`` a ``dropout.Drop``.
    Returns (out fp32, and with ``stats`` the normalised rows and 1/std
    (M,), else None, None)."""
    C = wo.shape[0]
    if C not in OUT_PROJ_WIDTHS:
        raise ValueError(f'out_proj_ln kernel takes C in {OUT_PROJ_WIDTHS}; '
                         f'got {C}')
    dev = a.device
    kernels.require(a, 'a', torch.bfloat16, dev)
    kernels.require(x, 'x', torch.float32, dev, a.shape)
    if a.shape[-1] != C:
        raise ValueError(f'a: expected last dim {C}, got {a.shape[-1]}')
    kernels.require(wo, 'wo', torch.bfloat16, dev, (C, C))
    for name, t in (('bo', bo), ('gamma', gamma), ('beta', beta)):
        kernels.require(t, name, torch.float32, dev, (C,))
    M = a.numel() // C
    out = torch.empty_like(x)
    n = torch.empty_like(x) if stats else None
    rstd = (torch.empty(M, dtype=torch.float32, device=dev) if stats
            else None)
    kernels.launch('ppgs_out_proj_ln', a.data_ptr(), wo.data_ptr(),
                   bo.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                   beta.data_ptr(), out.data_ptr(), kernels.ptr(n),
                   kernels.ptr(rstd), M, C, *drop.c_args(), device=dev)
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
    C = 256 or 512 with ReLU (d_head 128 or 256) and C = 768 with GELU
    (d_head 64); they raise on anything else."""
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
