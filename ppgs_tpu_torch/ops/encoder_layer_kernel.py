"""The post-LN encoder stack for inference, as a chain of CUDA kernels.

Counterpart of ``ppgs_tpu/ops/encoder_layer_kernel.py::encoder_stack``,
which runs all layers in ONE Pallas kernel with every layer's weights
resident in VMEM (~13 MB for the mel model). A Hopper block has 227 KB of
shared memory, so on the card each layer is four kernels, and the fp32
residual goes through device memory between them:

    K1 qkv_proj              qkv = bf16(bf16(x) @ Wqkv + bqkv)       (here)
    K2 attention             a   = softmax(mask(q k^T)) v per head
                             (ops/flash_attention.py)
    K3 out_proj_residual_ln  r   = LN1(x + a @ Wo + bo)              (here)
    K4 ffn_residual_ln       x   = LN2(r + relu(r @ W1 + b1) @ W2 + b2)
                             (ops/fused_ffn.py)

As in the TPU kernel, the softmax scale times log2(e) is folded into the q
third of the fused QKV weight and bias (once, by ``convert.prepare`` when
the model is loaded), the residual and the LayerNorm
statistics are fp32, the operands bf16 and the accumulation fp32. On CPU
tensors every step runs its plain PyTorch version; on CUDA tensors every
step launches its kernel or raises. ``encoder_stack_reference`` is the
same chain through the plain versions on any device.
"""

import torch

from .. import kernels
from .flash_attention import attention, attention_reference
from .fused_ffn import (ffn_residual_ln, ffn_residual_ln_reference,
                        layer_norm, matmul)

MAX_SEQ = 1024      # windows up to this length take the stack (as on the TPU)


def qkv_proj_reference(x, wqkv, bqkv):
    """Plain version of ``qkv_proj``; wqkv's dtype is the compute dtype."""
    cd = wqkv.dtype
    return matmul(x.to(cd), wqkv).to(cd) + bqkv.to(cd)


def qkv_proj(x, wqkv, bqkv):
    """K1 (``kernels/csrc/qkv_proj.cu``): x (..., C) fp32, wqkv (C, 3C)
    bf16, bqkv (3C,) fp32 -> (..., 3C) bf16."""
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
    return out


qkv_proj.launches = 0


def out_proj_residual_ln_reference(a, wo, bo, x, scale, bias):
    """Plain version of ``out_proj_residual_ln``."""
    return layer_norm(x.float() + matmul(a, wo) + bo.float(),
                      scale.float(), bias.float())


def out_proj_residual_ln(a, wo, bo, x, scale, bias):
    """K3 (``kernels/csrc/out_proj_ln.cu``): LN1(x + a @ wo + bo) with
    a (..., 256) bf16, x (..., 256) fp32 -> fp32."""
    if a.device.type == 'cpu':
        return out_proj_residual_ln_reference(a, wo, bo, x, scale, bias)
    C = wo.shape[0]
    if C != 256:
        raise ValueError(f'out_proj_ln kernel takes C=256; got {C}')
    dev = a.device
    kernels.require(a, 'a', torch.bfloat16, dev)
    kernels.require(x, 'x', torch.float32, dev, a.shape)
    if a.shape[-1] != C:
        raise ValueError(f'a: expected last dim {C}, got {a.shape[-1]}')
    kernels.require(wo, 'wo', torch.bfloat16, dev, (C, C))
    for name, t in (('bo', bo), ('scale', scale), ('bias', bias)):
        kernels.require(t, name, torch.float32, dev, (C,))
    out = torch.empty_like(x)
    kernels.launch('ppgs_out_proj_ln', a.data_ptr(), wo.data_ptr(),
                   bo.data_ptr(), x.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), out.data_ptr(), a.numel() // C,
                   device=dev)
    out_proj_residual_ln.launches += 1
    return out


out_proj_residual_ln.launches = 0


def _stack(x, mask, layers, heads, compute_dtype, causal, ops):
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
        x = ffn_fn(r, p.w1, ffn.b1, p.w2, ffn.b2, n2.scale, n2.bias)
    return x


@torch.no_grad()
def encoder_stack(x, mask, layers, heads, compute_dtype=torch.bfloat16,
                  causal=False):
    """The post-LN encoder stack on (B, T, C) activations -> fp32 (B, T, C).

    layers: the model's encoder layers (``models.transformer.EncoderLayer``),
    with the ``prepared`` weights of ``convert.prepare`` for
    ``compute_dtype``. mask: (B, T), True = valid key. On the card the
    kernels take bf16 only and C = 256 with d_head = 128; they raise on
    anything else."""
    return _stack(x, mask, layers, heads, compute_dtype, causal,
                  (qkv_proj, attention, out_proj_residual_ln,
                   ffn_residual_ln))


@torch.no_grad()
def encoder_stack_reference(x, mask, layers, heads,
                            compute_dtype=torch.bfloat16, causal=False):
    """Plain version of ``encoder_stack`` on any device and compute dtype."""
    return _stack(x, mask, layers, heads, compute_dtype, causal,
                  (qkv_proj_reference, attention_reference,
                   out_proj_residual_ln_reference,
                   ffn_residual_ln_reference))
