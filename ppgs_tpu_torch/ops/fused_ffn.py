"""Fused FFN + residual + LayerNorm (K4, ``kernels/csrc/ffn_ln.cu``).

    out = LN(res + relu(x @ w1 + b1) @ w2 + b2)

with the (M, F) hidden kept on the SM. One CUDA kernel serves two TPU
kernels that round in one place differently (``round_input``):

- ``round_input=False``: the FFN half of
  ``ppgs_tpu/ops/encoder_layer_kernel.py::_layer_body`` (encoder_stack's
  main path). The hidden is ``relu(bf16(bf16(x@w1) + bf16(b1)))`` and the
  residual is the fp32 x.
- ``round_input=True``: ``ppgs_tpu/ops/fused_ffn.py::_kernel``
  (``ffn_residual_layernorm``, the per-layer path). The hidden is
  ``bf16(relu(x@w1 + b1))`` and the residual is x rounded to bf16.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Bound, design and rounding notes
are in the CUDA source.
"""

import torch

from .. import kernels

LN_EPS = 1e-5


def layer_norm(r, scale, bias):
    """fp32 two-pass LayerNorm, as the JAX kernels compute it."""
    mean = r.mean(dim=-1, keepdim=True)
    var = ((r - mean) ** 2).mean(dim=-1, keepdim=True)
    return (r - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def matmul(a, w):
    """a @ w with the operands in their own dtype and fp32 accumulation:
    bf16 products are exact in fp32, so this is the kernels' arithmetic up
    to the order of the sums."""
    return a.float() @ w.float()


def ffn_residual_ln_reference(x, w1, b1, w2, b2, scale, bias,
                              round_input=False):
    """Plain version of ``ffn_residual_ln`` (any device, any compute dtype:
    the dtype of w1 is the compute dtype)."""
    cd = w1.dtype
    xc = x.to(cd)
    if round_input:
        h = torch.relu(matmul(xc, w1) + b1.float()).to(cd)
        res = xc.float()
    else:
        h = torch.relu(matmul(xc, w1).to(cd) + b1.to(cd))
        res = x.float()
    y = matmul(h, w2)
    return layer_norm(res + y + b2.float(), scale.float(), bias.float())


def ffn_residual_ln(x, w1, b1, w2, b2, scale, bias, round_input=False):
    """K4 on (..., 256) fp32 x; returns fp32 of x's shape."""
    if x.device.type == 'cpu':
        return ffn_residual_ln_reference(x, w1, b1, w2, b2, scale, bias,
                                         round_input)
    C, F = w1.shape
    if C != 256 or F % 128:
        raise ValueError(f'ffn_ln kernel takes C=256, F%128==0; got C={C}, '
                         f'F={F}')
    dev = x.device
    kernels.require(x, 'x', torch.float32, dev)
    if x.shape[-1] != C:
        raise ValueError(f'x: expected last dim {C}, got {x.shape[-1]}')
    kernels.require(w1, 'w1', torch.bfloat16, dev, (C, F))
    kernels.require(w2, 'w2', torch.bfloat16, dev, (F, C))
    kernels.require(b1, 'b1', torch.float32, dev, (F,))
    for name, t in (('b2', b2), ('scale', scale), ('bias', bias)):
        kernels.require(t, name, torch.float32, dev, (C,))
    out = torch.empty_like(x)
    kernels.launch('ppgs_ffn_ln', x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   w2.data_ptr(), b2.data_ptr(), scale.data_ptr(),
                   bias.data_ptr(), out.data_ptr(), x.numel() // C, F,
                   int(round_input), device=dev)
    ffn_residual_ln.launches += 1
    return out


ffn_residual_ln.launches = 0


def ffn_residual_layernorm(x, w1, b1, w2, b2, ln_scale, ln_bias):
    """LayerNorm(x + relu(x @ w1 + b1) @ w2 + b2): the per-layer path's FFN
    (``ppgs_tpu/ops/fused_ffn.py::ffn_residual_layernorm``). x (..., C)
    float32; w1 (C, F) and w2 (F, C) in the compute dtype. Unlike the TPU
    kernel, any number of rows works (no multiple of 512)."""
    return ffn_residual_ln(x, w1, b1, w2, b2, ln_scale, ln_bias,
                           round_input=True)


def ffn_residual_layernorm_reference(x, w1, b1, w2, b2, ln_scale, ln_bias):
    """Plain version of ``ffn_residual_layernorm``."""
    return ffn_residual_ln_reference(x, w1, b1, w2, b2, ln_scale, ln_bias,
                                     round_input=True)
