"""The wav2vec2 feature extractor's conv chain as CUDA kernels (B10,
``kernels/csrc/conv_stack.cu``).

Counterpart of ``ppgs_tpu/ops/conv_stack.py::feature_encoder_stack``: seven
VALID convs (wav2vec2-base: 512 channels, k = (10,3,3,3,3,2,2),
s = (5,2,2,2,2,2,2)), a per-channel GroupNorm after conv 0 whose
statistics span every conv-0 frame, and the tanh-approximate GELU after
each conv; bf16 operands and stream, fp32 accumulation and statistics. It
is the opt-in of the bf16 frontend (``PPGS_TPU_CONV_STACK=1``, as in the
JAX package); without it ``models.w2v2.feature_encoder`` runs plain convs.

Two kernels, each with its plain version below:

- ``conv_stats``: conv 0's per-channel sum and sum of squares over all
  its frames (the TPU's ``_stats_kernel``);
- ``conv_gelu``: one strided conv with GELU as an implicit GEMM; its first
  form is conv 1 with conv 0, the GroupNorm and GELU folded into its loads,
  so the conv-0 activation never reaches device memory (the TPU's
  ``_stack_kernel``, which runs the whole chain per time tile in VMEM).

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. The design, and why it does not copy the
TPU's per-tile chain, is in the CUDA source.
"""

import os

import torch

from .. import kernels

GN_EPS = 1e-5
MAX_K0 = 16          # conv 0's taps (the TPU kernel's PATCH_LANES)
CHANNELS = 512       # the kernels' width (wav2vec2's conv_dim)


def supported(config) -> bool:
    """The JAX package's rule (``ppgs_tpu/ops/conv_stack.py:263-282``): opt
    in with ``PPGS_TPU_CONV_STACK=1``, bf16 compute, conv 0 at most MAX_K0
    taps. The TPU backend check has no counterpart: on the CPU the wrappers
    run their plain versions."""
    if os.environ.get('PPGS_TPU_CONV_STACK', '0') != '1':
        return False
    return (config.compute_dtype == 'bfloat16'
            and config.conv_kernel[0] <= MAX_K0)


def _conv0(audio, w0, k0, s0):
    """Conv 0 in fp32 from bf16 audio (B, S) and weights (k0, C)."""
    patches = audio.float().unfold(-1, k0, s0)            # (B, T0, k0)
    return patches @ w0.float()                           # (B, T0, C)


def conv_stats_reference(audio, w0, k0, s0):
    """Plain version of ``conv_stats``."""
    x0 = _conv0(audio, w0, k0, s0)
    return torch.stack([x0.sum(dim=1), (x0 * x0).sum(dim=1)], dim=1)


def conv_stats(audio, w0, k0, s0):
    """Conv 0's per-channel sum and sum of squares over all its frames
    (``kernels/csrc/conv_stack.cu``): audio (B, S) bf16, w0 (k0, C) bf16
    -> (B, 2, C) fp32."""
    if audio.device.type == 'cpu':
        return conv_stats_reference(audio, w0, k0, s0)
    B, S = audio.shape
    dev = audio.device
    kernels.require(audio, 'audio', torch.bfloat16, dev)
    kernels.require(w0, 'w0', torch.bfloat16, dev, (k0, CHANNELS))
    if not 1 <= k0 <= MAX_K0 or S < k0:
        raise ValueError(f'conv_stats kernel takes 1 <= k0 <= {MAX_K0} and '
                         f'S >= k0; got k0={k0}, S={S}')
    T0 = (S - k0) // s0 + 1
    tiles = -(-T0 // 256)
    partial = torch.empty((B, tiles, 2, CHANNELS), dtype=torch.float32,
                          device=dev)
    tickets = torch.zeros(B, dtype=torch.int32, device=dev)
    sums = torch.empty((B, 2, CHANNELS), dtype=torch.float32, device=dev)
    kernels.launch('ppgs_conv_stats', audio.data_ptr(), S, w0.data_ptr(), k0,
                   s0, T0, B, partial.data_ptr(), sums.data_ptr(),
                   tickets.data_ptr(), device=dev)
    conv_stats.launches += 1
    return sums


conv_stats.launches = 0


def _gelu_bf16(x):
    return torch.nn.functional.gelu(x, approximate='tanh').to(torch.bfloat16)


def _conv_gelu(x, w, k, s):
    """bf16(gelu(conv)) of a bf16 (B, T_in, C) input with w (k*C, C): the
    k taps of output frame t are the k*C values from row s*t on."""
    B, T_in, C = x.shape
    T_out = (T_in - k) // s + 1
    taps = x.float().unfold(1, k, s).transpose(-1, -2)    # (B, T, k, C)
    return _gelu_bf16(taps.reshape(B, T_out, k * C) @ w.float())


def conv_gelu_reference(x, w, k, s, first=None):
    """Plain version of ``conv_gelu``."""
    if first is not None:
        w0, k0, s0, sums, gamma, beta = first
        x0 = _conv0(x, w0, k0, s0)
        n = x0.shape[1]
        mean = sums[:, 0:1] / n
        var = sums[:, 1:2] / n - mean * mean
        x0 = (x0 - mean) * torch.rsqrt(var + GN_EPS)
        x = _gelu_bf16(x0 * gamma + beta)
    return _conv_gelu(x, w, k, s)


def conv_gelu(x, w, k, s, first=None):
    """bf16(gelu(conv(x))) with stride s and w (k*C, C) bf16, the JAX
    (k, C_in, C_out) weight flattened (``kernels/csrc/conv_stack.cu``);
    x (B, T_in, C) bf16 -> (B, T_out, C) bf16.

    ``first`` = (w0 (k0, C) bf16, k0, s0, sums (B, 2, C) from
    ``conv_stats``, GroupNorm gamma and beta (C) fp32): x is the bf16 audio
    (B, S), and this conv's input is bf16(gelu(GroupNorm(conv 0))),
    computed in the kernel and never stored. ``conv_gelu.first`` counts
    the launches of that form."""
    if x.device.type == 'cpu':
        return conv_gelu_reference(x, w, k, s, first)
    dev = x.device
    C = CHANNELS
    kernels.require(x, 'x', torch.bfloat16, dev)
    kernels.require(w, 'w', torch.bfloat16, dev, (k * C, C))
    B = x.shape[0]
    if first is None:
        if x.dim() != 3 or x.shape[2] != C:
            raise ValueError(f'conv_gelu kernel takes (B, T, {C}) inputs; got '
                             f'{tuple(x.shape)}')
        T_in = x.shape[1]
        x_batch, extra = T_in * C, (None, 0, 0, 0, None, None, None)
    else:
        w0, k0, s0, sums, gamma, beta = first
        if x.dim() != 2 or not 1 <= k0 <= MAX_K0:
            raise ValueError(f'conv_gelu (first) takes (B, S) audio and '
                             f'1 <= k0 <= {MAX_K0}; got {tuple(x.shape)}, '
                             f'k0={k0}')
        kernels.require(w0, 'w0', torch.bfloat16, dev, (k0, C))
        kernels.require(sums, 'sums', torch.float32, dev, (B, 2, C))
        kernels.require(gamma, 'gamma', torch.float32, dev, (C,))
        kernels.require(beta, 'beta', torch.float32, dev, (C,))
        T_in = (x.shape[1] - k0) // s0 + 1
        x_batch = x.shape[1]
        extra = (w0.data_ptr(), k0, s0, T_in, sums.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr())
    T_out = (T_in - k) // s + 1
    out = torch.empty((B, max(T_out, 0), C), dtype=torch.bfloat16,
                      device=dev)
    kernels.launch('ppgs_conv_gelu', x.data_ptr(), x_batch, w.data_ptr(), k,
                   s, T_out, B, out.data_ptr(), *extra, device=dev)
    conv_gelu.launches += 1
    if first is not None:
        conv_gelu.first += 1
    return out


conv_gelu.launches = 0
conv_gelu.first = 0


def _stack(audio, taps, w0, gn_scale, gn_bias, kernel, stride, ops):
    stats_fn, conv_fn = ops
    audio = audio.to(torch.bfloat16).contiguous()
    k0, s0 = kernel[0], stride[0]
    sums = stats_fn(audio, w0, k0, s0)
    first = (w0, k0, s0, sums, gn_scale.float().contiguous(),
             gn_bias.float().contiguous())
    x = conv_fn(audio, taps[0], kernel[1], stride[1], first)
    for w, k, s in zip(taps[1:], kernel[2:], stride[2:]):
        x = conv_fn(x, w, k, s)
    return x


@torch.no_grad()
def feature_encoder_stack(audio, taps, w0, gn_scale, gn_bias, kernel,
                          stride):
    """(B, S) audio -> (B, T_final, C) bf16 features through the kernels.

    taps: convs 1.. as (k_i * C, C) bf16 (``convert.prepare_w2v2``); w0:
    conv 0 as (k0, C) bf16; gn_scale, gn_bias: conv 0's GroupNorm. The
    audio is rounded to bf16, as the TPU kernel's patches are."""
    return _stack(audio, taps, w0, gn_scale, gn_bias, kernel, stride,
                  (conv_stats, conv_gelu))


@torch.no_grad()
def feature_encoder_stack_reference(audio, taps, w0, gn_scale, gn_bias,
                                    kernel, stride):
    """Plain version of ``feature_encoder_stack`` on any device."""
    return _stack(audio, taps, w0, gn_scale, gn_bias, kernel, stride,
                  (conv_stats_reference, conv_gelu_reference))
