"""The wav2vec2 feature extractor's conv chain as CUDA kernels (B10,
``kernels/csrc/conv_stack.cu``).

Counterpart of ``ppgs_tpu/ops/conv_stack.py::feature_encoder_stack``: seven
VALID convs (wav2vec2-base: 512 channels, k = (10,3,3,3,3,2,2),
s = (5,2,2,2,2,2,2)), a per-channel GroupNorm after conv 0 whose
statistics span every conv-0 frame, and the tanh-approximate GELU after
each conv; bf16 operands and stream, fp32 accumulation and statistics. It
is the opt-in of the bf16 frontend (``PPGS_TPU_CONV_STACK=1``, as in the
JAX package); without it ``models.w2v2.feature_encoder`` runs plain convs.

Three kernels, each with its plain version below:

- ``conv_stats``: conv 0's per-channel sum and sum of squares over all
  its frames (the TPU's ``_stats_kernel``), through the patches' fp64 Gram
  matrix: no conv-0 output is formed;
- ``conv0_gelu``: conv 1's input, bf16(gelu(GroupNorm(conv 0))) of the
  audio, conv 0 on the tensor cores and tanhf's bf16 kept by a guarded
  fast GELU (``gelu_guard_safe``);
- ``conv_gelu``: one strided conv with GELU as an implicit GEMM on wgmma +
  TMA, in row tiles that stay inside an utterance (``conv_gelu_plan``);
  its first form is conv 1 from the audio, ``conv0_gelu`` then the
  product (the TPU's ``_stack_kernel`` runs the whole chain per time tile
  in VMEM; on Hopper, making conv 1's operand inside the product's kernel
  measured slower than storing it, ``kernels/csrc/conv_stack.cu``).

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise. The design, and why it does not copy the
TPU's per-tile chain, is in the CUDA source.
"""

import collections
import os

import torch

from .. import kernels

GN_EPS = 1e-5
MAX_K0 = 16          # conv 0's taps (the TPU kernel's PATCH_LANES)
CHANNELS = 512       # the kernels' width (wav2vec2's conv_dim)
MAX_TAPS = 3         # conv_gelu's taps (wav2vec2's convs 1-6 have 3 or 2)
BLOCK_ROWS = 128     # conv_gelu's output rows a block (conv_stack.cu BM)
CONV0_FRAMES = 128   # conv0_gelu's frames a block (conv_stack.cu C0_FRAMES)
STATS_FRAMES = 4608  # conv_stats' frames a block at most (conv_stack.cu)
STATS_SAMPLES = 24576     # and the samples it stages at most
STATS_WARPS = 8      # its warps, each on groups of STATS_K frames
STATS_K = 8          # the frames of one fp64 product (m16n8k8)
STATS_GRAM = MAX_K0 * MAX_K0 + MAX_K0   # a block's partial sums: G, then A

# conv0_gelu's GELU (conv_stack.cu gelu_pair) is the fast form f = x / (1 +
# 2^z), z = -2 log2(e) sqrt(2 / pi) (x + 0.044715 x^3), by ex2.approx and
# rcp.approx, where tanhf's form 0.5 x (1 + tanhf(u)) lies within (6 |x| +
# 12 |f|) 2^-24 of it. In units of 2^-24, tanhf's form lies within 3.07 |x|
# + 1 |G| of the exact function G (u's 7 roundings through sech^2(u) |u| <=
# 0.448, tanhf's 2 ulp, 1 + t, the product), the fast form within 2.27 |x|
# + 10.94 |G| (z's 8 roundings through ln 2 |z|, ex2.approx, 1 + e,
# rcp.approx, the product). The guard keeps f where f - m and f + m round
# to the same bf16, with m twice that bound, and takes tanhf's form
# elsewhere: the output is tanhf's bf16 either way.
GELU_ERR_ABS = 6 * 2.0 ** -24
GELU_ERR_REL = 12 * 2.0 ** -24
GUARD_ABS, GUARD_REL = 2 * GELU_ERR_ABS, 2 * GELU_ERR_REL


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
    -> (B, 2, C) fp32. The kernel sums the patches' A = sum_f p_f and
    Gram matrix G = sum_f p_f p_f^T in fp64 (bf16 products are exact) and
    contracts them with w0 (sum = w . A, sum of squares = w^T G w), each
    rounded once to fp32."""
    if audio.device.type == 'cpu':
        return conv_stats_reference(audio, w0, k0, s0)
    B, S = audio.shape
    dev = audio.device
    kernels.require(audio, 'audio', torch.bfloat16, dev)
    kernels.require(w0, 'w0', torch.bfloat16, dev, (k0, CHANNELS))
    plan = conv_stats_plan(S, k0, s0)
    partial = torch.empty((B, plan['tiles'], STATS_GRAM), dtype=torch.float64,
                          device=dev)
    tickets = torch.zeros(B, dtype=torch.int32, device=dev)
    sums = torch.empty((B, 2, CHANNELS), dtype=torch.float32, device=dev)
    kernels.launch('ppgs_conv_stats', audio.data_ptr(), S, w0.data_ptr(), k0,
                   s0, plan['T0'], B, plan['tiles'], partial.data_ptr(),
                   sums.data_ptr(), tickets.data_ptr(), device=dev)
    conv_stats.launches += 1
    return sums


conv_stats.launches = 0


def conv_stats_plan(S, k0, s0):
    """How ``conv_stats`` cuts its work: a grid of (tiles, B) blocks, block
    (i, b) staging the samples of conv-0 frames i frames .. (i + 1) frames
    - 1 of utterance b (below T0; frames = as many as STATS_FRAMES and
    STATS_SAMPLES allow) and summing them; its warp w takes the groups of
    STATS_K frames from STATS_K w on, STATS_K STATS_WARPS apart
    (``tests/test_torch_conv_stack.py`` replays the walk). Returns a dict:
    T0, frames and tiles, which the wrapper passes to the kernel, whose
    entry point refuses another. Raises ValueError for what the kernel
    does not take."""
    if not 1 <= k0 <= MAX_K0 or s0 < 1 or S < k0:
        raise ValueError(f'conv_stats kernel takes 1 <= k0 <= {MAX_K0}, s0 '
                         f'>= 1 and S >= k0; got k0={k0}, s0={s0}, S={S}')
    T0 = (S - k0) // s0 + 1
    frames = min(STATS_FRAMES, (STATS_SAMPLES - MAX_K0) // s0 + 1)
    return {'T0': T0, 'frames': frames, 'tiles': -(-T0 // frames)}


def conv_gelu_plan(B, T_in, k, s):
    """How ``conv_gelu`` cuts its work, and whether the kernel takes it.

    The output (B, T_out, C) is cut into tiles of BLOCK_ROWS rows that stay
    inside one utterance (each utterance's last tile ragged), each computed
    by two blocks of 256 columns: block x computes column half x % 2 of row
    tile x // 2 (the B * tiles of all utterances in a row). Tap j of output
    row t is input row s t + j, read through a tensor map of its own (rows
    of a box past T_out read zeros), so the last input row read is
    s (T_out - 1) + k - 1 < T_in.

    Returns a dict: T_out, tiles (row tiles an utterance) and blocks (the
    grid), which the wrapper passes to the kernel, whose entry point
    refuses any others. Raises ValueError for a shape the kernel does not
    take."""
    if not 1 <= k <= MAX_TAPS or s < 1:
        raise ValueError(f'conv_gelu kernel takes 1 <= k <= {MAX_TAPS} taps '
                         f'and s >= 1; got k={k}, s={s}')
    T_out = max((T_in - k) // s + 1, 0)
    tiles = -(-T_out // BLOCK_ROWS)
    return {'T_out': T_out, 'tiles': tiles, 'blocks': 2 * tiles * B}


def conv0_gelu_plan(S, k0, s0):
    """How ``conv0_gelu`` cuts its work: a grid of (tiles, B) blocks, block
    (i, b) making conv-0 frames f0 = i CONV0_FRAMES .. of utterance b (in
    steps of 64 rows and 64 columns) from the ``window`` samples from s0 f0
    on, row r tap k reading sample s0 r + k (none past the frames' last,
    s0 (T0 - 1) + k0 - 1 < S). Returns a dict: T0, tiles and window,
    which the wrapper passes to the kernel, whose entry point refuses any
    others. Raises ValueError for what the kernel does not take."""
    if not 1 <= k0 <= MAX_K0 or s0 < 1:
        raise ValueError(f'conv0_gelu kernel takes 1 <= k0 <= {MAX_K0} and '
                         f's0 >= 1; got k0={k0}, s0={s0}')
    window = s0 * (CONV0_FRAMES - 1) + k0
    T0 = max((S - k0) // s0 + 1, 0)
    tiles = -(-T0 // CONV0_FRAMES)
    return {'T0': T0, 'tiles': tiles, 'window': window}


def _gelu_bf16(x):
    return torch.nn.functional.gelu(x, approximate='tanh').to(torch.bfloat16)


def gelu_guard_safe(x, fast):
    """Where ``conv0_gelu`` keeps its fast GELU value ``fast`` of the fp32
    pre-activation ``x`` (the kernel's guard, in fp32 as it computes it):
    where fast - m and fast + m, m = GUARD_ABS |x| + GUARD_REL |fast|,
    round to the same bf16 bits, so that every value within m of ``fast``,
    tanhf's among them, rounds to them too."""
    x, fast = x.float(), fast.float()
    m = GUARD_ABS * x.abs() + GUARD_REL * fast.abs()
    bits = lambda v: v.to(torch.bfloat16).view(torch.int16)  # noqa: E731
    return bits(fast + m) == bits(fast - m)


def _conv_gelu(x, w, k, s):
    """bf16(gelu(conv)) of a bf16 (B, T_in, C) input with w (k*C, C): the
    k taps of output frame t are the k*C values from row s*t on."""
    B, T_in, C = x.shape
    T_out = (T_in - k) // s + 1
    taps = x.float().unfold(1, k, s).transpose(-1, -2)    # (B, T, k, C)
    return _gelu_bf16(taps.reshape(B, T_out, k * C) @ w.float())


def conv0_gelu_reference(audio, w0, k0, s0, sums, gamma, beta):
    """Plain version of ``conv0_gelu``."""
    x0 = _conv0(audio, w0, k0, s0)
    n = x0.shape[1]
    mean = sums[:, 0:1] / n
    var = sums[:, 1:2] / n - mean * mean
    x0 = (x0 - mean) * torch.rsqrt(var + GN_EPS)
    return _gelu_bf16(x0 * gamma + beta)


def conv0_gelu(audio, w0, k0, s0, sums, gamma, beta):
    """Conv 1's input, bf16(gelu(GroupNorm(conv 0))) of the bf16 audio (B,
    S) with w0 (k0, C) bf16, stride s0, the statistics ``sums`` (B, 2, C)
    from ``conv_stats`` and the GroupNorm's gamma and beta (C) fp32 ->
    (B, T0, C) bf16 (``kernels/csrc/conv_stack.cu``)."""
    return _conv0_gelu(audio, w0, k0, s0, sums, gamma, beta, None)


def conv0_gelu_counted(audio, w0, k0, s0, sums, gamma, beta):
    """``conv0_gelu``, and an int64 tensor (1,) on the card that counts the
    outputs whose GELU the kernel took by tanhf (its guard; pairs of
    columns, so even); None on the CPU, where the plain version runs."""
    if audio.device.type == 'cpu':
        return conv0_gelu_reference(audio, w0, k0, s0, sums, gamma,
                                    beta), None
    guarded = torch.zeros(1, dtype=torch.int64, device=audio.device)
    return _conv0_gelu(audio, w0, k0, s0, sums, gamma, beta,
                       guarded), guarded


def _conv0_gelu(audio, w0, k0, s0, sums, gamma, beta, guarded):
    if audio.device.type == 'cpu':
        return conv0_gelu_reference(audio, w0, k0, s0, sums, gamma, beta)
    dev = audio.device
    C = CHANNELS
    kernels.require(audio, 'audio', torch.bfloat16, dev)
    if audio.dim() != 2:
        raise ValueError(f'conv0_gelu takes (B, S) audio; got '
                         f'{tuple(audio.shape)}')
    B, S = audio.shape
    plan = conv0_gelu_plan(S, k0, s0)
    kernels.require(w0, 'w0', torch.bfloat16, dev, (k0, C))
    kernels.require(sums, 'sums', torch.float32, dev, (B, 2, C))
    kernels.require(gamma, 'gamma', torch.float32, dev, (C,))
    kernels.require(beta, 'beta', torch.float32, dev, (C,))
    act = torch.empty((B, plan['T0'], C), dtype=torch.bfloat16, device=dev)
    kernels.launch('ppgs_conv0_gelu', audio.data_ptr(), S, w0.data_ptr(), k0,
                   s0, plan['T0'], B, plan['tiles'], plan['window'],
                   sums.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                   act.data_ptr(),
                   None if guarded is None else guarded.data_ptr(),
                   device=dev)
    conv0_gelu.launches += 1
    return act


conv0_gelu.launches = 0


def conv_gelu_reference(x, w, k, s, first=None):
    """Plain version of ``conv_gelu``."""
    if first is not None:
        x = conv0_gelu_reference(x, *first)
    return _conv_gelu(x, w, k, s)


def conv_gelu(x, w, k, s, first=None):
    """bf16(gelu(conv(x))) with stride s and w (k*C, C) bf16, the JAX
    (k, C_in, C_out) weight flattened (``kernels/csrc/conv_stack.cu``);
    x (B, T_in, C) bf16 -> (B, T_out, C) bf16.

    ``first`` = (w0 (k0, C) bf16, k0, s0, sums (B, 2, C) from
    ``conv_stats``, GroupNorm gamma and beta (C) fp32): x is the bf16 audio
    (B, S), and this conv's input is bf16(gelu(GroupNorm(conv 0))), which
    ``conv0_gelu`` writes first (1.68 GB at 64 x 8 s, as the library path
    stores it too). ``conv_gelu.first`` counts the launches of that
    form, ``conv_gelu.strides`` the launches by s (the 100 Hz trunk's
    conv 6 takes s = 1)."""
    if x.device.type == 'cpu':
        return conv_gelu_reference(x, w, k, s, first)
    if first is not None:
        x = conv0_gelu(x, *first)
    dev = x.device
    C = CHANNELS
    kernels.require(x, 'x', torch.bfloat16, dev)
    kernels.require(w, 'w', torch.bfloat16, dev, (k * C, C))
    if x.dim() != 3 or x.shape[2] != C:
        raise ValueError(f'conv_gelu kernel takes (B, T, {C}) inputs; got '
                         f'{tuple(x.shape)}')
    B, T_in = x.shape[:2]
    plan = conv_gelu_plan(B, T_in, k, s)
    out = torch.empty((B, plan['T_out'], C), dtype=torch.bfloat16,
                      device=dev)
    kernels.launch('ppgs_conv_gelu', x.data_ptr(), T_in * C, w.data_ptr(), k,
                   s, plan['T_out'], B, plan['tiles'], plan['blocks'],
                   out.data_ptr(), device=dev)
    conv_gelu.launches += 1
    conv_gelu.strides[s] += 1
    if first is not None:
        conv_gelu.first += 1
    return out


conv_gelu.launches = 0
conv_gelu.first = 0
conv_gelu.strides = collections.Counter()   # launches by stride


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
