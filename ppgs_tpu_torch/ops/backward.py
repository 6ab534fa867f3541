"""Building blocks of the train kernels' backward passes, each a CUDA
kernel with its plain PyTorch version: a bf16 matrix product with
transpose flags (``gemm``, ``kernels/csrc/gemm.cu``), a deterministic
column sum (``colsum``) and the LayerNorm backward with a dropout epilogue
(``ln_dropout_bwd``, both ``kernels/csrc/layer_train.cu``).

The TPU kernels compute these inside their bodies and sum the weight and
bias gradients across a sequential grid; on the card the sums over rows
are split into per-block partials and added by ``colsum`` in a fixed
order, so a gradient is the same from run to run.

``cd`` is the compute dtype, the type an operand is rounded to before a
product: the kernels take bf16 only; the plain versions take any (the CPU
tests run them in float32 against the JAX package).
"""

import torch

from .. import kernels

PARTIAL_ROWS = 64   # rows per block of the kernels' per-block partial sums


def _rows(t):
    return t.numel() // t.shape[-1]


def block_sums(t, rows=PARTIAL_ROWS):
    """Column sums of a 2-D (M, N) tensor over blocks of ``rows`` rows ->
    (ceil(M / rows), N): the plain form of a kernel's partial sums."""
    M, N = t.shape
    blocks = -(-M // rows)
    t = torch.nn.functional.pad(t, (0, 0, 0, blocks * rows - M))
    return t.reshape(blocks, rows, N).sum(dim=1)


###############################################################################
# gemm
###############################################################################


DEPTH_STEP = 64     # the gemm kernel's depth step: a split chunk's multiple
BLOCK_M = 128       # the gemm kernel's block tile rows
SMS = 132           # streaming multiprocessors of an H100 SXM


def _k_chunk(K, splits):
    """Rows of the depth per split: the kernel's, a multiple of the depth
    step (64), so that no split reads into the next one's rows."""
    per_split = -(-K // splits)
    return -(-per_split // DEPTH_STEP) * DEPTH_STEP


def block_n(N):
    """The kernel's block tile columns for an output N columns wide: 256,
    or 128 where N % 256 != 0."""
    return 256 if N % 256 == 0 else 128


def split_count(M, N, depth):
    """Depth splits of a weight-gradient product with an (M, N) output:
    enough that tiles x splits fills one wave of the card's 132 SMs (one
    128 x ``block_n(N)`` tile a block and SM), each split at least one depth
    step deep, and none empty."""
    tiles = -(-M // BLOCK_M) * -(-N // block_n(N))
    splits = max(1, min(SMS // tiles, -(-depth // DEPTH_STEP)))
    return -(-depth // _k_chunk(depth, splits))


def gemm_reference(a, b, ta, tb, cd, splits=1, residual=None, want32=True,
                   want16=False):
    """Plain version of ``gemm``."""
    A = a.to(cd).float()
    A = A.T if ta else A
    B = b.float().T if tb else b.float()
    K = A.shape[1]
    chunk = _k_chunk(K, splits)
    if splits > 1:
        out = torch.stack([A[:, s * chunk:(s + 1) * chunk]
                           @ B[s * chunk:(s + 1) * chunk]
                           for s in range(splits)])
        return out, None
    out = A @ B
    if residual is not None:
        out = out + residual.reshape(out.shape)
    return (out if want32 else None), (out.to(cd) if want16 else None)


def gemm_shapes(a_shape, a_dtype, b_shape, ta, tb, splits=1, want16=False,
                residual=False, addresses=()):
    """The kernel's rule on its operands: (ta, tb) = (0, 1) or (1, 0), 2-D
    operands of matching depth, a bf16 or (transposed only) fp32 a and a
    bf16 b, N % 128 == 0, rows and ``addresses`` (the operands' base
    addresses) 16-byte aligned for the TMA, and split fp32 partials only,
    of a transposed a. Returns (M, N, K); raises ValueError
    for what the kernel does not take."""
    ta, tb = bool(ta), bool(tb)
    if len(a_shape) != 2 or len(b_shape) != 2 or ta == tb:
        raise ValueError('gemm kernel takes (ta, tb) = (0, 1) or (1, 0) and '
                         '2-D operands')
    if a_dtype not in (torch.bfloat16, torch.float32) or (
            a_dtype == torch.float32 and not ta):
        raise ValueError(f'gemm kernel takes a bf16 a, or an fp32 a only '
                         f'transposed; got {a_dtype}, ta={int(ta)}')
    M, K = (a_shape[1], a_shape[0]) if ta else a_shape
    N = b_shape[0] if tb else b_shape[1]
    if (b_shape[1] if tb else b_shape[0]) != K:
        raise ValueError(f'gemm: depths differ, {tuple(a_shape)} and '
                         f'{tuple(b_shape)}')
    a_row = a_shape[1] * (4 if a_dtype == torch.float32 else 2)
    if N % 128 or a_row % 16 or b_shape[1] * 2 % 16:
        raise ValueError(f'gemm kernel takes N % 128 == 0 and rows of a '
                         f'multiple of 16 bytes; got M={M} N={N} K={K}')
    if any(address % 16 for address in addresses):
        raise ValueError('gemm kernel takes 16-byte aligned operands')
    if splits < 1 or (splits > 1 and (want16 or residual or not ta)):
        raise ValueError('split gemm writes fp32 partial sums only, of a '
                         'transposed a')
    return M, N, K


def gemm(a, b, ta, tb, cd, splits=1, residual=None, want32=True,
         want16=False):
    """C = op(a) op(b) with fp32 accumulation: op(a) = a.T when ``ta``,
    op(b) = b.T when ``tb``; a 2-D (rows, cols) either bf16, or fp32
    rounded to bf16 as read (``ta`` only). Returns (fp32 C or None, bf16 C
    or None); with ``splits`` > 1 the fp32 result is (splits, M, N) partial
    sums over ``splits`` ranges of the depth, for ``colsum``. ``residual``
    (M, N) fp32 is added to C (splits == 1)."""
    if a.device.type == 'cpu':
        return gemm_reference(a, b, ta, tb, cd, splits, residual, want32,
                              want16)
    if cd != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError(f'gemm kernel takes bf16 operands; got {cd}, '
                         f'{b.dtype}')
    dev = a.device
    kernels.require(a, 'a', a.dtype, dev)
    kernels.require(b, 'b', torch.bfloat16, dev)
    if residual is not None:
        kernels.require(residual, 'residual', torch.float32, dev)
    M, N, K = gemm_shapes(
        a.shape, a.dtype, b.shape, ta, tb, splits, want16,
        residual is not None,
        [t.data_ptr() for t in (a, b, residual) if t is not None])
    if residual is not None and residual.numel() != M * N:
        raise ValueError('gemm: residual has the wrong size')
    out32 = (torch.empty((splits, M, N) if splits > 1 else (M, N),
                         dtype=torch.float32, device=dev)
             if want32 or splits > 1 else None)
    out16 = (torch.empty((M, N), dtype=torch.bfloat16, device=dev)
             if want16 else None)
    kernels.launch('ppgs_gemm', a.data_ptr(), int(a.dtype == torch.float32),
                   int(ta), a.shape[1], b.data_ptr(), int(tb), b.shape[1],
                   kernels.ptr(out32), kernels.ptr(out16),
                   kernels.ptr(residual), N, M, N, K, splits, device=dev)
    gemm.launches += 1
    key = gemm_form(ta, a.dtype, M, N, K)
    gemm.forms[key] = gemm.forms.get(key, 0) + 1
    return out32, out16


gemm.launches = 0
gemm.forms = {}     # launches by gemm_form


def gemm_form(ta, a_dtype, M, N, K):
    """The key of ``gemm.forms``: (ta, a's type, M, N, K)."""
    return (int(bool(ta)), str(a_dtype).replace('torch.', ''), M, N, K)


def weight_grad(a, b, cd, gemm_fn=None, colsum_fn=None):
    """a^T b summed over all rows, rounded to the compute dtype (the JAX
    kernels return their matrix gradients in it), as fp32: a split gemm,
    then colsum of its partials (``gemm_fn``/``colsum_fn``: the kernels by
    default, or their plain versions)."""
    gemm_fn, colsum_fn = gemm_fn or gemm, colsum_fn or colsum
    K, M = a.shape
    N = b.shape[1]
    splits = split_count(M, N, K)
    part, _ = gemm_fn(a, b, True, False, cd, splits=splits)
    if splits == 1:
        part = part[None]
    return colsum_fn(part.reshape(splits, M * N), round_to=cd).reshape(M, N)


###############################################################################
# colsum
###############################################################################


# colsum's first pass: 256 columns a block where it splits the rows (64
# threads of 4 columns in 4 row lanes), 8 blocks an SM, a split at least 64
# rows (16 a lane)
COLSUM_COLUMNS, COLSUM_MIN_ROWS, COLSUM_WAVE = 256, 64, SMS * 8


def colsum_plan(R, N):
    """(splits, chunk) of ``colsum`` over an (R, N) tensor: ``splits``
    ranges of ``chunk`` rows, range s rows [s chunk, min(R, (s + 1)
    chunk)), each non-empty, in order, together every row once. Enough
    splits that splits x column blocks fills one wave of the card (132
    SMs x 8 blocks), each at least COLSUM_MIN_ROWS rows; one (a single
    pass) when R is short."""
    col_blocks = -(-N // COLSUM_COLUMNS)
    splits = max(1, min(-(-COLSUM_WAVE // max(col_blocks, 1)),
                        R // COLSUM_MIN_ROWS))
    chunk = max(1, -(-R // splits))
    return -(-R // chunk) or 1, chunk


def colsum_reference(t, round_to=None):
    """Plain version of ``colsum``: ``t.sum(0)``. The kernel adds the same
    terms in another fixed order (each split of ``colsum_plan`` as 1, 2 or
    4 interleaved row lanes by its rows, each lane's rows into 4
    accumulators in turn, those added as (a0 + a1) + (a2 + a3), the lanes
    in order; then the splits' sums in 32 lanes the same way), so the two
    agree to fp32 rounding."""
    out = t.float().sum(dim=0)
    return out.to(round_to).float() if round_to is not None else out


def colsum(t, round_to=None):
    """Column sums of a 2-D fp32 (R, N) tensor -> (N,) fp32, rounded to
    ``round_to`` (kept in fp32) when given. Deterministic: rows are taken
    in a fixed order."""
    if t.device.type == 'cpu':
        return colsum_reference(t, round_to)
    dev = t.device
    kernels.require(t, 't', torch.float32, dev)
    if round_to not in (None, torch.bfloat16):
        raise ValueError(f'colsum rounds to bf16 only; got {round_to}')
    R, N = t.shape
    out = torch.empty(N, dtype=torch.float32, device=dev)
    splits, chunk = colsum_plan(R, N)
    scratch = (torch.empty((splits, N), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    kernels.launch('ppgs_colsum', t.data_ptr(), R, N, splits, chunk,
                   kernels.ptr(scratch), out.data_ptr(),
                   int(round_to is not None), device=dev)
    colsum.launches += 1
    return out


colsum.launches = 0


###############################################################################
# ln_dropout_bwd
###############################################################################


def ln_dropout_bwd_reference(g, n, rstd, gamma, drop, cd, want_dz=True):
    """Plain version of ``ln_dropout_bwd``."""
    C = g.shape[-1]
    g32 = g.reshape(-1, C).float()
    M = g32.shape[0]
    if n is not None:
        n32 = n.reshape(-1, C)
        dyg = g32 * gamma
        m1 = dyg.mean(dim=-1, keepdim=True)
        m2 = (dyg * n32).mean(dim=-1, keepdim=True)
        dz = (dyg - m1 - n32 * m2) * rstd.reshape(-1, 1)
        gn = g32 * n32
    else:
        dz, gn = g32, torch.zeros_like(g32)
    masked = dz
    if drop.on:
        keep = drop.keep((M, C), g.device)
        masked = torch.where(keep, dz * drop.scale, torch.zeros_like(dz))
    partial = block_sums(torch.cat([gn, g32, masked], dim=1))
    return ((dz.reshape(g.shape) if want_dz else None),
            masked.to(cd).reshape(g.shape), partial)


def ln_dropout_bwd(g, n, rstd, gamma, drop, cd, want_dz=True):
    """Per row of g (..., 256): dz = the LayerNorm backward of g given the
    normalised rows n and 1/std rstd (dz = g when n is None), and
    masked = keep ? dz / (1 - rate) : 0 for the Drop ``drop``. Returns
    (dz fp32 or None, masked in cd, partial (ceil(M/64), 3 * 256) fp32 of
    per-block column sums [g * n | g | masked], for ``colsum``)."""
    if g.device.type == 'cpu':
        return ln_dropout_bwd_reference(g, n, rstd, gamma, drop, cd, want_dz)
    C = g.shape[-1]
    if C != 256 or cd != torch.bfloat16:
        raise ValueError(f'ln_dropout_bwd kernel takes C=256 and bf16; got '
                         f'C={C}, {cd}')
    dev = g.device
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'g: expected fp32 or bf16, got {g.dtype}')
    kernels.require(g, 'g', g.dtype, dev)
    M = _rows(g)
    if n is not None:
        kernels.require(n, 'n', torch.float32, dev, g.shape)
        kernels.require(rstd, 'rstd', torch.float32, dev)
        kernels.require(gamma, 'gamma', torch.float32, dev, (C,))
    dz = torch.empty(g.shape, dtype=torch.float32, device=dev) if want_dz \
        else None
    masked = torch.empty(g.shape, dtype=torch.bfloat16, device=dev)
    partial = torch.empty((-(-M // PARTIAL_ROWS), 3 * C),
                          dtype=torch.float32, device=dev)
    kernels.launch('ppgs_ln_dropout_bwd', g.data_ptr(),
                   int(g.dtype == torch.bfloat16), kernels.ptr(n),
                   kernels.ptr(rstd), kernels.ptr(gamma), kernels.ptr(dz),
                   masked.data_ptr(),
                   partial.data_ptr(), M, *drop.c_args(), device=dev)
    ln_dropout_bwd.launches += 1
    return dz, masked, partial


ln_dropout_bwd.launches = 0
