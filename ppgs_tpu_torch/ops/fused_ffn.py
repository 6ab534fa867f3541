"""Fused FFN + residual + LayerNorm (K4, ``kernels/csrc/ffn_ln.cu``).

    out = LN(res + act(x @ w1 + b1) @ w2 + b2)

with ReLU or the tanh-approximate GELU at every width the JAX kernels take
up to 2048 (``width_ok``: C % 128 == 0; mel's 256, the w2v2fb head's 512,
the wav2vec2 trunks' 768 and 1024 among them), on a wgmma + TMA mainloop:
at C = 256 with ReLU one kernel that keeps the (M, F) hidden on the SM;
at every other (C, activation) two launches, the hidden's (bias,
activation and dropout on its accumulators, stored as bf16 in a scratch
buffer) and the output's (the residual and the LayerNorm on its
accumulators, over a cluster of ceil(C / 256) blocks). One entry point serves
two TPU kernels that round in one place differently (``round_input``):

- ``round_input=False``: the FFN half of
  ``ppgs_tpu/ops/encoder_layer_kernel.py::_layer_body`` (encoder_stack's
  and encoder_stack_streamed's main path). The hidden is
  ``act(bf16(bf16(x@w1) + bf16(b1)))`` and the residual is the fp32 x.
- ``round_input=True``: ``ppgs_tpu/ops/fused_ffn.py::_kernel``
  (``ffn_residual_layernorm``, the per-layer path). The hidden is
  ``bf16(relu(x@w1 + b1))`` and the residual is x rounded to bf16.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Bound, design and rounding notes
are in the CUDA source.

The training FFN with dropout (``ffn_train``, the TPU's ``ffn_train``, and
the FFN half of the whole-layer train kernel) is at the end of this module:
its forward is K4 with the dropout sites on, its backward a kernel of its
own (``kernels/csrc/ffn_train.cu``); both take every width of the rule with
ReLU.
"""

import collections

import torch

from .. import kernels
from . import backward, dropout

LN_EPS = 1e-5
# The widest C of the layer kernels (K1's K, K3's and K4's C): the cluster
# LayerNorm's 8 ranks of 256 columns, the portable cluster's most
# (kernels/csrc/residual_ln.cuh)
MAX_WIDTH = 2048
ACTIVATIONS = ('relu', 'gelu')
# The width whose hidden stays on chip (one kernel, ReLU); the others take
# two launches through an (M, F) bf16 hidden (kernels/csrc/ffn_ln.cu's note)
FUSED_WIDTH = 256


def width_ok(C):
    """The width rule of K1, K3 and K4 (their train forms too) and of the
    train backward kernels, which their C entry points check too: the JAX
    kernels' C % 128 == 0, from 128 to ``MAX_WIDTH``."""
    return C % 128 == 0 and 128 <= C <= MAX_WIDTH


def hidden_scratch(M, F, C, device, activation='relu'):
    """The (M, F) bf16 buffer that K4's two launches pass the hidden
    through; None for the one kernel (``FUSED_WIDTH`` with ReLU)."""
    if C == FUSED_WIDTH and activation == 'relu':
        return None
    return torch.empty((M, F), dtype=torch.bfloat16, device=device)


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


def activate(h, activation):
    """ReLU, or GELU with the tanh approximation (the w2v2 bf16 path's,
    ``ppgs_tpu/models/w2v2.py::_gelu``), computed in fp32 and returned in
    h's dtype."""
    if activation == 'gelu':
        return torch.nn.functional.gelu(
            h.float(), approximate='tanh').to(h.dtype)
    if activation == 'relu':
        return torch.relu(h)
    raise ValueError(f'activation {activation!r}: relu or gelu')


def ffn_residual_ln_reference(x, w1, b1, w2, b2, scale, bias,
                              round_input=False, activation='relu'):
    """Plain version of ``ffn_residual_ln`` (any device, any compute dtype:
    the dtype of w1 is the compute dtype)."""
    cd = w1.dtype
    xc = x.to(cd)
    if round_input:
        h = activate(matmul(xc, w1) + b1.float(), activation).to(cd)
        res = xc.float()
    else:
        h = activate(matmul(xc, w1).to(cd) + b1.to(cd), activation)
        res = x.float()
    y = matmul(h, w2)
    return layer_norm(res + y + b2.float(), scale.float(), bias.float())


def _launch_ffn(x, w1, b1, w2, b2, ln=None, round_input=False,
                drop_h=dropout.OFF, drop_y=dropout.OFF, stats=False,
                activation='relu'):
    """Check the operands and launch K4 (``kernels/csrc/ffn_ln.cu``) on the
    card: one kernel at C = 256 with ReLU, two (through ``hidden_scratch``)
    at every other width; C under the width rule (``width_ok``) in every
    form. ``ln`` = (gamma, beta): x (..., C) fp32 with ReLU or GELU, or
    ReLU for the train forms (``stats``, or a dropout site on); returns
    (LN(...) fp32, and with ``stats`` the normalised rows and 1/std (M,),
    else None, None). ``ln`` None: x (..., C) bf16 with ReLU, returns (the
    bf16 output, None, None). Last, the hidden's keep words
    (``keep_words_shape`` int32) where ``drop_h`` drops it (the train
    forms), else None."""
    C, F = w1.shape
    train = not ln or stats or drop_h.on or drop_y.on
    activations = ('relu',) if train else ACTIVATIONS
    taken = width_ok(C) and activation in activations
    rule = (f'C % 128 == 0, 128 <= C <= {MAX_WIDTH}, activation in '
            f'{activations}')
    if not taken or F % 128:
        raise ValueError(f'ffn_ln kernel takes (C, activation) {rule} and '
                         f'F%128==0; got C={C}, {activation}, F={F}')
    dev = x.device
    kernels.require(x, 'x', torch.float32 if ln else torch.bfloat16, dev)
    if x.shape[-1] != C:
        raise ValueError(f'x: expected last dim {C}, got {x.shape[-1]}')
    kernels.require(w1, 'w1', torch.bfloat16, dev, (C, F))
    kernels.require(w2, 'w2', torch.bfloat16, dev, (F, C))
    kernels.require(b1, 'b1', torch.float32, dev, (F,))
    kernels.require(b2, 'b2', torch.float32, dev, (C,))
    M = x.numel() // C
    out = n = rstd = y = None
    if ln:
        for name, t in zip(('gamma', 'beta'), ln):
            kernels.require(t, name, torch.float32, dev, (C,))
        out = torch.empty_like(x)
        if stats:
            n = torch.empty_like(x)
            rstd = torch.empty(M, dtype=torch.float32, device=dev)
    else:
        y = torch.empty_like(x)
    hidden = hidden_scratch(M, F, C, dev, activation)
    keep = (torch.empty(keep_words_shape(M, F), dtype=torch.int32,
                        device=dev) if drop_h.on else None)
    lo, hi, site_h, threshold, scale = drop_h.c_args()
    kernels.launch('ppgs_ffn_ln', x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                   w2.data_ptr(), b2.data_ptr(),
                   ln[0].data_ptr() if ln else None,
                   ln[1].data_ptr() if ln else None, kernels.ptr(out),
                   kernels.ptr(n), kernels.ptr(rstd), kernels.ptr(y),
                   kernels.ptr(hidden), kernels.ptr(keep), M, F, C,
                   int(activation == 'gelu'), int(round_input), lo, hi,
                   site_h, drop_y.site, threshold, scale, device=dev)
    return (out, n, rstd, keep) if ln else (y, None, None, keep)


def ffn_residual_ln(x, w1, b1, w2, b2, scale, bias, round_input=False,
                    activation='relu'):
    """K4 on (..., C) fp32 x; returns fp32 of x's shape.
    ``ffn_residual_ln.widths`` counts the launches per C."""
    if x.device.type == 'cpu':
        return ffn_residual_ln_reference(x, w1, b1, w2, b2, scale, bias,
                                         round_input, activation)
    out, _, _, _ = _launch_ffn(x, w1, b1, w2, b2, (scale, bias),
                               round_input, activation=activation)
    ffn_residual_ln.launches += 1
    ffn_residual_ln.widths[w1.shape[0]] += 1
    return out


ffn_residual_ln.launches = 0
ffn_residual_ln.widths = collections.Counter()


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


###############################################################################
# Training: FFN with dropout, forward and backward (B6, and B4's FFN half)
###############################################################################
#
# Counterpart of ppgs_tpu/ops/fused_ffn.py ffn_train,
#     y = drop2(drop1(relu(x @ w1 + b1)) @ w2 + b2),
# and of the FFN half of ppgs_tpu/ops/encoder_layer_train.py, which ends in
# the second LayerNorm instead (``ln``). Two kernels, each with its plain
# version below: the forward (K4, kernels/csrc/ffn_ln.cu, with its dropout
# sites on), which also writes the hidden's keep bits as int32 words, and
# the backward (kernels/csrc/ffn_train.cu) that recomputes the hidden,
# reads those words (it draws no Philox) and writes hd and bf16(dh) for
# the weight-gradient products (ops/backward.py). The JAX kernel takes
# M % 512 == 0; these take any M.


def keep_words_shape(M, F):
    """The shape of the hidden's keep words that ``ffn_train_fwd`` hands the
    backward: F / 32 int32 words a row, bit k of word w for column
    32 w + k."""
    return (M, F // 32)


def bwd_mask_words(M, F, C):
    """The int32 words of ``ffn_train_bwd``'s scratch at width C: at 512
    its hd pass hands the dh pass a bit for each hidden element of each
    128-row block, two words a thread of the warpgroup that takes a chunk
    of 64 columns (bit 4j + e of word u: its accumulator register 4j + e
    of row tile u, kept and relu'd on); none at 256 (one launch) and at the
    others (the run-time route, whose dh pass reads the mask from hd: hd >
    0 exactly where the unit is kept and relu'd on)."""
    return -(-M // 128) * 128 * F // 32 if C == 512 else 0


# K4's hidden launch in its train forms at C = 512 (kernels/csrc/ffn_ln.cu
# hidden_train_kernel) is persistent: as many blocks as the card has SMs
# walk units of 128 rows x 128 hidden columns, each block its contiguous
# range of them (row block by row block, so that a block's x is staged
# once a row block and stays resident), W1 streaming through a ring of 16
# KB slots. These mirror its plan and its walk, which the CPU tests hold.
HIDDEN_UNIT = 128                  # a unit's rows, and its hidden columns
HIDDEN_TRAIN_WIDTH = 512
_SMEM_MAX = 232448


def hidden_train_plan(x_f32, C=HIDDEN_TRAIN_WIDTH):
    """hidden_train_kernel's shared memory (``HPlan``): x resident in bf16
    (C / 64 slabs of 128 rows x 64 columns), the two consumer warpgroups'
    two 64 x 64 output boxes, and a ring of 16 KB slots (a W1 item, or a
    box of x: an fp32 x takes two a depth step) in what is left of a
    block's 227 KB. Raises ValueError at a width it is not built for."""
    if C != HIDDEN_TRAIN_WIDTH:
        raise ValueError(f'the hidden launch\'s train form is built for C = '
                         f'{HIDDEN_TRAIN_WIDTH}, not {C}')
    slot, x_bytes, out_bytes = 16384, C // 64 * 128 * 128, 2 * 2 * 8192
    stages = (_SMEM_MAX - 1280 - x_bytes - out_bytes) // slot
    return {'stages': stages, 'x_slots': 2 if x_f32 else 1,
            'smem': x_bytes + out_bytes + stages * (slot + 16) + 16 + 1024}


def hidden_walk(M, F, blocks):
    """The units that each block of hidden_train_kernel's grid walks, in
    order, as (row block, first hidden column) pairs (``HWalk``): M rows in
    blocks of 128, F / 128 column tiles; the grid is ``blocks`` (the card's
    SMs), or the units if fewer. The ranges are contiguous and balanced to
    one unit; odd blocks walk theirs backwards."""
    nt = F // HIDDEN_UNIT
    units = -(-M // HIDDEN_UNIT) * nt
    grid = min(blocks, units)
    walks = []
    for b in range(grid):
        u0, u1 = b * units // grid, (b + 1) * units // grid
        order = range(u1 - 1, u0 - 1, -1) if b & 1 else range(u0, u1)
        walks.append([(u // nt, u % nt * HIDDEN_UNIT) for u in order])
    return walks


def _pack_words(keep):
    """(M, F) bool -> ``keep_words_shape`` int32."""
    M, F = keep.shape
    words = (keep.long().view(M, F // 32, 32)
             << torch.arange(32, device=keep.device)).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def _unpack_words(words, F):
    """``keep_words_shape`` int32 -> (M, F) bool."""
    shift = torch.arange(32, device=words.device)
    return ((words.long()[..., None] >> shift) & 1).reshape(
        words.shape[0], F).bool()


def keep_words_reference(drop, M, F, device=None):
    """Plain version of the hidden's keep words: ``drop.keep((M, F))``
    packed as ``keep_words_shape`` says."""
    return _pack_words(drop.keep((M, F), device))


def _round(t, cd):
    """t rounded to the compute dtype cd, kept in fp32."""
    return t.to(cd).float()


def _hidden(xc, w1, b1, cd):
    """relu(cd(cd(x @ w1) + cd(b1))) in fp32, as both TPU kernels round."""
    return torch.relu(_round(_round(xc @ w1.float(), cd)
                             + _round(b1.float(), cd), cd))


def _scale_in(drop, cd):
    """1 / (1 - rate) in the compute dtype: the TPU kernels multiply a
    compute-dtype hidden (and ffn_train's output) by it."""
    return float(torch.tensor(drop.scale).to(cd).float())


def ffn_train_fwd_reference(x, w1, b1, w2, b2, drop_h, drop_y, ln=None):
    """Plain version of ``ffn_train_fwd`` (w1's dtype is the compute
    dtype); its keep words are ``keep_words_reference``'s."""
    cd = w1.dtype
    C, F = w1.shape
    x2 = x.reshape(-1, C).float()
    M = x2.shape[0]
    h = _hidden(_round(x2, cd), w1, b1, cd)
    words = None
    if drop_h.on:
        keep = drop_h.keep((M, F), x.device)
        words = _pack_words(keep)
        h = torch.where(keep, _round(h * _scale_in(drop_h, cd), cd),
                        torch.zeros_like(h))
    acc = h @ w2.float()
    if ln is not None:
        y = acc + b2.float()
        if drop_y.on:
            y = torch.where(drop_y.keep((M, C), x.device), y * drop_y.scale,
                            torch.zeros_like(y))
        z = x2 + y
        zc = z - z.mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt((zc * zc).mean(dim=-1, keepdim=True) + LN_EPS)
        n = zc * rstd
        out = n * ln[0] + ln[1]
        return out.reshape(x.shape), n.reshape(x.shape), rstd[:, 0], words
    y = _round(_round(acc, cd) + _round(b2.float(), cd), cd)
    if drop_y.on:
        y = torch.where(drop_y.keep((M, C), x.device),
                        _round(y * _scale_in(drop_y, cd), cd),
                        torch.zeros_like(y))
    return y.to(cd).reshape(x.shape), None, None, words


def ffn_train_fwd(x, w1, b1, w2, b2, drop_h, drop_y, ln=None):
    """The FFN's training forward (K4, ``kernels/csrc/ffn_ln.cu``, with
    its dropout sites; ReLU); w1 (C, F), w2 (F, C) bf16, b1, b2 fp32, drop_h
    and drop_y the hidden and output Drops.

    ``ln`` = (gamma, beta), B4's form: x (..., C) fp32, returns
    (LN2(x + drop_y(y0)) fp32, the normalised rows, 1/std (M,), keep).
    ``ln`` None, ffn_train's form: x (..., C) bf16, returns
    (drop_y(y) bf16, None, None, keep). keep: the hidden's keep bits for
    ``ffn_train_bwd`` (``keep_words_shape`` int32), None at rate 0."""
    if x.device.type == 'cpu':
        return ffn_train_fwd_reference(x, w1, b1, w2, b2, drop_h, drop_y, ln)
    result = _launch_ffn(x, w1, b1, w2, b2, ln, False, drop_h, drop_y,
                         stats=True)
    ffn_train_fwd.launches += 1
    return result


ffn_train_fwd.launches = 0


def ffn_train_bwd_reference(x, dy, w1, b1, w2, drop_h, keep,
                            residual=None):
    """Plain version of ``ffn_train_bwd``: it reads the keep bits from
    ``keep`` (the forward's words) or, given None, draws them from
    ``drop_h``."""
    cd = w1.dtype
    C, F = w1.shape
    x2 = x.reshape(-1, C).float()
    M = x2.shape[0]
    h = _hidden(_round(x2, cd), w1, b1, cd)
    dhd = dy.reshape(M, C).float() @ w2.float().T
    hd = h
    if drop_h.on:
        keep = (drop_h.keep((M, F), x.device) if keep is None
                else _unpack_words(keep, F))
        zero = torch.zeros_like(h)
        hd = torch.where(keep, _round(h * _scale_in(drop_h, cd), cd), zero)
        dhd = torch.where(keep, dhd * drop_h.scale, zero)
    dh = torch.where(h > 0, dhd, torch.zeros_like(dhd))
    dhc = _round(dh, cd)
    dx = dhc @ w1.float().T
    dx = (dx + residual.reshape(M, C)) if residual is not None else dx.to(cd)
    return (dx.reshape(x.shape), hd.to(cd), dhc.to(cd),
            backward.block_sums(dh))


def ffn_train_bwd(x, dy, w1, b1, w2, drop_h, keep, residual=None):
    """The FFN's backward up to its input (``kernels/csrc/ffn_train.cu``:
    one launch at C = 256, three at 512, which hand a mask over through a
    scratch of ``bwd_mask_words``, and three at every other C, whose hidden
    passes read W1 as stored and W2 transposed): x as the forward took it,
    C under ``width_ok``, dy (..., C) bf16 the gradient of the dropped
    output, already masked, keep the forward's keep words (None at rate 0);
    recomputes the hidden. Returns (dx: fp32 plus ``residual`` for an fp32
    x, bf16 for a bf16 x; hd and bf16(dh), (M, F) bf16; db1 partial sums
    (ceil(M/64), F))."""
    if x.device.type == 'cpu':
        return ffn_train_bwd_reference(x, dy, w1, b1, w2, drop_h, keep,
                                       residual)
    C, F = w1.shape
    if not width_ok(C) or F % 128:
        raise ValueError(f'ffn_train kernel takes C % 128 == 0, 128 <= C <= '
                         f'{MAX_WIDTH}, F%128==0; got C={C}, F={F}')
    dev = x.device
    x_f32 = x.dtype == torch.float32
    if x_f32 != (residual is not None):
        raise ValueError('ffn_train_bwd takes a residual with an fp32 x, '
                         'and none with a bf16 x')
    kernels.require(x, 'x', x.dtype, dev)
    kernels.require(dy, 'dy', torch.bfloat16, dev, x.shape)
    kernels.require(w1, 'w1', torch.bfloat16, dev, (C, F))
    kernels.require(w2, 'w2', torch.bfloat16, dev, (F, C))
    kernels.require(b1, 'b1', torch.float32, dev, (F,))
    if residual is not None:
        kernels.require(residual, 'residual', torch.float32, dev, x.shape)
    M = x.numel() // C
    if drop_h.on:
        if keep is None:
            raise ValueError('keep: the forward\'s keep words are needed '
                             'with the dropout on')
        kernels.require(keep, 'keep', torch.int32, dev, keep_words_shape(M, F))
    dx = torch.empty(x.shape, dtype=torch.float32 if x_f32
                     else torch.bfloat16, device=dev)
    hd = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    dh = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((-(-M // backward.PARTIAL_ROWS), F),
                          dtype=torch.float32, device=dev)
    words = bwd_mask_words(M, F, C)
    mask = torch.empty(words, dtype=torch.int32, device=dev) if words else None
    # W1 transposed: its (F, C) rows are the operand form of both of the
    # kernel's products with it (the source's note); on the run-time route
    # (every C but 256 and 512) the hidden passes take W1 as stored and W2
    # transposed, (C, F) both
    any_route = C not in (256, 512)
    w1t = w1.t().contiguous()
    w2t = w2.t().contiguous() if any_route else None
    kernels.launch('ppgs_ffn_train_bwd', x.data_ptr(), int(x_f32),
                   dy.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
                   w2.data_ptr(), w1.data_ptr() if any_route else None,
                   kernels.ptr(w2t), kernels.ptr(keep if drop_h.on else None),
                   kernels.ptr(residual), dx.data_ptr() if x_f32 else None,
                   None if x_f32 else dx.data_ptr(), hd.data_ptr(),
                   dh.data_ptr(), partial.data_ptr(), kernels.ptr(mask), M,
                   F, C, float(drop_h.scale), device=dev)
    ffn_train_bwd.launches += 1
    return dx, hd, dh, partial


ffn_train_bwd.launches = 0


# The steps of ffn_train, as kernels (plain versions on CPU tensors) or plain
TRAIN_KERNELS = (ffn_train_fwd, ffn_train_bwd, backward.ln_dropout_bwd,
                 backward.gemm, backward.colsum)
TRAIN_PLAIN = (ffn_train_fwd_reference, ffn_train_bwd_reference,
               backward.ln_dropout_bwd_reference, backward.gemm_reference,
               backward.colsum_reference)


class _FFNTrain(torch.autograd.Function):
    """ffn_train's forward and the JAX custom_vjp's backward rule."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, drop_h, drop_y, ops):
        y, _, _, keep = ops[0](x, w1, b1.float(), w2, b2.float(), drop_h,
                               drop_y)
        ctx.save_for_backward(x, w1, b1, w2, keep)
        ctx.cfg = (drop_h, drop_y, ops)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w1, b1, w2, keep = ctx.saved_tensors
        drop_h, drop_y, ops = ctx.cfg
        _, ffn_bwd, ln_bwd, gemm_fn, colsum_fn = ops
        cd, C = x.dtype, x.shape[-1]
        # g = keep_y ? gy / (1 - rate) : 0, rounded for the products; db2
        # sums it unrounded
        _, gc, partial = ln_bwd(gy.contiguous(), None, None, None, drop_y,
                                cd, want_dz=False)
        db2 = colsum_fn(partial, round_to=cd)[2 * C:]
        dx, hd, dh, db1_part = ffn_bwd(x, gc, w1, b1.float(), w2, drop_h,
                                       keep)
        db1 = colsum_fn(db1_part, round_to=cd)
        dw1 = backward.weight_grad(x, dh, cd, gemm_fn, colsum_fn)
        dw2 = backward.weight_grad(hd, gc.reshape(hd.shape[0], C), cd, gemm_fn,
                          colsum_fn)
        return (dx, dw1.to(cd), db1.to(cd), dw2.to(cd), db2.to(cd), None,
                None, None)


def _ffn_train(x, w1, b1, w2, b2, dropout_rate, seed, site, ops):
    drop_h = dropout.Drop(seed, site, float(dropout_rate))
    shape = x.shape
    y = _FFNTrain.apply(x.reshape(-1, shape[-1]), w1, b1, w2, b2, drop_h,
                        drop_h.at(site + 1), ops)
    return y.reshape(shape)


def ffn_train(x, w1, b1, w2, b2, dropout_rate=0.0, seed=0, site=3):
    """Differentiable drop2(drop1(relu(x @ w1 + b1)) @ w2 + b2)
    (``ppgs_tpu/ops/fused_ffn.py::ffn_train``): x (..., C), the weights and
    biases all in the compute dtype, as the JAX caller casts them; the
    gradients come back in it too. The hidden's mask is the Philox stream
    of (seed, site), the output's of (seed, site + 1)."""
    return _ffn_train(x, w1, b1, w2, b2, dropout_rate, seed, site,
                      TRAIN_KERNELS)


def ffn_train_reference(x, w1, b1, w2, b2, dropout_rate=0.0, seed=0, site=3):
    """Plain version of ``ffn_train`` on any device."""
    return _ffn_train(x, w1, b1, w2, b2, dropout_rate, seed, site,
                      TRAIN_PLAIN)
