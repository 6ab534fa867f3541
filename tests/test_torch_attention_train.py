"""The train attention's plain versions (``ppgs_tpu_torch/ops/
flash_attention.py``: ``attention_train_fwd_reference``, ``row_dot_reference``,
``attention_train_bwd_reference``) against the JAX package's
``flash_attention_train`` and its custom_vjp in interpret mode, on the CPU,
at rate 0; the plain forward's contract (bf16 o the fp32 o rounded, a
wholly masked window 0); and the forward and backward wrappers' argument
checks, which run before anything is launched.

The CUDA kernels run only on a card: chip_smoke.py holds the forward
(``kernels/csrc/attention_train.cu``) and the backward
(``kernels/csrc/attention_train_bwd.cu``) against these same plain versions
there, at these T, masks and causal settings, with dropout off and 0.1.
Tolerance: fp32 at rtol and atol 1e-4, the envelope of
tests/test_torch_train_kernels.py::test_flash_attention_train_matches_jax_kernel.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppgs_tpu.ops import flash_attention as jax_fa

from ppgs_tpu_torch.ops import dropout
from ppgs_tpu_torch.ops import flash_attention as fa

H, D = 2, fa.D_HEAD             # the train kernels' head width
C = H * D
# T about the kernels' 64-row tiles and 128-row blocks, and the per-layer
# path's window
T_EDGES = (1, 63, 64, 65, 127, 129, 500)


def _inputs(seed, T):
    """q, k, v, dO (4, T, C) fp32 and a (4, T) mask: a ragged prefix, a mask
    with holes (one whole 64-key tile masked where T reaches it), a wholly
    masked window, and a full one."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((4, T, C)).astype(np.float32)
                   for _ in range(4))
    keys = np.arange(T)
    mask = np.stack([keys < max(1, (2 * T) // 3),
                     rng.random(T) < 0.6,
                     np.zeros(T, bool),
                     np.ones(T, bool)])
    mask[1, 64:128] = False
    return q, k, v, do, mask


def _jax_train(q, k, v, do, mask, causal):
    """JAX flash_attention_train's output and its vjp of dO, on T padded to
    a multiple of 8 (its pad + mask at the call site): the padded keys are
    masked, their rows get a zero cotangent, the first T rows returned."""
    T = q.shape[1]
    pad = -T % 8
    wide = [jnp.asarray(np.pad(a, ((0, 0), (0, pad), (0, 0))))
            for a in (q, k, v, do)]
    wide_mask = jnp.asarray(np.pad(mask, ((0, 0), (0, pad))))

    def attend(q_, k_, v_):
        return jax_fa.flash_attention_train(
            q_, k_, v_, wide_mask, H, dropout_rate=0.0, causal=causal,
            interpret=True)

    out, vjp = jax.vjp(attend, *wide[:3])
    grads = vjp(wide[3])
    return [np.asarray(a)[:, :T] for a in (out, *grads)]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('T', T_EDGES)
def test_train_references_match_jax_kernel(T, causal):
    """o from the forward's plain version, then dq, dk, dv from the
    backward's on its lse and d_row (the steps of ``_FlashTrain``); lse
    itself is not compared: the port's is in log2 units and 0 on a row with
    no valid key, JAX's natural-log and near -1e29 there."""
    q, k, v, do, mask = _inputs(T, T)
    want = _jax_train(q, k, v, do, mask, causal)
    tq, tk, tv, tdo, tm = (torch.from_numpy(a) for a in (q, k, v, do, mask))
    sm = 1.0 / math.sqrt(D)
    drop = dropout.Drop(0, 1, 0.0)
    o, _, lse, keep = fa.attention_train_fwd_reference(
        tq, tk, tv, tm, H, fa.LOG2E * sm, causal, drop)
    d_row = fa.row_dot_reference(tdo, o, H)
    _, d32 = fa.attention_train_bwd_reference(
        tq, tk, tv, tm, lse, keep, tdo, d_row, H, fa.LOG2E * sm, sm, causal,
        drop, want_c=False, want32=True)
    got = [o, d32[..., :C], d32[..., C:2 * C], d32[..., 2 * C:]]
    for name, a, b in zip(('o', 'dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    # the wholly masked window: no output and no gradient
    assert not d32[2].any() and not o[2].any()


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('T', T_EDGES)
def test_train_fwd_reference_contract(T, causal):
    """What chip_smoke.py holds the forward kernel to besides the values:
    the bf16 o is the fp32 o rounded, the wholly masked window gives o = 0
    and lse = 0, and without want_f32 the wrapper (its plain version on a
    CPU tensor) gives the same o and lse and no fp32 o; with the dropout
    off and at 0.1 (the plain forward draws no keep words: the plain
    backward draws its own)."""
    q, k, v, _, mask = _inputs(T + 1, T)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    tm = torch.from_numpy(mask)
    sl = fa.LOG2E / math.sqrt(D)
    for rate in (0.0, 0.1):
        drop = dropout.Drop(3, 1, rate)
        o, o32, lse, keep = fa.attention_train_fwd_reference(
            tq, tk, tv, tm, H, sl, causal, drop, want_f32=True)
        assert keep is None
        assert o.dtype == torch.bfloat16 and o32.dtype == torch.float32
        assert tuple(lse.shape) == (4, H, T)
        assert torch.equal(o, o32.to(torch.bfloat16))
        assert not o32[2].any() and not lse[2].any()
        assert torch.isfinite(o32).all() and lse[3].abs().min() > 0
        got = fa.attention_train_fwd(tq, tk, tv, tm, H, sl, causal, drop)
        assert got[1] is None and got[3] is None
        assert torch.equal(got[0], o) and torch.equal(got[2], lse)


_DROP = dropout.Drop(1, 1, 0.1)


def _args(B=2, T=70, extra=0, offset=0, dtype=torch.bfloat16, do_extra=0):
    """The backward's operands as the whole-layer path passes them: q, k, v
    views of one (B, T, 3C + extra) buffer from column ``offset``, a valid
    mask, lse, the keep words, dout (a view of a (B, T, C + do_extra)
    buffer) and d_row."""
    buf = torch.zeros(B, T, 3 * C + extra, dtype=dtype)
    q, k, v = (buf[..., offset + i * C:offset + (i + 1) * C]
               for i in range(3))
    dout = torch.zeros(B, T, C + do_extra, dtype=torch.bfloat16)[..., :C]
    rows = torch.zeros(B, H, T)
    keep = torch.zeros(fa.keep_words_shape(B, H, T), dtype=torch.int32)
    return (q, k, v, torch.ones(B, T, dtype=torch.bool), rows, keep, dout,
            rows.clone())


def test_train_bwd_args_take_fused_views():
    assert fa._train_bwd_args(*_args(), H, _DROP) == (3 * C, C)
    assert fa._train_bwd_args(*_args(do_extra=8), H, _DROP) == (3 * C, C + 8)
    # with the dropout off the keep words are not read
    no_keep = _replace(_args(), 5, None)
    assert fa._train_bwd_args(*no_keep, H, dropout.Drop(1, 1, 0.0)) == (
        3 * C, C)


def _replace(args, i, value):
    return args[:i] + (value,) + args[i + 1:]


_a = _args()
_q16 = torch.zeros(2, 70, C, dtype=torch.bfloat16)
_rows = torch.zeros(2, H, 70)
_keep = _a[5]


@pytest.mark.parametrize('args,heads,match', [
    (_a, 4, 'd_head=128'),                                   # d_head 64
    (_a, 1, 'd_head=128'),                                   # d_head 256
    (_args(dtype=torch.float32), H, 'q: expected torch.bfloat16'),
    (_replace(_a, 1, _a[1].float()), H, 'k: expected torch.bfloat16'),
    (_replace(_a, 2, _a[2][:, :69]), H, 'v: expected shape'),
    (_replace(_a, 0, _q16), H, 'one row stride'),            # rs C vs 3C
    (_args(extra=1, offset=1), H, '16-byte aligned'),        # base + 2 bytes
    (_args(extra=4), H, '16-byte aligned'),                  # rs % 8 == 4
    (_replace(_a, 0, _q16.transpose(0, 1).contiguous().transpose(0, 1)),
     H, '16-byte aligned'),                                  # windows apart
    (_replace(_a, 0, torch.zeros(2, 70, 2 * C, dtype=torch.bfloat16)
              [..., ::2]), H, '16-byte aligned'),            # column stride 2
    (_replace(_a, 6, _a[6].float()), H, 'dout: expected bfloat16'),
    (_replace(_a, 6, _q16[:, :69]), H, 'dout: expected shape'),
    (_args(do_extra=4), H, '16-byte aligned'),               # dout rs % 8
    (_replace(_a, 6, torch.zeros(2, 70, C + 1, dtype=torch.bfloat16)
              [..., 1:]), H, '16-byte aligned'),             # dout base
    (_replace(_a, 3, torch.ones(2, 69, dtype=torch.bool)), H,
     'mask: expected shape'),
    (_replace(_a, 3, _a[3].to(torch.uint8)), H, 'mask: expected'),
    (_replace(_a, 3, torch.ones(70, 2, dtype=torch.bool).T), H,
     'mask: expected a contiguous'),
    (_replace(_a, 4, _rows.double()), H, 'lse: expected torch.float32'),
    (_replace(_a, 4, torch.zeros(2, 70, H)), H, 'lse: expected shape'),
    (_replace(_a, 4, torch.zeros(2, 70, H).transpose(1, 2)), H,
     'lse: expected a contiguous'),
    (_replace(_a, 7, _rows.to(torch.bfloat16)), H,
     'd_row: expected torch.float32'),
    (_replace(_a, 7, torch.zeros(2, H, 69)), H, 'd_row: expected shape'),
    (_replace(_a, 5, None), H, 'keep: the forward'),
    (_replace(_a, 5, _keep.long()), H, 'keep: expected torch.int32'),
    (_replace(_a, 5, _keep[:, :, :69]), H, 'keep: expected'),
    (_replace(_a, 5, torch.zeros(2, H, 70, 2, dtype=torch.int32)), H,
     'keep: expected shape'),                        # 2 words a row, not 4
])
def test_train_bwd_args_refuse_what_the_kernel_does_not_take(args, heads,
                                                             match):
    """A head width, dtype, shape, row stride, alignment or layout that the
    backward kernel does not take raises before anything is launched (the
    checks need no card)."""
    with pytest.raises(ValueError, match=match):
        fa._train_bwd_args(*args, heads, _DROP)


@pytest.mark.parametrize('T', (1, 63, 65, 127, 129, 130))
def test_keep_words_reference_packs_drop_keep(T):
    """The plain keep words hold ``Drop.keep`` bit for bit: bit k of word w
    of a query row is key 32 w + k, and the bits past T are 0 (odd T puts
    a Philox group of four across two rows)."""
    B, drop = 2, dropout.Drop(5, 3, 0.3)
    words = fa.keep_words_reference(drop, B, H, T)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == fa.keep_words_shape(B, H, T)
    bits = (words.long()[..., None] >> torch.arange(32)) & 1
    bits = bits.reshape(B, H, T, -1).bool()
    assert torch.equal(bits[..., :T], drop.keep((B, H, T, T)))
    assert not bits[..., T:].any()


def test_train_fwd_args_take_fused_views():
    q, k, v, mask = _args()[:4]
    assert fa._train_fwd_args(q, k, v, mask, H) == 3 * C
    separate = [torch.zeros(2, 70, C, dtype=torch.bfloat16) for _ in range(3)]
    assert fa._train_fwd_args(*separate, mask, H) == C
    wide = _args(T=fa.TRAIN_MAX_T)
    assert fa._train_fwd_args(*wide[:4], H) == 3 * C


def _fwd(args):
    return args[:4]


@pytest.mark.parametrize('args,heads,match', [
    (_fwd(_a), 4, 'd_head=128'),                             # d_head 64
    (_fwd(_a), 1, 'd_head=128'),                             # d_head 256
    (_fwd(_args(dtype=torch.float32)), H, 'q: expected torch.bfloat16'),
    (_fwd(_replace(_a, 1, _a[1].float())), H, 'k: expected torch.bfloat16'),
    (_fwd(_replace(_a, 2, _a[2][:, :69])), H, 'v: expected shape'),
    (_fwd(_replace(_a, 0, _q16)), H, 'one row stride'),      # rs C vs 3C
    (_fwd(_args(extra=1, offset=1)), H, '16-byte aligned'),  # base + 2 bytes
    (_fwd(_args(extra=4)), H, '16-byte aligned'),            # rs % 8 == 4
    (_fwd(_replace(_a, 0, _q16.transpose(0, 1).contiguous().transpose(0, 1))),
     H, '16-byte aligned'),                                  # windows apart
    (_fwd(_replace(_a, 0, torch.zeros(2, 70, 2 * C, dtype=torch.bfloat16)
                   [..., ::2])), H, '16-byte aligned'),      # column stride 2
    (_fwd(_replace(_a, 3, torch.ones(2, 69, dtype=torch.bool))), H,
     'mask: expected shape'),
    (_fwd(_replace(_a, 3, _a[3].to(torch.uint8))), H, 'mask: expected'),
    (_fwd(_replace(_a, 3, torch.ones(70, 2, dtype=torch.bool).T)), H,
     'mask: expected a contiguous'),
    (_fwd(_args(T=fa.TRAIN_MAX_T + 8)), H, 'T <= 1024'),      # past the limit
])
def test_train_fwd_args_refuse_what_the_kernel_does_not_take(args, heads,
                                                             match):
    """A head width, dtype, shape, row stride, alignment, mask layout or T
    that the forward kernel does not take raises before anything is
    launched (the checks need no card)."""
    with pytest.raises(ValueError, match=match):
        fa._train_fwd_args(*args, heads)
