"""The FFN train path's keep words on the CPU: K4's train form hands the
backward the hidden's keep bits as int32 words (``fused_ffn.keep_words_shape``),
and ``ffn_train_bwd`` reads them instead of drawing Philox again.

The kernels run only on a card (chip_smoke.py holds K4's words to Philox's
bits there, and the backward kernel to its plain version); here the plain
versions: the packing against ``Drop.keep`` bit for bit, and the plain
backward given the words against the same function drawing them, bit for
bit, in both of its forms (fp32 x with the residual, bf16 x).
"""

import math

import numpy as np
import pytest
import torch

from ppgs_tpu_torch.ops import dropout, fused_ffn

C = 256
DROP = dropout.Drop(11, 3, 0.1)
ODD_M = (1, 63, 65, 129)


def _operands(M, F, seed=0):
    """x fp32, dy bf16, w1, b1, w2 (bf16 weights), a residual: seeded numpy
    draws."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    return (t((M, C)), t((M, C)).to(torch.bfloat16),
            t((C, F), 1 / 16).to(torch.bfloat16), t((F,), 0.1),
            t((F, C), 1 / math.sqrt(F)).to(torch.bfloat16), t((M, C)))


def _bits(words, F):
    """(M, F / 32) int32 words -> (M, F) bool: bit k of word w is column
    32 w + k."""
    u = words.numpy().view(np.uint32)
    bits = (u[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(u.shape[0], F).astype(bool)


@pytest.mark.parametrize('F', [128, 384])
@pytest.mark.parametrize('M', ODD_M)
def test_keep_words_pack_the_hidden_mask(M, F):
    """``keep_words_reference`` holds ``Drop.keep((M, F))``: bit k of word w
    of a row is column 32 w + k."""
    words = fused_ffn.keep_words_reference(DROP, M, F)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == fused_ffn.keep_words_shape(M, F) == (M,
                                                                      F // 32)
    np.testing.assert_array_equal(_bits(words, F), DROP.keep((M, F)).numpy())


@pytest.mark.parametrize('ln', [False, True])
def test_train_fwd_reference_returns_the_keep_words(ln):
    """The plain forward's fourth output is the hidden's keep words in both
    forms (B4's LayerNorm form, ffn_train's bf16 form), None at rate 0."""
    M, F = 65, 384
    x, _, w1, b1, w2, _ = _operands(M, F)
    b2 = torch.zeros(C)
    args = ((x, w1, b1, w2, b2) if ln else
            (x.to(torch.bfloat16), w1, b1, w2, b2))
    norm = (torch.ones(C), torch.zeros(C)) if ln else None
    *_, words = fused_ffn.ffn_train_fwd_reference(*args, DROP, DROP.at(4),
                                                  norm)
    assert torch.equal(words, fused_ffn.keep_words_reference(DROP, M, F))
    *_, none = fused_ffn.ffn_train_fwd_reference(
        *args, dropout.OFF, dropout.OFF, norm)
    assert none is None


@pytest.mark.parametrize('form', ['fp32', 'bf16'])
@pytest.mark.parametrize('M,F', [(1, 128), (65, 384), (129, 128)])
def test_bwd_reference_given_the_words_equals_drawing_them(M, F, form):
    """``ffn_train_bwd_reference`` given the forward's words returns what
    it returns drawing the bits itself (keep None), bit for bit: dx, hd,
    bf16(dh) and the db1 partial sums."""
    x, dy, w1, b1, w2, res = _operands(M, F, seed=M)
    if form == 'bf16':
        x, res = x.to(torch.bfloat16), None
    words = fused_ffn.keep_words_reference(DROP, M, F)
    given = fused_ffn.ffn_train_bwd_reference(x, dy, w1, b1, w2, DROP, words,
                                              res)
    drawn = fused_ffn.ffn_train_bwd_reference(x, dy, w1, b1, w2, DROP, None,
                                              res)
    assert given[0].dtype == (torch.float32 if form == 'fp32'
                              else torch.bfloat16)
    for got, want in zip(given, drawn):
        assert torch.equal(got, want)


@pytest.mark.parametrize('form', ['fp32', 'bf16'])
def test_bwd_reference_reads_the_words_it_is_given(form):
    """Words that keep nothing give hd = bf16(dh) = 0, db1 = 0 and dx = the
    residual (or 0): the plain backward takes its bits from the words, not
    from the Drop, when it has them."""
    M, F = 63, 128
    x, dy, w1, b1, w2, res = _operands(M, F, seed=3)
    if form == 'bf16':
        x, res = x.to(torch.bfloat16), None
    none_kept = torch.zeros(fused_ffn.keep_words_shape(M, F),
                            dtype=torch.int32)
    dx, hd, dh, part = fused_ffn.ffn_train_bwd_reference(
        x, dy, w1, b1, w2, DROP, none_kept, res)
    assert not hd.any() and not dh.any() and not part.any()
    assert torch.equal(dx.float(), res if res is not None
                       else torch.zeros(M, C))
