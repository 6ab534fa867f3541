"""The FFN train path's keep words on the CPU: K4's train form hands the
backward the hidden's keep bits as int32 words (``fused_ffn.keep_words_shape``),
and ``ffn_train_bwd`` reads them instead of drawing Philox again.

The kernels run only on a card (chip_smoke.py holds K4's words to Philox's
bits there, and the backward kernel to its plain version); here the plain
versions: the packing against ``Drop.keep`` bit for bit, and the plain
backward given the words against the same function drawing them, bit for
bit, in both of its forms (fp32 x with the residual, bf16 x), at both
train widths (C = 256: the mel model; 512: the w2v2fb and w2v2fc heads).
"""

import math

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

from ppgs_tpu_torch.ops import dropout, fused_ffn

C = 256
DROP = dropout.Drop(11, 3, 0.1)
ODD_M = (1, 63, 65, 129)


def _widths(*cases):
    """``cases`` (tuples of arguments) at each train width, C last: the
    C = 512 cases' ids end in -C512."""
    return [pytest.param(*case, width, id='-'.join(map(str, case)) + (
        '' if width == C else f'-C{width}'))
            for width in fused_ffn.TRAIN_BWD_WIDTHS for case in cases]


def _operands(M, F, seed=0, C=C):
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


@pytest.mark.parametrize('ln,C', _widths((False,), (True,)))
def test_train_fwd_reference_returns_the_keep_words(ln, C):
    """The plain forward's fourth output is the hidden's keep words in both
    forms (B4's LayerNorm form, ffn_train's bf16 form), None at rate 0."""
    M, F = 65, 384
    x, _, w1, b1, w2, _ = _operands(M, F, C=C)
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


@pytest.mark.parametrize('M,F,form,C', _widths(
    *((M, F, form) for form in ('fp32', 'bf16')
      for M, F in ((1, 128), (65, 384), (129, 128)))))
def test_bwd_reference_given_the_words_equals_drawing_them(M, F, form, C):
    """``ffn_train_bwd_reference`` given the forward's words returns what
    it returns drawing the bits itself (keep None), bit for bit: dx, hd,
    bf16(dh) and the db1 partial sums."""
    x, dy, w1, b1, w2, res = _operands(M, F, seed=M, C=C)
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


@pytest.mark.parametrize('form,C', _widths(('fp32',), ('bf16',)))
def test_bwd_reference_reads_the_words_it_is_given(form, C):
    """Words that keep nothing give hd = bf16(dh) = 0, db1 = 0 and dx = the
    residual (or 0): the plain backward takes its bits from the words, not
    from the Drop, when it has them."""
    M, F = 63, 128
    x, dy, w1, b1, w2, res = _operands(M, F, seed=3, C=C)
    if form == 'bf16':
        x, res = x.to(torch.bfloat16), None
    none_kept = torch.zeros(fused_ffn.keep_words_shape(M, F),
                            dtype=torch.int32)
    dx, hd, dh, part = fused_ffn.ffn_train_bwd_reference(
        x, dy, w1, b1, w2, DROP, none_kept, res)
    assert not hd.any() and not dh.any() and not part.any()
    assert torch.equal(dx.float(), res if res is not None
                       else torch.zeros(M, C))


def _mask_cells(M, F):
    """Replay of the mask scratch's layout at C = 512 (ffn_train.cu's hd
    and dh passes): word 2 x + u of chunk f's 256 words of block b belongs
    to thread x of the warpgroup that walks chunk f, row tile u; its bit
    4j + e is that thread's accumulator register 4j + e: row 128 b + 64 u +
    16 (x // 32) + (x % 32) // 4 + 8 (e // 2), column 64 f + 8 j + 2 (x %
    4) + e % 2. Returns the (row, column) of every bit, in scratch
    order."""
    blocks, chunks = -(-M // 128), F // 64
    b, f, x, u, j, e = np.meshgrid(
        np.arange(blocks), np.arange(chunks), np.arange(128), np.arange(2),
        np.arange(8), np.arange(4), indexing='ij')
    lane = x % 32
    row = 128 * b + 64 * u + 16 * (x // 32) + lane // 4 + 8 * (e // 2)
    col = 64 * f + 8 * j + 2 * (lane % 4) + e % 2
    return row.ravel(), col.ravel()


@pytest.mark.parametrize('M,F', [(1, 128), (127, 128), (129, 384),
                                 (1000, 2048), (131072, 2048)])
def test_bwd_mask_scratch_holds_a_bit_for_every_hidden_element(M, F):
    """``bwd_mask_words`` sizes the scratch that the hd pass hands the dh
    pass at C = 512: 256 words a block of 128 rows a chunk of 64 hidden
    columns, one bit for each (row, column) of every block's rows (rows past
    M included: the passes' zero rows), none at C = 256 (one launch)."""
    assert fused_ffn.bwd_mask_words(M, F, 256) == 0
    words = fused_ffn.bwd_mask_words(M, F, 512)
    blocks = -(-M // 128)
    assert words == blocks * (F // 64) * 256
    assert words * 32 == blocks * 128 * F >= M * F
    if M * F <= 1000 * 2048:
        row, col = _mask_cells(M, F)
        assert row.size == words * 32
        cells = row * F + col
        assert np.unique(cells).size == cells.size
        assert cells.min() == 0 and cells.max() == blocks * 128 * F - 1


@pytest.mark.parametrize('M,F,blocks', [
    (1, 128, 132), (127, 384, 132), (129, 2048, 7), (1000, 2048, 132),
    (1000, 384, 5), (2597, 2048, 132), (131072, 2048, 132),
    (131072 - 65, 2048, 131)])
def test_hidden_walk_takes_every_unit_once(M, F, blocks):
    """K4's persistent hidden launch (C = 512 train forms): the blocks'
    walks cover every (row block, column tile) of M rows and F hidden
    columns once, in ranges balanced to one unit (a last wave that is not
    full takes the shorter ranges), each row block in one contiguous run
    of a walk (its x staged once there), M not a multiple of 128 included
    (the last block's rows past M are TMA's zeros)."""
    walks = fused_ffn.hidden_walk(M, F, blocks)
    rows, tiles = -(-M // 128), F // 128
    units = [u for walk in walks for u in walk]
    assert len(units) == len(set(units)) == rows * tiles
    assert set(units) == {(r, 128 * c) for r in range(rows)
                          for c in range(tiles)}
    lengths = [len(walk) for walk in walks]
    assert len(walks) == min(blocks, rows * tiles)
    assert max(lengths) - min(lengths) <= 1
    for walk in walks:
        rows = [r for r, _ in walk]
        runs = [r for i, r in enumerate(rows) if i == 0 or r != rows[i - 1]]
        assert len(runs) == len(set(runs))


@pytest.mark.parametrize('x_f32', [True, False])
def test_hidden_train_plan_fits_a_block(x_f32):
    """hidden_train_kernel's shared memory: x resident (128 KB of bf16 at C
    = 512), the output boxes, and at least two ring slots, within a block's
    227 KB; an fp32 x takes two slots a depth step, a bf16 one one."""
    plan = fused_ffn.hidden_train_plan(x_f32)
    assert plan['stages'] >= 2
    assert plan['smem'] <= 232448
    assert plan['x_slots'] == (2 if x_f32 else 1)


@pytest.mark.parametrize('C', [256, 768, 1024])
def test_hidden_train_plan_refuses_other_widths(C):
    """The persistent hidden launch is built for C = 512 alone (C = 256 is
    the fused kernel's; 768 has no train form)."""
    with pytest.raises(ValueError):
        fused_ffn.hidden_train_plan(True, C)


def _train_operands(M, C, F, x_dtype=torch.float32):
    """x, w1, b1, w2, b2 of K4's train forms, zeros of the kernel's types
    (the shapes are what the checks read)."""
    return (torch.zeros(M, C, dtype=x_dtype),
            torch.zeros(C, F, dtype=torch.bfloat16), torch.zeros(F),
            torch.zeros(F, C, dtype=torch.bfloat16), torch.zeros(C))


@pytest.mark.parametrize('C,F,ln,x_dtype,match', [
    (512, 200, True, torch.float32, 'F%128'),
    (512, 2048, True, torch.bfloat16, 'x: expected'),
    (512, 2048, False, torch.float32, 'x: expected'),
    (768, 3072, False, torch.bfloat16, 'ffn_ln kernel takes'),
    (384, 2048, True, torch.float32, 'ffn_ln kernel takes')])
def test_train_launch_refuses_what_the_kernels_do_not_take(C, F, ln, x_dtype,
                                                          match):
    """K4's train forms refuse, before any launch, a hidden width that is
    not a multiple of 128, an x of the other form's type (B4's fp32, B6's
    bf16), and a width without a train instance (768 has no bf16 output,
    384 no instance at all)."""
    x, w1, b1, w2, b2 = _train_operands(3, C, F, x_dtype)
    ln_args = (torch.ones(C), torch.zeros(C)) if ln else None
    drop = dropout.Drop(1, 3, 0.1)
    with pytest.raises(ValueError, match=match):
        fused_ffn._launch_ffn(x, w1, b1, w2, b2, ln_args, False, drop,
                              drop.at(4), stats=True)
