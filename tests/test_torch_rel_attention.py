"""B8 (``ppgs_tpu_torch/ops/flash_attention.py::rel_attention``,
``kernels/csrc/rel_attention.cu``) on the CPU: its plain version against
the JAX package's einsum and Pallas kernel, the closed form of the legacy
shift that the kernel reads its position term by, and the layouts its
wrapper hands the kernel.

The kernel itself runs only on the card (``chip_smoke.py`` phase 12 holds
it against ``rel_attention_reference``); here its index algebra is
replayed in numpy, tile by tile and warpgroup by warpgroup, and held bit
for bit against ``rel_shift(q_v pos^T)``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

from ppgs_tpu.ops import flash_attention as jax_fa
from ppgs_tpu_torch.models import conformer
from ppgs_tpu_torch.ops import flash_attention as fa

H, DK = 4, 36


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _inputs(seed, B, T):
    """q_u, k, v, q_v (B, T, H, d_k) and pos (T, H, d_k), rounded to bf16."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, T, H, DK)) for _ in range(4)]
    arrays.append(rng.standard_normal((T, H, DK)))
    return [np.asarray(torch.from_numpy(a.astype(np.float32))
                       .to(torch.bfloat16).float()) for a in arrays]


@pytest.mark.parametrize('T,lengths', [
    (64, [64, 40, 0]),              # ragged, one wholly masked row
    (72, [72, 1, 0]),               # one valid key, one wholly masked row
    (72, [72, 59]),                 # ragged, every row live
])
def test_rel_attention_reference_matches_jax(T, lengths):
    """The plain version (the position term by ``position_term``, then the
    bias form) against JAX's chip path: ``einsum(q_v, pad(pos))`` in bf16,
    then ``fused_attention_bias(..., legacy_shift=True)`` in interpret
    mode. Both round the term and p / denom to bf16, so the outputs differ
    by rounding flips: atol 1e-2 on outputs of typical size 0.3, relative
    L2 <= 2^-8, as the bias form's own test."""
    B = len(lengths)
    q_u, k, v, q_v, pos = _inputs(T, B, T)
    mask = np.arange(T)[None] < np.asarray(lengths)[:, None]
    bf16 = [jnp.asarray(a, jnp.bfloat16) for a in (q_u, k, v, q_v, pos)]
    jq_v = bf16[3].transpose(0, 2, 1, 3)                  # (B, H, T, d_k)
    jpos = jnp.pad(bf16[4].transpose(1, 0, 2)[None],
                   ((0, 0), (0, 0), (1, 0), (0, 0)))
    bias = jnp.einsum('bhqd,bhkd->bhqk', jq_v, jpos).reshape(B, H, T + 1, T)
    want = np.asarray(jax_fa.fused_attention_bias(
        *bf16[:3], bias, jnp.asarray(mask), H, legacy_shift=True,
        interpret=True), np.float32)
    args = [torch.from_numpy(a).to(torch.bfloat16)
            for a in (q_u, k, v, q_v, pos)]
    calls = fa.position_term.calls
    got = fa.rel_attention(*args, torch.from_numpy(mask), H)
    assert fa.position_term.calls == calls + 1        # the plain version ran
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, DK)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert _rel_l2(got, want) <= 2 ** -8
    dead = np.asarray(lengths) == 0
    assert not got[dead].any()


def shift_by_bands(bd, BQ, BK=64):
    """The shifted term of one head as B8 reads it, from the unshifted bd =
    q_v pos^T (T, T): for each block of BQ query rows (BQ / 64 warpgroups),
    the block's sequence of 64-position pos boxes (box m the lower part's
    from T - q0 - BQ + 64 m while m <= td0 + BQ / 64 - 1, td0 = q0 / 64,
    else the upper part's from 64 m - q0 - BQ - 1); for each key tile t of
    BK keys, warpgroup c's band of 128 columns from boxes t + BQ / 64 - 1 -
    c (half A) and t + BQ / 64 - c (half B), each half the product of its
    box's positions with q_v rows i0 .. (lower) or i0 + 1 .. (upper), zero
    for a row or position outside [0, T) (TMA's zero fill); then row r, key
    c at band column 63 - r + c. Half A of tile t + 1 must equal half B of
    tile t, which the kernel keeps in place of forming it again. Returns
    (the term, the (tile - diagonal tile, lower, half) triples the walk
    took at and after the diagonal)."""
    T = bd.shape[0]
    wgs = BQ // 64

    def product(rows, positions):
        ok = ((rows >= 0) & (rows < T))[:, None] & (
            (positions >= 0) & (positions < T))[None]
        return np.where(ok, bd[np.clip(rows, 0, T - 1)][
            :, np.clip(positions, 0, T - 1)], 0.0)

    out = np.full((T, T), np.nan)
    r = np.arange(64)[:, None]
    cols = np.arange(BK)[None]
    diagonal = set()
    for q0 in range(0, T, BQ):
        td0 = q0 // BK
        kept = {}

        def box(m):
            lower = m <= td0 + wgs - 1
            return lower, (T - q0 - BQ + 64 * m if lower
                           else 64 * m - q0 - BQ - 1)

        for t in range(-(-T // BK)):
            for c in range(wgs):
                i0 = q0 + 64 * c
                if i0 >= T:
                    continue
                td = td0 + c
                band = np.empty((64, 128))
                for half in (0, 1):
                    lower, start = box(t + wgs - 1 - c + half)
                    # the consumer's choice of q_v tile agrees with the box
                    assert lower == (t <= td if half == 0 else t < td)
                    rows = i0 + np.arange(64) + (0 if lower else 1)
                    band[:, 64 * half:64 * (half + 1)] = product(
                        rows, start + np.arange(64))
                    if t in (td, td + 1):
                        diagonal.add((t - td, lower, half))
                if c in kept:
                    assert np.array_equal(band[:, :64], kept[c])
                kept[c] = band[:, 64:]
                vals = band[r, 63 - r + cols]
                i, j = (i0 + r + 0 * cols), (t * BK + cols + 0 * r)
                keep = (i < T) & (j < T)
                out[i[keep], j[keep]] = vals[keep]
    return out, diagonal


@pytest.mark.parametrize('BQ', [64, 128, 192])
@pytest.mark.parametrize('T', [1, 7, 63, 64, 65, 130, 803])
def test_shift_by_bands_is_rel_shift(T, BQ):
    """The kernel's index algebra, bit for bit: the band start of each part,
    the skew column 63 - r + c, the three cases (j <= i, j = i + 1 from the
    zero at position -1, j >= i + 2 from q_v row i + 1), the zero-filled
    edges and half B kept as the next tile's half A, against
    ``rel_shift(q_v pos^T)`` on one head."""
    rng = np.random.default_rng(T)
    q_v = rng.standard_normal((T, DK))
    pos = rng.standard_normal((T, DK))
    bd = q_v @ pos.T
    got, diagonal = shift_by_bands(bd, BQ)
    want = conformer.rel_shift(torch.from_numpy(bd)[None, None])[0, 0]
    np.testing.assert_array_equal(got, want.numpy())
    # The diagonal tile takes half A from the lower part and half B from
    # the upper; the tile after it both halves from the upper
    assert {(0, True, 0), (0, False, 1)} <= diagonal
    assert not {(0, True, 1), (0, False, 0), (1, True, 0),
                (1, True, 1)} & diagonal


def test_the_conformer_hands_b8_views_it_reads_in_place():
    """The layouts ``conformer._rel_attention`` hands ``rel_attention``: q_u
    a fresh tensor, k and v views of the fused QKV product (864-byte rows),
    q_v and pos the memory behind ``attention_inputs``' transposed views;
    each passes the wrapper's TMA checks with the row strides the kernel is
    given, and a misaligned view or a heads-first one is refused."""
    B, T, C = 2, 40, H * DK
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    w = types.SimpleNamespace(wqkv=rand(C, 3 * C), bqkv=rand(3 * C),
                              wpos=rand(C, C), pos_bias_u=rand(H, DK),
                              pos_bias_v=rand(H, DK))
    x = torch.randn(B, T, C, generator=gen)
    pos_emb = torch.from_numpy(conformer.rel_pos_table(T, C))[None]
    q_u, k, v, q_v, pos = conformer.attention_inputs(
        x, pos_emb, w, H, torch.bfloat16)
    cpu = torch.device('cpu')
    shape = (B, T, H, DK)
    assert fa._tma_rows(q_u, 'q_u', shape, cpu) == C
    assert fa._tma_rows(k, 'k', shape, cpu) == 3 * C
    assert fa._tma_rows(v, 'v', shape, cpu) == 3 * C
    assert fa._tma_rows(q_v.transpose(1, 2), 'q_v', shape, cpu) == C
    assert fa._tma_rows(pos[0].transpose(0, 1), 'pos', (T, H, DK), cpu) == C
    with pytest.raises(ValueError, match='contiguous'):
        fa._tma_rows(q_v, 'q_v', (B, H, T, DK), cpu)
    # One frame: the view's stride along T is any, its rows 3C apart still
    one = rand(B, 1, 3 * C)[..., C:2 * C].unflatten(-1, (H, DK))
    assert fa._tma_rows(one, 'k', (B, 1, H, DK), cpu) == 3 * C
    assert fa._tma_rows(pos[0].transpose(0, 1)[:1], 'pos', (1, H, DK),
                        cpu) == C
    shifted = torch.empty(B * T * C + 1, dtype=torch.bfloat16)[1:]
    with pytest.raises(ValueError, match='16-byte aligned'):
        fa._tma_rows(shifted.view(B, T, H, DK), 'q_u', shape, cpu)
    # and the plain version of those views is the conformer's fused branch
    mask = torch.arange(T)[None] < torch.tensor([[T], [T - 7]])
    got = fa.rel_attention(q_u, k, v, q_v.transpose(1, 2),
                           pos[0].transpose(0, 1), mask, H)
    want = fa.fused_attention_bias_reference(
        q_u, k, v, fa.position_term(q_v, pos), mask, H)
    assert torch.equal(got, want)


def skew_by_shuffles(band):
    """What each thread of a warpgroup adds to its S fragment, replayed lane
    by lane as B8 does it: the (64, 128) band of a tile in two m64n64
    accumulator halves (register 4j + e of lane 4g + t: row 16 w + g + 8 (e
    / 2), column 64 half + 8j + 2t + e % 2), packed to bf16 pairs a group;
    row g of warp w takes band columns 8 J + sigma + 2t + e, J = 7 - 2w (6 -
    2w for row g + 8), sigma = 7 - g, so element (j, e) comes from group J +
    j (or the next, past the pair's end) of lane t + (sigma + e) / 2 of the
    quad, element (sigma + e) % 2 of its pair: one shuffle a element, the
    sender choosing the group. Pairs of groups within half A are done after
    half A's words, the others after half B's product, group 7 from half
    A. A copy of ``Skew`` and ``skew_add`` in ``rel_attention.cu``, which
    must change with them (half A's words there are the last tile's half B
    or packed from its own product: the same values, see
    ``shift_by_bands``). Returns the (64, 64) values added, by row and
    key."""
    out = np.full((64, 64), np.nan)
    for w in range(4):
        words = {}
        for half in (0, 1):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for rho in (0, 1):
                    for j in range(8):
                        r, c = 16 * w + g + 8 * rho, 64 * half + 8 * j + 2 * t
                        words[half, lane, rho, j] = band[r, c:c + 2]
        for half in (0, 1):
            for rho in (0, 1):
                J = 7 - 2 * w - rho
                for j in range(8):
                    lo = J + j
                    if (lo <= 6) != (half == 0):
                        continue
                    for e in (0, 1):
                        send = []
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            q = 7 - g + e
                            receiver = (t - (q >> 1)) & 3
                            group = lo + (q + 2 * receiver >= 8)
                            send.append(
                                words[0, lane, rho, group] if group < 8 and
                                (half == 0 or group == 7) else
                                words[1, lane, rho, group - 8])
                        for lane in range(32):
                            g, t = lane >> 2, lane & 3
                            q = 7 - g + e
                            src = (lane & ~3) | ((t + (q >> 1)) & 3)
                            out[16 * w + g + 8 * rho, 8 * j + 2 * t + e] = (
                                send[src][q & 1])
    return out


def test_skew_by_shuffles_reads_band_column_63_minus_r_plus_c():
    """The kernel's skew read at the level of lanes and registers: row r,
    key c of a tile takes band column 63 - r + c, every element once."""
    band = np.random.default_rng(5).standard_normal((64, 128))
    r, c = np.arange(64)[:, None], np.arange(64)[None]
    np.testing.assert_array_equal(skew_by_shuffles(band), band[r, 63 - r + c])
