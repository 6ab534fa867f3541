"""B10's plain versions (``ppgs_tpu_torch/ops/conv_stack.py``) against the
JAX package's ``feature_encoder_stack`` in interpret mode, the plans by
which the CUDA kernels ``conv_stats``, ``conv_gelu`` and ``conv0_gelu`` cut
their work, conv_stats' Gram route replayed in fp64 and conv0_gelu's GELU
guard.

The JAX stack runs as tests/test_conv_stack.py runs it on the CPU
(``interpret=True``, ``tile_out=8``). A chain of two convs there is
``conv_gelu``'s first form (conv 0, GroupNorm, GELU, then conv 1 with
GELU); a chain of three adds one plain-form conv, which the port runs on
the JAX side's own conv-1 output, so that each form is held alone. The
port's CUDA kernels run only on a card (chip_smoke.py holds them against
these plain versions there, at the shapes below too).

Lengths fall on and beside the kernel's 128-row tiles (conv 1's T_out of
127, 128, 129) and on a ragged tail of samples; B = 1 and 3; the plain
form at k = 3 and k = 2. Tolerance: the envelope of
tests/test_torch_w2v2.py's chain test (rtol = atol = 2e-2, and more than
99% of the outputs within 4e-3): the two sides do the same bf16 arithmetic
with fp32 sums in another order, so a bf16 rounding of a conv output flips
now and then and later convs pass it on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

from ppgs_tpu.ops import conv_stack as jax_conv_stack

from ppgs_tpu_torch.ops import conv_stack

C = conv_stack.CHANNELS


def _samples(T1, k1=3, s1=2, k0=10, s0=5, tail=0):
    """Samples of an utterance whose conv 1 has T1 output frames."""
    T0 = s1 * (T1 - 1) + k1
    return s0 * (T0 - 1) + k0 + tail


def _inputs(seed, B, S, kernel):
    """Seeded audio (B, S) and weights: conv i's (k_i, C_in, C_out) in
    fp32 (conv 0's C_in is 1), the GroupNorm's scale and shift. Each conv's
    weights at 1.5 / sqrt(k C) keep the activations' size from conv to
    conv through GELU (mean |x| ~0.35), as a trained stack's are."""
    rng = np.random.default_rng(seed)
    audio = (0.1 * rng.standard_normal((B, S))).astype(np.float32)
    weights = [(0.3 * rng.standard_normal((kernel[0], 1, C))
                ).astype(np.float32)]
    weights += [((k * C) ** -0.5 * 1.5 * rng.standard_normal((k, C, C))
                 ).astype(np.float32) for k in kernel[1:]]
    scale = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return audio, weights, scale, bias


def _jax_stack(audio, weights, scale, bias, kernel, stride):
    a16 = jnp.asarray(audio, jnp.bfloat16).astype(jnp.float32)
    patches = jax_conv_stack.make_patches(a16, kernel[0], stride[0])
    out = jax_conv_stack.feature_encoder_stack(
        patches, [jnp.asarray(w) for w in weights], jnp.asarray(scale),
        jnp.asarray(bias), tuple(kernel), tuple(stride), tile_out=8,
        interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port_weights(weights):
    """The port's operands: w0 (k0, C) and each conv's (k C, C), bf16."""
    w0 = torch.from_numpy(weights[0][:, 0, :]).to(torch.bfloat16)
    taps = [torch.from_numpy(w.reshape(-1, C)).to(torch.bfloat16)
            for w in weights[1:]]
    return w0, taps


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    assert np.isclose(got, want, rtol=4e-3, atol=4e-3).mean() > 0.99


def _first_operands(audio, weights, scale, bias, kernel, stride):
    a16 = torch.from_numpy(audio).to(torch.bfloat16)
    w0, taps = _port_weights(weights)
    sums = conv_stack.conv_stats_reference(a16, w0, kernel[0], stride[0])
    first = (w0, kernel[0], stride[0], sums, torch.from_numpy(scale),
             torch.from_numpy(bias))
    return a16, taps, first


# (B, conv 1's T_out, samples past it); conv 1 at k = 3 and k = 2
FIRST_CASES = [(1, 127, 0), (3, 128, 0), (1, 129, 3), (3, 129, 4),
               (1, 63, 2), (3, 1, 0)]


@pytest.mark.parametrize('k1', [3, 2])
@pytest.mark.parametrize('B,T1,tail', FIRST_CASES)
def test_conv_gelu_first_form_matches_jax(B, T1, tail, k1):
    """conv_gelu_reference's first form (conv 1 from the audio: conv 0, the
    GroupNorm and GELU, conv0_gelu_reference, then the product) against a
    two-conv JAX chain."""
    kernel, stride = (10, k1), (5, 2)
    S = _samples(T1, k1, tail=tail)
    audio, weights, scale, bias = _inputs(T1 + 7 * B + k1, B, S, kernel)
    want = _jax_stack(audio, weights, scale, bias, kernel, stride)
    a16, taps, first = _first_operands(audio, weights, scale, bias, kernel,
                                       stride)
    got = conv_stack.conv_gelu_reference(a16, taps[0], kernel[1], stride[1],
                                         first)
    assert got.shape == (B, T1, C) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), want)


# (B, conv 2's T_out, samples past it); conv 2 at k = 3 and k = 2
PLAIN_CASES = [(1, 63, 0), (3, 64, 1), (1, 65, 0), (3, 127, 2), (1, 128, 0),
               (1, 129, 3)]


@pytest.mark.parametrize('k2', [3, 2])
@pytest.mark.parametrize('B,T2,tail', PLAIN_CASES)
def test_conv_gelu_plain_form_matches_jax(B, T2, tail, k2):
    """conv_gelu_reference's plain form on the JAX chain's own conv-1
    output against a three-conv JAX chain."""
    kernel, stride = (10, 3, k2), (5, 2, 2)
    T1 = 2 * (T2 - 1) + k2
    S = _samples(T1, tail=tail)
    audio, weights, scale, bias = _inputs(T2 + 5 * B + k2, B, S, kernel)
    x1 = _jax_stack(audio, weights[:2], scale, bias, kernel[:2], stride[:2])
    want = _jax_stack(audio, weights, scale, bias, kernel, stride)
    _, taps = _port_weights(weights)
    got = conv_stack.conv_gelu_reference(
        torch.from_numpy(x1).to(torch.bfloat16), taps[1], k2, 2)
    assert got.shape == (B, T2, C)
    _close(got.float().numpy(), want)


@pytest.mark.parametrize('B,seconds,tail', [(1, 0.25, 0), (3, 0.25, 37),
                                            (2, 0.5, 5)])
def test_feature_encoder_stack_reference_matches_jax(B, seconds, tail):
    """The whole chain at wav2vec2-base's geometry (7 convs, 512 channels)
    against the JAX stack, from the audio."""
    kernel, stride = (10, 3, 3, 3, 3, 2, 2), (5, 2, 2, 2, 2, 2, 2)
    S = int(16000 * seconds) + tail
    audio, weights, scale, bias = _inputs(B + S, B, S, kernel)
    want = _jax_stack(audio, weights, scale, bias, kernel, stride)
    a16, taps, first = _first_operands(audio, weights, scale, bias, kernel,
                                       stride)
    got = conv_stack.feature_encoder_stack_reference(
        a16, taps, first[0], first[4], first[5], kernel, stride)
    _close(got.float().numpy(), want)


# conv_gelu's plan: (B, T_in, k, s) about its 128-row tiles
PLAN_CASES = [(B, s * (T - 1) + k + extra, k, s)
              for B in (1, 3) for k in (3, 2) for s in (2,)
              for T in (1, 63, 64, 65, 127, 128, 129, 400, 1001)
              for extra in (0, 1)]


@pytest.mark.parametrize('B,T_in,k,s', PLAN_CASES)
def test_conv_gelu_plan_covers_every_row_once(B, T_in, k, s):
    """The plan the wrapper hands the kernel (its tiles and its grid of
    blocks, which the entry point also checks): every output row of every
    utterance is in exactly one tile, for each of the two column halves,
    and every tap of every row reads an input row inside the utterance
    (tap j of row t: row s t + j; rows of a box past T_out read zeros)."""
    plan = conv_stack.conv_gelu_plan(B, T_in, k, s)
    T_out, tiles = plan['T_out'], plan['tiles']
    assert T_out == (T_in - k) // s + 1
    count = np.zeros((B, T_out, 2), np.int64)
    for block in range(plan['blocks']):
        tile, half = divmod(block, 2)
        b, t0 = tile // tiles, (tile % tiles) * conv_stack.BLOCK_ROWS
        rows = np.arange(t0, t0 + conv_stack.BLOCK_ROWS)
        count[b, rows[rows < T_out], half] += 1
        taps = s * rows[rows < T_out, None] + np.arange(k)
        assert taps.min() >= 0 and taps.max() < T_in
    assert (count == 1).all()


@pytest.mark.parametrize('B,T1,tail', FIRST_CASES + [(64, 12_807, 3)])
def test_conv0_gelu_plan_covers_every_frame_once(B, T1, tail):
    """The first form's operand, by the plan the wrapper hands the kernel
    (its tiles and window, which the entry point also checks): every
    conv-0 frame of every utterance is made by exactly one block of the
    (tiles, B) grid, whose audio window holds the samples of its frames,
    none past the audio; and conv 1's plan on those frames reads only
    frames below T0."""
    k0, s0 = 10, 5
    S = _samples(T1, tail=tail)
    plan = conv_stack.conv0_gelu_plan(S, k0, s0)
    T0, tiles = plan['T0'], plan['tiles']
    assert T0 == (S - k0) // s0 + 1
    count = np.zeros((B, T0), np.int64)
    for block in range(tiles * B):
        b, f0 = divmod(block, tiles)
        f0 *= conv_stack.CONV0_FRAMES
        frames = np.arange(f0, min(f0 + conv_stack.CONV0_FRAMES, T0))
        count[b, frames] += 1
        lo, hi = s0 * frames.min(), s0 * frames.max() + k0
        assert s0 * f0 <= lo and hi <= s0 * f0 + plan['window'] and hi <= S
    assert (count == 1).all()
    conv1 = conv_stack.conv_gelu_plan(B, T0, 3, 2)
    assert conv1['T_out'] == T1
    assert 2 * (T1 - 1) + 3 <= T0


@pytest.mark.parametrize('plan,args', [
    ('conv_gelu_plan', (1, 100, 4, 2)), ('conv_gelu_plan', (1, 100, 0, 2)),
    ('conv_gelu_plan', (1, 100, 3, 0)), ('conv0_gelu_plan', (600, 17, 5)),
    ('conv0_gelu_plan', (600, 10, 0)),
    ('conv0_gelu_plan', (600, 0, 5)), ('conv_stats_plan', (600, 17, 5)),
    ('conv_stats_plan', (600, 10, 0)), ('conv_stats_plan', (9, 10, 5))])
def test_plans_refuse_what_the_kernels_do_not_take(plan, args):
    """More than 3 taps or a stride below 1 for conv_gelu; no conv-0 tap,
    more than 16, or a stride below 1 for conv0_gelu (which reads its
    samples from device memory, so any window); the same or fewer samples
    than taps for conv_stats: a ValueError before any launch."""
    with pytest.raises(ValueError):
        getattr(conv_stack, plan)(*args)


def test_conv_gelu_wrapper_counts_nothing_on_cpu():
    """On CPU tensors ``conv_gelu`` and ``conv0_gelu`` return their plain
    versions' results and launch nothing (the counters move only where a
    kernel launches)."""
    kernel, stride = (10, 3), (5, 2)
    audio, weights, scale, bias = _inputs(3, 2, _samples(9), kernel)
    a16, taps, first = _first_operands(audio, weights, scale, bias, kernel,
                                       stride)
    counts = lambda: (conv_stack.conv_gelu.launches,  # noqa: E731
                      conv_stack.conv_gelu.first,
                      conv_stack.conv0_gelu.launches)
    before = counts()
    got = conv_stack.conv_gelu(a16, taps[0], 3, 2, first)
    want = conv_stack.conv_gelu_reference(a16, taps[0], 3, 2, first)
    assert torch.equal(got, want)
    assert torch.equal(conv_stack.conv0_gelu(a16, *first),
                       conv_stack.conv0_gelu_reference(a16, *first))
    act, guarded = conv_stack.conv0_gelu_counted(a16, *first)
    assert guarded is None and torch.equal(
        act, conv_stack.conv0_gelu_reference(a16, *first))
    assert counts() == before


# conv_stats: the plain version against the JAX package's statistics, and
# the kernel's Gram route replayed in fp64


def _stats_audio(seed, B, S, loud):
    """bf16-valued audio: a normal draw, or a loud one with a DC offset
    (0.9 + 0.05 N), where a direct fp32 sum of squares loses digits."""
    rng = np.random.default_rng(seed)
    a = (0.9 + 0.05 * rng.standard_normal((B, S)) if loud
         else 0.1 * rng.standard_normal((B, S)))
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _w0(seed, k0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.3 * rng.standard_normal((k0, C))).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize('k0,s0,T0,loud', [
    (10, 5, 1, False), (10, 5, 300, False), (10, 5, 300, True),
    (16, 3, 257, False), (1, 1, 40, True)])
def test_conv_stats_reference_matches_jax_stats(k0, s0, T0, loud):
    """conv_stats_reference against the statistics of the JAX stack's
    stats pass (``_stats_kernel``): make_patches' patches (PATCH_LANES
    wide, zero past k0) times the zero-padded bf16 w0 by the same fp32 dot,
    then the column sums of x0 and x0^2, on the same numpy-seeded audio and
    weights. rtol 1e-5, with atol 1e-5 of sum_f |x0| (sum_f x0 cancels:
    both sides' fp32 sums round at ~2^-24 of it)."""
    import jax

    B = 2
    S = s0 * (T0 - 1) + k0 + 3
    a16 = _stats_audio(T0 + k0, B, S, loud)
    w0 = _w0(k0 + s0, k0)
    patches = jax_conv_stack.make_patches(
        jnp.asarray(a16.float().numpy()), k0, s0)
    w_pad = jnp.zeros((patches.shape[-1], C), jnp.bfloat16).at[:k0].set(
        jnp.asarray(w0.float().numpy()).astype(jnp.bfloat16))
    want = []
    for b in range(B):
        x0 = jax.lax.dot(patches[b].astype(jnp.bfloat16), w_pad,
                         preferred_element_type=jnp.float32)
        want.append(np.stack([np.asarray(x0.sum(0)),
                              np.asarray((x0 * x0).sum(0))]))
    want = np.stack(want)
    got = conv_stack.conv_stats_reference(a16, w0, k0, s0).numpy()
    x64 = a16.double().unfold(-1, k0, s0) @ w0.double()
    scale = np.stack([x64.abs().sum(1).numpy(), (x64 * x64).sum(1).numpy()],
                     1)
    assert got.shape == want.shape == (B, 2, C)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * scale).all()


def _gram_replay(audio, w0, k0, s0):
    """conv_stats_kernel's arithmetic in fp64 (kernels/csrc/conv_stack.cu):
    per block of the plan's frames, A and the 16 x 16 Gram matrix of the
    zero-padded patches, rows 0-7 always (the m16n8k8 products D0 =
    G[0..15][0..7], read by symmetry), rows 8-15 when k0 > 8 and s0 > 8
    (D1); the blocks added in order; rows 8.. of G otherwise from rows
    - m s0 < 8 and the first and last frames' terms; then sum = w . A and
    sq = w^T G w."""
    a = audio.double().numpy()
    w = np.zeros((conv_stack.MAX_K0, C))
    w[:k0] = w0.double().numpy()
    B, S = a.shape
    plan = conv_stack.conv_stats_plan(S, k0, s0)
    T0, F = plan['T0'], plan['frames']
    high, base_high = k0 > 8, k0 > 8 and s0 > 8
    out = np.zeros((B, 2, C))
    for b in range(B):
        idx = s0 * np.arange(T0)[:, None] + np.arange(conv_stack.MAX_K0)
        P = np.where(np.arange(conv_stack.MAX_K0) < k0,
                     a[b][np.minimum(idx, S - 1)], 0.0)     # (T0, 16)
        G, A = np.zeros((16, 16)), np.zeros(16)
        for i in range(plan['tiles']):
            p = P[i * F:(i + 1) * F]
            g = p.T @ p
            G[:8] += g[:8]
            if base_high:
                G[8:, 8:] += g[8:, 8:]
            A += p.sum(0)
        if high and not base_high:
            for r in range(8, k0):
                for q in range(r, k0):
                    m = (r - 8) // s0 + 1
                    v = G[r - m * s0, q - m * s0]
                    for j in range(1, m + 1):
                        v += (a[b][s0 * T0 + r - j * s0]
                              * a[b][s0 * T0 + q - j * s0]
                              - a[b][r - j * s0] * a[b][q - j * s0])
                    G[r, q] = v
        sym = np.triu(G) + np.triu(G, 1).T
        out[b, 0] = w.T @ A
        out[b, 1] = np.einsum('pc,pq,qc->c', w, sym, w)
    return out


# (k0, s0): wav2vec2's, rows 8.. from rows - s0 once and several times
# over, rows 8.. summed (s0 > 8), one tap; T0 about the 4608-frame blocks
GRAM_CASES = [(10, 5), (16, 3), (16, 9), (12, 8), (9, 1), (1, 1)]


@pytest.mark.parametrize('loud', [False, True])
@pytest.mark.parametrize('T0', [1, 5, 4607, 4609])
@pytest.mark.parametrize('k0,s0', GRAM_CASES)
def test_gram_route_replay_matches_reference(k0, s0, T0, loud):
    """The kernel's Gram route, replayed in fp64, against
    conv_stats_reference (atol 1e-3, rtol 1e-4, chip_smoke.py's limits on
    the card) and against conv 0's statistics summed directly in fp64
    (rtol 1e-9: the route is that sum in another order)."""
    B = 2
    S = s0 * (T0 - 1) + k0 + 2
    a16 = _stats_audio(7 * k0 + s0 + T0, B, S, loud)
    w0 = _w0(k0 * s0, k0)
    got = _gram_replay(a16, w0, k0, s0)
    plain = conv_stack.conv_stats_reference(a16, w0, k0, s0).double().numpy()
    x64 = (a16.double().unfold(-1, k0, s0) @ w0.double()).numpy()
    exact = np.stack([x64.sum(1), (x64 * x64).sum(1)], 1)
    scale = np.stack([np.abs(x64).sum(1), (x64 * x64).sum(1)], 1)
    assert (np.abs(got - plain) <= 1e-3 + 1e-4 * np.abs(plain)).all()
    assert (np.abs(got - exact) <= 1e-9 * scale + 1e-12).all()


@pytest.mark.parametrize('s0', [5, 1, 3000, 20_000])
@pytest.mark.parametrize('T0', [1, 63, 64, 65, 4607, 4608, 4609, 25_615])
def test_conv_stats_plan_covers_every_frame_once(T0, s0):
    """conv_stats_kernel's walk (tiles of the plan's frames, each staging
    s0 (frames - 1) + k0 samples, at most STATS_SAMPLES; warp w on the
    groups of STATS_K frames from STATS_K w on, STATS_K STATS_WARPS apart,
    two a turn; frames past the tile's end read as zero) counts every frame
    of an utterance exactly once, and the samples it stages lie inside the
    audio."""
    k0 = 10
    S = s0 * (T0 - 1) + k0
    plan = conv_stack.conv_stats_plan(S, k0, s0)
    F, W, K = plan['frames'], conv_stack.STATS_WARPS, conv_stack.STATS_K
    assert plan['T0'] == T0 and 1 <= F <= conv_stack.STATS_FRAMES
    assert s0 * (F - 1) + conv_stack.MAX_K0 <= conv_stack.STATS_SAMPLES
    count = np.zeros(T0, np.int64)
    for tile in range(plan['tiles']):
        nf = min(F, T0 - tile * F)
        assert nf >= 1
        assert s0 * tile * F + s0 * (nf - 1) + k0 <= S
        for warp in range(W):
            f0 = K * warp
            while f0 < nf:
                f = (f0 + K * W * np.arange(2)[:, None]
                     + np.arange(K)).ravel()
                count[tile * F + f[f < nf]] += 1
                f0 += 2 * K * W
    assert (count == 1).all()


# conv0_gelu's GELU guard

def _tanh_form(x):
    """0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))) in fp32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    return 0.5 * x * (1 + torch.tanh(u))


def _fast_form(x):
    """The kernel's x / (1 + 2^z), z = x (K1 x^2 + K0), in fp32 (exp2 and
    the division exact here; on the card ex2.approx and rcp.approx)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    k0 = torch.tensor(-2 * 1.4426950408889634 * 0.7978845608028654,
                      dtype=torch.float32)
    k1 = k0 * torch.tensor(0.044715, dtype=torch.float32)
    z = x * (k1 * (x * x) + k0)
    return x / (1 + torch.exp2(z))


def _bits(v):
    return v.to(torch.bfloat16).view(torch.int16)


def test_gelu_forms_within_the_stated_bound():
    """The two forms of the tanh GELU, in fp32 on this machine, lie within
    the bound that the guard's margin takes twice, (GELU_ERR_ABS |x| +
    GELU_ERR_REL |fast|), over a dense sweep of x in [-12, 12]."""
    x = torch.linspace(-12, 12, 2_000_001, dtype=torch.float32)
    fast, tanh_form = _fast_form(x), _tanh_form(x)
    bound = (conv_stack.GELU_ERR_ABS * x.abs()
             + conv_stack.GELU_ERR_REL * fast.abs())
    assert ((fast - tanh_form).abs() <= bound).all()


@pytest.mark.parametrize('draw', ['normal', 'midpoints', 'tail'])
def test_gelu_guard_keeps_the_bf16_rounding(draw):
    """Property of conv0_gelu's guard: wherever ``gelu_guard_safe(x, f)``
    holds, every fp32 value t within the stated error of f (|t - f| <=
    GELU_ERR_ABS |x| + GELU_ERR_REL |f|, tanhf's value among them) rounds
    to f's bf16. Values of f drawn at and about bf16 rounding midpoints,
    from GELU's own range and its negative tail (where the absolute term
    dominates), each perturbed by up to the stated error either way."""
    gen = torch.Generator().manual_seed({'normal': 1, 'midpoints': 2,
                                         'tail': 3}[draw])
    n = 400_000
    if draw == 'tail':
        x = -2 - 4 * torch.rand(n, generator=gen)
        f = _fast_form(x)
    else:
        x = 3 * torch.randn(n, generator=gen)
        f = _fast_form(x)
    if draw == 'midpoints':
        # f moved onto the midpoint above its bf16 value, then off it by a
        # few fp32 ulps
        mid = (f.view(torch.int32) & -65536) | 0x8000
        f = mid.view(torch.float32)
        f = f + torch.randint(-40, 41, (n,), generator=gen).float() * (
            f.abs() * 2.0 ** -23)
    err = conv_stack.GELU_ERR_ABS * x.abs() + conv_stack.GELU_ERR_REL * f.abs()
    safe = conv_stack.gelu_guard_safe(x, f)
    assert safe.any() and not safe.all()
    for side in (-1, 1):
        for frac in (1.0, torch.rand(n, generator=gen)):
            t = (f.double() + side * frac * err.double()).float()
            t = torch.where(((t.double() - f.double()).abs()
                             <= err.double()), t, f)
            assert torch.equal(_bits(t)[safe], _bits(f)[safe])


def test_gelu_guard_share_is_small():
    """The guard sends few of GELU's typical inputs (N(0, 1), as the
    GroupNorm leaves them) to tanhf: under 1% (conv0_gelu prints the share
    it takes on the card)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(1_000_000, generator=gen)
    safe = conv_stack.gelu_guard_safe(x, _fast_form(x))
    assert 1 - safe.float().mean().item() < 1e-2
