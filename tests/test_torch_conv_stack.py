"""B10's plain versions (``ppgs_tpu_torch/ops/conv_stack.py``) against the
JAX package's ``feature_encoder_stack`` in interpret mode, and the plans by
which the CUDA kernels ``conv_gelu`` and ``conv0_gelu`` cut their work.

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
    ('conv0_gelu_plan', (20_000, 10, 100))])
def test_plans_refuse_what_the_kernels_do_not_take(plan, args):
    """More than 3 taps or a stride below 1 for conv_gelu; more than 16
    conv-0 taps, a stride below 1, or a window past the shared memory for
    conv0_gelu: a ValueError before any launch."""
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
    assert counts() == before
