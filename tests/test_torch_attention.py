"""K2's plain version (``ppgs_tpu_torch/ops/flash_attention.py``) against
the JAX package's ``flash_attention`` in interpret mode, on the CPU, at every
head width the kernel takes (64, 128, 256); and the wrapper's argument
checks, which run before anything is launched.

The CUDA kernel itself runs only on a card: chip_smoke.py holds it against
this same plain version there, at these shapes and masks. Tolerance: fp32,
rtol 1e-4 and atol 1e-5, as tests/test_torch_kernels.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppgs_tpu.ops import flash_attention as jax_fa

from ppgs_tpu_torch.ops import flash_attention as fa

H = 2                          # heads (the JAX packed form needs an even count)
# T about the kernel's 64-key tiles and 128-row query tiles, and the main
# paths' window
T_EDGES = (1, 63, 64, 65, 127, 129, 500)


def _inputs(seed, T, D):
    """q, k, v (4, T, H*D) fp32 and a (4, T) mask: a ragged prefix, a mask
    with holes (one whole 64-key tile masked where T reaches it), a wholly
    masked window, and a full one."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((4, T, H * D)).astype(np.float32)
               for _ in range(3))
    keys = np.arange(T)
    mask = np.stack([keys < max(1, (2 * T) // 3),
                     rng.random(T) < 0.6,
                     np.zeros(T, bool),
                     np.ones(T, bool)])
    mask[1, 64:128] = False
    return q, k, v, mask


def _jax_attention(q, k, v, mask, causal):
    """JAX flash_attention on T padded to a multiple of 8 (its pad + mask
    at the call site): the padded keys are masked, the first T rows
    returned. Its blocks of 8 only meet the check that T is a multiple of
    them: up to T = 1024 it runs the whole-T kernels."""
    T = q.shape[1]
    pad = -T % 8
    wide = [np.pad(a, ((0, 0), (0, pad), (0, 0))) for a in (q, k, v)]
    wide_mask = np.pad(mask, ((0, 0), (0, pad)))
    out = jax_fa.flash_attention(
        *(jnp.asarray(a) for a in wide), jnp.asarray(wide_mask),
        num_heads=H, block_q=8, block_k=8, causal=causal, interpret=True)
    return np.asarray(out)[:, :T]


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('T', T_EDGES)
@pytest.mark.parametrize('D', fa.D_HEADS)
def test_attention_reference_matches_jax_kernel(D, T, causal):
    """Both scales K2 is called with: log2(e)/sqrt(d) on raw q
    (``flash_attention_reference``), and 1 with the scale folded into q
    (``attention_reference``, as ``encoder_stack`` calls it)."""
    q, k, v, mask = _inputs(D + T, T, D)
    want = _jax_attention(q, k, v, mask, causal)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = fa.flash_attention_reference(tq, tk, tv, tm, H, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # exp2(q' k) = exp(q k / sqrt(d)) for q' = q log2(e) / sqrt(d)
    folded = tq * (fa.LOG2E / math.sqrt(D))
    got = fa.attention_reference(folded, tk, tv, tm, H, 1.0, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


def _fused(B=2, T=70, C=256, extra=0, offset=0, dtype=torch.bfloat16):
    """q, k, v views of one (B, T, 3C + extra) buffer, from column
    ``offset``, and a valid mask."""
    buf = torch.zeros(B, T, 3 * C + extra, dtype=dtype)
    views = tuple(buf[..., offset + i * C:offset + (i + 1) * C]
                  for i in range(3))
    return (*views, torch.ones(B, T, dtype=torch.bool))


def test_attention_args_take_fused_qkv_views():
    for C, d_head in ((768, 64), (256, 128), (512, 256)):
        heads = C // d_head
        assert fa._attention_args(*_fused(C=C), heads) == (d_head, 3 * C)


def _replace(args, i, value):
    return args[:i] + (value,) + args[i + 1:]


_q, _k, _v, _mask = _fused()
_q16 = torch.zeros(2, 70, 256, dtype=torch.bfloat16)


@pytest.mark.parametrize('args,heads,match', [
    (_fused(C=192), 2, 'd_head in'),                       # d_head 96
    (_fused(C=258), 2, 'd_head in'),                       # C % heads
    (_fused(C=128), 4, 'd_head in'),                       # d_head 32
    (_fused(dtype=torch.float32), 2, 'q: expected bfloat16'),
    (_replace(_fused(), 1, _k.float()), 2, 'k: expected bfloat16'),
    (_replace(_fused(), 2, _v[:, :69]), 2, 'v: expected shape'),
    (_replace(_fused(), 0, _q16), 2, 'one row stride'),     # rs C vs 3C
    (_fused(extra=1, offset=1), 2, '16-byte aligned'),      # base + 2 bytes
    (_fused(extra=4), 2, '16-byte aligned'),                # rs % 8 == 4
    (_replace(_fused(), 0, _q16.transpose(0, 1).contiguous().transpose(0, 1)),
     2, '16-byte aligned'),                                 # windows apart
    (_replace(_fused(), 0, torch.zeros(2, 70, 512, dtype=torch.bfloat16)
              [..., ::2]), 2, '16-byte aligned'),           # column stride 2
    (_replace(_fused(), 3, torch.ones(2, 69, dtype=torch.bool)), 2,
     'mask: expected shape'),
    (_replace(_fused(), 3, _mask.to(torch.uint8)), 2, 'mask: expected'),
    (_replace(_fused(), 3, torch.ones(70, 2, dtype=torch.bool).T), 2,
     'mask: expected a contiguous'),
])
def test_attention_args_refuse_what_the_kernel_does_not_take(args, heads,
                                                             match):
    """A head width, dtype, shape, layout or mask that K2 does not take
    raises before anything is launched (the checks need no card)."""
    with pytest.raises(ValueError, match=match):
        fa._attention_args(*args, heads)
