"""The port's PPG algebra (``ppgs_tpu_torch.ops.algebra``) against the JAX
package's (``ppgs_tpu.ops.algebra``) on the CPU, on the same numpy PPGs.

Tolerances: fp32 distances at rtol 1e-5, atol 1e-6 (the sqrt of a
divergence near 0 magnifies an ulp of the two libraries' log and matmul:
the largest seen here is 1.9e-6 relative); interpolation at 1e-6; fp32
sparsified PPGs at rtol 2e-5, atol 1e-6 with the kept classes exact and
the percentile thresholds bit for bit (the renormalizing softmax sums the
dropped classes' 1e-8 terms into the kept mass S >= 1/40, which a sum in
another order loses: up to 40 * 1e-8 / S = 1.6e-5 of a value); bf16
sparsified PPGs at atol 2^-7 (two bf16 ulps below 1: JAX's bf16 softmax
rounds its steps apart, torch's once) with the kept classes and
thresholds exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ppgs_tpu_torch
from ppgs_tpu.ops import algebra as jax_algebra
from ppgs_tpu_torch.ops import algebra


def random_ppg(rng, shape, scale=1.0):
    logits = scale * rng.standard_normal(shape).astype(np.float32)
    exp = np.exp(logits - logits.max(axis=-2, keepdims=True))
    return exp / exp.sum(axis=-2, keepdims=True)


def tied_ppg(rng, shape, q):
    """A PPG whose frames each hold one value at both ranks that the q
    quantile reads (floor and ceil of q (P - 1) in sorted order)."""
    x = rng.uniform(size=shape).astype(np.float32)
    ordered = np.sort(x, axis=-2)
    rank = q * (shape[-2] - 1)
    low, high = int(np.floor(rank)), int(np.ceil(rank))
    x = np.where(x == ordered[..., high:high + 1, :],
                 ordered[..., low:low + 1, :], x)
    return x / x.sum(axis=-2, keepdims=True)


@pytest.mark.parametrize('shape', [(40, 30), (3, 40, 30)])
@pytest.mark.parametrize('normalize', [True, False])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_distance_matches_jax(shape, normalize, reduction):
    rng = np.random.default_rng(0)
    x, y = random_ppg(rng, shape), random_ppg(rng, shape)
    want = np.asarray(jax_algebra.distance(
        jnp.asarray(x), jnp.asarray(y), reduction=reduction,
        normalize=normalize))
    got = algebra.distance(torch.from_numpy(x), torch.from_numpy(y),
                           reduction=reduction, normalize=normalize)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_distance_takes_numpy_on_the_named_device():
    rng = np.random.default_rng(1)
    x = random_ppg(rng, (40, 20))
    got = ppgs_tpu_torch.distance(x, x, device='cpu')
    assert got.device.type == 'cpu' and float(got) < 1e-3
    np.testing.assert_array_equal(
        algebra.similarity_matrix().numpy(),
        np.asarray(jax_algebra.similarity_matrix()))


@pytest.mark.parametrize('per_frame', [False, True])
def test_interpolate_matches_jax(per_frame):
    rng = np.random.default_rng(2)
    x, y = random_ppg(rng, (40, 30)), random_ppg(rng, (40, 30))
    t = (rng.uniform(size=(30,)).astype(np.float32) if per_frame else 0.25)
    want = np.asarray(jax_algebra.interpolate(jnp.asarray(x),
                                              jnp.asarray(y), t))
    got = algebra.interpolate(torch.from_numpy(x), torch.from_numpy(y), t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def kept(out):
    """The classes a sparsified frame kept: a dropped class comes out as
    1e-8 / S, a kept one as (p + 1e-8) / S, at least twice that."""
    return out > 1.5 * out.min(axis=-2, keepdims=True)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('method,threshold,ties', [
    ('constant', 0.02, False),
    ('percentile', 0.85, False),
    ('percentile', 0.5, False),
    ('percentile', 0.07, False),
    ('percentile', 0.85, True),
    ('percentile', 0.3, True),
    ('percentile', 0.99, True),
    ('topk', 3, False),
    ('topk', 1, False),
])
def test_sparsify_matches_jax(dtype, method, threshold, ties):
    rng = np.random.default_rng(3)
    shape = (2, 40, 500)
    ppg = (tied_ppg(rng, shape, threshold) if ties
           else random_ppg(rng, shape, scale=3.0))
    jax_ppg = jnp.asarray(ppg).astype(dtype)
    port_ppg = torch.from_numpy(ppg).to(getattr(torch, dtype))
    want = np.asarray(jax_algebra.sparsify(jax_ppg, method, threshold)
                      .astype(jnp.float32))
    got = algebra.sparsify(port_ppg, method, threshold)
    assert got.dtype == port_ppg.dtype
    got = got.float().numpy()
    np.testing.assert_array_equal(kept(got), kept(want))
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -7)
    if method == 'percentile':
        np.testing.assert_array_equal(
            algebra.percentile(port_ppg, threshold).float().numpy(),
            np.asarray(jnp.quantile(
                jax_ppg, jnp.asarray(threshold, jax_ppg.dtype), axis=-2,
                keepdims=True).astype(jnp.float32)))


def test_percentile_takes_what_torch_quantile_refuses():
    """torch.quantile takes only fp32 and fp64; the sort-based percentile
    takes bf16 too, and a frame's threshold does not depend on the other
    frames of the batch."""
    rng = np.random.default_rng(4)
    ppg = torch.from_numpy(random_ppg(rng, (2, 40, 300))).bfloat16()
    with pytest.raises(RuntimeError, match='float or double'):
        torch.quantile(ppg, 0.85, dim=-2)
    got = algebra.percentile(ppg, 0.85)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 1, 300)
    torch.testing.assert_close(got[1:, :, 100:], algebra.percentile(
        ppg[1:, :, 100:], 0.85), rtol=0, atol=0)


def test_sparsify_refuses_an_unknown_method():
    with pytest.raises(ValueError, match='not defined'):
        algebra.sparsify(torch.ones(40, 3) / 40, 'median', 0.5)
