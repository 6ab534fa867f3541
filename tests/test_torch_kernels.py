"""The port's kernel modules, plain PyTorch versions against the JAX package's
Pallas kernels in interpret mode, on the CPU.

The CUDA kernels themselves run only on a card: chip_smoke.py holds them
against these same plain versions there.
Tolerances are the JAX kernel tests' own (tests/test_encoder_layer_kernel.py,
tests/test_flash_attention.py, tests/test_fused_ffn.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.ops import encoder_layer_kernel as jax_elk
from ppgs_tpu.ops import flash_attention as jax_fa
from ppgs_tpu.ops import fused_ffn as jax_ffn

import ppgs_tpu_torch
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
from ppgs_tpu_torch.ops import flash_attention as fa
from ppgs_tpu_torch.ops import fused_ffn


def _layers(tmp_path, config, seed):
    """The same random-init layers in both packages, through one npz (the
    port's prepared for config.compute_dtype)."""
    params = jax_transformer.init(jax.random.PRNGKey(seed), config)
    path = tmp_path / 'params.npz'
    ppgs_tpu.load.save_params(path, params)
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=port_config,
                                         device='cpu')
    return ppgs_tpu.load.load_params(path)['layers'], model.layers


def _stack_inputs(seed, lengths, T, C=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), T, C)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.asarray(lengths)[:, None]
    return x, mask


@pytest.mark.parametrize('compute_dtype,causal,atol', [
    ('float32', False, 2e-4),
    ('bfloat16', False, 8e-2),
    ('bfloat16', True, 8e-2),
])
def test_encoder_stack_matches_jax_kernel(tmp_path, compute_dtype, causal,
                                          atol):
    config = ppgs_tpu.Config(num_hidden_layers=2,
                             compute_dtype=compute_dtype)
    jax_layers, port_layers = _layers(tmp_path, config, seed=0)
    # The last window is wholly masked, as chunked_forward makes them
    T = 128
    x, mask = _stack_inputs(1, [128, 77, 0], T)

    want = np.asarray(jax_elk.encoder_stack(
        jnp.asarray(x), jnp.asarray(mask), jax_layers,
        config.attention_heads, compute_dtype=jnp.dtype(compute_dtype),
        causal=causal, interpret=True))
    got = elk.encoder_stack_reference(
        torch.from_numpy(x), torch.from_numpy(mask), port_layers,
        config.attention_heads, compute_dtype=getattr(torch, compute_dtype),
        causal=causal).numpy()

    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[mask], want[mask], atol=atol, rtol=atol)
    # The wholly masked window: its attention is exactly 0 in both, so what
    # remains (the residual through both LayerNorms) agrees as well
    np.testing.assert_allclose(got[2], want[2], atol=atol, rtol=atol)


def _qkv(seed, B, T, H, D=128):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H * D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize('T,B,causal', [
    (256, 2, False),        # JAX _fused_kernel (whole T)
    (256, 2, True),
    (1152, 1, False),       # JAX _flash_kernel (blocked, T > 1024)
])
def test_flash_attention_matches_jax_kernel(T, B, causal):
    H = 2
    q, k, v = _qkv(2, B, T, H)
    mask = np.ones((B, T), bool)
    mask[-1, T - 50:] = False
    want = np.asarray(jax_fa.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask),
        num_heads=H, causal=causal, interpret=True))
    got = fa.flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask),
        H, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_attention_wholly_masked_window_is_zero():
    B, T, H = 2, 200, 2
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, B, T, H))
    mask = torch.ones(B, T, dtype=torch.bool)
    mask[0] = False
    for dtype in (torch.float32, torch.bfloat16):
        out = fa.attention_reference(q.to(dtype), k.to(dtype), v.to(dtype),
                                     mask, H, fa.LOG2E / math.sqrt(128))
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        assert torch.isfinite(out.float()).all()


def test_attention_reads_fused_qkv_views():
    """Strided q/k/v views of one (B, T, 3C) buffer give what contiguous
    copies give (the layout encoder_stack hands the kernel)."""
    B, T, H = 2, 70, 2
    C = H * 128
    qkv = torch.randn(B, T, 3 * C, generator=torch.Generator().manual_seed(0))
    mask = torch.arange(T)[None, :] < torch.tensor([[70], [33]])
    views = (qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:])
    got = fa.attention_reference(*views, mask, H, 0.1, causal=True)
    want = fa.attention_reference(*(t.contiguous() for t in views), mask, H,
                                  0.1, causal=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize('dtype,tol', [('bfloat16', 5e-2), ('float32', 1e-4)])
def test_ffn_residual_layernorm_matches_jax_kernel(dtype, tol):
    rng = np.random.default_rng(4)
    M, C, F = 512, 256, 2048
    x = rng.standard_normal((M, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, F)) / math.sqrt(C)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / math.sqrt(F)).astype(np.float32)
    b1, b2, g, beta = (rng.standard_normal(n).astype(np.float32) * s
                       for n, s in ((F, 0.1), (C, 0.1), (C, 1.0), (C, 0.1)))
    jd = jnp.dtype(dtype)
    want = np.asarray(jax_ffn.ffn_residual_layernorm(
        jnp.asarray(x), jnp.asarray(w1, jd), jnp.asarray(b1),
        jnp.asarray(w2, jd), jnp.asarray(b2), jnp.asarray(g),
        jnp.asarray(beta), interpret=True))
    td = getattr(torch, dtype)
    got = fused_ffn.ffn_residual_layernorm_reference(
        torch.from_numpy(x), torch.from_numpy(w1).to(td), torch.from_numpy(b1),
        torch.from_numpy(w2).to(td), torch.from_numpy(b2),
        torch.from_numpy(g), torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors every kernel wrapper returns its plain version's result
    and launches nothing."""
    gen = torch.Generator().manual_seed(5)
    M, C, F = 96, 256, 256
    x = torch.randn(M, C, generator=gen)
    w = torch.randn(C, 3 * C, generator=gen).to(torch.bfloat16)
    b = torch.randn(3 * C, generator=gen)
    counts = (elk.qkv_proj.launches, fa.attention.launches,
              elk.out_proj_residual_ln.launches,
              fused_ffn.ffn_residual_ln.launches)
    assert torch.equal(elk.qkv_proj(x, w, b),
                       elk.qkv_proj_reference(x, w, b))
    wo = torch.randn(C, C, generator=gen).to(torch.bfloat16)
    a = x.to(torch.bfloat16)
    g, beta = torch.ones(C), torch.zeros(C)
    assert torch.equal(
        elk.out_proj_residual_ln(a, wo, beta, x, g, beta),
        elk.out_proj_residual_ln_reference(a, wo, beta, x, g, beta))
    w1 = torch.randn(C, F, generator=gen).to(torch.bfloat16)
    w2 = torch.randn(F, C, generator=gen).to(torch.bfloat16)
    assert torch.equal(
        fused_ffn.ffn_residual_ln(x, w1, torch.zeros(F), w2, beta, g, beta),
        fused_ffn.ffn_residual_ln_reference(x, w1, torch.zeros(F), w2, beta,
                                            g, beta))
    assert counts == (elk.qkv_proj.launches, fa.attention.launches,
                      elk.out_proj_residual_ln.launches,
                      fused_ffn.ffn_residual_ln.launches)
