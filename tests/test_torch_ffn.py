"""K4 (``ppgs_tpu_torch/ops/fused_ffn.py``, ``kernels/csrc/ffn_ln.cu``) on
the CPU: its plain version in every form against the JAX package's Pallas
kernels in interpret mode, at the row counts that are edges of the CUDA
kernel's 128-row tiles (1, 127, 129), and the wrapper's argument checks.

The JAX kernels take only a multiple of their row block, so they are fed
the rows zero-padded to it and compared on the first M. The CUDA kernel
runs only on a card: chip_smoke.py holds it against these plain versions
there, at these and other odd shapes. Tolerances are the JAX kernel tests'
(tests/test_fused_ffn.py, tests/test_encoder_layer_kernel.py).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppgs_tpu
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.ops import encoder_layer_kernel as jax_elk
from ppgs_tpu.ops import fused_ffn as jax_ffn

import ppgs_tpu_torch
from ppgs_tpu_torch.ops import dropout
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
from ppgs_tpu_torch.ops import fused_ffn

C, F = 256, 512
BLOCK = 128              # the JAX kernels' row block here
EDGE_ROWS = (1, 127, 129)
# (compute dtype, tolerance): tests/test_torch_kernels.py's for the FFN
DTYPES = [('bfloat16', 5e-2), ('float32', 1e-4)]


def _ffn_inputs(seed, M):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, F)) / math.sqrt(C)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / math.sqrt(F)).astype(np.float32)
    b1, b2, g, beta = (rng.standard_normal(n).astype(np.float32) * s
                       for n, s in ((F, 0.1), (C, 0.1), (C, 1.0), (C, 0.1)))
    return x, w1, b1, w2, b2, g, beta


def _padded(x):
    """x's rows zero-padded to a multiple of BLOCK."""
    rows = -(-x.shape[0] // BLOCK) * BLOCK
    return np.concatenate([x, np.zeros((rows - x.shape[0], C), x.dtype)])


def _jax_ffn_ln(x, w1, b1, w2, b2, g, beta, dtype):
    jd = jnp.dtype(dtype)
    out = jax_ffn.ffn_residual_layernorm(
        jnp.asarray(_padded(x)), jnp.asarray(w1, jd), jnp.asarray(b1),
        jnp.asarray(w2, jd), jnp.asarray(b2), jnp.asarray(g),
        jnp.asarray(beta), block_m=BLOCK, interpret=True)
    return np.asarray(out)[:x.shape[0]]


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('M', EDGE_ROWS)
def test_round_input_form_matches_jax_kernel_at_tile_edges(M, dtype, tol):
    """round_input = 1 (the per-layer path) against
    ``ffn_residual_layernorm``."""
    x, w1, b1, w2, b2, g, beta = _ffn_inputs(M, M)
    want = _jax_ffn_ln(x, w1, b1, w2, b2, g, beta, dtype)
    td = getattr(torch, dtype)
    got = fused_ffn.ffn_residual_layernorm_reference(
        torch.from_numpy(x), torch.from_numpy(w1).to(td),
        torch.from_numpy(b1), torch.from_numpy(w2).to(td),
        torch.from_numpy(b2), torch.from_numpy(g),
        torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _layers(tmp_path, config, seed):
    """The same random-init layers in both packages, through one npz."""
    params = jax_transformer.init(jax.random.PRNGKey(seed), config)
    path = tmp_path / 'params.npz'
    ppgs_tpu.load.save_params(path, params)
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=port_config,
                                         device='cpu')
    return ppgs_tpu.load.load_params(path)['layers'], model.layers


@pytest.mark.parametrize('activation', ['relu', 'gelu'])
@pytest.mark.parametrize('M', EDGE_ROWS)
def test_round_input_0_form_matches_jax_stack_at_tile_edges(tmp_path, M,
                                                            activation):
    """round_input = 0 (encoder_stack's FFN, ReLU for the PPG heads and GELU
    for the wav2vec2 trunk) inside a one-layer stack on one window of M
    frames against ``encoder_stack``; bf16, the stack test's tolerance."""
    config = ppgs_tpu.Config(num_hidden_layers=1, ffn_channels=F,
                             compute_dtype='bfloat16')
    jax_layers, port_layers = _layers(tmp_path, config, seed=M)
    x = np.random.default_rng(M).standard_normal((1, M, C)).astype(
        np.float32)
    mask = np.ones((1, M), bool)
    want = np.asarray(jax_elk.encoder_stack(
        jnp.asarray(x), jnp.asarray(mask), jax_layers,
        config.attention_heads, compute_dtype=jnp.bfloat16,
        activation=activation, interpret=True))
    got = elk.encoder_stack_reference(
        torch.from_numpy(x), torch.from_numpy(mask), port_layers,
        config.attention_heads, compute_dtype=torch.bfloat16,
        activation=activation).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=8e-2, rtol=8e-2)


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('M', EDGE_ROWS)
def test_train_ln_form_at_rate_0_matches_jax_kernel_at_tile_edges(M, dtype,
                                                                  tol):
    """B4's form (LayerNorm epilogue, the normalised rows and 1/std) at
    dropout rate 0 computes LN(x + relu(x w1 + b1) w2 + b2), which
    ``ffn_residual_layernorm`` computes with other bf16 rounding points
    (none in fp32); its normalised rows times gamma plus beta are its
    output."""
    x, w1, b1, w2, b2, g, beta = _ffn_inputs(M + 1, M)
    want = _jax_ffn_ln(x, w1, b1, w2, b2, g, beta, dtype)
    td = getattr(torch, dtype)
    off = dropout.OFF
    out, n, rstd, keep = fused_ffn.ffn_train_fwd_reference(
        torch.from_numpy(x), torch.from_numpy(w1).to(td),
        torch.from_numpy(b1), torch.from_numpy(w2).to(td),
        torch.from_numpy(b2), off, off,
        (torch.from_numpy(g), torch.from_numpy(beta)))
    np.testing.assert_allclose(out.numpy(), want, rtol=tol, atol=tol)
    torch.testing.assert_close(out, n * torch.from_numpy(g)
                               + torch.from_numpy(beta))
    assert rstd.shape == (M,) and bool((rstd > 0).all())
    assert keep is None        # no keep words at rate 0


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('M', EDGE_ROWS)
def test_y_out_form_at_rate_0_matches_jax_kernel_at_tile_edges(M, dtype,
                                                               tol):
    """B6's bf16 form (no LayerNorm) at dropout rate 0 against
    ``ffn_train``'s forward."""
    x, w1, b1, w2, b2, _, _ = _ffn_inputs(M + 2, M)
    jd = jnp.dtype(dtype)
    want = np.asarray(jax_ffn.ffn_train(
        *(jnp.asarray(a, jd) for a in (_padded(x), w1, b1, w2, b2)),
        dropout_rate=0.0, block_m=BLOCK, interpret=True).astype(
            jnp.float32))[:M]
    td = getattr(torch, dtype)
    off = dropout.OFF
    got, _, _, keep = fused_ffn.ffn_train_fwd_reference(
        *(torch.from_numpy(a).to(td) for a in (x, w1, b1, w2, b2)), off, off)
    assert got.dtype == td and got.shape == (M, C) and keep is None
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _operands(C_=C, F_=F, x_dtype=torch.float32):
    bf16 = torch.bfloat16
    return (torch.zeros(3, C_, dtype=x_dtype), torch.zeros(C_, F_, dtype=bf16),
            torch.zeros(F_), torch.zeros(F_, C_, dtype=bf16), torch.zeros(C_))


LN = (torch.ones(C), torch.zeros(C))


@pytest.mark.parametrize('operands,kwargs,match', [
    (_operands(C_=384), dict(ln=(torch.ones(384), torch.zeros(384))),
     'activation'),
    (_operands(), dict(ln=LN, activation='gelu'), 'activation'),
    (_operands(F_=200), dict(ln=LN), r'F%128'),
    (_operands(x_dtype=torch.bfloat16), dict(ln=LN), 'x: expected'),
    (_operands(C_=512), dict(), 'activation'),
    (_operands(), dict(), 'x: expected'),
])
def test_launch_ffn_refuses_what_the_kernel_does_not_take(operands, kwargs,
                                                          match):
    """The widths, activations, hidden sizes and dtypes that K4 does not
    take raise before anything is launched: (C, activation) in LN_WIDTHS
    with the LayerNorm, (256, ReLU) for the bf16 output form; F % 128."""
    with pytest.raises(ValueError, match=match):
        fused_ffn._launch_ffn(*operands, **kwargs)


@pytest.mark.parametrize('C', [256, 512, 768])
def test_hidden_scratch_only_for_the_two_launch_widths(C):
    """At C = 256 the hidden stays on chip (no scratch); at 512 and 768 it
    goes through an (M, F) bf16 buffer between K4's two launches."""
    got = fused_ffn.hidden_scratch(70, 384, C, torch.device('cpu'))
    if C == fused_ffn.FUSED_WIDTH:
        assert got is None
    else:
        assert got.shape == (70, 384) and got.dtype == torch.bfloat16
    assert {w for w, _ in fused_ffn.LN_WIDTHS} >= {fused_ffn.FUSED_WIDTH, C}
