"""K1's plain version (``ppgs_tpu_torch/ops/encoder_layer_kernel.py``
``qkv_proj_reference``) against the JAX package's QKV product, on the CPU,
at every width the kernel takes ((K, N) = (256, 768), (512, 1536), (768,
2304)); a one-layer stack at C = 256 against ``encoder_stack`` in
interpret mode; and the wrapper's argument checks, which run before
anything is launched.

The oracle is ``dot_cd`` of ``ppgs_tpu/ops/encoder_layer_kernel.py``
``_layer_body``: ``jax.lax.dot(xc, w, preferred_element_type=f32)
.astype(cd) + b.astype(cd)``. Row counts sit about the CUDA kernel's 64-row
warpgroups and 128-row units, and a ragged 1000. The CUDA kernel runs only
on a card: chip_smoke.py holds it against this plain version there (phases
3, 6 and 9). Tolerances: fp32 rtol/atol 1e-4; bf16 atol/rtol 2e-2 (the bf16
envelope of docs/GOLDEN_PARITY.md: the two sides sum in other orders and
may round a product one bf16 ulp apart); the stack at the stack test's 8e-2
(tests/test_torch_ffn.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppgs_tpu
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.ops import encoder_layer_kernel as jax_elk

import ppgs_tpu_torch
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk

WIDTHS = elk.QKV_WIDTHS
EDGE_ROWS = (1, 63, 64, 65, 127, 128, 129, 1000)
DTYPES = [('float32', 1e-4), ('bfloat16', 2e-2)]


def _inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return x, w, b


def _dot_cd(x, w, b, dtype):
    """The TPU kernel's QKV product (``dot_cd``) in ``dtype``."""
    cd = jnp.dtype(dtype)
    out = jax.lax.dot(jnp.asarray(x).astype(cd), jnp.asarray(w, cd),
                      preferred_element_type=jnp.float32)
    return np.asarray((out.astype(cd) + jnp.asarray(b).astype(cd))
                      .astype(jnp.float32))


@pytest.mark.parametrize('dtype,tol', DTYPES)
@pytest.mark.parametrize('M', EDGE_ROWS)
@pytest.mark.parametrize('K,N', WIDTHS)
def test_qkv_proj_reference_matches_jax_dot_cd(K, N, M, dtype, tol):
    x, w, b = _inputs(M + K, M, K, N)
    want = _dot_cd(x, w, b, dtype)
    got = elk.qkv_proj_reference(torch.from_numpy(x),
                                 torch.from_numpy(w).to(getattr(torch, dtype)),
                                 torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _layers(tmp_path, config, seed):
    """The same random-init layers in both packages, through one npz."""
    params = jax_transformer.init(jax.random.PRNGKey(seed), config)
    path = tmp_path / 'params.npz'
    ppgs_tpu.load.save_params(path, params)
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=port_config,
                                         device='cpu')
    return ppgs_tpu.load.load_params(path)['layers'], model.layers


@pytest.mark.parametrize('M', (1, 65, 129))
def test_one_layer_stack_at_c256_matches_jax_stack(tmp_path, M):
    """K1 at C = 256 inside a one-layer bf16 stack on one window of M
    frames (the port's plain chain against ``encoder_stack`` in interpret
    mode), with the scale-folded weights each side prepares."""
    config = ppgs_tpu.Config(num_hidden_layers=1, ffn_channels=512,
                             compute_dtype='bfloat16')
    jax_layers, port_layers = _layers(tmp_path, config, seed=M + 7)
    assert port_layers[0].prepared.wqkv_folded.shape == WIDTHS[0]
    x = np.random.default_rng(M).standard_normal(
        (1, M, config.hidden_channels)).astype(np.float32)
    mask = np.ones((1, M), bool)
    want = np.asarray(jax_elk.encoder_stack(
        jnp.asarray(x), jnp.asarray(mask), jax_layers,
        config.attention_heads, compute_dtype=jnp.bfloat16, interpret=True))
    got = elk.encoder_stack_reference(
        torch.from_numpy(x), torch.from_numpy(mask), port_layers,
        config.attention_heads, compute_dtype=torch.bfloat16).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=8e-2, rtol=8e-2)


def _operands(M=70, K=256, N=768):
    return (torch.zeros(M, K), torch.zeros(K, N, dtype=torch.bfloat16),
            torch.zeros(N))


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts one element past an aligned
    address."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _with(i, t):
    ops = list(_operands())
    ops[i] = t
    return tuple(ops)


@pytest.mark.parametrize('operands,match', [
    (_operands(K=256, N=512), 'takes wqkv'),
    (_operands(K=128, N=384), 'takes wqkv'),
    (_operands(K=1024, N=3072), 'takes wqkv'),
    (_with(1, torch.zeros(2, 256, 768, dtype=torch.bfloat16)), 'takes wqkv'),
    (_with(0, torch.zeros(70, 256, dtype=torch.bfloat16)),
     'x: expected torch.float32'),
    (_with(1, torch.zeros(256, 768)), 'wqkv: expected torch.bfloat16'),
    (_with(2, torch.zeros(768, dtype=torch.bfloat16)),
     'bqkv: expected torch.float32'),
    (_with(2, torch.zeros(769)), 'bqkv: expected shape'),
    (_with(0, torch.zeros(70, 512)), 'x: expected last dim 256'),
    (_with(0, torch.zeros(256, 70).T), 'x: expected a contiguous'),
    (_with(1, torch.zeros(768, 256, dtype=torch.bfloat16).T),
     'wqkv: expected a contiguous'),                  # a transposed view
    (_with(1, torch.zeros(256, 1536, dtype=torch.bfloat16)[:, ::2]),
     'wqkv: expected a contiguous'),
    (_with(0, _misaligned((70, 256), torch.float32)), 'x: expected a 16-byte'),
    (_with(1, _misaligned((256, 768), torch.bfloat16)),
     'wqkv: expected a 16-byte'),
    (_with(2, _misaligned((768,), torch.float32)), 'bqkv: expected a 16-byte'),
    (_with(1, torch.zeros(256, 768, dtype=torch.bfloat16, device='meta')),
     'wqkv: expected torch.bfloat16 on cpu'),
])
def test_qkv_proj_args_refuse_what_the_kernel_does_not_take(operands, match):
    """A width, dtype, shape, layout, alignment or device that K1 does not
    take raises before anything is launched (the checks need no card)."""
    with pytest.raises(ValueError, match=match):
        elk.qkv_proj_args(*operands)


@pytest.mark.parametrize('K,N', WIDTHS)
def test_qkv_proj_args_take_every_width_and_leading_shape(K, N):
    """The three widths, with x as (B, T, K): the row count is B T."""
    x = torch.zeros(3, 50, K)
    assert elk.qkv_proj_args(x, torch.zeros(K, N, dtype=torch.bfloat16),
                             torch.zeros(N)) == 150
