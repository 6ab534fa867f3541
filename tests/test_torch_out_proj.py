"""K3 (``ppgs_tpu_torch/ops/encoder_layer_kernel.py`` ``out_proj_residual_ln``
and ``ppgs_tpu_torch/ops/encoder_layer_train.py`` ``out_proj_ln_train``) on
the CPU: the launch plan its wrapper computes and hands the kernel, the
operands the wrapper refuses before anything is launched, and both plain
versions against the JAX package's formula.

The oracle is ``_ln`` of ``ppgs_tpu/ops/encoder_layer_kernel.py`` (the
TPU kernel's two-pass LayerNorm) applied to ``x32 + a @ wo + bo``, the
product accumulated in fp32 (``preferred_element_type``) from operands in
the compute dtype, as ``_layer_body`` forms it; the train form at rate 0.
Row counts sit about the CUDA kernel's 64-row warpgroups and 128-row
tiles, and a ragged 1000.
The CUDA kernel runs only on a card: chip_smoke.py holds it against these
plain versions there (phases 3, 6 and 9). Tolerances: atol and rtol 1e-4
on the output and the normalised rows, 1e-5 on 1/std (fp32 LayerNorm
statistics; the two sides sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

from ppgs_tpu.ops import encoder_layer_kernel as jax_elk

from ppgs_tpu_torch import kernels
from ppgs_tpu_torch.ops import dropout
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
from ppgs_tpu_torch.ops import encoder_layer_train as elt

WIDTHS = elk.OUT_PROJ_WIDTHS
EDGE_ROWS = (1, 63, 64, 65, 127, 128, 129, 1000)


def _inputs(seed, M, C):
    rng = np.random.default_rng(seed)
    a = (0.5 * rng.standard_normal((M, C))).astype(np.float32)
    wo = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    x = rng.standard_normal((M, C)).astype(np.float32)
    bo, beta = (0.1 * rng.standard_normal((2, C))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    return a, wo, bo, x, gamma, beta


def _jax_out_proj_ln(a, wo, bo, x, gamma, beta, dtype):
    """``_ln(x32 + dot(a, wo) + bo, g1, be1)`` with a and wo in ``dtype``."""
    cd = jnp.dtype(dtype)
    acc = jax.lax.dot(jnp.asarray(a).astype(cd), jnp.asarray(wo).astype(cd),
                      preferred_element_type=jnp.float32)
    return np.asarray(jax_elk._ln(jnp.asarray(x) + acc + jnp.asarray(bo),
                                  jnp.asarray(gamma), jnp.asarray(beta)))


def _torch(arrays, dtype):
    a, wo, bo, x, gamma, beta = (torch.from_numpy(t) for t in arrays)
    cd = getattr(torch, dtype)
    return a.to(cd), wo.to(cd), bo, x, gamma, beta


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('M', EDGE_ROWS)
@pytest.mark.parametrize('C', WIDTHS)
def test_out_proj_reference_matches_jax(C, M, dtype):
    arrays = _inputs(C + M, M, C)
    want = _jax_out_proj_ln(*arrays, dtype)
    got = elk.out_proj_residual_ln(*_torch(arrays, dtype))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('M', EDGE_ROWS)
@pytest.mark.parametrize('C', WIDTHS)
def test_out_proj_train_reference_at_rate_0_matches_jax(C, M):
    arrays = _inputs(C + M + 1, M, C)
    a, wo, bo, x, gamma, beta = _torch(arrays, 'bfloat16')
    r, n, rstd = elt.out_proj_ln_train(a, wo, bo, x, gamma, beta,
                                       dropout.OFF)
    np.testing.assert_allclose(r.numpy(),
                               _jax_out_proj_ln(*arrays, 'bfloat16'),
                               rtol=1e-4, atol=1e-4)
    # the normalised rows and 1/std: the formula at gamma 1, beta 0
    ones, zeros = np.ones(C, np.float32), np.zeros(C, np.float32)
    np.testing.assert_allclose(
        n.numpy(), _jax_out_proj_ln(*arrays[:4], ones, zeros, 'bfloat16'),
        rtol=1e-4, atol=1e-4)
    z = x + (a.float() @ wo.float()) + bo
    var = z.var(dim=-1, unbiased=False)
    np.testing.assert_allclose(rstd.numpy(),
                               torch.rsqrt(var + 1e-5).numpy(),
                               rtol=1e-5, atol=1e-5)


def _operands(M, C):
    """Operands of K3's shapes; their values are never read (torch.empty:
    the largest plans' rows cost no memory)."""
    a = torch.empty(M, C, dtype=torch.bfloat16)
    wo = torch.empty(C, C, dtype=torch.bfloat16)
    x = torch.empty(M, C)
    bo, gamma, beta = torch.empty(C), torch.empty(C), torch.empty(C)
    return a, wo, bo, x, gamma, beta


@pytest.mark.parametrize('M', (0,) + EDGE_ROWS + (25_600, 64_000, 131_072,
                                                 128 * 70_000 + 1))
@pytest.mark.parametrize('C', WIDTHS)
def test_out_proj_wrapper_launches_the_plan(C, M, monkeypatch):
    """The wrapper hands the kernel the instance (C), the rows and the
    plan's grid: one cluster of C / 256 blocks a 128-row tile."""
    tiles = -(-M // 128)
    assert elk.out_proj_ln_plan(M, C) == (C, C // 256, tiles, tiles)
    calls = []
    monkeypatch.setattr(kernels, 'launch',
                        lambda symbol, *args, device: calls.append(
                            (symbol, args)))
    for stats in (False, True):
        out, n, rstd = elk.launch_out_proj_ln(*_operands(M, C),
                                              stats=stats)
        symbol, args = calls.pop()
        assert symbol == 'ppgs_out_proj_ln'
        assert args[9:12] == (M, C, tiles)
        assert (args[7] is None) == (not stats) == (args[8] is None)
        assert out.shape == (M, C) and (n is None) == (not stats)


def _unaligned(t):
    """A copy of ``t`` whose data starts 2 elements past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)
    return flat[2:2 + t.numel()].view(t.shape)


@pytest.mark.parametrize('case', [
    'width', 'a-fp32', 'x-bf16', 'wo-fp32', 'bo-bf16', 'x-shape',
    'a-last-dim', 'a-strided', 'a-unaligned', 'x-unaligned',
    'gamma-unaligned'])
def test_out_proj_wrapper_refuses_what_the_kernel_does_not_take(
        case, monkeypatch):
    monkeypatch.setattr(kernels, 'launch', lambda *a, **k: pytest.fail(
        'launched'))
    C = 384 if case == 'width' else 256
    a, wo, bo, x, gamma, beta = _operands(65, C)
    if case == 'a-fp32':
        a = a.float()
    elif case == 'x-bf16':
        x = x.to(torch.bfloat16)
    elif case == 'wo-fp32':
        wo = wo.float()
    elif case == 'bo-bf16':
        bo = bo.to(torch.bfloat16)
    elif case == 'x-shape':
        x = x[:64]
    elif case == 'a-last-dim':
        a = torch.zeros(65, 512, dtype=torch.bfloat16)
    elif case == 'a-strided':
        a = torch.zeros(C, 65, dtype=torch.bfloat16).t()
    elif case == 'a-unaligned':
        a = _unaligned(a)
    elif case == 'x-unaligned':
        x = _unaligned(x)
    elif case == 'gamma-unaligned':
        gamma = _unaligned(gamma)
    with pytest.raises(ValueError):
        elk.launch_out_proj_ln(a, wo, bo, x, gamma, beta)
