"""The PPG transformer's training at widths of the layer kernels' rule
that no registered config has (C % 128 == 0 up to 2048, d_head 128 or
256), on the CPU, at narrow depth (B = 2, T <= 40, F = 512 where F does not
matter), against the JAX package on the same seeded numpy inputs and npz
weights:

- the whole train layer (B4) at rate 0 in fp32, at (C, d_head) = (384,
  128), (1024, 128) and (1024, 256): the port's plain chain of the card's
  kernels against ``encoder_layer_train`` in interpret mode (out, dx and
  the 16 gradients within rtol = atol = 2e-3 and 2^-8 relative);
- B6 at C = 384 and 1024, fp32 and bf16: the plain ``y_out`` form of K4
  and the plain ``ffn_train_bwd`` (through ``ffn_train``) against JAX's
  ``ffn_train`` in interpret mode;
- ``ln_dropout_bwd``'s plain version against autograd at C = 384, 1024 and
  2048, rates 0 and 0.1;
- a 2-layer bf16 train step through ``make_train_step`` at (384, 128)
  against JAX's step at rate 0 (its train kernels in interpret mode): the
  loss within 1e-4 relative, the parameters after one Adam step within
  2^-8 relative;
- the wrappers of K3's and K4's train forms, ``ffn_train_bwd`` and
  ``ln_dropout_bwd`` hand their kernels every width of the rule (the launch
  recorded, not run), and the training gate is the inference rule.

The CUDA kernels run only on a card: ``chip_smoke.py --slices
train_any_width`` holds each against these plain versions there.
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
from ppgs_tpu.ops import encoder_layer_train as jax_elt
from ppgs_tpu.ops import flash_attention as jax_fa
from ppgs_tpu.ops import fused_ffn as jax_ffn
from ppgs_tpu.train import core as jax_train

import ppgs_tpu_torch
from ppgs_tpu_torch import convert, kernels
from ppgs_tpu_torch.models import transformer
from ppgs_tpu_torch.ops import backward, dropout
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
from ppgs_tpu_torch.ops import encoder_layer_train as elt
from ppgs_tpu_torch.ops import fused_ffn
from ppgs_tpu_torch.train import core as train_core

from test_torch_train_kernels import _layer_pair, _port_grads_as_jax

# (C, d_head): a width whose cluster's last rank is 128 columns wide, and a
# width of four ranks at both head widths
PAIRS = ((384, 128), (1024, 128), (1024, 256))
FFN_C = (384, 1024)
LN_C = (384, 1024, 2048)
# every C of the rule that the wrappers are held at: one rank, the odd
# ranks, and the widest
RULE_C = (128, 384, 640, 1024, 1280, 2048)
B, T, F = 2, 40, 512
BF16_ULP = 2.0 ** -8
BLOCK = 128              # the JAX FFN kernel's row block here


def _ids(pairs):
    return [pytest.param(c, d, id=f'C{c}-d{d}') for c, d in pairs]


def _t(array, dtype=torch.float32):
    return torch.from_numpy(np.array(array, np.float32)).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


###############################################################################
# B4 at rate 0 against the JAX kernel
###############################################################################


@pytest.mark.parametrize('C,D', _ids(PAIRS))
def test_encoder_layer_train_matches_jax_kernel(C, D):
    """The whole train layer at rate 0 (the plain chain of the card's
    kernels: K1, the train attention, K3's and K4's train forms,
    ``ffn_train_bwd``, ``ln_dropout_bwd``, gemm and colsum) against
    ``encoder_layer_train`` in interpret mode, in fp32: out, dx and the 16
    JAX gradients each within 2^-8 relative and rtol = atol = 2e-3
    elementwise (tests/test_encoder_layer_train.py's envelope; the key
    bias by its elementwise bound alone: softmax is shift-invariant in it,
    so its true gradient is ~0)."""
    layer_against_jax(C, D)


def layer_against_jax(C, D):
    """``test_encoder_layer_train_matches_jax_kernel``'s check at (C,
    d_head)."""
    H = C // D
    jax_layer, port = _layer_pair(seed=C + D, C=C, F=F)
    rng = np.random.default_rng(C + D)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[T], [T - 13]])
    cot = rng.standard_normal((B, T, C)).astype(np.float32)

    def jax_loss(x_, layer):
        out = jax_elt.encoder_layer_train(
            x_, jnp.asarray(mask), layer, H, dropout_rate=0.0,
            compute_dtype=jnp.float32, interpret=True)
        return (out * cot).sum(), out

    (_, want), (gx, gp) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jax_layer)
    xt = _t(x).requires_grad_()
    out = elt.encoder_layer_train_reference(
        xt, torch.from_numpy(mask), port, H, 0.0,
        compute_dtype=torch.float32)
    (out * _t(cot)).sum().backward()
    pairs = {'out': (out.detach().numpy(), want),
             'dx': (xt.grad.numpy(), gx)}
    got = _port_grads_as_jax(port)
    flat = jax.tree_util.tree_flatten_with_path(gp)[0]
    assert len(flat) == len(got) == 16
    for path, g in flat:
        key = jax.tree_util.keystr(path)
        pairs[key] = (got[key], g)
    for key, (a, b) in pairs.items():
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3, atol=2e-3,
                                   err_msg=key)
        if "['bk']" not in key:
            assert _rel(a, b) <= BF16_ULP, (key, _rel(a, b))


###############################################################################
# B6: K4's y_out form and ffn_train_bwd against the JAX kernel
###############################################################################


def _ffn_inputs(seed, M, C):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, F)) / math.sqrt(C)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / math.sqrt(F)).astype(np.float32)
    b1 = 0.1 * rng.standard_normal(F).astype(np.float32)
    b2 = 0.1 * rng.standard_normal(C).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize('C', FFN_C)
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_ffn_train_matches_jax_kernel(C, dtype):
    """B6 at rate 0, forward and backward: the port's plain chain (K4's
    y_out form, ``ffn_train_bwd``'s plain version, the weight gradients'
    gemm and colsum) against ``ffn_train`` in interpret mode on one 128-row
    block, each tensor within one bf16 ulp relative (fp32: 1e-4
    elementwise)."""
    M = BLOCK
    arrays = _ffn_inputs(C + 7, M, C)
    g = np.random.default_rng(C + 8).standard_normal((M, C)).astype(
        np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)

    def jax_loss(*args):
        out = jax_ffn.ffn_train(*args, dropout_rate=0.0, block_m=M,
                                interpret=True)
        return (out.astype(jnp.float32) * g).sum(), out

    (_, want), grads = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(a, jd) for a in arrays))
    tensors = [_t(a, td).requires_grad_() for a in arrays]
    out = fused_ffn.ffn_train_reference(*tensors, 0.0)
    assert out.dtype == td and out.shape == (M, C)
    (out.float() * _t(g)).sum().backward()
    pairs = [('out', out.float().detach().numpy(), want)] + [
        (name, t.grad.float().numpy(), gr) for name, t, gr in zip(
            ('dx', 'dw1', 'db1', 'dw2', 'db2'), tensors, grads)]
    for name, a, b in pairs:
        b = np.asarray(b, np.float32)
        if dtype == 'float32':
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        else:
            assert _rel(a, b) <= BF16_ULP, (name, _rel(a, b))


###############################################################################
# ln_dropout_bwd against autograd
###############################################################################


@pytest.mark.parametrize('C', LN_C)
@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_ln_dropout_bwd_matches_autograd(C, rate):
    """``ln_dropout_bwd``'s plain version on an fp32 LayerNorm (its
    normalised rows and 1/std): dz is autograd's input gradient, the masked
    output autograd's gradient of the dropout that follows, the partial
    sums' columns summed the gradients of gamma and beta (1e-5 relative:
    fp32 sums in another order)."""
    M = 70
    gen = torch.Generator().manual_seed(C + 12)
    z = torch.randn(M, C, generator=gen, dtype=torch.float64)
    gamma = 1 + 0.1 * torch.randn(C, generator=gen, dtype=torch.float64)
    beta = 0.1 * torch.randn(C, generator=gen, dtype=torch.float64)
    g = torch.randn(M, C, generator=gen, dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (z, gamma, beta)]
    out = torch.nn.functional.layer_norm(leaves[0], (C,), leaves[1],
                                         leaves[2], eps=fused_ffn.LN_EPS)
    dz, dgamma, dbeta = torch.autograd.grad(out, leaves, g)
    mean = z.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((z - mean) ** 2).mean(dim=-1) + fused_ffn.LN_EPS)
    n = (z - mean) * rstd[:, None]
    drop = dropout.Drop(13, 5, rate)
    got_dz, masked, partial = backward.ln_dropout_bwd_reference(
        g.float(), n.float(), rstd.float(), gamma.float(), drop,
        torch.float32)
    want_masked = (torch.where(drop.keep((M, C)), dz * drop.scale,
                               torch.zeros_like(dz)) if rate else dz)
    sums = partial.sum(dim=0)
    for got, want in ((got_dz, dz), (masked, want_masked),
                      (sums[:C], dgamma), (sums[C:2 * C], dbeta),
                      (sums[2 * C:], want_masked.sum(dim=0))):
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    assert partial.shape == (-(-M // backward.PARTIAL_ROWS), 3 * C)


###############################################################################
# A train step through the entry point's step
###############################################################################


def test_train_step_matches_jax_at_384(monkeypatch):
    """One bf16 train step of a 2-layer transformer at (C, d_head) = (384,
    128) through ``make_train_step``, dropout 0, T = 40 (the whole-layer
    path: the plain chain of the card's kernels), from the same npz
    parameters as JAX's step (its Pallas train kernels in interpret mode):
    the loss within 1e-4 relative, and each parameter after one Adam step
    within 2^-8 relative (measured <= 1.2e-3). The biases start at 0, so
    after the step they are lr times the sign of their gradient (Adam's
    first step), and a gradient element near 0 takes its sign from
    rounding: each element within 2 lr, and at most 2% of a bias's
    elements more than lr / 100 apart (measured <= 1.3%); the key biases,
    whose whole gradient is rounding noise (softmax is shift-invariant in
    them), by the first bound alone."""
    step_against_jax(monkeypatch, 384, 3)


def step_against_jax(monkeypatch, C, heads):
    """``test_train_step_matches_jax_at_384``'s check at width C with
    ``heads`` heads."""
    config = ppgs_tpu.config.get('mel').replace(
        num_hidden_layers=2, hidden_channels=C, attention_heads=heads,
        ffn_channels=F, dropout=0.0)
    params = jax_transformer.init(jax.random.PRNGKey(3), config)
    zero = {key for key, value in ppgs_tpu_torch.load.flatten_params(
        jax.device_get(params)).items() if not np.any(value)}
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
    model = train_core.init_model(port_config, 'cpu')
    model.load_state_dict(convert.params_from_jax(
        ppgs_tpu_torch.load.flatten_params(jax.device_get(params))))

    rng = np.random.default_rng(14)
    lengths = np.array([T, T - 10])
    features = rng.standard_normal((B, config.input_channels, T)).astype(
        np.float32)
    targets = rng.integers(0, 40, size=(B, T)).astype(np.int64)
    for i, n in enumerate(lengths):
        features[i, :, n:] = 0
        targets[i, n:] = -100

    def interpret(module, name):
        original = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: original(
            *a, **{**k, 'interpret': True}))

    interpret(jax_elt, 'encoder_layer_train')
    interpret(jax_fa, 'flash_attention_train')
    monkeypatch.setattr(jax_transformer, '_use_flash', lambda d: True)
    optimizer = jax_train.make_optimizer(config)
    step_fn = jax_train.make_train_step(config, optimizer)
    want_params, _, want_loss, _ = step_fn(
        params, optimizer.init(params), jnp.asarray(features),
        jnp.asarray(targets), jnp.asarray(lengths), jax.random.PRNGKey(1),
        with_stats=True)

    calls = []
    original = elt.encoder_layer_train
    monkeypatch.setattr(elt, 'encoder_layer_train', lambda *a, **k: (
        calls.append(1), original(*a, **k))[1])
    port_opt = train_core.make_optimizer(model.parameters(), config)
    step = train_core.make_train_step(model, port_config, port_opt)
    got_loss, _ = step(torch.from_numpy(features), torch.from_numpy(targets),
                       torch.from_numpy(lengths), seed=0)
    assert transformer.use_kernels(port_config, 'cpu', train=True)
    assert len(calls) == 2
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-4)
    names = [n for n, _ in model.named_parameters()]
    got = convert.params_to_jax(dict(zip(
        names, [p.detach() for p in model.parameters()])))
    want = ppgs_tpu_torch.load.flatten_params(jax.device_get(want_params))
    assert sorted(got) == sorted(want)
    lr = config.learning_rate
    assert zero and all('bias' in key or key.endswith(('bq', 'bk', 'bv',
                                                        'bo', 'b1', 'b2'))
                        for key in zero)
    for key in want:
        apart = np.abs(got[key] - want[key])
        if key not in zero:
            assert _rel(got[key], want[key]) <= BF16_ULP, (
                key, _rel(got[key], want[key]))
            continue
        assert apart.max() <= 2 * lr, (key, apart.max())
        if not key.endswith('attn.bk'):
            assert (apart > lr / 100).mean() <= 0.02, (
                key, (apart > lr / 100).mean())


###############################################################################
# The wrappers and the gate
###############################################################################


@pytest.mark.parametrize('C', RULE_C)
def test_train_wrappers_launch_every_width_of_the_rule(C, monkeypatch):
    """K3's train form, K4's two train forms, ``ffn_train_bwd`` and
    ``ln_dropout_bwd`` take every C of the rule: each wrapper checks its
    operands and hands its kernel the width (the launch recorded here, not
    run); ``ffn_train_bwd`` hands the run-time route, every C but 256 and
    512, W1 as stored and W2 transposed."""
    calls = []
    monkeypatch.setattr(kernels, 'launch', lambda symbol, *args, device:
                        calls.append((symbol, args)))
    bf16, M, Fh = torch.bfloat16, 3, 384
    drop = dropout.Drop(1, 3, 0.1)
    x, vec = torch.zeros(M, C), torch.zeros(C)
    out, n, rstd = elk.launch_out_proj_ln(
        x.to(bf16), torch.zeros(C, C, dtype=bf16), vec, x, vec, vec,
        drop=drop, stats=True)
    symbol, args = calls.pop()
    assert symbol == 'ppgs_out_proj_ln' and args[9:11] == (M, C)
    assert n.shape == (M, C) and rstd.shape == (M,)
    w1, w2 = (torch.zeros(C, Fh, dtype=bf16), torch.zeros(Fh, C, dtype=bf16))
    b1 = torch.zeros(Fh)
    for ln, xs in (((vec, vec), x), (None, x.to(bf16))):
        got = fused_ffn._launch_ffn(xs, w1, b1, w2, vec, ln, False, drop,
                                    drop.at(4), stats=True)
        symbol, args = calls.pop()
        assert symbol == 'ppgs_ffn_ln' and args[13:16] == (M, Fh, C)
        assert got[0].shape == (M, C)
        assert got[3].shape == fused_ffn.keep_words_shape(M, Fh)
    # The backward's wrappers run their plain versions on CPU tensors:
    # meta tensors (no storage, address 0) take the kernels' side
    x, vec, w1, b1, w2 = (t.to('meta') for t in (x, vec, w1, b1, w2))
    fused_ffn.ffn_train_bwd(x, x.to(bf16), w1, b1, w2, drop,
                            torch.zeros(fused_ffn.keep_words_shape(M, Fh),
                                        dtype=torch.int32, device='meta'), x)
    symbol, args = calls.pop()
    assert symbol == 'ppgs_ffn_train_bwd' and args[16:19] == (M, Fh, C)
    assert (args[6] is None) == (args[7] is None) == (C in (256, 512))
    backward.ln_dropout_bwd(x, x, torch.ones(M, device='meta'), vec, drop,
                            bf16)
    symbol, args = calls.pop()
    assert symbol == 'ppgs_ln_dropout_bwd' and args[8:10] == (M, C)
    assert not calls


def test_training_gate_takes_every_pair_of_the_rule():
    """``use_kernels(config, 'cuda', train=True)`` is True for every (C,
    d_head) with C % 128 == 0 from 128 to 2048, d_head 128 or 256 and C %
    d_head == 0 (24 pairs), as in inference; past 2048 it raises, naming
    ROADMAP.md; on the CPU it takes the plain path."""
    mel = ppgs_tpu_torch.config.get('mel')
    taken = set()
    for C in range(128, 2049, 128):
        for D in (128, 256):
            if C % D:
                continue
            config = mel.replace(hidden_channels=C, attention_heads=C // D)
            assert transformer.inference_width_ok(C, D)
            assert transformer.use_kernels(config, 'cuda', train=True) is True
            assert transformer.use_kernels(config, 'cpu', train=True) is True
            taken.add((C, D))
    assert len(taken) == 24
    for C, heads in ((2176, 17), (2560, 2), (2304, 9)):
        config = mel.replace(hidden_channels=C, attention_heads=heads)
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            transformer.use_kernels(config, 'cuda', train=True)
        assert transformer.use_kernels(config, 'cpu', train=True) is True
