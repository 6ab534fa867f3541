"""The PPG transformer at the (C, d_head) pairs of the card's kernels that
no registered config has: (256, 256), (512, 128), (768, 128) and (768,
256), on the CPU, at the real widths and a narrow depth (2 layers, B = 2,
T <= 40).

The same seeded numpy inputs and npz weights go through the JAX package
and the port's plain path: inference through ``from_features`` in fp32 at
1e-4 and in bf16 at atol 2e-2 (the PPGs); the whole train layer (B4) at
rate 0 in fp32, per tensor within 2^-8 relative and elementwise within the
JAX kernel tests' 2e-3, against the JAX package's Pallas kernel in
interpret mode. At C = 768, the width whose FFN kernels are new, the
plain versions of K4 with ReLU (its LayerNorm form),
of its two train forms and of ``ffn_train_bwd`` (through ``ffn_train``)
against the JAX kernels in interpret mode, and ``ln_dropout_bwd``'s against
autograd. Last the gates: the training gate is the intersection of the
train kernels' own rules (the layer kernels' width rule and the head
widths of K2 and the train attention), the inference gate the same rule,
and a width outside it that the JAX rule sends to its kernels raises on
the card, naming ROADMAP.md.

The CUDA kernels run only on a card: ``chip_smoke.py --slices widths``
holds each against these plain versions there.
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
from ppgs_tpu.ops import fused_ffn as jax_ffn

import ppgs_tpu_torch
from ppgs_tpu_torch.models import transformer
from ppgs_tpu_torch.ops import backward, dropout
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
from ppgs_tpu_torch.ops import encoder_layer_train as elt
from ppgs_tpu_torch.ops import flash_attention as fa
from ppgs_tpu_torch.ops import fused_ffn

from test_torch_train_kernels import _layer_pair, _port_grads_as_jax

PAIRS = ((256, 256), (512, 128), (768, 128), (768, 256))
NEW_C, F = 768, 2048
LAYERS, B, T = 2, 2, 40
BF16_ULP = 2.0 ** -8
BLOCK = 128              # the JAX FFN kernels' row block here


def _ids(pairs):
    return [pytest.param(c, d, id=f'C{c}-d{d}') for c, d in pairs]


def _t(array, dtype=torch.float32):
    return torch.from_numpy(np.array(array, np.float32)).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


###############################################################################
# The slice: inference through the entry points
###############################################################################


@pytest.mark.parametrize('C,D', _ids(PAIRS))
def test_from_features_matches_jax(tmp_path, C, D):
    """``from_features`` on the same npz and features: fp32 at 1e-4, bf16
    PPGs at atol 2e-2 (the bf16 gate of the card's checks). In bf16 the
    port's plain path is the kernels' chain (d_head % 128 == 0: the JAX
    rule), JAX's on the CPU its XLA path."""
    rng = np.random.default_rng(C + D)
    features = rng.standard_normal((B, 80, T)).astype(np.float32)
    lengths = np.array([T, 27])
    for compute_dtype, tol in (('float32', dict(rtol=1e-4, atol=1e-4)),
                               ('bfloat16', dict(rtol=0, atol=2e-2))):
        config = ppgs_tpu.Config(
            num_hidden_layers=LAYERS, hidden_channels=C,
            attention_heads=C // D, compute_dtype=compute_dtype)
        path = tmp_path / f'{compute_dtype}.npz'
        ppgs_tpu.load.save_params(
            path, jax_transformer.init(jax.random.PRNGKey(C + D), config))
        port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
        assert transformer.use_kernels(port_config, 'cpu') is (
            compute_dtype == 'bfloat16')
        want = np.asarray(ppgs_tpu.from_features(
            features, lengths, checkpoint=path, config=config))
        got = ppgs_tpu_torch.from_features(
            features, lengths, checkpoint=path, config=port_config,
            device='cpu').numpy()
        assert got.shape == want.shape == (B, 40, T)
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(got[i, :, :n], want[i, :, :n],
                                       err_msg=compute_dtype, **tol)


###############################################################################
# B4 at rate 0 against the JAX kernel
###############################################################################


@pytest.mark.parametrize('C,D', _ids(PAIRS))
def test_encoder_layer_train_matches_jax_kernel(C, D):
    """The whole train layer at rate 0 (the plain chain of the card's
    kernels) against ``encoder_layer_train`` in interpret mode, in fp32:
    out, dx and the 16 JAX gradients each within 2^-8 relative and within
    rtol = atol = 2e-3 elementwise (tests/test_encoder_layer_train.py's
    envelope). In bf16 the two sides share their rounding points, but at
    these widths a hidden unit near 0 flips its relu' between two fp32 sums
    in other orders now and then and moves every gradient upstream of it by
    up to 1e-2 relative (test_torch_train_kernels.py holds bf16 with that
    allowance at C = 512); the bf16 arithmetic is held by the inference
    test above and on the card."""
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
            # the key bias's true gradient is ~0 (softmax is shift-
            # invariant in it): only its elementwise bound is meaningful
            assert _rel(a, b) <= BF16_ULP, (key, _rel(a, b))


###############################################################################
# The new kernel instances at C = 768 against the JAX kernels
###############################################################################


def _ffn_inputs(seed, M, C=NEW_C):
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
    return np.concatenate([x, np.zeros((rows - x.shape[0], x.shape[1]),
                                       x.dtype)])


@pytest.mark.parametrize('dtype,tol', [('bfloat16', 5e-2),
                                       ('float32', 1e-4)])
def test_k4_relu_768_forms_match_jax_kernel(dtype, tol):
    """K4 (768, ReLU): its inference LayerNorm form with round_input 1 and
    its B4 train form at rate 0 against ``ffn_residual_layernorm``, its B6
    train form (bf16 output) against ``ffn_train``'s forward, on 129 rows
    (a 128-row tile and one more); test_torch_ffn.py's tolerances."""
    M = 129
    x, w1, b1, w2, b2, g, beta = _ffn_inputs(M, M)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_ffn.ffn_residual_layernorm(
        jnp.asarray(_padded(x)), jnp.asarray(w1, jd), jnp.asarray(b1),
        jnp.asarray(w2, jd), jnp.asarray(b2), jnp.asarray(g),
        jnp.asarray(beta), block_m=BLOCK, interpret=True))[:M]
    tensors = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2, g, beta)]
    xt, w1t, b1t, w2t, b2t, gt, bt = tensors
    w1t, w2t = w1t.to(td), w2t.to(td)
    got = fused_ffn.ffn_residual_layernorm_reference(xt, w1t, b1t, w2t, b2t,
                                                     gt, bt)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    off = dropout.OFF
    out, n, rstd, keep = fused_ffn.ffn_train_fwd_reference(
        xt, w1t, b1t, w2t, b2t, off, off, (gt, bt))
    np.testing.assert_allclose(out.numpy(), want, rtol=tol, atol=tol)
    assert rstd.shape == (M,) and keep is None
    want_y = np.asarray(jax_ffn.ffn_train(
        *(jnp.asarray(a, jd) for a in (_padded(x), w1, b1, w2, b2)),
        dropout_rate=0.0, block_m=BLOCK, interpret=True).astype(
            jnp.float32))[:M]
    y, _, _, keep = fused_ffn.ffn_train_fwd_reference(
        *(torch.from_numpy(a).to(td) for a in (x, w1, b1, w2, b2)), off, off)
    assert y.dtype == td and y.shape == (M, NEW_C) and keep is None
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_ffn_train_768_matches_jax_kernel(dtype):
    """B6 at C = 768 and rate 0, forward and backward: the port's plain
    chain (K4's y_out form, ``ffn_train_bwd``'s plain version, the weight
    gradients' gemm and colsum) against ``ffn_train`` in interpret mode,
    each tensor within one bf16 ulp relative (fp32: 1e-4 elementwise)."""
    M = BLOCK
    arrays = _ffn_inputs(7, M)[:5]
    g = np.random.default_rng(8).standard_normal((M, NEW_C)).astype(
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


def test_ffn_train_bwd_768_reads_the_words_as_it_draws():
    """``ffn_train_bwd``'s plain version at C = 768 given the forward's keep
    words equals itself drawing them, in both forms, bit for bit."""
    M = 70
    x, w1, b1, w2, _, _, _ = _ffn_inputs(9, M)
    rng = np.random.default_rng(10)
    dy = _t(rng.standard_normal((M, NEW_C)), torch.bfloat16)
    residual = _t(rng.standard_normal((M, NEW_C)))
    w1t, w2t = _t(w1, torch.bfloat16), _t(w2, torch.bfloat16)
    drop = dropout.Drop(11, 3, 0.1)
    words = fused_ffn.keep_words_reference(drop, M, F)
    for xs, res in ((_t(x), residual), (_t(x, torch.bfloat16), None)):
        got = fused_ffn.ffn_train_bwd_reference(xs, dy, w1t, _t(b1), w2t,
                                                drop, words, res)
        want = fused_ffn.ffn_train_bwd_reference(xs, dy, w1t, _t(b1), w2t,
                                                 drop, None, res)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize('rate', [0.0, 0.1])
def test_ln_dropout_bwd_768_matches_autograd(rate):
    """``ln_dropout_bwd``'s plain version at C = 768 on an fp32 LayerNorm
    (its normalised rows and 1/std): dz is autograd's input gradient, the
    masked output autograd's gradient of the dropout that follows, the
    partial sums' columns summed the gradients of gamma and beta (1e-5
    relative: fp32 sums in another order)."""
    M, C = 70, NEW_C
    gen = torch.Generator().manual_seed(12)
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
# The gate
###############################################################################


def test_gate_is_the_intersection_of_the_kernel_tables():
    """The training gate takes every (C, d_head) that each kernel on the
    training path takes, read from their rules: the layer kernels' width
    rule (``fused_ffn.width_ok``: K1, K3's and K4's train forms,
    ``ffn_train_bwd``, and ``ln_dropout_bwd`` up to its
    ``LN_BWD_MAX_WIDTH``) and the head widths of K2 and the train attention
    that the JAX rule sends to the kernels (d_head % 128 == 0): 50 pairs,
    the six pairs of C = 256, 512, 768 and d_head 128, 256 among them."""
    d_heads = {d for d in range(128, backward.LN_BWD_MAX_WIDTH + 1, 128)
               if fa.d_head_ok(d) and fa.train_d_head_ok(d)}
    want = {(c, d) for c in range(128, backward.LN_BWD_MAX_WIDTH + 1, 128)
            for d in d_heads if fused_ffn.width_ok(c) and c % d == 0}
    assert len(want) == 50 and want > {
        (256, 128), (256, 256), (512, 128), (512, 256), (768, 128),
        (768, 256)}
    mel = ppgs_tpu_torch.config.get('mel')
    for C, D in want:
        config = mel.replace(hidden_channels=C, attention_heads=C // D)
        assert transformer.inference_width_ok(C, D)
        assert transformer.use_kernels(config, 'cuda', train=True) is True


def test_inference_gate_is_the_width_rule():
    """The inference gate: every (C, d_head) of the layer kernels' width
    rule (C % 128 == 0 up to 2048) with K2's head widths that the JAX rule
    sends to the kernels (128, 256) runs on the card, the six training
    pairs among them, as in training; the rule is ``fused_ffn.width_ok``,
    which K1's and K3's wrappers check too."""
    mel = ppgs_tpu_torch.config.get('mel')
    admitted = set()
    for C in range(128, 2049, 128):
        assert fused_ffn.width_ok(C) and elk.width_ok(C)
        for D in (128, 256):
            if C % D:
                continue
            config = mel.replace(hidden_channels=C, attention_heads=C // D)
            assert transformer.use_kernels(config, 'cuda') is True
            assert transformer.use_kernels(config, 'cuda', train=True)
            admitted.add((C, D))
    assert len(admitted) == 16 + 8
    assert not any(fused_ffn.width_ok(C) for C in (0, 64, 192, 320, 2176))


@pytest.mark.parametrize('C,heads', [(2304, 2), (384, 3)])
def test_gate_still_raises_outside_the_tables(C, heads):
    """A width that the JAX rule sends to its kernels and the card's do not
    take raises on the card, naming ROADMAP.md, and takes the plain path on
    the CPU: C = 2304 (past 2048) with d_head 1152 in inference and
    training. C = 384 with d_head 128, which the training gate refused
    before the train kernels took every width of the rule, is taken in
    both."""
    config = ppgs_tpu_torch.config.get('mel').replace(
        hidden_channels=C, attention_heads=heads)
    assert (C // heads) % 128 == 0
    for train in (False, True):
        if C > 2048:
            with pytest.raises(NotImplementedError, match='ROADMAP.md'):
                transformer.use_kernels(config, 'cuda', train=train)
        else:
            assert transformer.use_kernels(config, 'cuda',
                                           train=train) is True
    assert transformer.use_kernels(config, 'cpu', train=True) is True
