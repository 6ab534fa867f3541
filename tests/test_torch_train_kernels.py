"""The port's train kernels on the CPU: their plain PyTorch versions against
the JAX package's Pallas train kernels in interpret mode (rate 0), against
hand-written autograd replicas fed the same Philox masks (dropout on), and
the Philox stream itself.

The CUDA kernels run only on a card: chip_smoke.py holds each of them
against these plain versions there, with dropout 0.1 and identical masks.
Tolerances: the JAX kernel tests' envelopes (tests/test_encoder_layer_train.py
rtol/atol 2e-3) unless a case states its own. B4, B5 and B6 are held at the
mel model's width (C = 256, 2 heads of 128, F = 2048) and at the w2v2fb and
w2v2fc heads' (C = 512, 2 heads of 256; F cut to 256 here): the cases whose
ids end in -C512.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppgs_tpu
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.ops import encoder_layer_train as jax_elt
from ppgs_tpu.ops import flash_attention as jax_fa
from ppgs_tpu.ops import fused_ffn as jax_ffn

from ppgs_tpu_torch.models.transformer import EncoderLayer
from ppgs_tpu_torch.ops import backward
from ppgs_tpu_torch.ops import dropout
from ppgs_tpu_torch.ops import encoder_layer_train as elt
from ppgs_tpu_torch.ops import flash_attention as fa
from ppgs_tpu_torch.ops import fused_ffn

C, H, F = 256, 2, 2048
HEAD_C, HEAD_F = 512, 256       # the w2v2fb head's width, a narrow F


def _widths(*cases):
    """``cases`` (tuples of arguments) at the mel model's width and the
    head's, (C, F) last: the head's ids end in -C512."""
    return [pytest.param(*case, c, f, id='-'.join(map(str, case)) + (
        '' if c == C else f'-C{c}'))
            for c, f in ((C, F), (HEAD_C, HEAD_F)) for case in cases]


def _t(array, dtype=torch.float32):
    return torch.from_numpy(np.array(array, np.float32)).to(dtype)


###############################################################################
# Philox
###############################################################################


@pytest.mark.parametrize('counter,key,want', [
    ((0, 0, 0, 0), (0, 0), '6627e8d5 e169c58d bc57ac4c 9b00dbd8'),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     '408f276d 41c83b0e a20bc7c6 6d5451fd'),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), 'd16cfe09 94fdcceb 5001e420 24126ea1'),
])
def test_philox_known_answers(counter, key, want):
    """Random123's philox4x32-10 known-answer vectors."""
    words = dropout.philox(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert ' '.join(f'{int(w):08x}' for w in words) == want


def test_keep_fraction_at_rate_0_1():
    n = 1 << 20
    kept = dropout.keep_mask((n,), seed=2024, site_id=3, rate=0.1).sum()
    sigma = math.sqrt(n * 0.1 * 0.9)
    assert abs(kept.item() - 0.9 * n) < 4 * sigma


def test_masks_deterministic_per_seed_and_site():
    shape = (4, 33, 70)
    a = dropout.keep_mask(shape, 7, 2, 0.3)
    assert torch.equal(a, dropout.keep_mask(shape, 7, 2, 0.3))
    assert not torch.equal(a, dropout.keep_mask(shape, 8, 2, 0.3))
    assert not torch.equal(a, dropout.keep_mask(shape, 7, 3, 0.3))
    # 64-bit seeds: the high word counts
    assert not torch.equal(dropout.keep_mask(shape, 7 + (1 << 40), 2, 0.3),
                           a)


def test_masks_independent_of_the_block_split():
    """An element's bit is a function of its flat index alone: any subset
    of indices, drawn one Philox call per element as a kernel block would,
    gives the full mask's bits; and the leading rows of a batch draw the
    same bits whatever the batch size."""
    seed, site, shape = 99, 5, (6, 2, 40, 40)
    full = dropout.bits(math.prod(shape), seed, site)
    index = torch.randperm(full.numel(), generator=torch.Generator()
                           .manual_seed(0))[:997]
    g = index >> 2
    lo, hi = dropout.seed_words(seed)
    words = torch.stack(dropout.philox(
        (g & 0xFFFFFFFF, g >> 32, torch.full_like(g, site),
         torch.zeros_like(g)), (lo, hi)), dim=1)
    assert torch.equal(words[torch.arange(len(index)), index & 3],
                       full[index])
    small = dropout.keep_mask((2,) + shape[1:], seed, site, 0.5)
    assert torch.equal(small, dropout.keep_mask(shape, seed, site, 0.5)[:2])


###############################################################################
# B4: the whole layer
###############################################################################


def _layer_pair(seed=0, C=C, F=F):
    """The JAX init's layer 0 and the port's EncoderLayer with its values,
    at width C with an F-wide FFN."""
    params = jax_transformer.init(
        jax.random.PRNGKey(seed),
        ppgs_tpu.Config(hidden_channels=C, ffn_channels=F))
    layer = params['layers'][0]
    port = EncoderLayer(C, F)
    a = layer['attn']
    values = {
        'attn.wqkv': np.concatenate([a['wq'], a['wk'], a['wv']], axis=1),
        'attn.bqkv': np.concatenate([a['bq'], a['bk'], a['bv']]),
        'attn.wo': a['wo'], 'attn.bo': a['bo'],
        'norm1.scale': layer['norm1']['scale'],
        'norm1.bias': layer['norm1']['bias'],
        'ffn.w1': layer['ffn']['w1'], 'ffn.b1': layer['ffn']['b1'],
        'ffn.w2': layer['ffn']['w2'], 'ffn.b2': layer['ffn']['b2'],
        'norm2.scale': layer['norm2']['scale'],
        'norm2.bias': layer['norm2']['bias']}
    port.load_state_dict({k: _t(v) for k, v in values.items()})
    return layer, port


def _port_grads_as_jax(port):
    """The port layer's gradients in the JAX layer's keys."""
    grads = {name: p.grad.numpy() for name, p in port.named_parameters()}
    out = {}
    for kind in 'wb':
        for name, part in zip('qkv', np.split(grads[f'attn.{kind}qkv'], 3,
                                              axis=-1)):
            out[f"['attn']['{kind}{name}']"] = part
    for key, value in grads.items():
        if 'qkv' not in key:
            a, b = key.split('.')
            out[f"['{a}']['{b}']"] = value
    return out


BF16_ULP = 2.0 ** -8     # bf16's relative spacing at the top of a binade


def _assert_close(name, got, want, tol, exact=None):
    """fp32 (tol a number): elementwise rtol = atol = tol. bf16 (tol None):
    relative L2 error within one bf16 ulp. Both sides round at the same
    points in bf16, but take their fp32 sums in another order, so a value
    near a rounding boundary rounds the other way now and then (and a
    hidden unit near 0 flips its relu'): elementwise, such flips exceed any
    fp32-style envelope, while the whole tensor stays within one ulp
    (measured on these inputs: out 1.5e-4, dx 8e-4, matrix gradients
    <= 2.9e-3, vector gradients <= 1.7e-3). The key bias is skipped in
    bf16, as tests/test_encoder_layer_train.py skips it: softmax is
    shift-invariant in it, so its true gradient is ~0 and only rounding
    noise is left.

    ``exact``: the same function in fp32 (the C = 512 cases). There one
    relu' flip was seen on these inputs: a hidden unit 5e-4 from 0 moved
    across it by an LN1 output one bf16 ulp apart on the two sides, which
    moves dx and every gradient upstream of the FFN hidden by up to 1e-2
    relative. So there the bound is the larger of one ulp and half the JAX
    bf16 result's own distance from the fp32 one: two sides that rounded
    at other points would be about 1.4 of that distance apart, and these
    share most of their bf16 rounding (measured: port to JAX at most 0.26
    of JAX to fp32)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if tol is not None:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=name)
    elif "['bk']" not in name:
        norm = np.linalg.norm(want)
        err = np.linalg.norm(got - want) / norm
        bound = BF16_ULP if exact is None else max(
            BF16_ULP, 0.5 * np.linalg.norm(
                want - np.asarray(exact, np.float32)) / norm)
        assert err <= bound, (name, err, bound)


def _assert_grads(port, jax_grads, tol, exact_grads=None):
    got = _port_grads_as_jax(port)
    flat = jax.tree_util.tree_flatten_with_path(jax_grads)[0]
    exact = (None if exact_grads is None else dict(
        (jax.tree_util.keystr(path), value) for path, value in
        jax.tree_util.tree_flatten_with_path(exact_grads)[0]))
    assert len(flat) == len(got) == 16
    for path, want in flat:
        key = jax.tree_util.keystr(path)
        _assert_close(key, got[key], want, tol,
                      None if exact is None else exact[key])


# (compute dtype, causal, out tolerance, gradient tolerance); None: the
# bf16 criterion of _assert_close
@pytest.mark.parametrize('cd,causal,out_tol,grad_tol,C,F', _widths(
    ('float32', False, 1e-4, 2e-3),
    ('float32', True, 1e-4, 2e-3),
    ('bfloat16', False, None, None),
))
def test_encoder_layer_train_matches_jax_kernel(cd, causal, out_tol,
                                                grad_tol, C, F):
    B, T = 2, 64
    jax_layer, port = _layer_pair(C=C, F=F)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[T], [T - 14]])
    cot = rng.standard_normal((B, T, C)).astype(np.float32)

    def jax_run(dtype):
        def jax_loss(x_, layer):
            out = jax_elt.encoder_layer_train(
                x_, jnp.asarray(mask), layer, H, dropout_rate=0.0,
                causal=causal, compute_dtype=jnp.dtype(dtype),
                interpret=True)
            return (out * cot).sum(), out

        (_, out), grads = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                             has_aux=True)(
            jnp.asarray(x), jax_layer)
        return out, grads

    want, (gx, gp) = jax_run(cd)
    # At C = 512 the bf16 results are held against fp32's too (_assert_close)
    exact = (jax_run('float32') if cd == 'bfloat16' and C == HEAD_C
             else (None, (None, None)))

    xt = _t(x).requires_grad_()
    out = elt.encoder_layer_train_reference(
        xt, torch.from_numpy(mask), port, H, 0.0, causal=causal,
        compute_dtype=getattr(torch, cd))
    (out * _t(cot)).sum().backward()
    _assert_close('out', out.detach().numpy(), want, out_tol, exact[0])
    _assert_close('dx', xt.grad.numpy(), gx, grad_tol, exact[1][0])
    _assert_grads(port, gp, grad_tol, exact[1][1])


def test_encoder_layer_train_with_dropout_matches_replica():
    """Rate 0.3: the plain layer's gradients (the TPU kernel's backward
    rule, written out) equal autograd through a straightforward fp32
    replica fed the same Philox masks."""
    _layer_replica(C, F)


def _layer_replica(C, F):
    B, T, rate, seed, site = 2, 24, 0.3, 5, 1
    _, port = _layer_pair(1, C, F)
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((B, T, C))).requires_grad_()
    mask = torch.arange(T)[None] < torch.tensor([[T], [T - 7]])
    cot = _t(rng.standard_normal((B, T, C)))
    params = [x] + list(port.parameters())

    out = elt.encoder_layer_train_reference(
        x, mask, port, H, rate, seed=seed, site=site,
        compute_dtype=torch.float32)
    (out * cot).sum().backward()
    got = [p.grad.clone() for p in params]
    for p in params:
        p.grad = None

    def drop(t, s):
        keep = dropout.keep_mask(t.shape, seed, s, rate)
        return torch.where(keep, t / (1 - rate), torch.zeros_like(t))

    M, d = B * T, C // H
    a = port.attn
    qkv = x.reshape(M, C) @ a.wqkv + a.bqkv
    q, k, v = (t.reshape(B, T, H, d).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    s = (q @ k.transpose(-1, -2) / math.sqrt(d)).masked_fill(
        ~mask[:, None, None, :], -1e30)
    p = drop(torch.softmax(s, dim=-1), site)
    o1 = drop((p @ v).transpose(1, 2).reshape(M, C) @ a.wo + a.bo, site + 1)
    r = torch.nn.functional.layer_norm(x.reshape(M, C) + o1, (C,),
                                       port.norm1.scale, port.norm1.bias)
    h = drop(torch.relu(r @ port.ffn.w1 + port.ffn.b1), site + 2)
    y = drop(h @ port.ffn.w2 + port.ffn.b2, site + 3)
    want_out = torch.nn.functional.layer_norm(
        r + y, (C,), port.norm2.scale, port.norm2.bias).reshape(B, T, C)
    (want_out * cot).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               want_out.detach().numpy(), atol=1e-4)
    for p, g in zip(params, got):
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), rtol=2e-3,
                                   atol=2e-3)


###############################################################################
# B5: attention
###############################################################################


@pytest.mark.parametrize('cd,causal,tol,C,F', _widths(
    ('float32', False, 1e-4),
    ('float32', True, 1e-4),
    # bf16: both sides round the normalised probabilities before PV;
    # measured max difference 4.9e-4
    ('bfloat16', False, 2e-3),
))
def test_flash_attention_train_matches_jax_kernel(cd, causal, tol, C, F):
    """At C = 512 (2 heads of 256) the bf16 gradients reach [0.5, 1), where
    a result near a rounding boundary that rounds the other way moves by
    one bf16 ulp, 3.9e-3 (one such element of 65,536 seen): the bf16 case
    there takes rtol 2e-3 + 2^-8."""
    B, T = 2, 64
    rtol = tol + (BF16_ULP if cd == 'bfloat16' and C == HEAD_C else 0.0)
    rng = np.random.default_rng(1)
    q, k, v, do = (rng.standard_normal((B, T, C)).astype(np.float32)
                   for _ in range(4))
    mask = np.arange(T)[None] < np.array([[T], [T - 20]])
    jd = jnp.dtype(cd)

    def jax_loss(q_, k_, v_):
        out = jax_fa.flash_attention_train(
            q_, k_, v_, jnp.asarray(mask), H, dropout_rate=0.0,
            causal=causal, interpret=True)
        return (out.astype(jnp.float32) * do).sum(), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(t, jd) for t in (q, k, v)))
    td = getattr(torch, cd)
    qkv = [_t(t, td).requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_train_reference(*qkv, torch.from_numpy(mask), H,
                                             0.0, causal=causal)
    (out.float() * _t(do)).sum().backward()
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=tol)
    for t, g in zip(qkv, grads):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(g, np.float32), rtol=rtol,
                                   atol=tol)


def test_flash_attention_train_with_dropout_matches_replica():
    _attention_replica(C)


def _attention_replica(C, F=None):
    B, T, rate, seed, site = 2, 40, 0.3, 7, 5
    gen = torch.Generator().manual_seed(2)
    qkv = torch.randn(B, T, 3 * C, generator=gen).requires_grad_()
    mask = torch.arange(T)[None] < torch.tensor([[T], [25]])
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    out = fa.flash_attention_train_reference(q, k, v, mask, H, rate, seed,
                                             site=site)
    cot = torch.randn(out.shape, generator=gen)
    (out * cot).sum().backward()
    got = qkv.grad.clone()
    qkv.grad = None

    d = C // H
    q4, k4, v4 = (t.reshape(B, T, H, d).transpose(1, 2) for t in (q, k, v))
    s = (q4 @ k4.transpose(-1, -2) / math.sqrt(d)).masked_fill(
        ~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    p = torch.where(dropout.keep_mask(p.shape, seed, site, rate),
                    p / (1 - rate), torch.zeros_like(p))
    want = (p @ v4).transpose(1, 2).reshape(B, T, C)
    (want * cot).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), qkv.grad.numpy(), atol=1e-5)


###############################################################################
# B6: FFN
###############################################################################


def _ffn_inputs(seed, M, F_=512, C=C):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, C)).astype(np.float32),
            (rng.standard_normal((C, F_)) / 16).astype(np.float32),
            (rng.standard_normal(F_) * 0.1).astype(np.float32),
            (rng.standard_normal((F_, C)) / math.sqrt(F_)).astype(np.float32),
            (rng.standard_normal(C) * 0.1).astype(np.float32))


# bf16 (None): the output and the gradients are bf16 on both sides (the JAX
# rule casts them to the operand dtype); _assert_close's criterion
# (measured relative L2 errors <= 6.3e-5)
@pytest.mark.parametrize('cd,tol,C,F', _widths(('float32', 1e-4),
                                             ('bfloat16', None)))
def test_ffn_train_matches_jax_kernel(cd, tol, C, F):
    M = 128
    arrays = _ffn_inputs(4, M, C=C)
    g = np.random.default_rng(5).standard_normal((M, C)).astype(np.float32)
    jd = jnp.dtype(cd)

    def jax_loss(*args):
        out = jax_ffn.ffn_train(*args, dropout_rate=0.0, block_m=M,
                                interpret=True)
        return (out.astype(jnp.float32) * g).sum(), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=tuple(range(5)),
                                          has_aux=True)(
        *(jnp.asarray(a, jd) for a in arrays))
    td = getattr(torch, cd)
    tensors = [_t(a, td).requires_grad_() for a in arrays]
    out = fused_ffn.ffn_train_reference(*tensors, 0.0)
    (out.float() * _t(g)).sum().backward()
    _assert_close('out', out.float().detach().numpy(), want, tol)
    for name, t, gr in zip(('dx', 'dw1', 'db1', 'dw2', 'db2'), tensors,
                           grads):
        _assert_close(name, t.grad.float().numpy(), gr, tol)


def test_ffn_train_with_dropout_matches_replica():
    _ffn_replica(C)


def _ffn_replica(C, F=None):
    M, rate, seed, site = 70, 0.3, 9, 3
    tensors = [_t(a).requires_grad_() for a in _ffn_inputs(6, M, 256, C)]
    x, w1, b1, w2, b2 = tensors
    out = fused_ffn.ffn_train_reference(x, w1, b1, w2, b2, rate, seed, site)
    cot = _t(np.random.default_rng(7).standard_normal((M, C)))
    (out * cot).sum().backward()
    got = [t.grad.clone() for t in tensors]
    for t in tensors:
        t.grad = None

    def drop(t, s):
        keep = dropout.keep_mask(t.shape, seed, s, rate)
        return torch.where(keep, t / (1 - rate), torch.zeros_like(t))

    want = drop(drop(torch.relu(x @ w1 + b1), site) @ w2 + b2, site + 1)
    (want * cot).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=1e-5)
    for t, g in zip(tensors, got):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=2e-5)


@pytest.mark.parametrize('replica', [_layer_replica, _attention_replica,
                                     _ffn_replica],
                         ids=['layer', 'attention', 'ffn'])
def test_dropout_replicas_at_the_head_width(replica):
    """The three dropout-replica checks above (B4, B5, B6 at rate 0.3) at
    the w2v2fb head's width, C = 512 with 2 heads of 256."""
    replica(HEAD_C, HEAD_F)


###############################################################################
# Wrappers
###############################################################################


def test_train_wrappers_take_plain_version_on_cpu():
    """On CPU tensors every train kernel wrapper returns its plain
    version's result and launches nothing."""
    wrappers = (fa.attention_train_fwd, fa.row_dot, fa.attention_train_bwd,
                fused_ffn.ffn_train_fwd, fused_ffn.ffn_train_bwd,
                elt.out_proj_ln_train, backward.ln_dropout_bwd,
                backward.gemm, backward.colsum)
    before = [w.launches for w in wrappers]
    gen = torch.Generator().manual_seed(0)
    B, T = 2, 20
    drop = dropout.Drop(3, 1, 0.2)
    qkv = torch.randn(B, T, 3 * C, generator=gen).to(torch.bfloat16)
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    mask = torch.ones(B, T, dtype=torch.bool)
    args = (q, k, v, mask, H, 0.1, False, drop)
    o, _, lse, keep = fa.attention_train_fwd(*args)
    assert torch.equal(o, fa.attention_train_fwd_reference(*args)[0])
    d_row = fa.row_dot(o, o, H)
    assert torch.equal(d_row, fa.row_dot_reference(o, o, H))
    bargs = (q, k, v, mask, lse, keep, o, d_row, H, 0.1, 0.07, False, drop)
    assert torch.equal(fa.attention_train_bwd(*bargs)[0],
                       fa.attention_train_bwd_reference(*bargs)[0])
    x = torch.randn(B * T, C, generator=gen)
    w1 = torch.randn(C, 256, generator=gen).to(torch.bfloat16)
    w2 = torch.randn(256, C, generator=gen).to(torch.bfloat16)
    b1, b2 = torch.zeros(256), torch.zeros(C)
    fargs = (x.to(torch.bfloat16), w1, b1, w2, b2, drop, drop.at(2))
    y, _, _, hkeep = fused_ffn.ffn_train_fwd(*fargs)
    want_y, _, _, want_keep = fused_ffn.ffn_train_fwd_reference(*fargs)
    assert torch.equal(y, want_y) and torch.equal(hkeep, want_keep)
    y16 = x.to(torch.bfloat16)
    for got, want in zip(
            fused_ffn.ffn_train_bwd(y16, y16, w1, b1, w2, drop, hkeep),
            fused_ffn.ffn_train_bwd_reference(y16, y16, w1, b1, w2, drop,
                                              hkeep)):
        assert torch.equal(got, want)
    ones = torch.ones(C)
    wo = w1[:, :C].contiguous()
    assert torch.equal(
        elt.out_proj_ln_train(y16, wo, b2, x, ones, b2, drop)[0],
        elt.out_proj_ln_train_reference(y16, wo, b2, x, ones, b2, drop)[0])
    assert torch.equal(
        backward.ln_dropout_bwd(x, None, None, None, drop, torch.bfloat16)[1],
        backward.ln_dropout_bwd_reference(x, None, None, None, drop,
                                          torch.bfloat16)[1])
    assert torch.equal(
        backward.gemm(y16, wo, False, True, torch.bfloat16)[0],
        backward.gemm_reference(y16, wo, False, True, torch.bfloat16)[0])
    assert torch.equal(    # the (1, 0) form with an fp32 a, split
        backward.gemm(x, y16, True, False, torch.bfloat16, splits=2)[0],
        backward.gemm_reference(x, y16, True, False, torch.bfloat16,
                                splits=2)[0])
    assert torch.equal(backward.colsum(x), backward.colsum_reference(x))
    assert [w.launches for w in wrappers] == before


###############################################################################
# The gemm kernel's split rule and operand rule
###############################################################################

# The weight-gradient forms' outputs (M, N): dW1, dW2, dWo, dWqkv
WEIGHT_FORMS = {'dW1': (C, F), 'dW2': (F, C), 'dWo': (C, C),
                'dWqkv': (C, 3 * C)}
ROWS = (256 * 512, 256 * 500)   # the whole-layer and per-layer paths


@pytest.mark.parametrize('rows', ROWS)
def test_gemm_split_partials_sum_to_the_product(rows):
    """The plain gemm's split partials at each weight form's split: chunks
    of a multiple of 64 rows, none empty, only the last ragged (ones count
    each chunk's rows), and their sum is the whole product."""
    for M, N in WEIGHT_FORMS.values():
        splits = backward.split_count(M, N, rows)
        chunk = backward._k_chunk(rows, splits)
        assert chunk % 64 == 0
        ones = torch.ones(rows, 1)
        parts, _ = backward.gemm_reference(ones, ones, True, False,
                                           torch.float32, splits=splits)
        assert parts[:, 0, 0].tolist() == (
            [chunk] * (splits - 1) + [rows - (splits - 1) * chunk])
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(rows, 16, generator=gen)
    b = torch.randn(rows, 32, generator=gen)
    splits = backward.split_count(C, F, rows)
    parts, _ = backward.gemm_reference(a, b, True, False, torch.float32,
                                       splits=splits)
    whole, _ = backward.gemm_reference(a, b, True, False, torch.float32)
    assert parts.shape == (splits, 16, 32)
    np.testing.assert_allclose(parts.sum(0).numpy(), whole.numpy(),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize('rows', ROWS)
def test_split_count_fills_one_wave(rows):
    """Tiles x splits fill one wave of the 132 SMs (at least 95% of it),
    one 128 x block_n(N) tile a block."""
    want = {'dW1': 8, 'dW2': 8, 'dWo': 64 if rows == ROWS[0] else 65,
            'dWqkv': 22}
    for name, (M, N) in WEIGHT_FORMS.items():
        tiles = -(-M // 128) * (N // backward.block_n(N))
        splits = backward.split_count(M, N, rows)
        assert splits == want[name], name
        assert 0.95 * 132 <= tiles * splits <= 132, name


def _forms(rows):
    """The six forms' gemm_shapes arguments -> (M, N, K)."""
    f32, bf16 = torch.float32, torch.bfloat16
    split = {name: backward.split_count(M, N, rows)
             for name, (M, N) in WEIGHT_FORMS.items()}
    return [
        (((rows, C), f32, (rows, F), 1, 0, split['dW1']), (C, F, rows)),
        (((rows, F), bf16, (rows, C), 1, 0, split['dW2']), (F, C, rows)),
        (((rows, C), bf16, (rows, C), 1, 0, split['dWo']), (C, C, rows)),
        (((rows, C), f32, (rows, 3 * C), 1, 0, split['dWqkv']),
         (C, 3 * C, rows)),
        (((rows, C), bf16, (C, C), 0, 1, 1, True), (rows, C, C)),
        (((rows, 3 * C), bf16, (C, 3 * C), 0, 1, 1, False, True),
         (rows, C, 3 * C)),
    ]


@pytest.mark.parametrize('rows', ROWS)
def test_gemm_shapes_take_the_six_forms(rows):
    for args, want in _forms(rows):
        assert backward.gemm_shapes(*args, addresses=(0, 256)) == want


@pytest.mark.parametrize('args', [
    ((64, 256), torch.bfloat16, (64, 256), 0, 0),        # (ta, tb) = (0, 0)
    ((64, 256), torch.bfloat16, (64, 256), 1, 1),        # (1, 1)
    ((256, 64), torch.float32, (128, 64), 0, 1),         # fp32 a untransposed
    ((256, 64), torch.float16, (128, 64), 0, 1),         # an fp16 a
    ((2, 64, 256), torch.bfloat16, (64, 256), 1, 0),     # a 3-D a
    ((64, 256), torch.bfloat16, (72, 256), 1, 0),        # depths differ
    ((64, 256), torch.bfloat16, (64, 200), 1, 0),        # N % 128 != 0
    ((64, 130), torch.float32, (64, 256), 1, 0),         # 520-byte rows of a
    ((256, 100), torch.bfloat16, (128, 100), 0, 1),      # 200-byte rows
    ((64, 256), torch.bfloat16, (64, 256), 1, 0, 2, True),   # split, bf16
    ((64, 256), torch.bfloat16, (64, 256), 1, 0, 2, False, True),  # + res
    ((256, 64), torch.bfloat16, (128, 64), 0, 1, 2),     # split, untransposed
    ((64, 256), torch.bfloat16, (64, 256), 1, 0, 0),     # no split at all
], ids=['tt00', 'tt11', 'f32-untransposed', 'fp16', '3d', 'depths', 'n200',
        'f32-rows', 'bf16-rows', 'split-bf16', 'split-residual',
        'split-untransposed', 'splits-0'])
def test_gemm_shapes_refuse_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        backward.gemm_shapes(*args)


def test_gemm_shapes_refuse_unaligned_addresses():
    args = ((64, 256), torch.bfloat16, (64, 256), 1, 0)
    assert backward.gemm_shapes(*args, addresses=(0, 16)) == (256, 256, 64)
    with pytest.raises(ValueError, match='aligned'):
        backward.gemm_shapes(*args, addresses=(0, 8))


###############################################################################
# colsum's split plan and its plain version
###############################################################################

STEP = 256 * 512
# colsum's shapes in a 256 x 512 step (dbqkv, the ln_dropout_bwd and db1
# partials, the weight gradients' split partials) and the plan's edges
COLSUM_SHAPES = [(1, 768), (255, 768), (256, 768), (STEP, 3 * C),
                 (STEP // 64, 3 * C), (STEP // 64, F)] + [
    (backward.split_count(M, N, STEP), M * N)
    for M, N in WEIGHT_FORMS.values()]


@pytest.mark.parametrize('R,N', COLSUM_SHAPES)
def test_colsum_plan_covers_every_row_once(R, N):
    """colsum's split ranges take every row once, in order, none empty;
    several only where each has COLSUM_MIN_ROWS rows or more, and together
    with the column blocks they fill at most one wave (132 SMs x 8)."""
    splits, chunk = backward.colsum_plan(R, N)
    ranges = [range(s * chunk, min(R, (s + 1) * chunk))
              for s in range(splits)]
    assert all(len(r) for r in ranges)
    assert [row for r in ranges for row in r] == list(range(R))
    col_blocks = -(-N // 256)
    if splits > 1:
        assert chunk >= backward.COLSUM_MIN_ROWS
        assert (splits - 1) * col_blocks < 132 * 8
    if (R, N) == (STEP, 3 * C):          # dbqkv: one full wave
        assert (splits, chunk) == (352, 373) and splits * col_blocks == 1056


def test_colsum_plan_of_no_rows():
    assert backward.colsum_plan(0, 768) == (1, 1)


@pytest.mark.parametrize('R,N', [(1, 5), (255, 768), (2048, 8), (8, 4096)])
def test_colsum_reference_is_the_column_sum(R, N):
    """The plain version is t.sum(0), and with round_to its bf16 rounding
    kept in fp32."""
    gen = torch.Generator().manual_seed(R + N)
    t = torch.randn(R, N, generator=gen)
    assert torch.equal(backward.colsum_reference(t), t.sum(0))
    np.testing.assert_allclose(backward.colsum_reference(t).numpy(),
                               t.double().sum(0).numpy(), rtol=1e-5,
                               atol=1e-4)
    rounded = backward.colsum_reference(t, torch.bfloat16)
    assert rounded.dtype == torch.float32
    assert torch.equal(rounded, t.sum(0).to(torch.bfloat16).float())
