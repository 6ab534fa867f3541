"""The port's conformer (``ppgs_tpu_torch/models/conformer.py``) and its
fused rel-pos attention B8 (``ops/flash_attention.py::rel_attention``)
against the JAX package on the CPU.

Both packages read one JAX-init parameter file, its biases, norms and
BatchNorm statistics drawn at random and its q/k projections scaled up so
that the attention is far from uniform. fp32 is held at the conformer
envelope of docs/GOLDEN_PARITY.md (rtol 1e-3, atol 2e-3). bf16 is held by
the relative L2 error, as the train kernels' tests hold bf16 tensors
(elementwise limits fail on rounding flips from sums taken in another
order). The JAX side runs the kernel branch as on its chip: the Pallas
kernel in interpret mode.
"""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu.convert import conformer_weights as jax_conformer_weights
from ppgs_tpu.models import conformer as jax_conformer
from ppgs_tpu.ops import flash_attention as jax_fa
from ppgs_tpu_torch.models import conformer
from ppgs_tpu_torch.ops import flash_attention as fa

TINY = dict(num_blocks=2)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _randomize(tree, rng, path=''):
    """Biases, norms and BatchNorm statistics at random, q/k scaled x4."""
    if isinstance(tree, list):
        return [_randomize(t, rng, path) for t in tree]
    if isinstance(tree, dict):
        return {k: _randomize(v, rng, f'{path}.{k}') for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    leaf = path.rsplit('.', 1)[-1]
    if leaf in ('bias', 'mean'):
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if leaf == 'scale':
        return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if leaf == 'var':
        return (1 + 0.5 * rng.random(a.shape)).astype(np.float32)
    if path.endswith(('attn.q.weight', 'attn.k.weight')):
        return 4 * a
    return a


def _both(tmp_path, compute_dtype='float32', seed=0):
    """(JAX params, JAX config, the port's prepared Conformer, its config)
    from one parameter file."""
    jcfg = jax_conformer.ConformerConfig(compute_dtype=compute_dtype, **TINY)
    params = _randomize(jax_conformer.init(jax.random.PRNGKey(seed), jcfg),
                        np.random.default_rng(seed))
    path = tmp_path / 'conformer.npz'
    ppgs_tpu.load.save_params(path, params)
    pcfg = conformer.ConformerConfig(**dataclasses.asdict(jcfg))
    model = conformer.Conformer(pcfg)
    model.load_state_dict(ppgs_tpu_torch.convert.conformer_params_from_jax(
        ppgs_tpu_torch.load.load_flat(path)), strict=True)
    ppgs_tpu_torch.convert.prepare_conformer(model)
    return (ppgs_tpu.load.load_params(path), jcfg,
            model.eval().requires_grad_(False), pcfg)


def _interpret(fn):
    return functools.wraps(fn)(lambda *a, **k: fn(*a, **{**k,
                                                         'interpret': True}))


def _jax_chip_path(monkeypatch):
    """JAX's conformer on its chip path: the fused attention kernel in
    interpret mode. The patched module attribute is read at trace time, so
    each call below traces afresh (nothing here is jitted around it)."""
    monkeypatch.setattr(jax_fa, 'fused_attention_bias',
                        _interpret(jax_fa.fused_attention_bias))
    monkeypatch.setattr(jax_conformer, '_use_fused_rel_attention',
                        lambda t: True)


###############################################################################
# B8 and its helpers
###############################################################################


def _bias_inputs(seed, B, T, H=4, dk=36):
    """q, k, v and the (B, H, T + 1, T) zero-column-padded position term."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, dk)).astype(np.float32)
               for _ in range(3))
    bias = 2 * rng.standard_normal((B, H, T + 1, T)).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize('T,lengths', [
    (64, [64, 40, 0]),              # ragged, one wholly masked window
    (72, [72, 1]),                  # one valid key
    (64, [64, 23]),                 # ragged, every window live
])
def test_fused_attention_bias_matches_jax_kernel(T, lengths):
    """B8's bias-form plain version against the Pallas kernel
    (legacy_shift=True) in interpret mode, on bf16 inputs: both sum in
    fp32 and round p / denom to bf16 before PV, so the bf16 outputs differ
    by rounding flips of one ulp of p at most: atol 1e-2 on outputs of
    typical size 0.3, and relative L2 <= 2^-8."""
    B = len(lengths)
    q, k, v, bias = _bias_inputs(T, B, T)
    mask = np.arange(T)[None] < np.asarray(lengths)[:, None]
    bf16 = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, bias)]
    want = np.asarray(jax_fa.fused_attention_bias(
        *bf16, jnp.asarray(mask), 4, legacy_shift=True, interpret=True),
        np.float32)
    tq, tk, tv, tb = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, bias))
    got = fa.fused_attention_bias_reference(tq, tk, tv, tb,
                                            torch.from_numpy(mask), 4)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 4, 36)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    assert _rel_l2(got, want) <= 2 ** -8
    dead = np.asarray(lengths) == 0
    assert not got[dead].any()


def test_rel_pos_table_and_rel_shift_are_exact():
    for T in (7, 64, 5003):
        np.testing.assert_array_equal(conformer.rel_pos_table(T, 144),
                                      jax_conformer._rel_pos_table(T, 144))
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 7)).astype(
        np.float32)
    np.testing.assert_array_equal(
        conformer.rel_shift(torch.from_numpy(x)).numpy(),
        np.asarray(jax_conformer._rel_shift(jnp.asarray(x))))


###############################################################################
# The module
###############################################################################


def _block_inputs(seed, B, T, C=144):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    lengths = np.array([T] + [T * 2 // 3] * (B - 1))
    mask = np.arange(T)[None] < lengths[:, None]
    return x, mask


@pytest.mark.parametrize('compute_dtype,fused,limit', [
    ('float32', False, None),       # the conformer envelope, elementwise
    ('bfloat16', True, 1e-2),       # B8 against the JAX kernel branch
    ('bfloat16', False, 1e-2),      # the bf16 branch of T > 2048
])
def test_rel_attention_matches_jax(tmp_path, monkeypatch, compute_dtype,
                                   fused, limit):
    """Both branches of the attention against JAX's, on block 0's weights.
    bf16: relative L2 <= 1e-2, about 3 bf16 ulps (the products round their
    outputs to bf16 at other places in the two frameworks)."""
    jparams, jcfg, model, pcfg = _both(tmp_path, compute_dtype)
    T = 72
    x, mask = _block_inputs(3, 2, T)
    pos = conformer.rel_pos_table(T, 144)[None]
    cd = jnp.dtype(compute_dtype)
    if fused:
        _jax_chip_path(monkeypatch)
    else:
        monkeypatch.setenv('PPGS_TPU_CONFORMER_KERNEL', '0')
    want = np.asarray(jax_conformer._rel_attention(
        jnp.asarray(x), jnp.asarray(pos), jparams['blocks'][0]['attn'],
        jnp.asarray(mask), 4, cd, None), np.float32)
    calls = []
    kernel = fa.rel_attention
    monkeypatch.setattr(fa, 'rel_attention',
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    # The rule picks the fused branch for bf16 at this T; the bf16 branch
    # of T > 2048 runs here with the limit lowered below T
    assert conformer.use_fused_rel_attention(T, 36, getattr(
        torch, compute_dtype)) == (compute_dtype == 'bfloat16')
    assert not conformer.use_fused_rel_attention(2049, 36, torch.bfloat16)
    if not fused:
        monkeypatch.setattr(conformer, 'MAX_FUSED_T', T - 1)
    got = conformer._rel_attention(
        torch.from_numpy(x), torch.from_numpy(pos),
        model.blocks[0].prepared.attn, torch.from_numpy(mask), 4,
        getattr(torch, compute_dtype)).numpy()
    assert calls == ([1] if fused else [])
    if limit is None:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)
    else:
        assert _rel_l2(got, want) <= limit


def test_embed_matches_jax(tmp_path):
    jparams, jcfg, model, pcfg = _both(tmp_path)
    feats = np.random.default_rng(4).standard_normal((2, 50, 80)).astype(
        np.float32)
    want_x, want_pos = jax_conformer.embed(jparams, jnp.asarray(feats), jcfg)
    got_x, got_pos = conformer.embed(model, torch.from_numpy(feats))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-3,
                               atol=2e-3)


def test_conv_module_matches_jax(tmp_path):
    jparams, jcfg, model, pcfg = _both(tmp_path)
    x, _ = _block_inputs(5, 2, 40)
    want = jax_conformer._conv_module(jnp.asarray(x),
                                      jparams['blocks'][1]['conv'],
                                      jnp.float32, None)
    block = model.blocks[1]
    got = conformer._conv_module(torch.from_numpy(x), block.conv,
                                 block.prepared.conv, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)


def test_block_matches_jax(tmp_path):
    jparams, jcfg, model, pcfg = _both(tmp_path)
    T = 48
    x, mask = _block_inputs(6, 3, T)
    pos = conformer.rel_pos_table(T, 144)[None]
    want = jax_conformer._block(jnp.asarray(x), jnp.asarray(pos),
                                jparams['blocks'][0], jnp.asarray(mask),
                                jcfg, None)
    got = conformer.block(torch.from_numpy(x), torch.from_numpy(pos),
                          model.blocks[0], torch.from_numpy(mask), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)


def _features(seed, B, T):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T, 80)).astype(np.float32)
    lengths = np.array([T] + [T - 9 * (i + 1) for i in range(B - 1)])
    for i, n in enumerate(lengths):
        feats[i, n:] = 0
    return feats, lengths


def test_forward_matches_jax_fp32(tmp_path):
    """The 2-block forward, ragged lengths, at the conformer envelope on
    each row's valid frames."""
    jparams, jcfg, model, pcfg = _both(tmp_path)
    feats, lengths = _features(7, 3, 70)
    want = np.asarray(jax_conformer.forward(
        jparams, jnp.asarray(feats), jnp.asarray(lengths), jcfg))
    got = conformer.forward(model, torch.from_numpy(feats),
                            torch.from_numpy(lengths)).numpy()
    assert got.shape == want.shape == (3, 70, 144)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=1e-3,
                                   atol=2e-3)


def test_forward_matches_jax_bf16_chip_path(tmp_path, monkeypatch):
    """The bf16 forward (B8's plain version in each block) against JAX's
    forward on its chip path (the Pallas kernel in interpret mode, a freshly
    jitted function: a cached trace would keep the XLA branch). Relative L2
    <= 1e-2 and cosine >= 0.9999 on the valid frames (3.7e-3 and 0.999993
    read): two blocks of bf16 products, rounded at other places in the two
    frameworks."""
    jparams, jcfg, model, pcfg = _both(tmp_path, 'bfloat16', seed=1)
    feats, lengths = _features(8, 2, 64)
    _jax_chip_path(monkeypatch)
    forward = jax.jit(lambda p, f, n: jax_conformer.forward(p, f, n, jcfg))
    want = np.asarray(forward(jparams, jnp.asarray(feats),
                              jnp.asarray(lengths)))
    calls = []
    kernel = fa.rel_attention
    monkeypatch.setattr(fa, 'rel_attention',
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    got = conformer.forward(model, torch.from_numpy(feats),
                            torch.from_numpy(lengths)).numpy()
    assert len(calls) == TINY['num_blocks']
    valid = np.arange(64)[None] < lengths[:, None]
    g, w = got[valid].ravel(), want[valid].ravel()
    assert _rel_l2(g, w) <= 1e-2
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.9999


###############################################################################
# Parameters
###############################################################################


def test_init_has_the_jax_layout():
    cfg = conformer.ConformerConfig(**TINY)
    want = ppgs_tpu.load.flatten_params(jax_conformer.init(
        jax.random.PRNGKey(0), jax_conformer.ConformerConfig(**TINY)))
    got = ppgs_tpu_torch.load.flatten_params(
        conformer.init(cfg, torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert set(conformer.Conformer(cfg).state_dict()) == set(want)
    assert all(v.dtype == np.float32 for v in got.values())


def test_state_dict_conversion_matches_jax(tmp_path):
    """The port's numpy copy of conformer_params_from_state_dict gives the
    JAX converter's pytree on a random ESPnet-keyed state dict, and
    conformer_params_from_checkpoint the same from a .pth of it."""
    rng = np.random.default_rng(9)
    jparams = jax_conformer.init(jax.random.PRNGKey(2),
                                 jax_conformer.ConformerConfig(**TINY))
    flat = ppgs_tpu.load.flatten_params(jparams)
    # An ESPnet state dict of the right shapes: invert the layouts
    sd = {}
    for key, value in flat.items():
        shape = np.asarray(value).shape
        sd[key] = rng.standard_normal(shape).astype(np.float32)
    esp = _espnet_names(sd)
    want = ppgs_tpu.load.flatten_params(
        jax_conformer_weights.conformer_params_from_state_dict(
            esp, num_blocks=2))
    got = ppgs_tpu_torch.load.flatten_params(
        ppgs_tpu_torch.convert.conformer_params_from_state_dict(
            esp, num_blocks=2))
    assert set(got) == set(want) == set(flat)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    # And from a 24epoch.pth-style file: 'encoder.'-prefixed tensors
    path = tmp_path / '24epoch.pth'
    torch.save({'encoder.' + k: torch.from_numpy(v) for k, v in esp.items()}
               | {'decoder.w': torch.zeros(1)}, path)
    got = ppgs_tpu_torch.load.flatten_params(
        ppgs_tpu_torch.convert.conformer_params_from_checkpoint(path, 2))
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


class _Payload:
    """A pickled object that is not a tensor: unpickling it would call
    ``print``, as a hostile file would call anything."""

    def __reduce__(self):
        return print, ('unpickled',)


def test_checkpoint_holding_objects_is_refused(tmp_path, capsys):
    """conformer_params_from_checkpoint unpickles with weights_only: a .pth
    that holds anything but tensors raises before it runs."""
    path = tmp_path / 'hostile.pth'
    torch.save({'encoder.embed.conv.0.weight': torch.zeros(1),
                'encoder.payload': _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError):
        ppgs_tpu_torch.convert.conformer_params_from_checkpoint(path, 2)
    assert 'unpickled' not in capsys.readouterr().out


def _espnet_names(flat):
    """An ESPnet ConformerEncoder state dict whose arrays, converted, have
    the JAX shapes of ``flat``."""
    sd = {}
    conv2d = {'embed.conv1': 'embed.conv.0', 'embed.conv2': 'embed.conv.2'}
    for key, value in flat.items():
        parts = key.split('.')
        if parts[0] == 'embed':
            module, leaf = '.'.join(parts[:2]), parts[2]
            if module in conv2d:
                sd[f'{conv2d[module]}.{leaf}'] = (
                    value.transpose(3, 2, 0, 1) if leaf == 'weight' else value)
            else:
                sd[f'embed.out.0.{leaf}'] = (value.T if leaf == 'weight'
                                             else value)
        elif parts[0] == 'after_norm':
            sd[f'after_norm.{_NORM[parts[1]]}'] = value
        else:
            i, rest = parts[1], parts[2:]
            sd.update(_block_entry(f'encoders.{i}', rest, value))
    return sd


_NORM = {'scale': 'weight', 'bias': 'bias'}
_FFN = {'ff_macaron': 'feed_forward_macaron', 'ff': 'feed_forward'}
_LINEAR = {'q': 'linear_q', 'k': 'linear_k', 'v': 'linear_v',
           'out': 'linear_out', 'pos': 'linear_pos'}
_CONV = {'pointwise1': 'pointwise_conv1', 'depthwise': 'depthwise_conv',
         'pointwise2': 'pointwise_conv2'}
_BN = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
       'var': 'running_var'}


def _block_entry(p, rest, value):
    head = rest[0]
    if head in _FFN:
        w, leaf = rest[1], rest[2]
        return {f'{p}.{_FFN[head]}.w_{w[1]}.{leaf}':
                value.T if leaf == 'weight' else value}
    if head.startswith('norm'):
        return {f'{p}.{head}.{_NORM[rest[1]]}': value}
    if head == 'attn':
        if rest[1].startswith('pos_bias'):
            return {f'{p}.self_attn.{rest[1]}': value}
        return {f'{p}.self_attn.{_LINEAR[rest[1]]}.{rest[2]}':
                value.T if rest[2] == 'weight' else value}
    if rest[1] == 'batch_norm':
        return {f'{p}.conv_module.norm.{_BN[rest[2]]}': value}
    return {f'{p}.conv_module.{_CONV[rest[1]]}.{rest[2]}':
            value.transpose(2, 1, 0) if rest[2] == 'weight' else value}
