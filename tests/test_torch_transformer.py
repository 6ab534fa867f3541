"""The port's transformer (forward, chunked_forward) against the JAX model
on the CPU: the same npz weights and the same numpy inputs. fp32 at the
golden-parity tolerance of 1e-4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppgs_tpu
import ppgs_tpu_torch
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu_torch.models import transformer

NARROW = dict(num_hidden_layers=2, hidden_channels=64, ffn_channels=128)


@functools.partial(jax.jit, static_argnames=('config',))
def _jax_forward(params, features, lengths, phys_lengths, config):
    return jax_transformer.forward(params, features, lengths, config,
                                   phys_lengths=phys_lengths)


@functools.partial(jax.jit, static_argnames=('config', 'true_frames'))
def _jax_chunked(params, features, lengths, config, true_frames):
    return jax_transformer.chunked_forward(params, features, lengths, config,
                                           true_frames=true_frames)


def _models(tmp_path, seed=0, **fields):
    """(JAX params, JAX config, port model) from one random-init npz."""
    config = ppgs_tpu.Config(**fields)
    path = tmp_path / 'params.npz'
    ppgs_tpu.load.save_params(
        path, jax_transformer.init(jax.random.PRNGKey(seed), config))
    port_config = ppgs_tpu_torch.Config(**dataclasses.asdict(config))
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=port_config,
                                         device='cpu')
    return ppgs_tpu.load.load_params(path), config, model


def _features(seed, B, T):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, 80, T)).astype(np.float32)


@pytest.mark.parametrize('fields,T,lengths,phys', [
    # A zero-length row, and phys_lengths truncation before the output conv
    (dict(NARROW, compute_dtype='float32'), 120, [120, 77, 0], [120, 100, 90]),
    (dict(NARROW, compute_dtype='float32', is_causal=True), 97, [97, 50],
     None),
    # Full width (C=256, 5 layers, 2 x 128 heads), T < 500
    (dict(compute_dtype='float32'), 300, [300, 211], [300, 260]),
])
def test_forward_matches_jax(tmp_path, fields, T, lengths, phys):
    params, config, model = _models(tmp_path, **fields)
    features = _features(T, len(lengths), T)
    phys_np = None if phys is None else np.asarray(phys, np.int32)
    want = np.asarray(_jax_forward(
        params, jnp.asarray(features), jnp.asarray(lengths, jnp.int32),
        None if phys is None else jnp.asarray(phys_np), config))
    got = transformer.forward(
        model, torch.from_numpy(features), torch.tensor(lengths),
        phys_lengths=None if phys is None else torch.tensor(phys)).numpy()
    assert got.shape == want.shape == (len(lengths), 40, T)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # Rows of length 0 are wholly masked: zeros, not NaN
    for i, n in enumerate(lengths):
        if n == 0:
            assert np.array_equal(got[i], np.zeros_like(got[i]))


@pytest.mark.parametrize('T,lengths,true_frames', [
    # Row 1 ends on a window edge: its last window holds only the halo and
    # is wholly masked (per-window length 0)
    (1100, [1100, 800], 1100),
    # The physical end before T (a padded extent), as infer passes it
    (950, [900, 612], 900),
])
def test_chunked_forward_matches_jax(tmp_path, T, lengths, true_frames):
    params, config, model = _models(tmp_path, seed=1, **NARROW,
                                    compute_dtype='float32')
    features = _features(T + 1, len(lengths), T)
    want = np.asarray(_jax_chunked(
        params, jnp.asarray(features), jnp.asarray(lengths, jnp.int32),
        config, true_frames))
    got = transformer.chunked_forward(
        model, torch.from_numpy(features), torch.tensor(lengths),
        true_frames=true_frames).numpy()
    assert got.shape == want.shape == (len(lengths), 40, T)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_per_layer_path_matches_jax(tmp_path):
    """bf16 at a width the kernels do not take (d_head = 32): the plain
    per-layer path, which rounds where the JAX XLA path rounds."""
    params, config, model = _models(tmp_path, seed=2, **NARROW)
    T, lengths = 160, [160, 99]
    features = _features(3, 2, T)
    want = np.asarray(_jax_forward(
        params, jnp.asarray(features), jnp.asarray(lengths, jnp.int32),
        None, config))
    got = transformer.forward(model, torch.from_numpy(features),
                              torch.tensor(lengths)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize('name,fields,device,want', [
    ('mel', {}, 'cuda', True),
    ('mel', {}, 'cpu', True),
    ('mel', dict(compute_dtype='float32'), 'cuda', False),
    ('mel', dict(hidden_channels=64), 'cuda', False),       # d_head = 32
    ('w2v2fb', {}, 'cpu', True),                            # d_head = 256
    ('w2v2fb', {}, 'cuda', NotImplementedError),
    ('w2v2fc', dict(compute_dtype='float32'), 'cuda', False),
])
def test_kernel_gate_follows_the_jax_rule(name, fields, device, want):
    """bf16 with d_head % 128 == 0 takes the kernels, as JAX's _use_flash
    does; on the card, such a width the kernels do not take raises."""
    config = ppgs_tpu_torch.config.get(name).replace(**fields)
    d_head = config.hidden_channels // config.attention_heads
    jax_rule = config.compute_dtype == 'bfloat16' and d_head % 128 == 0
    if want is NotImplementedError:
        assert jax_rule
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            transformer.use_kernels(config, device)
    else:
        assert transformer.use_kernels(config, device) is want is jax_rule


def test_prepare_casts_and_folds_once(tmp_path):
    """convert.prepare: the compute-dtype casts, and the softmax scale times
    log2(e) folded into the q third of the stack's QKV, made at load."""
    _, _, model = _models(tmp_path, seed=3, **NARROW)
    layer = model.layers[1]
    p, C = layer.prepared, 64
    fold = torch.tensor(np.log2(np.e) / np.sqrt(C // 2), dtype=torch.float32)
    wqkv = layer.attn.wqkv.detach()
    assert p.w1.dtype == p.wqkv_folded.dtype == torch.bfloat16
    assert p.bqkv_folded.dtype == torch.float32
    assert torch.equal(p.w2, layer.ffn.w2.detach().to(torch.bfloat16))
    assert torch.equal(p.wqkv_folded[:, :C],
                       (wqkv[:, :C] * fold).to(torch.bfloat16))
    assert torch.equal(p.wqkv_folded[:, C:], wqkv[:, C:].to(torch.bfloat16))


def test_chunk_layout_and_positional_encoding_match_jax():
    for frames in (1, 399, 400, 401, 1100, 5000):
        assert transformer.chunk_layout(frames, 500, 50) == (
            jax_transformer.chunk_layout(frames, 500, 50))
    np.testing.assert_array_equal(transformer.positional_encoding(700, 256),
                                  jax_transformer.positional_encoding(700, 256))
