"""The port's training slice against the JAX package on the CPU: the loss,
the train step (gradients, clipping, Adam), the train-mode model on the
kernel paths (plain versions here, JAX in interpret mode), checkpoints in
both directions, the evaluation pass and the metrics."""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
from ppgs_tpu import load as jax_load
from ppgs_tpu.evaluate.metrics import Metrics as JaxMetrics
from ppgs_tpu.models import transformer as jax_transformer
from ppgs_tpu.ops import encoder_layer_train as jax_elt
from ppgs_tpu.ops import flash_attention as jax_fa
from ppgs_tpu.train import core as jax_train

import ppgs_tpu_torch as port
from ppgs_tpu_torch import convert
from ppgs_tpu_torch.evaluate.metrics import Metrics
from ppgs_tpu_torch.models import transformer as port_transformer
from ppgs_tpu_torch.ops import encoder_layer_train as elt
from ppgs_tpu_torch.ops import flash_attention as fa
from ppgs_tpu_torch.ops import fused_ffn
from ppgs_tpu_torch.train import core as train_core

from torch_corpus import point_configs, write_corpus

TINY = ppgs_tpu.Config(
    num_hidden_layers=2, hidden_channels=64, ffn_channels=128,
    max_len=64, chunk_length=64, chunk_overlap=8, compute_dtype='float32')


def _port_config(config):
    return port.Config(**dataclasses.asdict(config))


def make_batch(B=4, T=64, seed=0):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((B, 80, T)).astype(np.float32)
    targets = rng.integers(0, 40, size=(B, T)).astype(np.int64)
    lengths = np.array([T, T - 10, T // 2, 5][:B], dtype=np.int64)
    for i, n in enumerate(lengths):
        features[i, :, n:] = 0
        targets[i, n:] = -100
    return features, targets, lengths


def _port_model(jax_params, config):
    """The port's Transformer holding the JAX parameters."""
    model = port_transformer.Transformer(_port_config(config))
    flat = port.load.flatten_params(jax.device_get(jax_params))
    model.load_state_dict(convert.params_from_jax(flat))
    return model


def _as_jax_flat(model, values):
    """{parameter name: tensor} of ``model`` -> the JAX flat layout."""
    names = [n for n, _ in model.named_parameters()]
    return convert.params_to_jax(dict(zip(names, values)))


def _assert_flat_close(got, want_tree, rtol, atol):
    want = port.load.flatten_params(jax.device_get(want_tree))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol,
                                   err_msg=key)


###############################################################################
# Loss, step, optimizer
###############################################################################


@pytest.mark.parametrize('weighted,reduction', [
    (False, 'mean'), (True, 'mean'), (False, 'sum'), (True, 'none')])
def test_loss_matches_jax(weighted, reduction):
    _, targets, _ = make_batch()
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 40, 64)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=40).astype(np.float32)
    want = jax_train.loss(jnp.asarray(logits), jnp.asarray(targets), TINY,
                          jnp.asarray(weights) if weighted else None,
                          reduction)
    got = train_core.loss(torch.from_numpy(logits), torch.from_numpy(targets),
                          None, torch.from_numpy(weights) if weighted
                          else None, reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _jax_step(config, features, targets, lengths):
    """One JAX train step from the PRNGKey(0) init: (Adam state, loss)."""
    params = jax_transformer.init(jax.random.PRNGKey(0), config)
    optimizer = jax_train.make_optimizer(config)
    step_fn = jax_train.make_train_step(config, optimizer)
    _, opt_state, loss, _ = step_fn(
        params, optimizer.init(params), jnp.asarray(features),
        jnp.asarray(targets), jnp.asarray(lengths), jax.random.PRNGKey(1),
        with_stats=True)
    return opt_state[0], loss


def _l2(flat):
    return float(np.sqrt(sum(np.square(v.astype(np.float64)).sum()
                             for v in flat.values())))


def _max_abs(flat):
    return float(max(np.abs(v).max() for v in flat.values()))


@pytest.mark.parametrize('clip', [
    {}, {'gradient_clip_threshold_l2': 0.05},
    {'gradient_clip_threshold_inf': 0.002}])
def test_train_step_matches_jax(clip):
    """Dropout 0, fp32: the loss, the (clipped) gradients the optimizer
    receives, and Adam's moments after one step. The thresholds clip hard
    (the unclipped norm is ~2, the max ~0.1), so the clipped gradients are
    held to the unclipped JAX gradients times the clip scale at the
    unclipped case's tolerance, and the scale the port applied to the one
    the JAX step applied."""
    config = TINY.replace(dropout=0.0, **clip)
    features, targets, lengths = make_batch()
    model = _port_model(jax_transformer.init(jax.random.PRNGKey(0), config),
                        config)
    adam, want_loss = _jax_step(config, features, targets, lengths)
    unclipped = port.load.flatten_params(jax.device_get(jax.tree.map(
        lambda m: m / 0.1, _jax_step(TINY.replace(dropout=0.0), features,
                                     targets, lengths)[0].mu)))

    port_opt = train_core.make_optimizer(model.parameters(), config)
    step = train_core.make_train_step(model, _port_config(config), port_opt)
    got_loss, stats = step(torch.from_numpy(features),
                           torch.from_numpy(targets),
                           torch.from_numpy(lengths), seed=0, with_stats=True)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    # The gradients Adam received (mu = (1 - 0.9) g after one step), and
    # the port's before clipping (its stats)
    grads = _as_jax_flat(model, [p.grad for p in model.parameters()])
    clipped = port.load.flatten_params(jax.device_get(
        jax.tree.map(lambda m: m / 0.1, adam.mu)))
    scale = 1.0
    if clip:
        (kind, threshold), = clip.items()
        if kind == 'gradient_clip_threshold_l2':
            measure, port_before = _l2, float(stats['gradients/norm'])
        else:
            measure = _max_abs
            port_before = max(abs(float(stats['gradients/max'])),
                              abs(float(stats['gradients/min'])))
        scale = min(1.0, threshold / (measure(unclipped) + 1e-12))
        assert scale < 0.1
        np.testing.assert_allclose(port_before, measure(unclipped),
                                   rtol=2e-3)
        np.testing.assert_allclose(measure(grads) / port_before, scale,
                                   rtol=1e-4)
        # the JAX step clipped by the same scale
        for key in unclipped:
            np.testing.assert_allclose(clipped[key], unclipped[key] * scale,
                                       rtol=1e-5, atol=1e-12, err_msg=key)
    assert sorted(grads) == sorted(unclipped)
    for key in unclipped:
        np.testing.assert_allclose(grads[key] / scale, unclipped[key],
                                   rtol=2e-3, atol=2e-3, err_msg=key)
    moments = convert.adam_state_to_jax(model, port_opt)
    assert int(moments['count']) == int(adam.count) == 1
    _assert_flat_close(moments['nu'], adam.nu, rtol=5e-3, atol=1e-9)


def test_adam_update_matches_optax():
    """Given identical gradients, torch.optim.Adam and optax.adam make the
    same updates (three steps)."""
    rng = np.random.default_rng(2)
    shapes = [(64, 32), (32,), (5, 7, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10 ** -i
              for i, s in enumerate(shapes)] for _ in range(3)]
    optimizer = optax.adam(2e-4)
    jp = [jnp.asarray(p) for p in params]
    state = optimizer.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = train_core.make_optimizer(tp, TINY)
    for g in grads:
        updates, state = optimizer.update([jnp.asarray(x) for x in g], state,
                                          jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        topt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-6)


###############################################################################
# Train-mode model on the kernel paths
###############################################################################


BF16 = ppgs_tpu.Config(num_hidden_layers=2, dropout=0.0)


def _bf16_inputs(T, B=2, seed=4):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, 80, T)).astype(np.float32)
    lengths = np.array([T, T - 10][:B])
    cot = rng.standard_normal((B, 40, T)).astype(np.float32)
    return feats, lengths, cot


def _spy(monkeypatch, module, name, calls):
    original = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize('T,expected', [
    (64, {'encoder_layer_train': 2}),
    (60, {'flash_attention_train': 2, 'ffn_train': 2}),
    (1032, {'ffn_train': 2}),
])
def test_train_dispatch(monkeypatch, T, expected):
    """bf16 at the kernels' width: T % 8 == 0 takes the whole-layer path,
    other T the per-layer attention and FFN paths, and T > 1024 plain
    attention with the FFN path (the JAX dispatch)."""
    calls = []
    _spy(monkeypatch, elt, 'encoder_layer_train', calls)
    _spy(monkeypatch, fa, 'flash_attention_train', calls)
    _spy(monkeypatch, fused_ffn, 'ffn_train', calls)
    model = train_core.init_model(_port_config(BF16), 'cpu')
    feats, lengths, cot = _bf16_inputs(T)
    out = model(torch.from_numpy(feats), torch.from_numpy(lengths),
                train=True, seed=3)
    (out * torch.from_numpy(cot)).sum().backward()
    assert {n: calls.count(n) for n in set(calls)} == expected
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_remat_recomputes_the_same_gradients():
    """config.remat (torch.utils.checkpoint per layer) recomputes each
    layer in the backward with the same Philox masks: the gradients are the
    ones without it."""
    config = _port_config(TINY)
    grads = []
    for remat in (False, True):
        model = train_core.init_model(config.replace(remat=remat), 'cpu')
        features, targets, lengths = (torch.from_numpy(a)
                                      for a in make_batch())
        out = model(features, lengths, train=True, seed=9)
        train_core.loss(out, targets).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize('T', [64, 60])
def test_bf16_train_forward_matches_jax(monkeypatch, T):
    """Dropout 0, bf16: the port's train forward and gradients on the
    kernel paths against the JAX package's (its Pallas train kernels in
    interpret mode). Criteria of tests/test_encoder_layer_train.py:178-239,
    tightened to what was measured: logits within 1e-2 (measured 4.7e-3,
    bf16 rounding flips from sums in another order), per tensor
    cos > 0.998 (measured 1 - cos <= 9.4e-4) and norm within 1% (measured
    0.14%), skipping tensors whose norm is < 0.05 (key biases)."""
    params = jax_transformer.init(jax.random.PRNGKey(1), BF16)
    model = _port_model(params, BF16)
    feats, lengths, cot = _bf16_inputs(T)

    def interpret(module, name):
        original = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: original(
            *a, **{**k, 'interpret': True}))

    interpret(jax_elt, 'encoder_layer_train')
    interpret(jax_fa, 'flash_attention_train')
    monkeypatch.setattr(jax_transformer, '_use_flash', lambda d: True)

    def loss(p):
        out = jax_transformer.forward(p, jnp.asarray(feats),
                                      jnp.asarray(lengths), BF16, train=True,
                                      rng=jax.random.PRNGKey(0))
        return (out * cot).sum(), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = model(torch.from_numpy(feats), torch.from_numpy(lengths),
                train=True, seed=0)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-2, rtol=1e-2)
    got = _as_jax_flat(model, [p.grad for p in model.parameters()])
    for key, w in port.load.flatten_params(jax.device_get(grads)).items():
        g, w = got[key].ravel(), np.asarray(w, np.float32).ravel()
        norm = np.linalg.norm(w)
        if norm < 0.05:
            continue
        cos = g @ w / (np.linalg.norm(g) * norm)
        assert cos > 0.998, (key, cos)
        assert abs(np.linalg.norm(g) - norm) <= 0.01 * norm, key


def _grads_agree(got, want, floor):
    """Per tensor, as test_bf16_train_forward_matches_jax holds them: cos >
    0.998 and norm within 1%, skipping tensors whose norm is below
    ``floor`` (the key biases: softmax is shift-invariant in them)."""
    for key, w in want.items():
        g, w = got[key].ravel(), np.asarray(w, np.float32).ravel()
        norm = np.linalg.norm(w)
        if norm < floor:
            continue
        cos = g @ w / (np.linalg.norm(g) * norm)
        assert cos > 0.998, (key, cos)
        assert abs(np.linalg.norm(g) - norm) <= 0.01 * norm, key


@pytest.mark.parametrize('T', [64, 60])
def test_w2v2fb_train_step_matches_jax(monkeypatch, tmp_path, T):
    """The head-training slice as a whole: one train step of the w2v2fb
    config (input 768, C = 512, 2 heads of 256, F = 2048, bf16; depth cut
    to 2 layers, dropout 0) from the same npz parameters on both sides, on
    w2v2fb-like features: T = 64 takes the whole-layer path, T = 60 the
    per-layer path (the JAX train kernels in interpret mode, the port's
    plain versions, each layer through the path's functions). The loss
    within 1e-3 relative (measured 5e-5), and the gradients Adam received
    (its first moment / 0.1) per tensor as
    test_bf16_train_forward_matches_jax holds them (here from the mean
    loss, so the skipping floor is 1e-4: measured norms 4e-5 to 6e-5 for
    the key biases, >= 3e-3 for every other tensor)."""
    config = ppgs_tpu.config.get('w2v2fb').replace(num_hidden_layers=2,
                                                   dropout=0.0)
    path = tmp_path / 'head.npz'
    jax_load.save_params(path, jax_transformer.init(jax.random.PRNGKey(2),
                                                    config))
    params = jax_load.load_params(path)
    model = train_core.init_model(_port_config(config), 'cpu')
    model.load_state_dict(convert.params_from_jax(port.load.load_flat(path)))

    rng = np.random.default_rng(6)
    B = 2
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
    _, opt_state, want_loss, _ = step_fn(
        params, optimizer.init(params), jnp.asarray(features),
        jnp.asarray(targets), jnp.asarray(lengths), jax.random.PRNGKey(1),
        with_stats=True)

    calls = []
    _spy(monkeypatch, elt, 'encoder_layer_train', calls)
    _spy(monkeypatch, fa, 'flash_attention_train', calls)
    _spy(monkeypatch, fused_ffn, 'ffn_train', calls)
    port_opt = train_core.make_optimizer(model.parameters(), config)
    step = train_core.make_train_step(model, _port_config(config), port_opt)
    got_loss, _ = step(torch.from_numpy(features), torch.from_numpy(targets),
                       torch.from_numpy(lengths), seed=0)
    assert sorted(set(calls)) == (['encoder_layer_train'] if T % 8 == 0 else
                                  ['ffn_train', 'flash_attention_train'])
    assert len(calls) == (2 if T % 8 == 0 else 4)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-3)
    got = _as_jax_flat(model, [p.grad for p in model.parameters()])
    want = port.load.flatten_params(jax.device_get(jax.tree.map(
        lambda m: m / 0.1, opt_state[0].mu)))
    assert sorted(got) == sorted(want)
    _grads_agree(got, want, 1e-4)


###############################################################################
# Checkpoints, evaluation, the loop
###############################################################################


def _jax_state_after_one_step(config):
    params = jax_transformer.init(jax.random.PRNGKey(0), config)
    optimizer = jax_train.make_optimizer(config)
    step_fn = jax_train.make_train_step(config, optimizer)
    features, targets, lengths = make_batch()
    params, opt_state, _, _ = step_fn(
        params, optimizer.init(params), jnp.asarray(features),
        jnp.asarray(targets), jnp.asarray(lengths), jax.random.PRNGKey(2))
    return optimizer, params, opt_state


def test_jax_checkpoint_resumes_in_port(tmp_path):
    _, params, opt_state = _jax_state_after_one_step(TINY)
    path = jax_train.checkpoint_state(tmp_path, 7, 2, params, opt_state)
    config = _port_config(TINY)
    model = port_transformer.Transformer(config)
    optimizer = train_core.make_optimizer(model.parameters(), config)
    assert train_core.latest_checkpoint(tmp_path) == path
    assert train_core.load_checkpoint(path, model, optimizer) == (7, 2)
    _assert_flat_close(convert.params_to_jax(model.state_dict()), params,
                       rtol=0, atol=0)
    moments = convert.adam_state_to_jax(model, optimizer)
    assert int(moments['count']) == int(opt_state[0].count)
    _assert_flat_close(moments['mu'], opt_state[0].mu, rtol=0, atol=0)
    _assert_flat_close(moments['nu'], opt_state[0].nu, rtol=0, atol=0)


def _port_state_after_one_step(config):
    model = train_core.init_model(config, 'cpu')
    optimizer = train_core.make_optimizer(model.parameters(), config)
    step = train_core.make_train_step(model, config, optimizer)
    features, targets, lengths = (torch.from_numpy(a) for a in make_batch())
    step(features, targets, lengths, seed=11)
    return model, optimizer


def test_port_checkpoint_restores_in_jax(tmp_path):
    config = _port_config(TINY)
    model, optimizer = _port_state_after_one_step(config)
    path = train_core.checkpoint_state(tmp_path, 3, 1, model, optimizer)
    template = jax_transformer.init(jax.random.PRNGKey(5), TINY)
    params, opt_state, step, epoch = jax_train.load_checkpoint(
        path, jax_train.make_optimizer(TINY), template)
    assert (step, epoch) == (3, 1)
    moments = convert.adam_state_to_jax(model, optimizer)
    _assert_flat_close(convert.params_to_jax(model.state_dict()), params,
                       rtol=0, atol=0)
    _assert_flat_close(moments['mu'], opt_state[0].mu, rtol=0, atol=0)
    _assert_flat_close(moments['nu'], opt_state[0].nu, rtol=0, atol=0)
    assert int(opt_state[0].count) == 1
    # ... and load.model reads it as an inference checkpoint
    loaded, _ = port.load.model(checkpoint=path, config=config, device='cpu')
    for (name, a), b in zip(loaded.named_parameters(), model.parameters()):
        assert torch.equal(a, b), name


def _loader(seeds=(0, 1, 2)):
    def loader_fn(partition):
        offset = 0 if partition == 'train' else 10
        for seed in seeds:
            yield make_batch(seed=seed + offset)
    return loader_fn


def test_evaluate_partition_reads_the_trained_parameters(tmp_path):
    """After an optimizer step, the evaluation pass scores the current
    parameters: it matches an evaluation of the checkpoint loaded fresh
    (the prepared weights of an earlier pass would be stale)."""
    config = _port_config(TINY)
    model, optimizer = _port_state_after_one_step(config)
    loader_fn = _loader()
    before = train_core.evaluate_partition(None, 0, model, config,
                                           loader_fn, 'valid')
    step = train_core.make_train_step(model, config, optimizer)
    step(*(torch.from_numpy(a) for a in make_batch(seed=5)), seed=12)
    after = train_core.evaluate_partition(None, 1, model, config, loader_fn,
                                          'valid')
    assert after['valid/loss'] != before['valid/loss']
    path = train_core.checkpoint_state(tmp_path, 2, 0, model, optimizer)
    fresh, _ = port.load.model(checkpoint=path, config=config, device='cpu')
    metrics = Metrics(config=config)
    for features, targets, lengths in loader_fn('valid'):
        metrics.update(fresh(torch.from_numpy(features),
                             torch.from_numpy(lengths)), targets)
    want = metrics()
    for key, value in want.items():
        assert after[f'valid/{key}'] == pytest.approx(value, rel=1e-6,
                                                      abs=1e-7), key


def _jax_loader_fn(config):
    """loader_fn over the JAX package's loaders of 'commonvoice', its train
    sampler set to each epoch in turn."""
    loaders = {p: importlib.import_module('ppgs_tpu.data.loader').loader(
        'commonvoice', p, config=config) for p in ('train', 'valid')}
    epochs = iter(range(1 << 30))

    def loader_fn(partition):
        if partition == 'train':
            loaders['train'].batch_sampler.set_epoch(next(epochs))
        return iter(loaders[partition])
    return loader_fn


def test_train_writes_logs_and_checkpoints_and_resumes(tmp_path,
                                                       monkeypatch):
    config = _port_config(TINY).replace(evaluation_interval=2,
                                        checkpoint_interval=2)
    loader_fn = _loader()
    # The default loaders over a dataset's caches: the same run, bit for
    # bit, as one fed the JAX package's loaders
    point_configs(monkeypatch, tmp_path / 'corpus')
    write_corpus(tmp_path / 'corpus', 'commonvoice',
                 (0.3, 0.45, 0.6, 0.35, 0.5, 0.4, 0.55, 0.25, 0.62, 0.33),
                 seed=2, mel_cache=True)
    ppgs_tpu.partition.datasets(['commonvoice'])
    from_data = config.replace(max_len=512, max_training_frames=300)
    by_default = train_core.train('commonvoice', tmp_path / 'default',
                                  from_data, max_steps=3, device='cpu')
    by_jax = train_core.train(
        directory=tmp_path / 'jax-loader', config=from_data, max_steps=3,
        loader_fn=_jax_loader_fn(ppgs_tpu.Config(
            **dataclasses.asdict(from_data))), device='cpu')
    for (name, got), want in zip(by_default.state_dict().items(),
                                 by_jax.state_dict().values()):
        assert torch.equal(got, want), name
    with pytest.raises(RuntimeError, match='CUDA'):
        train_core.train(directory=tmp_path, config=config, max_steps=1,
                         loader_fn=loader_fn)
    train_core.train(directory=tmp_path, config=config, max_steps=3,
                     loader_fn=loader_fn, device='cpu')
    names = sorted(p.name for p in tmp_path.iterdir())
    assert {'00000002.npz', '00000003.npz', '00000003.json',
            'metrics.jsonl'} <= set(names)
    records = [json.loads(line) for line in
               (tmp_path / 'metrics.jsonl').read_text().splitlines()]
    assert np.isfinite(records[0]['train/loss'])
    assert [r['step'] for r in records if 'valid/loss' in r] == [0, 2]
    # Resume: steps 3 and 4 only (an evaluation at 4, none at 0 or 2 again)
    train_core.train(directory=tmp_path, config=config, max_steps=5,
                     loader_fn=loader_fn, device='cpu')
    records = [json.loads(line) for line in
               (tmp_path / 'metrics.jsonl').read_text().splitlines()]
    assert [r['step'] for r in records if 'valid/loss' in r] == [0, 2, 4]
    meta = json.loads((tmp_path / '00000005.json').read_text())
    assert meta['step'] == 5


def test_unknown_backend_is_npz_in_both_packages(tmp_path):
    """The orbax backend is the port's own step directories (orbax's
    on-disk format is not ported): an empty run directory has no latest
    step. A backend that neither package has ('zarr') saves, finds and
    restores npz in both, as the JAX package's dispatch sends every value
    but 'orbax' to npz: the same files, each package's checkpoint restored
    by the other to the same state."""
    assert train_core.latest_checkpoint(tmp_path, backend='orbax') is None
    assert train_core.latest_checkpoint(tmp_path, backend='zarr') is None
    assert jax_train.latest_checkpoint(tmp_path, backend='zarr') is None
    jax_optimizer, params, opt_state = _jax_state_after_one_step(TINY)
    jax_dir, port_dir = tmp_path / 'jax', tmp_path / 'port'
    jax_path = jax_train.checkpoint_state(jax_dir, 7, 2, params, opt_state,
                                          backend='zarr')
    config = _port_config(TINY)
    model = port_transformer.Transformer(config)
    optimizer = train_core.make_optimizer(model.parameters(), config)
    assert train_core.latest_checkpoint(jax_dir, backend='zarr') == jax_path
    assert train_core.load_checkpoint(jax_path, model, optimizer,
                                      backend='zarr') == (7, 2)
    port_path = train_core.checkpoint_state(port_dir, 7, 2, model, optimizer,
                                            backend='zarr')
    assert ([p.name for p in sorted(port_dir.iterdir())]
            == [p.name for p in sorted(jax_dir.iterdir())]
            == ['00000007.json', '00000007.npz'])
    assert jax_train.latest_checkpoint(port_dir, backend='zarr') == port_path
    with np.load(jax_path) as want, np.load(port_path) as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got_params, got_state, step, epoch = jax_train.load_checkpoint(
        port_path, jax_optimizer, jax_transformer.init(
            jax.random.PRNGKey(5), TINY), backend='zarr')
    assert (step, epoch) == (7, 2)
    _assert_flat_close(convert.params_to_jax(model.state_dict()), got_params,
                       rtol=0, atol=0)
    _assert_flat_close(convert.params_to_jax(model.state_dict()), params,
                       rtol=0, atol=0)
    assert int(got_state[0].count) == int(opt_state[0].count)
    _assert_flat_close(convert.adam_state_to_jax(model, optimizer)['mu'],
                       got_state[0].mu, rtol=0, atol=0)


###############################################################################
# Metrics
###############################################################################


@pytest.mark.parametrize('balanced', [False, True])
def test_metrics_match_jax(balanced):
    config = TINY.replace(class_balanced=balanced)
    jm, pm = JaxMetrics(config=config), Metrics(config=_port_config(config))
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        logits = rng.standard_normal((3, 40, 50)).astype(np.float32) * 3
        targets = rng.integers(0, 40, size=(3, 50))
        targets[1, 30:] = -100
        jm.update(jnp.asarray(logits), jnp.asarray(targets))
        pm.update(torch.from_numpy(logits), torch.from_numpy(targets))
    want, got = jm(), pm()
    assert sorted(got) == sorted(k for k, v in want.items()
                                 if isinstance(v, float))
    for key, value in got.items():
        if key.startswith(('Count/', 'Total/')) or 'Accuracy' in key:
            assert value == want[key], key          # counts: exact
        else:
            assert value == pytest.approx(want[key], rel=1e-5), key
    # With the figures: the same scalars, and the JAX package's two figures
    drawn = Metrics(include_figures=True, config=_port_config(config))
    drawn.state = pm.state
    results = drawn()
    figures = {k for k, v in results.items() if not isinstance(v, float)}
    assert figures == {'ConfusionMatrix', 'DistanceMatrix'}
    assert {k: v for k, v in results.items() if k not in figures} == got
    import matplotlib.pyplot as plt
    for key in figures:
        assert isinstance(results[key], plt.Figure)
        plt.close(results[key])
