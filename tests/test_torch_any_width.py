"""The layer kernels at every width of their inference rule (K1, K3 and
K4 at any C % 128 == 0 up to 2048) on the CPU, at narrow depth (2 layers,
B = 2, T <= 40), against the JAX package on the same seeded numpy inputs
and npz weights.

- ``from_features`` at C = 128 (1 head of 128), 384 (3 x 128) and 1024 (8 x
  128 and 4 x 256): fp32 at 1e-4, bf16 PPGs at atol 2e-2
  (docs/GOLDEN_PARITY.md);
- the plain versions of K1, K3 and K4 at C = 384 and 1024: a one-layer
  stack against ``encoder_stack`` in interpret mode (K4's round_input 0
  form), and K4's round_input 1 form against ``ffn_residual_layernorm`` in
  interpret mode; test_torch_ffn.py's tolerances;
- wav2vec2-large's trunk widths (C = 1024, 16 heads of 64, F = 4096, 2
  layers) through the port's stack against ``encoder_stack_streamed`` in
  interpret mode: fp32 at 1e-4, bf16 within the JAX kernel's own bf16
  distance from fp32 (the test's note says why not B7's C = 128 limits);
- the two gates, called for 'cuda' (they need no card): the inference
  gate takes every C % 128 up to 2048 at d_head 128 / 256 and the trunk at
  d_head 64 / 128; the training gate is the same rule
  (tests/test_torch_train_any_width.py holds the train kernels' plain
  versions there); past 2048 and a trunk d_head of 8 raise, naming
  ROADMAP.md (tests/test_torch_wide_heads.py holds the other head widths:
  d_head % 128 == 0 up to 2048, a trunk's 16 and 32).

The CUDA kernels run only on a card: ``chip_smoke.py --slices any_width``
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
from ppgs_tpu.models import w2v2 as jax_w2v2
from ppgs_tpu.ops import encoder_layer_kernel as jax_elk
from ppgs_tpu.ops import fused_ffn as jax_ffn

import ppgs_tpu_torch
from ppgs_tpu_torch import convert, kernels
from ppgs_tpu_torch.models import transformer, w2v2
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
from ppgs_tpu_torch.ops import fused_ffn

# (C, d_head) of the PPG transformer here: one head, a width of three 128
# column groups (the cluster's last rank 128 wide), and a width of four
# ranks at both head widths
PAIRS = ((128, 128), (384, 128), (1024, 128), (1024, 256))
KERNEL_C = (384, 1024)           # the plain kernels against JAX's
LAYERS, B, T, F = 2, 2, 40, 2048
BLOCK = 128                      # the JAX FFN kernel's row block here
# wav2vec2-large's trunk (facebook/wav2vec2-large): hidden 1024, 16 heads
# of 64, intermediate 4096; the feature encoder is base's
LARGE = dict(hidden_size=1024, num_layers=24, num_heads=16,
             intermediate_size=4096)


def _ids(pairs):
    return [pytest.param(c, d, id=f'C{c}-d{d}') for c, d in pairs]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _config(C, D, compute_dtype, layers=LAYERS):
    return ppgs_tpu.Config(num_hidden_layers=layers, hidden_channels=C,
                           attention_heads=C // D, ffn_channels=F,
                           compute_dtype=compute_dtype)


def _npz(path, config, seed):
    ppgs_tpu.load.save_params(
        path, jax_transformer.init(jax.random.PRNGKey(seed), config))
    return ppgs_tpu_torch.Config(**dataclasses.asdict(config))


###############################################################################
# The PPG transformer through its entry point
###############################################################################


@pytest.mark.parametrize('C,D', _ids(PAIRS))
def test_from_features_matches_jax(tmp_path, C, D):
    """``from_features`` on the same npz and features: fp32 at 1e-4, bf16
    PPGs at atol 2e-2. In bf16 the port's plain path is the kernels'
    chain (the JAX rule sends d_head % 128 == 0 to the kernels), JAX's on
    the CPU its XLA path."""
    rng = np.random.default_rng(C + D)
    features = rng.standard_normal((B, 80, T)).astype(np.float32)
    lengths = np.array([T, 27])
    for compute_dtype, tol in (('float32', dict(rtol=1e-4, atol=1e-4)),
                               ('bfloat16', dict(rtol=0, atol=2e-2))):
        config = _config(C, D, compute_dtype)
        path = tmp_path / f'{compute_dtype}.npz'
        port_config = _npz(path, config, C + D)
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
# The plain kernels against the JAX kernels in interpret mode
###############################################################################


@pytest.mark.parametrize('dtype,tol', [('bfloat16', 5e-2),
                                       ('float32', 1e-4)])
@pytest.mark.parametrize('C', KERNEL_C)
def test_one_layer_stack_matches_jax_stack(tmp_path, C, dtype, tol):
    """K1 -> K2 -> K3 -> K4 (round_input 0) of one layer, the port's plain
    chain, against ``encoder_stack`` in interpret mode on one ragged
    window and one full, with the scale-folded weights each side prepares;
    test_torch_ffn.py's stack tolerances."""
    config = _config(C, 128, dtype, layers=1)
    path = tmp_path / 'params.npz'
    port_config = _npz(path, config, C)
    model, _ = ppgs_tpu_torch.load.model(checkpoint=path, config=port_config,
                                         device='cpu')
    assert model.layers[0].prepared.wqkv_folded.shape == (C, 3 * C)
    rng = np.random.default_rng(C + 1)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[T], [T - 13]])
    want = np.asarray(jax_elk.encoder_stack(
        jnp.asarray(x), jnp.asarray(mask),
        ppgs_tpu.load.load_params(path)['layers'], C // 128,
        compute_dtype=jnp.dtype(dtype), interpret=True))
    got = elk.encoder_stack_reference(
        torch.from_numpy(x), torch.from_numpy(mask), model.layers, C // 128,
        compute_dtype=getattr(torch, dtype)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got[mask], want[mask], atol=tol, rtol=tol)


def _ffn_inputs(seed, M, C):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, C)).astype(np.float32)
    w1 = (rng.standard_normal((C, F)) / math.sqrt(C)).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) / math.sqrt(F)).astype(np.float32)
    b1, b2, g, beta = (rng.standard_normal(n).astype(np.float32) * s
                       for n, s in ((F, 0.1), (C, 0.1), (C, 1.0), (C, 0.1)))
    return x, w1, b1, w2, b2, g, beta


@pytest.mark.parametrize('dtype,tol', [('bfloat16', 5e-2),
                                       ('float32', 1e-4)])
@pytest.mark.parametrize('C', KERNEL_C)
def test_k4_round_input_form_matches_jax_kernel(C, dtype, tol):
    """K4's round_input 1 form (the per-layer path's) against
    ``ffn_residual_layernorm`` in interpret mode on 129 rows (a 128-row
    tile and one more, zero-padded for the JAX kernel);
    test_torch_ffn.py's tolerances."""
    M = 129
    x, w1, b1, w2, b2, g, beta = _ffn_inputs(C, M, C)
    padded = np.concatenate([x, np.zeros((2 * BLOCK - M, C), np.float32)])
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_ffn.ffn_residual_layernorm(
        jnp.asarray(padded), jnp.asarray(w1, jd), jnp.asarray(b1),
        jnp.asarray(w2, jd), jnp.asarray(b2), jnp.asarray(g),
        jnp.asarray(beta), block_m=BLOCK, interpret=True))[:M]
    xt, w1t, b1t, w2t, b2t, gt, bt = (torch.from_numpy(a) for a in
                                      (x, w1, b1, w2, b2, g, beta))
    got = fused_ffn.ffn_residual_layernorm_reference(
        xt, w1t.to(td), b1t, w2t.to(td), b2t, gt, bt)
    assert got.dtype == torch.float32 and got.shape == (M, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


###############################################################################
# wav2vec2-large's trunk widths
###############################################################################


def test_large_trunk_stack_matches_encoder_stack_streamed(tmp_path):
    """B7 at wav2vec2-large's widths (C = 1024, 16 heads of 64, F = 4096),
    2 layers: the port's K1 -> K2(d_head 64) -> K3 -> K4(GELU) chain (plain
    versions) against the TPU's streamed kernel in interpret mode, a ragged
    window and a full one. In fp32 the two are one algorithm: atol and
    rtol 1e-4 (they read ~1.5e-6). In bf16 they round at the same points
    but sum in other orders; at these widths the init's N(0, 0.02) weights
    make each branch as large as the residual, so a branch's bf16 rounding
    moves the output by ~1e-2 (the JAX kernel's own bf16 output is 2.9e-3
    relative L2 from its fp32 one here), past test_torch_w2v2.py's B7
    limits, which were read at C = 128. So the port's bf16 chain is held to
    the TPU kernel's own bf16 accuracy: no farther from the fp32 result
    than the JAX kernel's bf16 output, with 25% to spare (it reads 0.89 of
    it), and within the bf16 gate's atol 2e-2 of it."""
    jcfg = jax_w2v2.W2V2Config(**dict(LARGE, num_layers=LAYERS),
                               compute_dtype='bfloat16')
    path = tmp_path / 'w2v2.npz'
    ppgs_tpu.load.save_params(path, jax_w2v2.init(jax.random.PRNGKey(11),
                                                  jcfg))
    params = ppgs_tpu.load.load_params(path)
    C, H = jcfg.hidden_size, jcfg.num_heads
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([[T], [T - 9]])
    want, got = {}, {}
    for dtype in ('float32', 'bfloat16'):
        model = w2v2.Wav2Vec2(w2v2.W2V2Config(**dict(
            dataclasses.asdict(jcfg), compute_dtype=dtype)))
        model.load_state_dict(convert.w2v2_params_from_jax(
            ppgs_tpu_torch.load.load_flat(path)), strict=True)
        convert.prepare_w2v2(model)
        assert w2v2.use_stack(model.config, T, 'cuda') is (
            dtype == 'bfloat16')
        want[dtype] = np.asarray(jax_elk.encoder_stack_streamed(
            jnp.asarray(x), jnp.asarray(mask), params['encoder']['layers'],
            H, compute_dtype=jnp.dtype(dtype), activation='gelu',
            interpret=True)).astype(np.float32)[mask]
        with torch.no_grad():
            out = elk.encoder_stack_reference(
                torch.from_numpy(x), torch.from_numpy(mask),
                model.encoder.layers, H, compute_dtype=getattr(torch, dtype),
                activation='gelu').numpy()
        assert out.shape == (B, T, C) and np.isfinite(out).all()
        got[dtype] = out[mask]
    np.testing.assert_allclose(got['float32'], want['float32'], rtol=1e-4,
                               atol=1e-4)
    truth = want['float32']
    assert (_rel_l2(got['bfloat16'], truth)
            <= 1.25 * _rel_l2(want['bfloat16'], truth))
    np.testing.assert_allclose(got['bfloat16'], want['bfloat16'], rtol=0,
                               atol=2e-2)


###############################################################################
# The gates
###############################################################################


@pytest.mark.parametrize('C', range(128, 2049, 128))
def test_inference_gate_takes_every_width_up_to_2048(C):
    """Every C % 128 == 0 up to 2048 runs on the card in inference: the
    PPG transformer at d_head 128 and 256 (where they divide C), the
    wav2vec2 trunk at d_head 64 and 128; K1's, K3's and K4's wrappers take
    the width (their argument checks need no card)."""
    mel = ppgs_tpu_torch.config.get('mel')
    for D in (128, 256):
        if C % D == 0:
            config = mel.replace(hidden_channels=C, attention_heads=C // D)
            assert transformer.use_kernels(config, 'cuda') is True
    for D in (64, 128):
        trunk = dataclasses.replace(w2v2.BASE, hidden_size=C,
                                    num_heads=C // D,
                                    compute_dtype='bfloat16')
        assert w2v2.use_stack(trunk, 400, 'cuda') is True
    x = torch.zeros(3, C)
    assert elk.qkv_proj_args(x, torch.zeros(C, 3 * C, dtype=torch.bfloat16),
                             torch.zeros(3 * C)) == 3
    vec = torch.zeros(C)
    assert elk.out_proj_ln_args(x.to(torch.bfloat16),
                                torch.zeros(C, C, dtype=torch.bfloat16),
                                vec, x, vec, vec) == 3
    assert fused_ffn.width_ok(C)


def test_training_gate_takes_the_new_pairs():
    """The training gate is the inference rule: it takes every new pair
    here (C = 128, 384, 1024 with d_head 128 or 256) on the card, and the
    plain path on the CPU."""
    mel = ppgs_tpu_torch.config.get('mel')
    for C, D in PAIRS:
        config = mel.replace(hidden_channels=C, attention_heads=C // D)
        assert transformer.use_kernels(config, 'cuda') is True
        assert transformer.use_kernels(config, 'cuda', train=True) is True
        assert transformer.use_kernels(config, 'cpu', train=True) is True


@pytest.mark.parametrize('C,heads,trunk', [
    (2176, 17, False),       # past 2048, d_head 128
    (2304, 6, False),        # past 2048, d_head 384
    (2176, 34, True),        # a trunk past 2048, d_head 64
    (1024, 128, True),       # a trunk at d_head 8
])
def test_gates_raise_outside_the_rule(C, heads, trunk):
    """Widths the JAX rule sends to its kernels and the card's do not take
    raise on the card, naming ROADMAP.md: no quiet plain path; the CPU
    runs the plain versions."""
    if trunk:
        config = dataclasses.replace(w2v2.BASE, hidden_size=C,
                                     num_heads=heads,
                                     compute_dtype='bfloat16')
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            w2v2.use_stack(config, 400, 'cuda')
        assert w2v2.use_stack(config, 400, 'cpu') is True
        return
    config = ppgs_tpu_torch.config.get('mel').replace(
        hidden_channels=C, attention_heads=heads)
    for train in (False, True):
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            transformer.use_kernels(config, 'cuda', train=train)
    assert transformer.use_kernels(config, 'cpu') is True


@pytest.mark.parametrize('C', (2176, 320))
def test_wrappers_refuse_widths_outside_the_rule(C, monkeypatch):
    """K1, K3 and K4 refuse a C past 2048 or not a multiple of 128 before
    anything is launched, in their train forms too; at a new width of the
    rule (384) K3's and K4's train forms are taken."""
    bf16 = torch.bfloat16
    x, vec = torch.zeros(3, C), torch.zeros(C)
    with pytest.raises(ValueError, match='takes wqkv'):
        elk.qkv_proj_args(x, torch.zeros(C, 3 * C, dtype=bf16),
                          torch.zeros(3 * C))
    with pytest.raises(ValueError, match='out_proj_ln kernel'):
        elk.out_proj_ln_args(x.to(bf16), torch.zeros(C, C, dtype=bf16), vec,
                             x, vec, vec)
    with pytest.raises(ValueError, match='ffn_ln kernel'):
        fused_ffn._launch_ffn(x, torch.zeros(C, 256, dtype=bf16),
                              torch.zeros(256),
                              torch.zeros(256, C, dtype=bf16), vec,
                              ln=(vec, vec))
    with pytest.raises(ValueError, match='out_proj_ln kernel'):
        elk.launch_out_proj_ln(x.to(bf16), torch.zeros(C, C, dtype=bf16),
                               vec, x, vec, vec, stats=True)
    with pytest.raises(ValueError, match='ffn_ln kernel'):
        fused_ffn._launch_ffn(x, torch.zeros(C, 256, dtype=bf16),
                              torch.zeros(256),
                              torch.zeros(256, C, dtype=bf16), vec,
                              ln=(vec, vec), stats=True)
    calls = []
    monkeypatch.setattr(kernels, 'launch', lambda symbol, *args, device:
                        calls.append(symbol))
    x, vec = torch.zeros(3, 384), torch.zeros(384)
    elk.launch_out_proj_ln(x.to(bf16), torch.zeros(384, 384, dtype=bf16),
                           vec, x, vec, vec, stats=True)
    fused_ffn._launch_ffn(x, torch.zeros(384, 256, dtype=bf16),
                          torch.zeros(256), torch.zeros(256, 384, dtype=bf16),
                          vec, ln=(vec, vec), stats=True)
    assert calls == ['ppgs_out_proj_ln', 'ppgs_ffn_ln']
