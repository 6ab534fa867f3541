"""The attention kernels at every head width of the JAX rule up to the
port's C <= 2048, on the CPU, at narrow depth (2 layers, B = 2, T <= 40),
against the JAX package on the same seeded numpy inputs and npz weights:

- ``from_features`` with the default two heads at C = 768, 1024 and 2048
  (d_head 384, 512, 1024): fp32 at 1e-4, bf16 PPGs at atol 2e-2 with the
  argmax on >= 99.5% of the frames (docs/GOLDEN_PARITY.md);
- K2's plain version against ``flash_attention`` in interpret mode at
  d_head 384, 512, 1024 and 2048 (its whole-T kernel) and at 32 and 16
  (its packed kernel, 128 / d_head heads a 128-lane block);
- the train attention's plain versions at d_head 512 against
  ``flash_attention_train`` in interpret mode, forward and gradients at
  rate 0;
- the wide routes' cluster: its rank plan at every d_head % 128 == 0 from
  384 to 2048, and a model of its arithmetic (S summed over the ranks'
  partials in rank order) against the plain versions and the JAX kernels
  at d_head 384 and 1024;
- B4's plain chain at (1024, 2 heads) in fp32 against
  ``encoder_layer_train`` in interpret mode, and a 2-layer bf16 train step
  at (768, 2 heads) against JAX's (tests/test_torch_train_any_width.py's
  checks);
- the wav2vec2 trunk's shape re-headed to 24 heads of 32 (2 layers)
  through the port's stack against ``encoder_stack_streamed`` in
  interpret mode (tests/test_torch_any_width.py's bf16 rule);
- the wrappers hand the kernels the new widths (the launches recorded, not
  run), and the gates take every (C, d_head) with C % 128 == 0 up to 2048,
  d_head % 128 == 0 and C % d_head == 0 (50 pairs) in inference and
  training, and the trunk at d_head 16, 32, 64 and 128.

The CUDA kernels run only on a card: ``chip_smoke.py --slices wide_heads``
holds each against these plain versions there.
"""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
from ppgs_tpu.models import w2v2 as jax_w2v2
from ppgs_tpu.ops import encoder_layer_kernel as jax_elk
from ppgs_tpu.ops import flash_attention as jax_fa

import ppgs_tpu_torch
from ppgs_tpu_torch import convert, kernels
from ppgs_tpu_torch.models import transformer, w2v2
from ppgs_tpu_torch.ops import dropout
from ppgs_tpu_torch.ops import encoder_layer_kernel as elk
from ppgs_tpu_torch.ops import flash_attention as fa

from test_torch_any_width import _config, _npz, _rel_l2
from test_torch_train_any_width import layer_against_jax, step_against_jax

LAYERS, B, T = 2, 2, 40
# (C, d_head) of the PPG transformer with its default two heads
PAIRS = ((768, 384), (1024, 512), (2048, 1024))
WIDE_D = (384, 512, 1024, 2048)
NARROW_D = (16, 32)
# T about the kernels' 64-key tiles and 128-row blocks
T_EDGES = (1, 65, 129)


def _ids(pairs):
    return [pytest.param(c, d, id=f'C{c}-d{d}') for c, d in pairs]


###############################################################################
# The PPG transformer through its entry point
###############################################################################


@pytest.mark.parametrize('C,D', _ids(PAIRS))
def test_from_features_matches_jax(tmp_path, C, D):
    """``from_features`` at two heads of d_head on the same npz and
    features: fp32 at 1e-4, bf16 PPGs at atol 2e-2 with the argmax on at
    least 99.5% of the valid frames. In bf16 the port's plain path is the
    kernels' chain (the JAX rule sends d_head % 128 == 0 to the kernels),
    JAX's on the CPU its XLA path."""
    rng = np.random.default_rng(C + D)
    features = rng.standard_normal((B, 80, T)).astype(np.float32)
    lengths = np.array([T, 27])
    for compute_dtype, tol in (('float32', dict(rtol=1e-4, atol=1e-4)),
                               ('bfloat16', dict(rtol=0, atol=2e-2))):
        config = _config(C, D, compute_dtype)
        assert config.attention_heads == 2
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
        agree = []
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(got[i, :, :n], want[i, :, :n],
                                       err_msg=compute_dtype, **tol)
            agree += list(got[i, :, :n].argmax(0) == want[i, :, :n].argmax(0))
        assert np.mean(agree) >= 0.995, (compute_dtype, np.mean(agree))


###############################################################################
# The plain attention against the JAX kernels in interpret mode
###############################################################################


def _inputs(seed, T, C):
    """q, k, v, dO (4, T, C) fp32 and a (4, T) mask: a ragged prefix, a mask
    with holes (one whole 64-key tile masked where T reaches it), a wholly
    masked window, and a full one."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((4, T, C)).astype(np.float32)
                   for _ in range(4))
    keys = np.arange(T)
    mask = np.stack([keys < max(1, (2 * T) // 3), rng.random(T) < 0.6,
                     np.zeros(T, bool), np.ones(T, bool)])
    mask[1, 64:128] = False
    return q, k, v, do, mask


def _padded(arrays, mask):
    """The arrays and the mask on T padded to a multiple of 8 (the JAX
    kernels' pad + mask at the call site: the padded keys are masked)."""
    pad = -mask.shape[1] % 8
    return ([jnp.asarray(np.pad(a, ((0, 0), (0, pad), (0, 0))))
             for a in arrays], jnp.asarray(np.pad(mask, ((0, 0), (0, pad)))))


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('T', T_EDGES)
@pytest.mark.parametrize('D', NARROW_D + WIDE_D)
def test_attention_reference_matches_jax_kernel(D, T, causal):
    """K2's plain version at head width D against ``flash_attention`` in
    interpret mode: its packed kernel at d_head 16 and 32 (8 and 4 heads,
    one 128-lane block), its whole-T kernel at two heads of 384 to 2048;
    fp32, rtol 1e-4 and atol 1e-5 (tests/test_torch_attention.py's), with
    raw q and with the scale folded into q; the wholly masked window 0."""
    H = 128 // D if D < 128 else 2
    q, k, v, _, mask = _inputs(D + T, T, H * D)
    wide, wide_mask = _padded((q, k, v), mask)
    want = np.asarray(jax_fa.flash_attention(
        *wide, wide_mask, num_heads=H, block_q=8, block_k=8, causal=causal,
        interpret=True))[:, :T]
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    got = fa.flash_attention_reference(tq, tk, tv, tm, H, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    folded = tq * (fa.LOG2E / math.sqrt(D))
    got = fa.attention_reference(folded, tk, tv, tm, H, 1.0, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert not got[2].any()


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('T', T_EDGES)
def test_train_references_match_jax_kernel_at_512(T, causal):
    """The train attention's plain versions at two heads of 512, rate 0:
    o from the forward, then dq, dk and dv from the backward on its lse
    and d_row (the steps of ``_FlashTrain``), against
    ``flash_attention_train`` in interpret mode and its vjp
    (tests/test_torch_attention_train.py's tolerances, rtol = atol =
    1e-4); the wholly masked window gives no output and no gradient."""
    H, D = 2, 512
    C = H * D
    q, k, v, do, mask = _inputs(T + 7, T, C)
    wide, wide_mask = _padded((q, k, v, do), mask)

    def attend(q_, k_, v_):
        return jax_fa.flash_attention_train(
            q_, k_, v_, wide_mask, H, dropout_rate=0.0, causal=causal,
            interpret=True)

    out, vjp = jax.vjp(attend, *wide[:3])
    want = [np.asarray(a)[:, :T] for a in (out, *vjp(wide[3]))]
    tq, tk, tv, tdo, tm = (torch.from_numpy(a) for a in (q, k, v, do, mask))
    sm = 1.0 / math.sqrt(D)
    drop = dropout.Drop(0, 1, 0.0)
    o, _, lse, keep = fa.attention_train_fwd_reference(
        tq, tk, tv, tm, H, fa.LOG2E * sm, causal, drop)
    d_row = fa.row_dot_reference(tdo, o, H)
    _, d32 = fa.attention_train_bwd_reference(
        tq, tk, tv, tm, lse, keep, tdo, d_row, H, fa.LOG2E * sm, sm, causal,
        drop, want_c=False, want32=True)
    got = [o, d32[..., :C], d32[..., C:2 * C], d32[..., 2 * C:]]
    for name, a, b in zip(('o', 'dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    assert not d32[2].any() and not o[2].any()


###############################################################################
# The wide routes' cluster: the rank plan and its arithmetic
###############################################################################


def _wide_constant(name):
    """``constexpr int name = value;`` of ``attention_wide.cuh``."""
    text = (kernels.CSRC / 'attention_wide.cuh').read_text()
    return int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))


def _wide_ranks(d):
    """A model of the wide routes' rank plan at head width d
    (``wide::ranks`` and ``wide::rank_cols`` in ``attention_wide.cuh``,
    whose RANK_COLS it reads): the (first column, columns) of each block
    of a head's cluster, in rank order, RANK_COLS columns each but the
    last, which has the rest. K2 and the train forward add the ranks'
    partial scores in this order. The kernels' own plan is checked on the
    card (chip_smoke.py's phase 42 runs every wide width)."""
    cols = _wide_constant('RANK_COLS')
    return [(c, min(cols, d - c)) for c in range(0, d, cols)]


@pytest.mark.parametrize('D', range(384, 2049, 128))
def test_wide_rank_plan_covers_the_head(D):
    """K2's and the train forward's cluster at d_head D, up to the
    header's MAX_D: at most 8 ranks (the portable cluster), in rank order,
    disjoint ranges of 256 columns that cover the head, the last of 128
    where D % 256 == 128."""
    assert D <= _wide_constant('MAX_D')
    plan = _wide_ranks(D)
    assert 2 <= len(plan) <= 8
    assert [c for c, _ in plan] == [256 * r for r in range(len(plan))]
    widths = [w for _, w in plan]
    assert sum(widths) == D
    assert widths[:-1] == [256] * (len(plan) - 1)
    assert widths[-1] == (128 if D % 256 == 128 else 256)


def _cluster_model(q, k, v, mask, heads, scale_log2, causal, train):
    """The wide routes' arithmetic, in q's dtype: S the sum of the ranks'
    partials Q_r K_r^T in rank order (``_wide_ranks``), the key and causal
    masks, the softmax (K2's: p = exp2(s - max), 1/l after the product; or,
    with ``train``, the train forward's at rate 0: p = exp2(s - lse) before
    it), then P V_r for each rank and the ranks' columns joined."""
    B, T, C = q.shape
    plan = _wide_ranks(C // heads)
    q4, k4, v4 = (fa._heads_first(t, heads) for t in (q, k, v))
    s = 0
    for c, w in plan:
        s = s + q4[..., c:c + w] @ k4[..., c:c + w].transpose(-1, -2)
    valid = fa._valid(mask, T, causal)
    s = (s * scale_log2).masked_fill(~valid, fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    if train:
        lse = torch.where(l > 0, m + torch.log2(l.clamp_min(1e-30)), 0.0)
        p, l = torch.exp2(s - lse).masked_fill(~valid, 0.0), 1.0
    o = torch.cat([p.to(q.dtype).float() @ v4[..., c:c + w]
                   for c, w in plan], dim=-1)
    return fa._heads_last(o / torch.as_tensor(l).clamp_min(1e-30)).to(
        q.dtype)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('T', T_EDGES)
@pytest.mark.parametrize('D', (384, 1024))
def test_cluster_model_matches_the_references_and_jax(D, T, causal):
    """The cluster's arithmetic at two heads of D in fp32 (K2's softmax,
    and the train forward's at rate 0): within 1e-5 of the plain versions
    (``attention_reference``, ``attention_train_fwd_reference``), which
    sum S in one product, and against ``flash_attention`` and
    ``flash_attention_train`` in interpret mode at their tests' tolerances
    (rtol 1e-4 and atol 1e-5; rtol = atol = 1e-4); the wholly masked
    window 0."""
    H = 2
    q, k, v, _, mask = _inputs(D + T + 3, T, H * D)
    wide, wide_mask = _padded((q, k, v), mask)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    sl = fa.LOG2E / math.sqrt(D)
    got = _cluster_model(tq, tk, tv, tm, H, sl, causal, train=False)
    np.testing.assert_allclose(
        got.numpy(), fa.attention_reference(tq, tk, tv, tm, H, sl,
                                            causal).numpy(),
        rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_fa.flash_attention(
        *wide, wide_mask, num_heads=H, block_q=8, block_k=8, causal=causal,
        interpret=True))[:, :T]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert not got[2].any()
    got = _cluster_model(tq, tk, tv, tm, H, sl, causal, train=True)
    o, _, _, _ = fa.attention_train_fwd_reference(
        tq, tk, tv, tm, H, sl, causal, dropout.Drop(0, 1, 0.0))
    np.testing.assert_allclose(got.numpy(), o.numpy(), rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_fa.flash_attention_train(
        *wide, wide_mask, H, dropout_rate=0.0, causal=causal,
        interpret=True))[:, :T]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert not got[2].any()


###############################################################################
# Training at two heads of the wide widths
###############################################################################


def test_encoder_layer_train_matches_jax_kernel_at_1024():
    """B4's plain chain at C = 1024 with two heads of 512, rate 0, fp32,
    against ``encoder_layer_train`` in interpret mode: out, dx and the 16
    gradients within 2^-8 relative and rtol = atol = 2e-3."""
    layer_against_jax(1024, 512)


def test_train_step_matches_jax_at_768(monkeypatch):
    """One bf16 train step of a 2-layer transformer at C = 768 with two
    heads of 384 through ``make_train_step`` against JAX's (its Pallas
    train kernels in interpret mode): the loss within 1e-4 relative, each
    parameter after one Adam step within 2^-8 relative."""
    step_against_jax(monkeypatch, 768, 2)


###############################################################################
# The wav2vec2 trunk at 24 heads of 32
###############################################################################


def test_trunk_at_d_head_32_matches_encoder_stack_streamed(tmp_path):
    """B7 at wav2vec2-base's widths re-headed to 24 heads of 32 (C = 768, F
    = 3072), 2 layers: the port's K1 -> K2(d_head 32) -> K3 -> K4(GELU)
    chain (plain versions) against the TPU's streamed kernel in interpret
    mode (its packed attention, four heads a 128-lane block), a ragged
    window and a full one: fp32 at atol and rtol 1e-4; bf16 no farther
    from the fp32 result than the JAX kernel's own bf16 output, with 25%
    to spare, and within the bf16 gate's atol 2e-2 of it
    (tests/test_torch_any_width.py's rule for the large trunk)."""
    jcfg = jax_w2v2.W2V2Config(num_layers=LAYERS, num_heads=24,
                               compute_dtype='bfloat16')
    assert jcfg.hidden_size // jcfg.num_heads == 32
    path = tmp_path / 'w2v2.npz'
    ppgs_tpu.load.save_params(path, jax_w2v2.init(jax.random.PRNGKey(13),
                                                  jcfg))
    params = ppgs_tpu.load.load_params(path)
    C, H = jcfg.hidden_size, jcfg.num_heads
    rng = np.random.default_rng(14)
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
# The wrappers and the gates
###############################################################################


def _meta_views(Tq, C, heads):
    """q, k, v views of one (2, Tq, 3C) bf16 meta buffer (no storage,
    address 0: the wrappers take the kernels' side), and a valid mask."""
    buf = torch.zeros(2, Tq, 3 * C, dtype=torch.bfloat16, device='meta')
    q, k, v = (buf[..., i * C:(i + 1) * C] for i in range(3))
    return q, k, v, torch.ones(2, Tq, dtype=torch.bool, device='meta')


@pytest.mark.parametrize('D', NARROW_D + WIDE_D)
def test_wrappers_hand_the_kernels_the_new_widths(D, monkeypatch):
    """K2 takes d_head 16, 32 and 384 ... 2048; the train forward, row_dot
    and the train backward take 384 ... 2048 (and refuse 16 and 32): each
    wrapper checks its operands and hands its C entry point the head width
    (the launch recorded here, not run)."""
    calls = []
    monkeypatch.setattr(kernels, 'launch', lambda symbol, *args, device:
                        calls.append((symbol, args)))
    H = 128 // D if D < 128 else 2
    C, Tq = H * D, 70
    q, k, v, mask = _meta_views(Tq, C, H)
    assert fa._attention_args(q, k, v, mask, H) == (D, 3 * C)
    out = fa.attention(q, k, v, mask, H, 1.0)
    symbol, args = calls.pop()
    assert symbol == 'ppgs_attention' and args[9:11] == (H, D)
    assert out.shape == (2, Tq, C)
    drop = dropout.Drop(1, 1, 0.1)
    if D < 128:
        with pytest.raises(ValueError, match='d_head % 128 == 0'):
            fa.attention_train_fwd(q, k, v, mask, H, 1.0, False, drop)
        assert not calls
        return
    o, o32, lse, keep = fa.attention_train_fwd(q, k, v, mask, H, 1.0, False,
                                               drop, want_f32=True)
    symbol, args = calls.pop()
    assert symbol == 'ppgs_attention_train_fwd' and args[10:14] == (2, Tq,
                                                                    H, D)
    assert keep.shape == fa.keep_words_shape(2, H, Tq)
    d_row = fa.row_dot(o32, o32, H)
    symbol, args = calls.pop()
    assert symbol == 'ppgs_row_dot' and args[5:9] == (2, Tq, H, D)
    fa.attention_train_bwd(q, k, v, mask, lse, keep, o, d_row, H, 1.0, 1.0,
                           False, drop, want32=True)
    symbol, args = calls.pop()
    assert symbol == 'ppgs_attention_train_bwd' and args[17:21] == (2, Tq,
                                                                    H, D)
    assert not calls


@pytest.mark.parametrize('C,heads,match', [
    (128, 16, 'd_head in'),                # d_head 8: K2 has no form
    (4352, 2, 'd_head in'),                # d_head 2176: past 2048
])
def test_k2_refuses_outside_its_widths(C, heads, match):
    q, k, v, mask = _meta_views(70, C, heads)
    with pytest.raises(ValueError, match=match):
        fa._attention_args(q, k, v, mask, heads)


def test_gates_take_every_pair_of_the_jax_rule_up_to_2048():
    """On the card the inference and training gates take every (C, d_head)
    with C % 128 == 0 up to 2048, d_head % 128 == 0 and C % d_head == 0:
    50 pairs, the default two heads at every C % 256 == 0 among them; the
    wav2vec2 trunk at d_head 16, 32, 64 and 128 at every C % 128 == 0 up
    to 2048 whose heads fill 128-lane blocks; past 2048 (C = 2304 with two
    heads of 1152) and at a trunk d_head of 8 they raise, naming
    ROADMAP.md, and the CPU takes the plain path."""
    mel = ppgs_tpu_torch.config.get('mel')
    taken = set()
    for C in range(128, 2049, 128):
        for D in range(128, C + 1, 128):
            if C % D:
                continue
            config = mel.replace(hidden_channels=C, attention_heads=C // D)
            assert transformer.inference_width_ok(C, D)
            assert transformer.use_kernels(config, 'cuda') is True
            assert transformer.use_kernels(config, 'cuda', train=True) is True
            taken.add((C, D))
        for D in (16, 32, 64, 128):
            trunk = dataclasses.replace(w2v2.BASE, hidden_size=C,
                                        num_heads=C // D,
                                        compute_dtype='bfloat16')
            assert w2v2.use_stack(trunk, 400, 'cuda') is True
    assert len(taken) == 50
    assert {(C, C // 2) for C in range(256, 2049, 256)} <= taken
    wide = mel.replace(hidden_channels=2304, attention_heads=2)
    for train in (False, True):
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            transformer.use_kernels(wide, 'cuda', train=train)
    assert transformer.use_kernels(wide, 'cpu', train=True) is True
    narrow = dataclasses.replace(w2v2.BASE, num_heads=96,
                                 compute_dtype='bfloat16')
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        w2v2.use_stack(narrow, 400, 'cuda')
    assert w2v2.use_stack(narrow, 400, 'cpu') is True
