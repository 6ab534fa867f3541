"""wav2vec 2.0 (base) in PyTorch: feature encoder + transformer encoder.

Counterpart of ``ppgs_tpu/models/w2v2.py`` for its three consumers: the
w2v2fb frontend (``preprocess/w2v2fb.py``: frozen facebook/wav2vec2-base),
the w2v2fc frontend and the W2V2 / W2V2FC models (``models/w2v2_ppg.py``:
the 100 Hz trunk, ``W2V2Config.with_final_stride(1)``). Semantics of
transformers' Wav2Vec2Model (post-LN, do_stable_layer_norm=False). The
public layouts are the JAX package's: audio (B, S), hidden states
(B, T', C). Parameters live in ``nn.Module``s in the JAX package's
``x @ W`` orientation (``convert.w2v2_params_from_jax`` maps its npz onto
them), the encoder layers being ``models.transformer.EncoderLayer``s.

The bf16 encoder runs through the four-kernel stack
(``ops/encoder_layer_kernel.py``, the TPU's ``encoder_stack_streamed``
with ``activation='gelu'``) under the JAX package's rule: bf16, d_head
dividing 128 with whole 128-lane head groups, T <= 1024. Like the TPU
kernel (and unlike the JAX package's XLA path, which keeps the residual in
bf16), that stack carries an fp32 residual across all 12 layers. The
feature convs, the positional conv and the projection are plain PyTorch,
as the JAX package leaves them to XLA; ``PPGS_TPU_CONV_STACK=1`` runs the
feature convs through the conv-stack kernels (``ops/conv_stack.py``).

``forward(..., train=True, seed=...)`` is the JAX package's train mode
(the reference's HF model in .train() with freeze_feature_extractor()):
the feature encoder frozen (under no_grad, JAX's stop_gradient), then
the feature projection's dropout, spec-augment and the encoder's dropout
sites and LayerDrop, each drawn from the Philox stream of ``seed`` at
its own site (``ops/dropout.py::w2v2_site``). As in the JAX package, that
path reaches no kernel: plain PyTorch with autograd, the XLA path's
operations, reading the parameters. A forward whose parameters want
gradients takes the same differentiable path without the draws.

``_spec_augment`` follows the JAX package, not transformers'
``_compute_mask_indices``: the span count comes from the padded T, the
starts are drawn uniformly over each row's valid starts, and spans may
overlap.
"""

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv_stack
from ..ops import dropout
from ..ops import encoder_layer_kernel as elk
from ..ops import fused_ffn
from ..ops.masking import mask_from_lengths
from . import transformer


###############################################################################
# Architecture config (a copy of the JAX package's)
###############################################################################


@dataclasses.dataclass(frozen=True)
class W2V2Config:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    compute_dtype: str = 'float32'

    # Train-mode regularization (transformers Wav2Vec2Config defaults),
    # read by the train forward
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    layerdrop: float = 0.1
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2

    def with_final_stride(self, stride: int) -> 'W2V2Config':
        """The reference's 100 Hz variant: last conv stride 2 -> stride
        (ppgs/model/w2v2.py:26)."""
        return dataclasses.replace(
            self, conv_stride=self.conv_stride[:-1] + (stride,))


BASE = W2V2Config()


def feat_extract_output_lengths(lengths, config: W2V2Config = BASE):
    """Conv-stack output lengths: floor((L - k) / s) + 1 per layer."""
    for kernel, stride in zip(config.conv_kernel, config.conv_stride):
        lengths = (lengths - kernel) // stride + 1
    return lengths


###############################################################################
# Modules
###############################################################################


class _Weight(nn.Module):
    def __init__(self, *shape, bias=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*shape))
        if bias is not None:
            self.bias = nn.Parameter(torch.zeros(bias))


class FeatureLayer(nn.Module):
    """One feature conv (torch (O, I, K) weight, no bias), with conv 0's
    GroupNorm(C, C)."""

    def __init__(self, c_in, c_out, kernel, group_norm):
        super().__init__()
        self.conv = _Weight(c_out, c_in, kernel)
        if group_norm:
            self.group_norm = transformer.Norm(c_out)


class Wav2Vec2(nn.Module):
    """The wav2vec2 trunk for one ``W2V2Config``. It runs once
    ``convert.prepare_w2v2`` has prepared it (``preprocess.w2v2fb`` does)."""

    def __init__(self, config: W2V2Config = BASE):
        super().__init__()
        self.config = config
        d = config.hidden_size
        dims = (1,) + tuple(config.conv_dim)
        self.feature_encoder = nn.ModuleList(
            FeatureLayer(dims[i], dims[i + 1], k, i == 0)
            for i, k in enumerate(config.conv_kernel))
        self.feature_projection = nn.Module()
        self.feature_projection.norm = transformer.Norm(config.conv_dim[-1])
        self.feature_projection.projection = _Weight(config.conv_dim[-1], d,
                                                     bias=d)
        self.masked_spec_embed = nn.Parameter(torch.zeros(d))
        groups = config.num_conv_pos_embedding_groups
        self.encoder = nn.Module()
        self.encoder.pos_conv = _Weight(d, d // groups,
                                        config.num_conv_pos_embeddings,
                                        bias=d)
        self.encoder.norm = transformer.Norm(d)
        self.encoder.layers = nn.ModuleList(
            transformer.EncoderLayer(d, config.intermediate_size)
            for _ in range(config.num_layers))

    def forward(self, audio, lengths=None, mask_config=None, train=False,
                seed=None):
        return forward(self, audio, lengths, mask_config=mask_config,
                       train=train, seed=seed)


def init(config: W2V2Config = BASE, generator=None):
    """Random parameters in the JAX package's layout (a nested dict of
    numpy arrays, as ``ppgs_tpu.models.w2v2.init`` returns), so that
    ``load.save_params`` writes a file both packages read: normal(0, 0.02)
    matrices and convs, zero biases, unit norms, a uniform
    masked_spec_embed, drawn from ``generator``; the numbers are not
    JAX's."""
    def normal(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float64)
                * 0.02).float().numpy()

    def zeros(n):
        return np.zeros(n, np.float32)

    def norm(n):
        return {'scale': np.ones(n, np.float32), 'bias': zeros(n)}

    params = {'feature_encoder': []}
    in_dim = 1
    for i, (out_dim, kernel) in enumerate(
            zip(config.conv_dim, config.conv_kernel)):
        layer = {'conv': {'weight': normal(kernel, in_dim, out_dim)}}
        if i == 0:
            layer['group_norm'] = norm(out_dim)
        params['feature_encoder'].append(layer)
        in_dim = out_dim
    d, f = config.hidden_size, config.intermediate_size
    params['feature_projection'] = {
        'norm': norm(config.conv_dim[-1]),
        'projection': {'weight': normal(config.conv_dim[-1], d),
                       'bias': zeros(d)}}
    params['masked_spec_embed'] = torch.rand(
        d, generator=generator, dtype=torch.float64).float().numpy()
    groups = config.num_conv_pos_embedding_groups
    params['encoder'] = {
        'pos_conv': {'weight': normal(config.num_conv_pos_embeddings,
                                      d // groups, d),
                     'bias': zeros(d)},
        'norm': norm(d), 'layers': []}
    for _ in range(config.num_layers):
        params['encoder']['layers'].append({
            'attn': {**{f'w{n}': normal(d, d) for n in 'qkvo'},
                     **{f'b{n}': zeros(d) for n in 'qkvo'}},
            'norm1': norm(d),
            'ffn': {'w1': normal(d, f), 'b1': zeros(f), 'w2': normal(f, d),
                    'b2': zeros(d)},
            'norm2': norm(d)})
    return params


###############################################################################
# Blocks
###############################################################################


def _layer_norm(x, p, eps=1e-5):
    """LayerNorm with fp32 statistics; output in the input's dtype (the
    encoder's residual rides the compute dtype on the per-layer path)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * p.scale
            + p.bias).to(x.dtype)


def _group_norm(x, p, eps=1e-5):
    """GroupNorm(C, C) over (B, C, T) (one group per channel): fp32
    statistics over every frame, whatever the storage dtype; fp32 out."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * p.scale[:, None]
            + p.bias[:, None])


def _gelu(x):
    """Exact-erf GELU in fp32, the tanh approximation in bf16 (computed in
    fp32, rounded once), as ``ppgs_tpu/models/w2v2.py::_gelu``."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x.float(), approximate='tanh').to(x.dtype)
    return F.gelu(x)


def _compute_dtype(config):
    return getattr(torch, config.compute_dtype)


@torch.no_grad()
def feature_encoder(model, audio, config: W2V2Config = BASE):
    """Raw audio (B, S) -> features (B, T', conv_dim[-1]) fp32 at ~50 Hz.

    bf16 compute stores every conv output in bf16 (the conv-0 output is
    gigabytes at 64 x 8 s), with fp32 GroupNorm statistics; fp32 compute
    keeps everything fp32. With ``PPGS_TPU_CONV_STACK=1`` the bf16 stack
    runs through the conv-stack kernels (``ops/conv_stack.py``)."""
    cd = _compute_dtype(config)
    layers = model.feature_encoder
    gn = getattr(layers[0], 'group_norm', None)
    if conv_stack.supported(config) and gn is not None:
        w = model.feature_prepared
        taps = [getattr(w, f'w{i}') for i in range(1, len(layers))]
        return conv_stack.feature_encoder_stack(
            audio, taps, w.w0, gn.scale, gn.bias, tuple(config.conv_kernel),
            tuple(config.conv_stride)).float()

    x = audio[:, None, :].to(cd)                         # (B, 1, S)
    for i, layer in enumerate(layers):
        x = F.conv1d(x.to(cd), layer.conv.weight.to(cd),
                     stride=config.conv_stride[i])
        if i == 0 and gn is not None:
            x = _group_norm(x, gn).to(cd)
        x = _gelu(x)
    return x.transpose(1, 2).float()


def _pos_conv(x, p, config: W2V2Config):
    """Grouped positional conv (k = 128, groups = 16) on (B, T, C), 'same'
    padding minus the last frame for the even k; fp32 sums, the bias in
    fp32, then the compute dtype and GELU."""
    k = config.num_conv_pos_embeddings
    cd = _compute_dtype(config)
    out = F.conv1d(x.transpose(1, 2).to(cd), p.weight.to(cd),
                   padding=k // 2, groups=config.num_conv_pos_embedding_groups)
    out = (out.float() + p.bias[:, None]).to(cd)
    if k % 2 == 0:
        out = out[..., :-1]                              # SamePadLayer
    return _gelu(out.transpose(1, 2))


# The trunk's head widths on the card: K2's that divide 128 (the JAX
# rule's packed heads); 8 and less are not ported (a TMA box is at least
# 16 bytes wide: they need a packed form, ROADMAP.md)
STACK_D_HEADS = (16, 32, 64, 128)


def use_stack(config: W2V2Config, T, device) -> bool:
    """Whether the encoder runs as the four-kernel stack: the JAX package's
    rule (``ppgs_tpu/models/w2v2.py:302-314, :413-420``: bf16, d_head
    dividing 128 with whole 128-lane head groups, T <= 1024). On the card
    the kernels take any C of K1, K3 and K4's width rule
    (``fused_ffn.width_ok``: C % 128 == 0 up to 2048; wav2vec2-base's 768
    and -large's 1024 among them) with d_head in ``STACK_D_HEADS``; another
    width the rule sends to them raises NotImplementedError there."""
    C, heads = config.hidden_size, config.num_heads
    d_head = C // heads
    stack = (config.compute_dtype == 'bfloat16' and 128 % d_head == 0
             and heads % (128 // d_head) == 0 and T <= elk.MAX_SEQ)
    if (stack and torch.device(device).type == 'cuda'
            and not (fused_ffn.width_ok(C) and d_head in STACK_D_HEADS)):
        raise NotImplementedError(
            f'The CUDA kernels take the wav2vec2 trunk at C % 128 == 0 up '
            f'to {fused_ffn.MAX_WIDTH} with d_head in {STACK_D_HEADS}; this '
            f'one has C = {C} with d_head = {d_head} (ROADMAP.md)')
    return stack


@torch.no_grad()
def encoder(model, hidden, attention_mask=None, config: W2V2Config = BASE):
    """Transformer encoder on (B, T, C) features (post-LN) -> (B, T, C) in
    the compute dtype.

    On the stack (``use_stack``) the residual is fp32 from the input to the
    last layer, as in the TPU kernel; on the per-layer path it is stored in
    the compute dtype, as in the JAX package's XLA path, with fp32
    LayerNorm statistics."""
    cd = _compute_dtype(config)
    p = model.encoder
    hidden = hidden.to(cd)
    if attention_mask is not None:
        hidden = hidden * attention_mask[..., None].to(cd)
    hidden = hidden + _pos_conv(hidden, p.pos_conv, config).to(cd)
    hidden = _layer_norm(hidden, p.norm, config.layer_norm_eps)

    B, T, C = hidden.shape
    key_mask = (attention_mask.bool() if attention_mask is not None
                else torch.ones(B, T, dtype=torch.bool, device=hidden.device))
    if use_stack(config, T, hidden.device):
        return elk.encoder_stack(hidden, key_mask, p.layers, config.num_heads,
                                 compute_dtype=cd,
                                 activation='gelu').to(cd)

    for layer in p.layers:
        w = layer.prepared
        attn_out = transformer._attention(hidden, w, key_mask, False,
                                          config.num_heads, cd, False)
        attn_res = _layer_norm(hidden + attn_out, layer.norm1,
                               config.layer_norm_eps)
        ff = _gelu(fused_ffn.matmul(attn_res.to(cd), w.w1).to(cd) + w.b1)
        ff = (fused_ffn.matmul(ff, w.w2).to(cd) + w.b2).to(attn_res.dtype)
        hidden = _layer_norm(attn_res + ff, layer.norm2,
                             config.layer_norm_eps)
    return hidden


###############################################################################
# Train mode: the JAX package's XLA path, differentiable
###############################################################################


def _spec_augment(hidden, valid_mask, seed, embed, config: W2V2Config):
    """The JAX package's time masking (``ppgs_tpu/models/w2v2.py:271-299``):
    num = max(mask_time_min_masks, round(mask_time_prob T / length)) spans
    of mask_time_length frames a row, from the padded T, each start drawn
    uniformly over the row's valid starts [0, max(valid - length, 1)), the
    spans' frames overwritten with ``embed``. Rows of T <= length are left
    as they are."""
    B, T, _ = hidden.shape
    length = config.mask_time_length
    num = max(config.mask_time_min_masks,
              int(config.mask_time_prob * T / length + 0.5))
    if T <= length:
        return hidden
    device = hidden.device
    lengths = (valid_mask.sum(-1) if valid_mask is not None
               else torch.full((B,), T, device=device))
    hi = torch.clamp(lengths.to(torch.int64) - length, min=1)[:, None]
    draws = dropout.bits(B * num, seed, dropout.w2v2_site('spec_augment'),
                         device).view(B, num)
    starts = (draws * hi) >> 32                             # (B, num)
    t = torch.arange(T, device=device)[None, None, :]
    spans = (t >= starts[..., None]) & (t < starts[..., None] + length)
    time_mask = spans.any(dim=1)                            # (B, T)
    return torch.where(time_mask[..., None], embed.to(hidden.dtype), hidden)


def layer_kept(seed, layer, rate):
    """Whether LayerDrop keeps encoder layer ``layer`` in the step of
    ``seed``: its one draw against ``rate`` (on the host, a pure function of
    the seed, so the step neither waits for the card nor depends on it)."""
    if rate <= 0:
        return True
    draw = int(dropout.bits(1, seed, dropout.w2v2_site('layerdrop', layer))[0])
    return draw >= dropout.threshold(rate)


def _attention_train(x, attn, mask, heads, cd, seed, rate, site):
    """Self-attention on (B, T, C) with dropout on the probabilities, as the
    JAX package's XLA ``_attention``: q, k and v in the compute dtype, the
    logits rounded to it, an fp32 softmax with the key mask before the max
    (a wholly masked row gives 0), the probabilities dropped in fp32 and
    rounded for the product with v. The max is taken out of the autograd
    graph: the softmax does not depend on it, and the backward then keeps
    no copy of the logits."""
    B, T, C = x.shape
    d = C // heads
    qkv = x.to(cd) @ attn.wqkv.to(cd) + attn.bqkv.to(cd)

    def heads_first(t):
        return t.reshape(B, T, heads, d).transpose(1, 2)

    q, k, v = (heads_first(qkv[..., i * C:(i + 1) * C]) for i in range(3))
    logits = (q @ k.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :], float('-inf'))
    with torch.no_grad():
        top = logits.amax(dim=-1, keepdim=True)
        top = torch.where(torch.isfinite(top), top, 0.0)
    unnorm = torch.exp(logits - top)
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    if seed is not None:
        probs = dropout.dropout(probs, seed, site, rate)
    out = (probs.to(cd) @ v).transpose(1, 2).reshape(B, T, C)
    return (out @ attn.wo.to(cd) + attn.bo.to(cd)).to(x.dtype)


def _encoder_train(model, hidden, mask, config: W2V2Config, seed):
    """The encoder on (B, T, C) as the JAX package's XLA path (the residual
    in the compute dtype, fp32 LayerNorm statistics), differentiable; with
    ``seed`` (not None) the train mode's dropout sites and LayerDrop. A
    layer that LayerDrop skips is not computed: its output is its input,
    and its parameters get no gradient (zero in JAX's tree)."""
    cd = _compute_dtype(config)
    p = model.encoder
    eps = config.layer_norm_eps
    hidden = hidden.to(cd)
    if mask is not None:
        hidden = hidden * mask[..., None].to(cd)
    hidden = hidden + _pos_conv(hidden, p.pos_conv, config).to(cd)
    hidden = _layer_norm(hidden, p.norm, eps)

    def drop(x, kind, layer, rate):
        if seed is None:
            return x
        return dropout.dropout(x, seed, dropout.w2v2_site(kind, layer), rate)

    hidden = drop(hidden, 'pos_conv', None, config.hidden_dropout)
    for i, layer in enumerate(p.layers):
        if seed is not None and not layer_kept(seed, i, config.layerdrop):
            continue
        a = _attention_train(
            hidden, layer.attn, mask, config.num_heads, cd, seed,
            config.attention_dropout, dropout.w2v2_site('probs', i))
        a = drop(a, 'attention', i, config.hidden_dropout)
        res = _layer_norm(hidden + a, layer.norm1, eps)
        f = layer.ffn
        h = _gelu(res.to(cd) @ f.w1.to(cd) + f.b1.to(cd))
        h = drop(h, 'activation', i, config.activation_dropout)
        h = (h @ f.w2.to(cd) + f.b2.to(cd)).to(res.dtype)
        h = drop(h, 'output', i, config.hidden_dropout)
        hidden = _layer_norm(res + h, layer.norm2, eps)
    return hidden


def _wants_grad(model):
    return (torch.is_grad_enabled()
            and model.feature_projection.projection.weight.requires_grad)


def forward(model, audio, lengths=None, config: W2V2Config = None,
            mask_config: W2V2Config = None, train=False, seed=None):
    """Full wav2vec2: (B, S) audio -> (B, T', hidden) last hidden state in
    the compute dtype.

    ``lengths``: valid sample counts (a tensor); converted to a
    feature-level attention mask as transformers'
    _get_feature_vector_attention_mask does, with ``mask_config``'s
    convs when given (the W2V2 model's stride-2 mask on its 100 Hz trunk,
    ``models/w2v2_ppg.py::_mask_config``).

    ``train`` with a ``seed`` (an int): the train mode's feature-projection
    dropout, spec-augment, encoder dropout and LayerDrop, drawn from the
    Philox stream of ``seed``. Train mode, and a forward whose parameters
    want gradients, take the differentiable path (plain PyTorch, the JAX
    package's XLA operations); otherwise the inference path, under no_grad
    (the four-kernel stack where ``use_stack`` says so). The feature
    encoder is frozen in both."""
    config = config or model.config
    train = train and seed is not None
    features = feature_encoder(model, audio, config)
    mask = None
    if lengths is not None:
        out_lengths = feat_extract_output_lengths(lengths,
                                                  mask_config or config)
        mask = mask_from_lengths(out_lengths, features.shape[1])
    if not (train or _wants_grad(model)):
        return _inference(model, features, mask, config)

    cd = _compute_dtype(config)
    fp = model.feature_projection
    hidden = _layer_norm(features, fp.norm, config.layer_norm_eps)
    hidden = (hidden.to(cd) @ fp.projection.weight.to(cd)
              + fp.projection.bias.to(cd))
    if train:
        hidden = dropout.dropout(hidden, seed,
                                 dropout.w2v2_site('projection'),
                                 config.feat_proj_dropout)
        if config.apply_spec_augment and config.mask_time_prob > 0:
            hidden = _spec_augment(hidden, mask, seed,
                                   model.masked_spec_embed, config)
    return _encoder_train(model, hidden, mask, config,
                          seed if train else None)


@torch.no_grad()
def _inference(model, features, mask, config: W2V2Config):
    """The inference forward from the feature encoder's output."""
    cd = _compute_dtype(config)
    fp = model.feature_projection
    hidden = _layer_norm(features, fp.norm, config.layer_norm_eps)
    hidden = (fused_ffn.matmul(hidden.to(cd), fp.projection.weight.to(cd))
              .to(cd) + fp.projection.bias.to(cd))
    return encoder(model, hidden, mask, config)
