"""wav2vec 2.0 (base) in PyTorch, inference: feature encoder + transformer
encoder.

Counterpart of ``ppgs_tpu/models/w2v2.py`` for the w2v2fb frontend
(``preprocess/w2v2fb.py``): frozen facebook/wav2vec2-base, semantics of
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

Not ported yet (ROADMAP.md): train mode (dropout, LayerDrop,
spec-augment), the 100 Hz ``mask_config`` variant of the W2V2 model.
"""

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv_stack
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

    # Train-mode regularization (transformers Wav2Vec2Config defaults), kept
    # so that the two packages' configs have the same fields; the port's
    # inference forward does not read them
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    feat_proj_dropout: float = 0.0
    layerdrop: float = 0.1
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2


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

    def forward(self, audio, lengths=None):
        return forward(self, audio, lengths)


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


def use_stack(config: W2V2Config, T, device) -> bool:
    """Whether the encoder runs as the four-kernel stack: the JAX package's
    rule (``ppgs_tpu/models/w2v2.py:302-314, :413-420``: bf16, d_head
    dividing 128 with whole 128-lane head groups, T <= 1024). On the card
    the kernels take wav2vec2-base's C = 768 with d_head = 64; another
    width the rule sends to them raises NotImplementedError there."""
    C, heads = config.hidden_size, config.num_heads
    d_head = C // heads
    stack = (config.compute_dtype == 'bfloat16' and 128 % d_head == 0
             and heads % (128 // d_head) == 0 and T <= elk.MAX_SEQ)
    if (stack and torch.device(device).type == 'cuda'
            and (C, d_head) != (768, 64)):
        raise NotImplementedError(
            f'The CUDA kernels take the wav2vec2 trunk at C = 768 with '
            f'd_head = 64; this one has C = {C} with d_head = {d_head} '
            f'(ROADMAP.md)')
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


@torch.no_grad()
def forward(model, audio, lengths=None, config: W2V2Config = None):
    """Full wav2vec2: (B, S) audio -> (B, T', hidden) last hidden state in
    the compute dtype.

    ``lengths``: valid sample counts (a tensor); converted to a
    feature-level attention mask as transformers'
    _get_feature_vector_attention_mask does."""
    config = config or model.config
    cd = _compute_dtype(config)
    features = feature_encoder(model, audio, config)
    fp = model.feature_projection
    hidden = _layer_norm(features, fp.norm, config.layer_norm_eps)
    hidden = (fused_ffn.matmul(hidden.to(cd), fp.projection.weight.to(cd))
              .to(cd) + fp.projection.bias.to(cd))
    mask = None
    if lengths is not None:
        out_lengths = feat_extract_output_lengths(lengths, config)
        mask = mask_from_lengths(out_lengths, features.shape[1])
    return encoder(model, hidden, mask, config)

