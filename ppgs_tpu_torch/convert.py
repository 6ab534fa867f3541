"""JAX parameter files -> the port's module state, in one place.

The JAX package stores a flat npz (``ppgs_tpu/load.py:34-73``) with keys
such as ``layers.0.attn.wq``: matrices in ``x @ W`` orientation and conv
weights as (K, I, O). The port keeps the ``x @ W`` orientation; the only
relayouts are here:

- ``attn.wq/wk/wv`` (C, C) and ``bq/bk/bv`` (C,) fuse into
  ``attn.wqkv`` (C, 3C) and ``attn.bqkv`` (3C,);
- conv weights (K, I, O) transpose to torch's (O, I, K);
- ``prepare`` derives, once per loaded model, the compute-dtype copies the
  encoder's products read, with the softmax scale folded in for the stack.

The same holds for the wav2vec2 trunk (``w2v2_params_from_jax``,
``prepare_w2v2``), whose encoder layers have the transformer's layout and
whose grouped positional conv (k, C/G, C) becomes torch's (C, C/G, k), and
for the conformer (``conformer_params_from_jax``, ``prepare_conformer``),
whose module keeps the JAX layout; ``conformer_params_from_state_dict``
converts the reference's ESPnet checkpoint to that layout without JAX.
The reference's own ``.pt`` checkpoints of the transformer and the
convolution model map to the JAX layout here too
(``transformer_params_from_state_dict``,
``convolution_params_from_state_dict``), and the convolution model's npz
onto its module (``convolution_params_from_jax``).
"""

import math

import numpy as np
import torch

from .models.transformer import Prepared
from .ops.flash_attention import LOG2E

_CONVS = ('input_conv', 'output_conv')
_LAYER_COPIES = ('attn.wo', 'attn.bo', 'norm1.scale', 'norm1.bias',
                 'ffn.w1', 'ffn.b1', 'ffn.w2', 'ffn.b2',
                 'norm2.scale', 'norm2.bias')


def _tensor(array):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(array)))


def params_from_jax(flat):
    """Map a flat JAX transformer parameter dict (numpy arrays) onto the
    state dict of ``models.transformer.Transformer``. Every leaf must be
    used: a leftover key raises, so nothing is silently dropped."""
    flat = dict(flat)
    state = {}
    for conv in _CONVS:
        weight = np.asarray(flat.pop(f'{conv}.weight'))
        state[f'{conv}.weight'] = _tensor(weight.transpose(2, 1, 0))
        state[f'{conv}.bias'] = _tensor(flat.pop(f'{conv}.bias'))
    num_layers = len({key.split('.')[1] for key in flat
                      if key.startswith('layers.')})
    for i in range(num_layers):
        p = f'layers.{i}.'
        state[p + 'attn.wqkv'] = _tensor(np.concatenate(
            [flat.pop(p + f'attn.w{n}') for n in 'qkv'], axis=1))
        state[p + 'attn.bqkv'] = _tensor(np.concatenate(
            [flat.pop(p + f'attn.b{n}') for n in 'qkv']))
        for name in _LAYER_COPIES:
            state[p + name] = _tensor(flat.pop(p + name))
    if flat:
        raise ValueError(f'Unmapped JAX parameters: {sorted(flat)}')
    return state


def convolution_params_from_jax(flat):
    """Map a flat JAX convolution-model parameter dict (``conv1``,
    ``conv2``, ``conv3``, each (K, I, O) with its bias) onto the state dict
    of ``models.convolution.Convolution``: the weights to torch's (O, I,
    K). ``load_state_dict(strict=True)`` refuses a leftover or missing
    key."""
    return {key: _tensor(np.asarray(value).transpose(2, 1, 0)
                         if key.endswith('.weight') else value)
            for key, value in flat.items()}


@torch.no_grad()
def prepare(model):
    """Give each encoder layer of a ``models.transformer.Transformer`` its
    ``prepared`` weights (``prepare_layers``) for the config's compute
    dtype. ``load.model`` calls this once, before moving the model to its
    device; call it again after changing the parameters."""
    prepare_layers(model.layers, model.config.attention_heads,
                   getattr(torch, model.config.compute_dtype))


@torch.no_grad()
def prepare_layers(layers, heads, cd):
    """Give each encoder layer (``models.transformer.EncoderLayer``) its
    ``prepared`` weights: non-persistent buffers in the compute dtype
    ``cd``, which move with the model and are never saved.

    - ``wqkv``, ``bqkv``, ``wo``, ``bo``, ``w1``, ``b1``, ``w2``, ``b2``: the
      per-layer path's operands, the JAX package's casts to the compute
      dtype;
    - ``wqkv_folded`` (compute dtype) and ``bqkv_folded`` (fp32): the fused
      QKV with the softmax scale times log2(e) folded into its q third, in
      fp32 before the cast, as the TPU ``encoder_stack`` does
      (``ppgs_tpu/ops/encoder_layer_kernel.py:305-318``).

    The stack's fp32 vectors (its biases and the LayerNorms) are the
    parameters themselves."""
    for layer in layers:
        attn, ffn = layer.attn, layer.ffn
        C = attn.wo.shape[0]
        fold = torch.ones(3 * C, device=attn.wqkv.device)
        fold[:C] = LOG2E / math.sqrt(C // heads)
        tensors = {name: t.detach().to(cd).contiguous() for name, t in (
            ('wqkv', attn.wqkv), ('bqkv', attn.bqkv), ('wo', attn.wo),
            ('bo', attn.bo), ('w1', ffn.w1), ('b1', ffn.b1), ('w2', ffn.w2),
            ('b2', ffn.b2))}
        tensors['wqkv_folded'] = (attn.wqkv * fold).to(cd).contiguous()
        tensors['bqkv_folded'] = (attn.bqkv * fold).float().contiguous()
        layer.prepared = Prepared(tensors)


def w2v2_params_from_jax(flat):
    """Map a flat JAX wav2vec2 parameter dict (``ppgs_tpu/models/w2v2.py``
    ``init``'s pytree, flattened as ``load.flatten_params`` does) onto the
    state dict of ``models.w2v2.Wav2Vec2``: the feature convs' (K, I, O)
    and the positional conv's (k, C/G, C) to torch's (O, I, K), and each
    encoder layer's q, k and v fused as the transformer's are. Every leaf
    is used: ``load_state_dict(strict=True)`` refuses a leftover."""
    flat = dict(flat)
    state = {}
    layers = sorted({int(key.split('.')[2]) for key in flat
                     if key.startswith('encoder.layers.')})
    for i in layers:
        p = f'encoder.layers.{i}.'
        state[p + 'attn.wqkv'] = _tensor(np.concatenate(
            [flat.pop(p + f'attn.w{n}') for n in 'qkv'], axis=1))
        state[p + 'attn.bqkv'] = _tensor(np.concatenate(
            [flat.pop(p + f'attn.b{n}') for n in 'qkv']))
    for key, value in flat.items():
        value = np.asarray(value)
        if key.endswith('conv.weight'):
            value = value.transpose(2, 1, 0)
        state[key] = _tensor(value)
    return state


@torch.no_grad()
def prepare_w2v2(model):
    """The compute-dtype copies a ``models.w2v2.Wav2Vec2`` reads, for its
    config's compute dtype: each encoder layer's ``prepared`` weights
    (``prepare_layers``), and the feature convs as the conv-stack kernels
    take them (``feature_prepared``: conv 0 as (k0, C), the later convs as
    (k * C_in, C_out), the JAX (k, C_in, C_out) weight flattened)."""
    config = model.config
    cd = getattr(torch, config.compute_dtype)
    prepare_layers(model.encoder.layers, config.num_heads, cd)
    taps = {}
    for i, layer in enumerate(model.feature_encoder):
        weight = layer.conv.weight.detach().permute(2, 1, 0)     # (k, I, O)
        taps[f'w{i}'] = weight.reshape(-1, weight.shape[-1]).to(
            cd).contiguous()
    model.feature_prepared = Prepared(taps)


def conformer_params_from_jax(flat):
    """Map a flat JAX conformer parameter dict (``ppgs_tpu/models/
    conformer.py`` ``init``'s pytree, flattened as ``load.flatten_params``
    does) onto the state dict of ``models.conformer.Conformer``: the module
    keeps the JAX names and layouts, so each key maps to itself.
    ``load_state_dict(strict=True)`` refuses a leftover or missing key."""
    return {key: _tensor(value) for key, value in flat.items()}


@torch.no_grad()
def prepare_conformer(model):
    """The compute-dtype copies a ``models.conformer.Conformer`` reads, for
    its config's compute dtype, as non-persistent buffers (``prepared``):
    the 5x5 conv weights as torch's (O, I, KH, KW), the d -> d one
    channels-last; each block's fused QKV (d, 3d) and bias, the position
    projection and biases, the out-projection, both FFNs, the pointwise
    convs as (d, 2d) and (d, d) matrices and the depthwise conv as (d, 1,
    k). The fp32 biases and norms of the conv module are the parameters
    themselves."""
    from torch import nn

    cd = getattr(torch, model.config.compute_dtype)

    def cast(t):
        return t.detach().to(cd).contiguous()

    embed = model.embed
    model.prepared = Prepared({
        'conv1': cast(embed.conv1.weight.permute(3, 2, 0, 1)),
        'conv2': embed.conv2.weight.detach().permute(3, 2, 0, 1).to(cd)
        .contiguous(memory_format=torch.channels_last),
        'out': cast(embed.out.weight), 'out_bias': cast(embed.out.bias)})
    for block in model.blocks:
        attn, conv = block.attn, block.conv
        prepared = nn.Module()
        prepared.attn = Prepared({
            'wqkv': cast(torch.cat([attn.q.weight, attn.k.weight,
                                    attn.v.weight], dim=1)),
            'bqkv': cast(torch.cat([attn.q.bias, attn.k.bias, attn.v.bias])),
            'wpos': cast(attn.pos.weight),
            'pos_bias_u': cast(attn.pos_bias_u),
            'pos_bias_v': cast(attn.pos_bias_v),
            'wo': cast(attn.out.weight), 'bo': cast(attn.out.bias)})
        for name in ('ff_macaron', 'ff'):
            ffn = getattr(block, name)
            setattr(prepared, name, Prepared({
                'w1': cast(ffn.w1.weight), 'b1': cast(ffn.w1.bias),
                'w2': cast(ffn.w2.weight), 'b2': cast(ffn.w2.bias)}))
        prepared.conv = Prepared({
            'pw1': cast(conv.pointwise1.weight[0]),
            'dw': cast(conv.depthwise.weight.permute(2, 1, 0)),
            'pw2': cast(conv.pointwise2.weight[0])})
        block.prepared = prepared


###############################################################################
# The reference's ESPnet checkpoint -> the JAX layout (a numpy copy of
# ppgs_tpu/convert/conformer_weights.py)
###############################################################################


def _esp_linear(sd, prefix, bias=True):
    p = {'weight': sd[f'{prefix}.weight'].T}
    if bias:
        p['bias'] = sd[f'{prefix}.bias']
    return p


def _esp_norm(sd, prefix):
    return {'scale': sd[f'{prefix}.weight'], 'bias': sd[f'{prefix}.bias']}


def conformer_params_from_state_dict(sd, num_blocks=16):
    """Map an ESPnet ConformerEncoder state dict of numpy arrays (no
    'encoder.' prefix; the published ``24epoch.pth``, reference
    build_ppg_model.py:69-85) onto the JAX package's conformer pytree:
    Conv2d (O, I, KH, KW) -> (KH, KW, I, O), Conv1d (O, I, K) -> (K, I, O),
    Linear (out, in) -> (in, out), BatchNorm statistics as they are. Save it
    with ``load.save_params`` for ``preprocess.bottleneck``."""
    def conv1d(prefix):
        return {'weight': np.transpose(sd[f'{prefix}.weight'], (2, 1, 0)),
                'bias': sd[f'{prefix}.bias']}

    params = {
        'embed': {
            'conv1': {'weight': np.transpose(sd['embed.conv.0.weight'],
                                             (2, 3, 1, 0)),
                      'bias': sd['embed.conv.0.bias']},
            'conv2': {'weight': np.transpose(sd['embed.conv.2.weight'],
                                             (2, 3, 1, 0)),
                      'bias': sd['embed.conv.2.bias']},
            'out': _esp_linear(sd, 'embed.out.0'),
        },
        'after_norm': _esp_norm(sd, 'after_norm'),
        'blocks': [],
    }
    for i in range(num_blocks):
        p = f'encoders.{i}'
        cm = f'{p}.conv_module'
        params['blocks'].append({
            'ff_macaron': {
                'w1': _esp_linear(sd, f'{p}.feed_forward_macaron.w_1'),
                'w2': _esp_linear(sd, f'{p}.feed_forward_macaron.w_2')},
            'norm_ff_macaron': _esp_norm(sd, f'{p}.norm_ff_macaron'),
            'attn': {
                'q': _esp_linear(sd, f'{p}.self_attn.linear_q'),
                'k': _esp_linear(sd, f'{p}.self_attn.linear_k'),
                'v': _esp_linear(sd, f'{p}.self_attn.linear_v'),
                'out': _esp_linear(sd, f'{p}.self_attn.linear_out'),
                'pos': _esp_linear(sd, f'{p}.self_attn.linear_pos',
                                   bias=False),
                'pos_bias_u': sd[f'{p}.self_attn.pos_bias_u'],
                'pos_bias_v': sd[f'{p}.self_attn.pos_bias_v']},
            'norm_mha': _esp_norm(sd, f'{p}.norm_mha'),
            'conv': {
                'pointwise1': conv1d(f'{cm}.pointwise_conv1'),
                'depthwise': conv1d(f'{cm}.depthwise_conv'),
                'batch_norm': {'scale': sd[f'{cm}.norm.weight'],
                               'bias': sd[f'{cm}.norm.bias'],
                               'mean': sd[f'{cm}.norm.running_mean'],
                               'var': sd[f'{cm}.norm.running_var']},
                'pointwise2': conv1d(f'{cm}.pointwise_conv2')},
            'norm_conv': _esp_norm(sd, f'{p}.norm_conv'),
            'ff': {'w1': _esp_linear(sd, f'{p}.feed_forward.w_1'),
                   'w2': _esp_linear(sd, f'{p}.feed_forward.w_2')},
            'norm_ff': _esp_norm(sd, f'{p}.norm_ff'),
            'norm_final': _esp_norm(sd, f'{p}.norm_final'),
        })
    return params


def conformer_params_from_checkpoint(path, num_blocks=16):
    """Read a ``24epoch.pth``-style checkpoint (keys prefixed 'encoder.')
    into the JAX package's conformer pytree. The file is unpickled with
    ``weights_only``: one that holds anything but tensors and plain
    containers is refused."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = {k.removeprefix('encoder.'): v.numpy()
          for k, v in ckpt.items() if k.startswith('encoder.')}
    return conformer_params_from_state_dict(sd, num_blocks)


def params_to_jax(state):
    """The inverse of ``params_from_jax``: a Transformer state dict (or any
    dict of tensors with its keys, such as Adam's moments) -> the JAX
    package's flat {key: numpy array}."""
    flat = {}
    for key, value in state.items():
        array = value.detach().cpu().numpy()
        conv = key.split('.')[0]
        if conv in _CONVS and key.endswith('.weight'):
            array = array.transpose(2, 1, 0)
        if key.endswith(('attn.wqkv', 'attn.bqkv')):
            # 'layers.i.attn.' and 'w' or 'b'
            prefix, kind = key[:-4], key[-4]
            for name, part in zip('qkv', np.split(array, 3, axis=-1)):
                flat[f'{prefix}{kind}{name}'] = np.ascontiguousarray(part)
            continue
        flat[key] = np.ascontiguousarray(array)
    return flat


def adam_state_to_jax(model, optimizer):
    """A ``torch.optim.Adam``'s state for ``model`` -> the JAX package's
    optax adam state as flat arrays: {'count': int32, 'mu': flat,
    'nu': flat}, with the fused-QKV moments split as the parameters are.
    A parameter without state yet (no step taken) has zero moments."""
    mu, nu, count = {}, {}, 0
    for name, param in model.named_parameters():
        state = optimizer.state.get(param, {})
        if state:
            count = int(state['step'])
        mu[name] = state.get('exp_avg', torch.zeros_like(param))
        nu[name] = state.get('exp_avg_sq', torch.zeros_like(param))
    return {'count': np.asarray(count, np.int32), 'mu': params_to_jax(mu),
            'nu': params_to_jax(nu)}


def adam_state_from_jax(model, optimizer, count, mu, nu):
    """Load an optax adam state (count, and mu and nu as flat JAX-layout
    dicts) into ``optimizer``, a ``torch.optim.Adam`` over
    ``model.parameters()``: optax's count is Adam's step, mu and nu its
    exp_avg and exp_avg_sq (the two updates are the same function)."""
    mu, nu = params_from_jax(mu), params_from_jax(nu)
    for name, param in model.named_parameters():
        optimizer.state[param] = {
            'step': torch.tensor(float(count)),
            'exp_avg': mu[name].to(param.device, param.dtype).clone(),
            'exp_avg_sq': nu[name].to(param.device, param.dtype).clone(),
        }


###############################################################################
# The reference's .pt checkpoints -> the JAX layout (a numpy copy of
# ppgs_tpu/convert/torch_weights.py)
###############################################################################


def load_torch_checkpoint(path):
    """A reference ``.pt`` checkpoint as a flat {name: numpy array}, its
    state dict taken from under 'model' when it is nested there. The file
    is unpickled with ``weights_only``: one that holds anything but
    tensors and plain containers is refused."""
    state_dict = torch.load(path, map_location='cpu', weights_only=True)
    if 'model' in state_dict:
        state_dict = state_dict['model']
    return {k: v.detach().cpu().numpy() for k, v in state_dict.items()}


def _reference_conv(sd, prefix):
    return {'weight': np.transpose(sd[f'{prefix}.weight'], (2, 1, 0)),
            'bias': sd[f'{prefix}.bias']}


def transformer_params_from_state_dict(sd, num_layers=5):
    """Map the reference Transformer's state dict (numpy arrays) onto the
    JAX package's pytree: Conv1d (O, I, K) -> (K, I, O), the packed
    in-projection (3C, C) -> wq, wk, wv each (C, C) transposed, Linear
    (out, in) -> (in, out)."""
    params = {'input_conv': _reference_conv(sd, 'input_layer'),
              'output_conv': _reference_conv(sd, 'output_layer'),
              'layers': []}
    for i in range(num_layers):
        p = f'model.layers.{i}'
        in_w = sd[f'{p}.self_attn.in_proj_weight']
        in_b = sd[f'{p}.self_attn.in_proj_bias']
        d = in_w.shape[1]
        wq, wk, wv = in_w[:d], in_w[d:2 * d], in_w[2 * d:]
        bq, bk, bv = in_b[:d], in_b[d:2 * d], in_b[2 * d:]
        params['layers'].append({
            'attn': {'wq': wq.T, 'wk': wk.T, 'wv': wv.T,
                     'wo': sd[f'{p}.self_attn.out_proj.weight'].T,
                     'bq': bq, 'bk': bk, 'bv': bv,
                     'bo': sd[f'{p}.self_attn.out_proj.bias']},
            'norm1': {'scale': sd[f'{p}.norm1.weight'],
                      'bias': sd[f'{p}.norm1.bias']},
            'norm2': {'scale': sd[f'{p}.norm2.weight'],
                      'bias': sd[f'{p}.norm2.bias']},
            'ffn': {'w1': sd[f'{p}.linear1.weight'].T,
                    'b1': sd[f'{p}.linear1.bias'],
                    'w2': sd[f'{p}.linear2.weight'].T,
                    'b2': sd[f'{p}.linear2.bias']},
        })
    return params


def convolution_params_from_state_dict(sd):
    """Map the reference Convolution model's state dict (an
    ``nn.Sequential`` whose convs are entries 0, 2 and 4) onto the JAX
    package's pytree."""
    return {'conv1': _reference_conv(sd, '0'),
            'conv2': _reference_conv(sd, '2'),
            'conv3': _reference_conv(sd, '4')}
