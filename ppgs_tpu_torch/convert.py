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
whose grouped positional conv (k, C/G, C) becomes torch's (C, C/G, k).
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
