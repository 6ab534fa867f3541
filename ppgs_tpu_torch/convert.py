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
    ``prepared`` weights: non-persistent buffers in the config's compute
    dtype, which move with the model and are never saved. ``load.model``
    calls this once, before moving the model to its device; call it again
    after changing the parameters.

    - ``wqkv``, ``bqkv``, ``wo``, ``bo``, ``w1``, ``b1``, ``w2``, ``b2``: the
      per-layer path's operands, the JAX package's casts to the compute
      dtype;
    - ``wqkv_folded`` (compute dtype) and ``bqkv_folded`` (fp32): the fused
      QKV with the softmax scale times log2(e) folded into its q third, in
      fp32 before the cast, as the TPU ``encoder_stack`` does
      (``ppgs_tpu/ops/encoder_layer_kernel.py:305-318``).

    The stack's fp32 vectors (its biases and the LayerNorms) are the
    parameters themselves."""
    cd = getattr(torch, model.config.compute_dtype)
    heads = model.config.attention_heads
    for layer in model.layers:
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
