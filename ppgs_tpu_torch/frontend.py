"""Codebook frontends: the dequantization of cached codec codes at train
and inference time (reference: config/encodec.py:8-22, config/dac.py:18-30,
consumed at ppgs/train/core.py:115-119 and ppgs/core.py:105-115); the
counterpart of ``ppgs_tpu/frontend.py``.

The encodec and dac representations cache int codes (B, Q, T). A config
with ``frontend`` set turns them into the model's input latents through a
codebook table (Q, V, D) read from an npz asset:

- encodec (sum):    out[b, :, t] = sum_q    codebook[q, codes[b, q, t], :]
  (EnCodec's RVQ decode: the residual levels add; 128-d latents)
- dac (concat):     out[b, :, t] = concat_q codebook[q, codes[b, q, t], :]
  (DAC's ``quantizer.from_codes`` latents: 8-d codes a level concatenated
  to 96-d, the config's input channels)

The gather is plain PyTorch indexing: the JAX package computes it in XLA,
with no Pallas kernel. It walks the levels one at a time, so that the
(B, Q, T, D) gather is never held (0.84 GB in fp32 at encodec's 32 levels
for 64 x 800 frames). The codebook assets are made once by
scripts/convert_codebooks.py (which needs the codec packages and the
network); tests register seeded codebooks with ``register`` or point
``CODEBOOK_DIR`` at their own npz files.
"""

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import config as config_mod

# Frontend name -> (codebooks (Q, V, D) on the host, mode), filled from the
# npz assets at first use; tests may register directly
_REGISTRY = {}
# Frontend name -> its closure, which keeps the codebooks it moved to a
# device; dropped when the name is registered anew
_FRONTENDS = {}

CODEBOOK_DIR = config_mod.ASSETS_DIR / 'codebooks'

# How each known frontend merges its quantizer levels
_MODES = {'encodec': 'sum', 'dac': 'concat'}


def register(name: str, codebooks, mode: str):
    """Register a codebook set (Q, V, D) for ``name`` ('sum' or 'concat');
    it is kept on the host."""
    if mode not in ('sum', 'concat'):
        raise ValueError(f"mode must be 'sum' or 'concat', got {mode!r}")
    _REGISTRY[name] = (torch.as_tensor(codebooks).detach().cpu(), mode)
    _FRONTENDS.pop(name, None)


def unregister(name: str):
    _REGISTRY.pop(name, None)
    _FRONTENDS.pop(name, None)


def _load(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    path = Path(CODEBOOK_DIR) / f'{name}.npz'
    if not path.exists():
        raise FileNotFoundError(
            f'Codebook asset for frontend {name!r} not found at {path}. '
            f'Convert it once with scripts/convert_codebooks.py '
            f'(requires the codec package + network).')
    with np.load(path) as data:
        mode = (str(data['mode']) if 'mode' in data
                else _MODES.get(name, 'sum'))
        register(name, np.asarray(data['codebooks']), mode)
    return _REGISTRY[name]


def decode_codes(codes, codebooks, mode: str = 'sum'):
    """Dequantize int codes (B, Q, T) or (Q, T) through codebooks (Q, V, D).

    Returns float32 (B, D, T) for mode='sum' or (B, Q * D, T), level-major,
    for mode='concat' (without the batch axis for (Q, T) codes), on the
    codes' device. Float codes (the collate path's padded buffers) are cast
    to int first, and a code outside [0, V) takes the nearest row, as XLA's
    gather clamps it."""
    codes = torch.as_tensor(codes)
    if codes.is_floating_point():
        codes = codes.to(torch.int32)
    squeeze = codes.ndim == 2
    if squeeze:                       # (Q, T): one utterance
        codes = codes[None]
    B, Q, T = codes.shape
    if Q > codebooks.shape[0]:
        raise ValueError(
            f'{Q} quantizer levels in codes but only {codebooks.shape[0]} '
            f'codebooks')
    codebooks = torch.as_tensor(codebooks).to(codes.device, torch.float32)
    V, D = codebooks.shape[1:]
    codes = codes.long().clamp(0, V - 1)
    if mode == 'sum':
        out = torch.zeros(B, T, D, device=codes.device)
        for q in range(Q):
            out += F.embedding(codes[:, q], codebooks[q])
        out = out.transpose(1, 2).contiguous()            # (B, D, T)
    else:
        out = torch.empty(B, Q * D, T, device=codes.device)
        for q in range(Q):
            out[:, q * D:(q + 1) * D] = F.embedding(
                codes[:, q], codebooks[q]).transpose(1, 2)
    return out[0] if squeeze else out


def make_frontend(name: str):
    """The FRONTEND closure of a codebook representation, int codes (B, Q,
    T) -> float32 latents (B, C, T) on the codes' device (the reference's
    ``FRONTEND(device)`` factory, config/encodec.py:8-22). The codebooks
    move to a device once, at their first use there: the closure is kept
    until ``name`` is registered anew."""
    if name in _FRONTENDS:
        return _FRONTENDS[name]
    codebooks, mode = _load(name)
    placed = {}

    def frontend(codes):
        codes = torch.as_tensor(codes)
        if codes.device not in placed:
            placed[codes.device] = codebooks.to(codes.device, torch.float32)
        return decode_codes(codes, placed[codes.device], mode)

    frontend.codebooks = codebooks
    frontend.mode = mode
    _FRONTENDS[name] = frontend
    return frontend


def maybe_frontend(config) -> Optional[object]:
    """The config's FRONTEND closure, or None (reference
    train/core.py:35-39)."""
    config = config_mod.get(config)
    if config.frontend is None:
        return None
    return make_frontend(config.frontend)
