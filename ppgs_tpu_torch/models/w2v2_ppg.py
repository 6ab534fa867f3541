"""wav2vec2-based PPG models (PyTorch).

Counterpart of ``ppgs_tpu/models/w2v2_ppg.py``:

- W2V2 (``'Wav2Vec2.0'``, reference ppgs/model/w2v2.py): facebook/
  wav2vec2-base with the final conv stride 2 -> 1 (100 Hz latents), the
  feature encoder frozen, and a Conv1d(768 -> 40, k = 5) head.
  Representation: raw audio ('wav').
- W2V2FC (reference ppgs/model/w2v2fc.py): the Charsiu
  'charsiu/en_w2v2_fc_10ms' frame classifier, the same 100 Hz trunk and a
  linear head over 42 tokens; <unk> and <pad> dropped and the other 40
  permuted into the package's phoneme order.

Both take (B, 1, S) audio and valid sample counts and return (B, 40, T)
logits at 100 Hz. Parameters live in ``nn.Module``s: ``w2v2`` the trunk
(``models.w2v2.Wav2Vec2``), ``head`` the conv (torch's (O, I, K)) or the
linear head (the JAX package's (C, 42) ``x @ W``);
``convert.w2v2_ppg_params_from_jax`` maps the JAX package's npz onto them.
A module runs once ``convert.prepare_w2v2`` has prepared its trunk
(``load.model`` does).
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..phonemes import CHARSIU_PERMUTE
from . import w2v2
from .transformer import conv1d_same

# pad = window//2 - hop//2 (reference w2v2.py:19)
PADDING = 400 // 2 - 160 // 2


def w2v2_100hz_config(compute_dtype='float32'):
    """wav2vec2-base (``w2v2.BASE``, read when called) with the final conv
    stride 1: 100 Hz latents."""
    return dataclasses.replace(w2v2.BASE.with_final_stride(1),
                               compute_dtype=compute_dtype)


def _mask_config(config100):
    """The original stride-2 config used for the mask-length formula (a
    transformers artifact the reference W2V2 model is trained with): its
    key mask covers about the first half of the 100 Hz frames."""
    return dataclasses.replace(
        config100, conv_stride=config100.conv_stride[:-1] + (2,))


###############################################################################
# Modules
###############################################################################


class W2V2(nn.Module):
    """The W2V2 end-to-end model for one config; ``forward`` is the
    module-level function of the same name."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        wcfg = w2v2_100hz_config(config.compute_dtype)
        self.w2v2 = w2v2.Wav2Vec2(wcfg)
        # freeze_feature_extractor (ppgs/model/w2v2.py:29)
        self.w2v2.feature_encoder.requires_grad_(False)
        self.head = nn.Conv1d(wcfg.hidden_size, config.output_channels,
                              config.kernel_size)

    def forward(self, features, lengths, train=False, seed=None):
        return forward(self, features, lengths, train, seed)


class W2V2FC(nn.Module):
    """The Charsiu frame classifier for one config; ``forward`` is
    ``fc_forward``."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        wcfg = w2v2_100hz_config(config.compute_dtype)
        self.w2v2 = w2v2.Wav2Vec2(wcfg)
        self.w2v2.feature_encoder.requires_grad_(False)
        self.head = w2v2._Weight(wcfg.hidden_size, 42, bias=42)

    def forward(self, features, lengths, train=False, seed=None):
        return fc_forward(self, features, lengths, train, seed)


###############################################################################
# Initialization (production weights come from conversion)
###############################################################################


def init(config: Config, generator=None):
    """Random W2V2 parameters in the JAX package's layout: the 100 Hz
    trunk's ``w2v2.init`` and a kaiming-uniform conv head (K, C, 40), drawn
    from ``generator``; the numbers are not JAX's."""
    wcfg = w2v2_100hz_config()
    k, c, out = config.kernel_size, wcfg.hidden_size, config.output_channels
    bound = 1.0 / math.sqrt(c * k)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, dtype=torch.float64)
        return ((2 * u - 1) * bound).float().numpy()

    return {'w2v2': w2v2.init(wcfg, generator),
            'head': {'weight': uniform(k, c, out), 'bias': uniform(out)}}


def fc_init(config: Config, generator=None):
    """Random W2V2FC parameters in the JAX package's layout: the 100 Hz
    trunk and a (C, 42) head uniform within 1 / sqrt(C), zero bias."""
    del config
    wcfg = w2v2_100hz_config()
    c = wcfg.hidden_size
    u = torch.rand((c, 42), generator=generator, dtype=torch.float64)
    return {'w2v2': w2v2.init(wcfg, generator),
            'head': {'weight': ((2 * u - 1) / math.sqrt(c)).float().numpy(),
                     'bias': np.zeros(42, np.float32)}}


###############################################################################
# Forward passes
###############################################################################


def _padded_audio(features, lengths):
    """(B, 1, S) audio -> (B, S + 2 PADDING), and the sample counts of the
    reference's mask (arange(S + 2 pad) - 2 pad < lengths, shifted)."""
    if features.dim() != 3 or features.shape[1] != 1:
        # jnp.squeeze(axis=1)'s refusal, which the JAX package raises when
        # infer hands these models a frontend's (B, C, T) features
        raise ValueError(
            f'cannot select an axis to squeeze out which has size not equal '
            f'to one, got shape={tuple(features.shape)} and dimensions=(1,)')
    audio = F.pad(features.float(), (PADDING, PADDING))[:, 0]
    return audio, torch.as_tensor(lengths, device=audio.device) + 2 * PADDING


def forward(model, features, lengths, train=False, seed=None):
    """(B, 1, S) raw audio + sample lengths -> (B, 40, T) logits at 100 Hz.

    The trunk's key mask comes from the stride-2 config (``_mask_config``),
    as the reference's trained model has it. ``train`` with a ``seed``:
    the trunk's train mode (dropout, spec-augment, LayerDrop); the feature
    encoder stays frozen."""
    wcfg = model.w2v2.config
    audio, sample_lengths = _padded_audio(features, lengths)
    hidden = w2v2.forward(model.w2v2, audio, sample_lengths, wcfg,
                          mask_config=_mask_config(wcfg), train=train,
                          seed=seed)                       # (B, T', C)
    return conv1d_same(hidden.transpose(1, 2), model.head.weight,
                       model.head.bias)


def fc_forward(model, features, lengths, train=False, seed=None):
    """(B, 1, S) audio -> (B, 40, T) Charsiu logits permuted to the
    package's order. The trunk runs without its train mode, as in the JAX
    package (which drops ``train`` and ``rng``)."""
    del train, seed
    wcfg = model.w2v2.config
    audio, sample_lengths = _padded_audio(features, lengths)
    hidden = w2v2.forward(model.w2v2, audio, sample_lengths, wcfg)
    logits = hidden.float() @ model.head.weight + model.head.bias
    # Drop <unk>/<pad>, permute into the package's phoneme order
    permute = torch.as_tensor(CHARSIU_PERMUTE, device=logits.device)
    return logits[..., :-2][..., permute].transpose(1, 2)
