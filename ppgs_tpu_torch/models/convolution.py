"""Convolutional baseline model (PyTorch).

Counterpart of ``ppgs_tpu/models/convolution.py`` (reference:
ppgs/model/convolution.py:13-29): three 'same'-padded k = 5 convs in fp32
with ReLU between them, on (B, C, T). It has no kernel of its own: cuDNN's
fp32 convs run it on the card, with TF32 off (``devices.resolve``).
``convert.convolution_params_from_jax`` maps a JAX parameter file onto its
state.
"""

import math

import torch
from torch import nn

from ..config import Config
from .transformer import conv1d_same


class Convolution(nn.Module):
    """The convolution model for one config; ``forward`` is the
    module-level function of the same name."""

    def __init__(self, config: Config):
        super().__init__()
        self.config = config
        k = config.kernel_size
        c_in, c, c_out = (config.input_channels, config.hidden_channels,
                          config.output_channels)
        self.conv1 = nn.Conv1d(c_in, c, k)
        self.conv2 = nn.Conv1d(c, c, k)
        self.conv3 = nn.Conv1d(c, c_out, k)

    def forward(self, features, lengths=None, train=False, seed=None):
        return forward(self, features, lengths, train, seed)


def init(config: Config, generator=None):
    """Random parameters in the JAX package's layout (a nested dict of
    numpy arrays, as ``ppgs_tpu.models.convolution.init`` returns): each
    conv kaiming-uniform, weight (K, I, O) and bias within 1 / sqrt(I K),
    as JAX's ``_conv_init`` draws them, from ``generator``; the numbers
    are not JAX's."""
    k = config.kernel_size

    def conv(c_in, c_out):
        bound = 1.0 / math.sqrt(c_in * k)

        def uniform(shape):
            u = torch.rand(shape, generator=generator, dtype=torch.float64)
            return ((2 * u - 1) * bound).float().numpy()

        return {'weight': uniform((k, c_in, c_out)),
                'bias': uniform((c_out,))}

    c_in, c, c_out = (config.input_channels, config.hidden_channels,
                      config.output_channels)
    return {'conv1': conv(c_in, c), 'conv2': conv(c, c),
            'conv3': conv(c, c_out)}


def forward(model, features, lengths=None, train=False, seed=None):
    """(B, C, T) features -> (B, output_channels, T) logits, in fp32.
    ``lengths``, ``train`` and ``seed`` are unused, as in the reference (the
    model has no dropout)."""
    del lengths, train, seed
    x = features.float()
    x = torch.relu(conv1d_same(x, model.conv1.weight, model.conv1.bias))
    x = torch.relu(conv1d_same(x, model.conv2.weight, model.conv2.bias))
    return conv1d_same(x, model.conv3.weight, model.conv3.bias)
