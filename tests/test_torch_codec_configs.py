"""The codebook configs (encodec, dac) on the port: their features are int
codes that the JAX package dequantizes to latents before the model
(ppgs_tpu/core.py:108-114). That frontend is not ported yet, so inference,
training and evaluation refuse such a config (NotImplementedError naming
ROADMAP.md A12) instead of feeding the codes to the input conv."""

import numpy as np
import pytest
import torch

import ppgs_tpu
import ppgs_tpu_torch as port
from ppgs_tpu_torch import core as port_core
from ppgs_tpu_torch.models import transformer as port_transformer
from ppgs_tpu_torch.train import core as train_core

CODECS = ('encodec', 'dac')


def _codes(config, frames=20):
    rng = np.random.default_rng(0)
    return rng.integers(0, 1024, (1, config.input_channels, frames))


@pytest.mark.parametrize('name', CODECS)
def test_configs_name_their_frontend_as_the_jax_package_does(name):
    assert port.config.get(name).frontend == name
    assert ppgs_tpu.config.get(name).frontend == name


@pytest.mark.parametrize('name', CODECS)
def test_infer_refuses_a_codebook_config(name, tmp_path):
    config = port.config.get(name)
    head = tmp_path / 'head.npz'
    port.load.save_params(head, port_transformer.init(
        config, torch.Generator().manual_seed(1)))
    with pytest.raises(NotImplementedError, match='A12'):
        port_core.infer(_codes(config), np.array([20]),
                        representation=config.representation,
                        checkpoint=head, config=config, device='cpu')


@pytest.mark.parametrize('name', CODECS)
def test_train_refuses_a_codebook_config(name, tmp_path):
    config = port.config.get(name)
    batch = (_codes(config), np.zeros((1, 20), np.int64), np.array([20]))
    with pytest.raises(NotImplementedError, match='A12'):
        train_core.train(directory=tmp_path, config=config, max_steps=1,
                         loader_fn=lambda partition: iter([batch]),
                         device='cpu')
    assert not any(tmp_path.iterdir())      # no step, no checkpoint


@pytest.mark.parametrize('name', CODECS)
def test_evaluate_partition_refuses_a_codebook_config(name):
    config = port.config.get(name)
    model = train_core.init_model(config, torch.device('cpu'))
    batch = (_codes(config), np.zeros((1, 20), np.int64), np.array([20]))
    with pytest.raises(NotImplementedError, match='A12'):
        train_core.evaluate_partition(None, 0, model, config,
                                      lambda partition: iter([batch]),
                                      'valid')
