"""The codebook configs (encodec, dac) on the port: their features are int
codes that a codebook frontend dequantizes to latents before the model, as
in the JAX package (ppgs_tpu/core.py:108-114). Inference, training and
evaluation under these configs are held against the JAX package in
tests/test_torch_frontend.py."""

import pytest

import torch_threads  # noqa: F401  (cores shared among xdist workers)

import ppgs_tpu
import ppgs_tpu_torch as port

CODECS = ('encodec', 'dac')


@pytest.mark.parametrize('name', CODECS)
def test_configs_name_their_frontend_as_the_jax_package_does(name):
    assert port.config.get(name).frontend == name
    assert ppgs_tpu.config.get(name).frontend == name
