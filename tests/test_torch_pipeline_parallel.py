"""The port's pipeline parallelism on the CPU (gloo): the GPipe schedule
over 2 stages (4 layers, tests/test_pipeline.py's CONFIG), its gradients
through the ring, DP x PP and TP x PP on 4 ranks, the divisibility errors
of ``ppgs_tpu/parallel/pipeline.py:102-121``, and dropout by its
statistics, held against the port's sequential forward.

Tolerances: 1e-4 relative with 1e-5 absolute on the logits and on every
gradient (tests/test_pipeline.py's envelope): the stages run the
sequential per-layer path on microbatches, whose products sum in another
order than the whole batch's, and the gradients are summed over the
stages and the replicas.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)
import torch_parallel_worker as worker

import ppgs_tpu_torch
from ppgs_tpu_torch import parallel
from ppgs_tpu_torch.models import transformer
from ppgs_tpu_torch.ops import dropout
from ppgs_tpu_torch.ops.masking import mask_from_lengths

MODES = (('pipeline', 2), ('pipeline4', 4))
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp('pipeline')
    worker.write_inputs(root)
    launched = [(mode, n, worker.launch(mode, root, n)) for mode, n in MODES]
    for _, _, procs in launched:
        worker.wait(procs)
    return root, {mode: worker.results(mode, root, n)
                  for mode, n, _ in launched}


@pytest.fixture(scope='module')
def sequential(runs):
    """The sequential forward's logits and gradients of the square loss
    (dropout 0), one process."""
    root, _ = runs
    net = worker.model(root, 'pipeline.npz', worker.pipeline_config(),
                       grad=True)
    features, lengths = worker.pipeline_inputs(root)
    logits = transformer.forward(net, features, lengths).numpy()
    out = transformer.forward(net, features, lengths, train=True, seed=0)
    worker.square_loss(out).backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    return logits, out.detach().numpy(), grads


def _close(got, want, name=''):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=name)


@pytest.mark.parametrize('key', ['pp_forward', 'pp_forward_m2'])
def test_pipeline_forward_matches_sequential(runs, sequential, key):
    """Inference through 2 stages, 4 and 2 microbatches, on every
    stage."""
    _, found = runs
    for arrays, _ in found['pipeline']:
        _close(arrays[key], sequential[0])


def test_pipeline_gradients_match_sequential(runs, sequential):
    """The backward through the ring (the reverse schedule) and the
    stages' gradients summed: the sequential forward's gradients."""
    _, found = runs
    _, train_logits, grads = sequential
    for arrays, _ in found['pipeline']:
        _close(arrays['pp_train'], train_logits)
        for name, want in grads.items():
            _close(arrays[f'pp_grad.{name}'], want, name)


def test_data_and_pipeline_parallel(runs, sequential):
    """DP x PP on a (2, 2) ('data', 'pipe') mesh: each rank's rows of each
    microbatch, the gradients summed over both axes."""
    _, found = runs
    _, train_logits, grads = sequential
    for arrays, _ in found['pipeline4']:
        _close(arrays['dppp'], train_logits[arrays['dppp_rows']])
        for name, want in grads.items():
            _close(arrays[f'dppp_grad.{name}'], want, name)


def test_tensor_and_pipeline_parallel(runs, sequential):
    """TP x PP on a (2, 2) ('pipe', 'model') mesh: each rank holds half of
    its stage layers' split tensors and gathers them before they run; the
    shards' gradients gathered are the sequential ones."""
    root, found = runs
    _, train_logits, grads = sequential
    net = worker.model(root, 'pipeline.npz', worker.pipeline_config())
    dims = parallel.w2v2_module_dims(net)
    split = parallel.local_bytes(net, set(dims))
    for arrays, scalars in found['pipeline4']:
        _close(arrays['tppp'], train_logits)
        for name, want in grads.items():
            _close(arrays[f'tppp_grad.{name}'], want, name)
        local_split, local_whole = scalars['tppp_bytes']
        assert 2 * local_split == split
        assert local_whole == parallel.local_bytes(net) - split // 2


@pytest.mark.parametrize('shape,names,kwargs,batch,match', [
    ((3,), ('pipe',), {}, 8,
     'num_hidden_layers=4 must divide evenly over 3'),
    ((2,), ('pipe',), {'num_microbatches': 3}, 8,
     'batch 8 must divide into 3'),
    ((2,), ('pipe',), {'num_microbatches': 1}, 8,
     'microbatches 1 must divide into 2'),
    ((4, 2), ('data', 'pipe'), {'batch_axis': 'data'}, 4,
     'microbatch size 2 must divide'),
    ((2, 2), ('pipe', 'model'), {'tp_axis': 'model'}, 8,
     "sharded over 'model'"),
])
def test_pipeline_validates_divisibility(runs, shape, names, kwargs, batch,
                                         match):
    """JAX's errors, raised before any exchange, and TP x PP's on a model
    that is not sharded."""
    root, _ = runs
    mesh = parallel.Mesh(shape, names, 0, {})
    features, lengths = worker.pipeline_inputs(root)
    net = worker.model(root, 'pipeline.npz', worker.pipeline_config())
    with pytest.raises(ValueError, match=match):
        parallel.pipeline_forward(net, features[:batch], lengths[:batch],
                                  mesh, **kwargs)


def _pipelined_sequence(net, features, lengths, seed, microbatches):
    """The pipelined train forward's function in one process: the
    positional encoding's dropout on the whole batch, then each
    microbatch through every layer with the pipeline's Philox sites."""
    config = net.config
    T = features.shape[-1]
    mask = mask_from_lengths(lengths, T)
    x = transformer.conv1d_same(features, net.input_conv.weight,
                                net.input_conv.bias)
    x = (x.transpose(1, 2) * mask[..., None] + net.pe[:T]).contiguous()
    x = dropout.dropout(x, seed, dropout.PE_SITE, config.dropout)
    rows = features.shape[0] // microbatches
    outs = []
    for mb in range(microbatches):
        h, m = x[mb * rows:(mb + 1) * rows], mask[mb * rows:(mb + 1) * rows]
        for i, layer in enumerate(net.layers):
            drop = dropout.Drop(seed, dropout.pipeline_site(
                i, mb, microbatches), config.dropout)
            h = transformer._encoder_layer_train(
                h, layer, m, config.is_causal, config.attention_heads,
                torch.float32, False, drop)
        outs.append(h)
    x = torch.cat(outs).transpose(1, 2)
    x = transformer.conv1d_same(x, net.output_conv.weight,
                                net.output_conv.bias)
    return (x * mask[:, None, :]).detach().numpy()


def test_pipeline_dropout(runs, sequential):
    """Dropout 0.1 in the stage bodies: a seed gives the same logits
    twice and another seed others, both apart from inference; they are
    the pipelined function's in one process (the sites keyed by the
    global layer and microbatch); and the sites' keep rate is 0.9 within
    5 standard deviations."""
    root, found = runs
    features, lengths = worker.pipeline_inputs(root)
    net = worker.model(root, 'pipeline.npz',
                       worker.pipeline_config(dropout=0.1))
    for arrays, _ in found['pipeline']:
        a, a2, b = (arrays[f'pp_dropout_{k}'] for k in ('a', 'a2', 'b'))
        np.testing.assert_array_equal(a, a2)
        assert not np.allclose(a, b)
        assert not np.allclose(a, sequential[0])
        for got, seed in ((a, 5), (b, 6)):
            _close(got, _pipelined_sequence(net, features, lengths, seed, 4))
    shape = (2, 48, 32)
    kept = [dropout.keep_mask(shape, 5, dropout.pipeline_site(
        layer, mb, 4) + k, 0.1).float().mean().item()
        for layer in range(4) for mb in range(4) for k in range(4)
        if k != 0]
    n = len(kept) * np.prod(shape)
    assert abs(np.mean(kept) - 0.9) < 5 * np.sqrt(0.09 / n)
    assert len(set(kept)) > len(kept) // 2


def test_stack_layer_params(runs):
    """The layers' parameters stacked on a leading layer dim, as JAX's
    ``stack_layer_params`` stacks its pytree."""
    root, _ = runs
    net = worker.model(root, 'pipeline.npz', worker.pipeline_config())
    stacked = parallel.stack_layer_params(net.layers)
    assert sorted(stacked) == sorted(
        n for n, _ in net.layers[0].named_parameters())
    for i, layer in enumerate(net.layers):
        for name, param in layer.named_parameters():
            assert torch.equal(stacked[name][i], param)
    assert ppgs_tpu_torch.parallel.pipeline_forward is \
        parallel.pipeline.pipeline_forward
