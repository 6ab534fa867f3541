"""The port's parallel layer on the CPU: context parallelism through
``infer``, DP x CP, the TP rules and the TP frontends, and the data-parallel
branch of ``from_dataloader``, on gloo groups of 2 and 4 ranks
(``tests/torch_parallel_worker.py``, launched once for the module), held
against the port's single process and against the JAX package.

Tolerances: the ranks run the single process's window geometry and
weights, and on the CPU the same products, so CP, DP x CP, the TP
frontends (whose gathered weights are the whole ones) and the DP file
outputs equal the single process bit for bit; against JAX's
``context_parallel_chunked_forward`` on its virtual CPU mesh the fp32
logits hold at 1e-4 (ROADMAP's transformer envelope, docs/GOLDEN_PARITY.md).
The TP rules give each rank exactly the slices that JAX's NamedSharding
gives its device.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401  (cores shared among xdist workers)
import torch_parallel_worker as worker

import jax
import jax.numpy as jnp

import ppgs_tpu
from ppgs_tpu import parallel as jax_parallel
from ppgs_tpu.models import conformer as jax_conformer
from ppgs_tpu.models import w2v2 as jax_w2v2

import ppgs_tpu_torch
from ppgs_tpu_torch import parallel
from ppgs_tpu_torch.models import conformer, w2v2
from ppgs_tpu_torch.preprocess import bottleneck, w2v2fb

MODES = (('parallel', 2), ('parallel4', 4))




@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Both modes' ranks at once; their results by mode."""
    root = tmp_path_factory.mktemp('parallel')
    worker.write_inputs(root)
    launched = [(mode, n, worker.launch(mode, root, n)) for mode, n in MODES]
    for _, _, procs in launched:
        worker.wait(procs)
    return root, {mode: worker.results(mode, root, n)
                  for mode, n, _ in launched}


def _single_chunked(root, T):
    data = worker.inputs(root)
    return ppgs_tpu_torch.infer(
        data[f'cp_features_{T}'], data[f'cp_lengths_{T}'],
        checkpoint=root / 'model.npz', softmax=False,
        config=worker.make_config(), device='cpu').numpy()


@pytest.mark.parametrize('T', worker.CP_T)
def test_context_parallel_infer_matches_single_process(runs, T):
    """``infer`` with a 'seq' axis of 2 splits the windows over the ranks
    and gathers the logits: the single process's chunked forward, bit for
    bit, for T = 300 (padded to 384) and T = 192."""
    root, found = runs
    want = _single_chunked(root, T)
    for arrays, _ in found['parallel']:
        assert arrays[f'cp_{T}'].shape == want.shape
        np.testing.assert_array_equal(arrays[f'cp_{T}'], want)


def test_context_parallel_output_stays_split(runs):
    """``context_parallel_chunked_forward`` returns each rank's half of the
    padded time axis; the halves joined are the whole."""
    root, found = runs
    want = _single_chunked(root, 300)
    halves = [arrays['cp_local'] for arrays, _ in found['parallel']]
    assert [h.shape[-1] for h in halves] == [192, 192]
    np.testing.assert_array_equal(
        np.concatenate(halves, axis=-1)[..., :300], want)


@pytest.fixture(scope='module')
def jax_cp(runs):
    """JAX's halo-exchange CP of the T = 300 input (padded to 384) on a
    (2, 2) ('data', 'seq') mesh of virtual CPU devices, same weights."""
    root, _ = runs
    data = worker.inputs(root)
    config = ppgs_tpu.Config(**{
        k: getattr(worker.make_config(), k) for k in (
            'num_hidden_layers', 'hidden_channels', 'ffn_channels',
            'max_len', 'chunk_length', 'chunk_overlap', 'compute_dtype')})
    mesh = jax_parallel.make_mesh(devices=jax.devices()[:4], shape=(2, 2),
                                  axis_names=('data', 'seq'))
    padded, true_frames = jax_parallel.pad_frames_for_context(
        jnp.asarray(data['cp_features_300']), config, 2)
    return np.asarray(jax_parallel.context_parallel_chunked_forward(
        ppgs_tpu.load.load_params(root / 'model.npz'), padded,
        data['cp_lengths_300'], config, mesh, axis='seq',
        batch_axis='data', true_frames=true_frames))[..., :300]


def test_context_parallel_matches_jax(runs, jax_cp):
    """The port's CP logits (a 'seq' axis of 2) against JAX's CP at
    1e-4."""
    _, found = runs
    for arrays, _ in found['parallel']:
        np.testing.assert_allclose(arrays['cp_300'], jax_cp, rtol=1e-4,
                                   atol=1e-4)


def test_data_and_context_parallel(runs, jax_cp):
    """DP x CP on a (2, 2) ('data', 'seq') mesh: each rank holds two rows'
    halves of the padded time axis; the joined logits are the single
    process's bit for bit, and JAX's DP x CP at 1e-4."""
    root, found = runs
    want = _single_chunked(root, 300)
    for rank, (arrays, _) in enumerate(found['parallel4']):
        d, s = divmod(rank, 2)
        np.testing.assert_array_equal(arrays['dpcp'][..., :300], want)
        end = min(300, 192 * (s + 1))
        np.testing.assert_array_equal(
            arrays['dpcp_local'][..., :end - 192 * s],
            want[2 * d:2 * d + 2, :, 192 * s:end])
        np.testing.assert_allclose(arrays['dpcp'][..., :300], jax_cp,
                                   rtol=1e-4, atol=1e-4)


def _jax_slices(sharding_fn, params, n=2):
    """{path: [device i's slice]} of JAX's placement on n devices."""
    mesh = jax_parallel.make_mesh(devices=jax.devices()[:n], shape=(n,),
                                  axis_names=('model',))
    placed = jax_parallel.shard_params(params, sharding_fn(mesh, params))
    out = {}
    for keys, array in jax.tree_util.tree_flatten_with_path(placed)[0]:
        path = '.'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                        for k in keys)
        shards = sorted(array.addressable_shards, key=lambda s: s.device.id)
        out[path] = [np.asarray(shards[i].data) for i in range(n)]
    return out


@pytest.mark.parametrize('rule', ['w2v2', 'conformer'])
def test_tp_rules_match_jax_named_sharding(rule):
    """Each rank's slice of every parameter path is the block that JAX's
    NamedSharding places on the device at its coordinate."""
    if rule == 'w2v2':
        params = jax_w2v2.init(jax.random.PRNGKey(0),
                               jax_w2v2.W2V2Config(
                                   **vars(worker.TINY_W2V2)))
        port_rule, jax_rule = (parallel.w2v2_param_sharding,
                               jax_parallel.w2v2_param_sharding)
    else:
        params = jax_conformer.init(jax.random.PRNGKey(0),
                                    jax_conformer.ConformerConfig(
                                        num_blocks=2))
        port_rule, jax_rule = (parallel.conformer_param_sharding,
                               jax_parallel.conformer_param_sharding)
    want = _jax_slices(jax_rule, params)
    flat = {k: np.asarray(v)
            for k, v in ppgs_tpu.load.flatten_params(params).items()}
    split = 0
    for rank in range(2):
        mesh = parallel.Mesh((2,), ('model',), rank, {})
        dims = port_rule(mesh, flat)
        got = parallel.shard_params(flat, dims, mesh)
        assert sorted(got) == sorted(want)
        for path in want:
            np.testing.assert_array_equal(got[path], want[path][rank],
                                          err_msg=path)
        split = sum(d is not None for d in dims.values())
    assert split > 10


@pytest.fixture
def frontends(runs, monkeypatch):
    """The single process's frontends at the workers' tiny trunks."""
    root, _ = runs
    monkeypatch.setattr(w2v2, 'BASE', worker.TINY_W2V2)
    monkeypatch.setattr(w2v2fb, 'W2V2FB_CHECKPOINT', root / 'w2v2.npz')
    monkeypatch.setattr(conformer, 'BOTTLENECK', worker.TINY_CONFORMER)
    monkeypatch.setattr(bottleneck, 'BOTTLENECK_CHECKPOINT',
                        root / 'conformer.npz')
    with worker.one_thread():
        return worker.frontend_features(root, worker.make_config())


@pytest.mark.parametrize('name,rule', [
    ('w2v2fb', 'w2v2_module_dims'), ('bottleneck', 'conformer_module_dims')])
def test_tp_frontends_match_single_process(runs, frontends, name, rule):
    """With a 'model' axis of 2 each rank holds half of every tensor the
    rule splits (by its parameters' bytes; the rest whole), the trunk runs
    on each layer's gathered weights, and the features are the single
    process's bit for bit."""
    root, found = runs
    want = frontends[name].numpy()
    full = (w2v2fb._trunk(worker.TINY_W2V2, 'cpu') if name == 'w2v2fb'
            else bottleneck._encoder(worker.TINY_CONFORMER, 'cpu'))
    dims = getattr(parallel, rule)(full)
    split = parallel.local_bytes(full, set(dims))
    whole = parallel.local_bytes(full)
    assert 0 < split < whole
    for arrays, scalars in found['parallel']:
        np.testing.assert_array_equal(arrays[f'tp_{name}'], want)
        local_split, local_whole = scalars[f'bytes_{rule}']
        assert 2 * local_split == split
        assert local_whole == whole - split // 2


def test_data_parallel_from_dataloader_matches_single_process(runs,
                                                              tmp_path):
    """``from_files_to_files(num_workers=2)`` in a group of 2: every rank
    walks the same batches, runs its rows and saves their files; each
    file is the single process's bit for bit."""
    root, _ = runs
    files = worker.wav_files(root)
    with worker.one_thread():
        ppgs_tpu_torch.from_files_to_files(
            files, [tmp_path / f'{f.stem}.npy' for f in files],
            checkpoint=root / 'model.npz', num_workers=2,
            config=worker.make_config(), device='cpu')
    for f in files:
        np.testing.assert_array_equal(
            np.load(root / 'dp_outputs' / f'{f.stem}.npy'),
            np.load(tmp_path / f'{f.stem}.npy'), err_msg=f.name)


def test_collectives_were_counted(runs):
    """The CP runs exchanged their halos once a call (``comm.counts``)."""
    _, found = runs
    for _, scalars in found['parallel']:
        assert scalars['counts']['halo/gloo'] == 3


def test_mesh_and_batch_helpers():
    """Without a process group: the mesh has one rank, its -1 fills with
    it, and ``pad_batch_to_multiple`` pads targets with -100 as JAX's
    does."""
    mesh = parallel.make_mesh((-1,), ('data',))
    assert mesh.shape == {'data': 1} and mesh.group('data') is None
    assert parallel.fill_shape((-1, 2), 8) == (4, 2)
    with pytest.raises(ValueError, match='ranks'):
        parallel.make_mesh((2,), ('seq',))
    arrays = (np.ones((5, 3), np.float32), np.zeros((5, 4), np.int64))
    got = parallel.pad_batch_to_multiple(arrays, 4, fill=(0, -100))
    want = jax_parallel.pad_batch_to_multiple(arrays, 4, fill=(0, -100))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    rows = parallel.shard_batch(parallel.Mesh((2,), ('data',), 1, {}),
                                np.arange(6))
    np.testing.assert_array_equal(rows, [3, 4, 5])
