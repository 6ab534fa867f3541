"""The port's multi-process layer on the CPU (gloo): data-parallel training
over 2 and 4 ranks with an uneven valid-frame split, its evaluation, the
multihost helpers, and the orbax backend's collective saves, kill/resume
and coordinated interrupt (tests/test_multihost.py's cases, replayed on
``ppgs_tpu_torch``), held against the port's single process and JAX's.

Tolerances: DP training sums each step's gradients in another order than
one process (per rank, then across ranks), so the parameters after 3
Adam steps agree at fp32 1e-5 (rtol and atol), except the key biases:
softmax ignores a shift of a row's scores, their gradient is rounding
noise, and Adam turns it into steps of up to about lr (held to 2 lr a
step, as tests/test_torch_frontend.py holds them). The metric sums are
exact counts, their float sums within 1e-6 relative.
"""

import json
import signal
import time

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (cores shared among xdist workers)
import torch_parallel_worker as worker

import jax

import ppgs_tpu
from ppgs_tpu.train import core as jax_train

from ppgs_tpu_torch import parallel
from ppgs_tpu_torch.evaluate.metrics import Metrics
from ppgs_tpu_torch.parallel import multihost
from ppgs_tpu_torch.train import core as train_core

STEPS = 3


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """DP training on 2 and 4 ranks and the orbax phases A then B."""
    root = tmp_path_factory.mktemp('multihost')
    worker.write_inputs(root)
    launched = [(mode, n, worker.launch(mode, root, n))
                for mode, n in (('multihost', 2), ('train4', 4),
                                ('train_tp', 2), ('train_pp', 2),
                                ('orbax_phase_a', 2))]
    for _, _, procs in launched:
        worker.wait(procs)
    resumed = [worker.launch(mode, root, 2)
               for mode in ('orbax_phase_b', 'train_tp_resume')]
    for procs in resumed:
        worker.wait(procs)
    found = {mode: worker.results(mode, root, n) for mode, n, _ in launched}
    for mode in ('orbax_phase_b', 'train_tp_resume'):
        found[mode] = worker.results(mode, root, 2)
    return root, found


@pytest.fixture(scope='module')
def single(tmp_path_factory):
    """The single process's 3 steps, in this process (as the workers run
    them: metrics.jsonl without tensorboard, no figures)."""
    root = tmp_path_factory.mktemp('single')
    with pytest.MonkeyPatch.context() as patch, worker.one_thread():
        worker.quiet(patch)
        return worker.train_params(root / 'run', worker.make_config())


@pytest.fixture(scope='module')
def single6(tmp_path_factory):
    """The single process's 6 uninterrupted steps (checkpoints every 2)."""
    root = tmp_path_factory.mktemp('single6')
    config = worker.make_config(checkpoint_backend='orbax',
                                checkpoint_interval=2)
    with pytest.MonkeyPatch.context() as patch, worker.one_thread():
        worker.quiet(patch)
        return worker.train_params(root / 'run', config, 6)


def _params(arrays):
    return {k[len('params.'):]: v for k, v in arrays.items()
            if k.startswith('params.')}


def _assert_params_close(got, want, steps=STEPS, rtol=1e-5, atol=1e-5):
    assert sorted(got) == sorted(want)
    reach = 2 * steps * worker.make_config().learning_rate
    for key in want:
        if key.endswith('.attn.bk'):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=reach, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                       atol=atol, err_msg=key)


def test_ranks_see_the_group(runs):
    _, found = runs
    scalars = [s for _, s in found['multihost']]
    assert [s['process_count'] for s in scalars] == [2, 2]
    assert [s['is_primary'] for s in scalars] == [True, False]


@pytest.mark.parametrize('mode', ['multihost', 'train4'])
def test_data_parallel_train_matches_single_process(runs, single, mode):
    """3 steps over 2 and 4 ranks (B = 5 padded to 6 and 8 rows: one
    rank's rows -100 padding in part or whole) against one process."""
    _, found = runs
    for arrays, _ in found[mode]:
        _assert_params_close(_params(arrays), single)


def test_tensor_parallel_train_matches_single_process(runs, single):
    """3 steps with a 'model' axis of 2: each rank keeps its slices of the
    w2v2 rule's tensors and their Adam moments, gathers a layer before it
    runs and reduce-scatters its gradient; the gathered parameters are
    the single process's."""
    _, found = runs
    for arrays, scalars in found['train_tp']:
        _assert_params_close(_params(arrays), single)
        counts = scalars['counts']
        assert counts['tp_gather/gloo'] > 0
        assert counts['tp_gather_backward/gloo'] > 0


def test_tensor_parallel_train_resumes(runs, single6):
    """The TP run resumed by new processes from its step-3 npz checkpoint
    (written whole by rank 0) to step 6: each rank reloads its slices of
    the parameters and Adam's moments, and the run is the uninterrupted
    single process's."""
    _, found = runs
    for arrays, _ in found['train_tp_resume']:
        _assert_params_close(_params(arrays), single6, steps=6)


def test_pipeline_parallel_train_matches_single_process(runs, single):
    """3 steps with a 'pipe' axis of 2 (B = 5 padded to 6: 2 microbatches
    of 3 rows): the GPipe schedule in the train step, the stages'
    gradients summed."""
    _, found = runs
    for arrays, scalars in found['train_pp']:
        _assert_params_close(_params(arrays), single)
        assert scalars['counts']['gradients/gloo'] == STEPS


def test_single_process_train_matches_jax(single, tmp_path, monkeypatch):
    """JAX's ``train`` from the same initial weights on the same stream
    (its 8 virtual CPU devices: B = 5 padded to 8 rows), 3 steps."""
    initial = train_core.init_model(worker.make_config(), 'cpu')
    weights = ppgs_tpu.load.unflatten_params(worker.jax_layout(initial))
    monkeypatch.setattr(jax_train.models, 'init',
                        lambda rng, config: weights)
    config = ppgs_tpu.Config(
        num_hidden_layers=2, hidden_channels=64, ffn_channels=128,
        max_len=64, chunk_length=64, chunk_overlap=8,
        compute_dtype='float32', dropout=0.0,
        evaluation_interval=10 ** 9, checkpoint_interval=10 ** 9)
    params = jax_train.train('synthetic', directory=tmp_path, config=config,
                             max_steps=STEPS, loader_fn=worker.loader_fn)
    want = ppgs_tpu.load.flatten_params(jax.device_get(params))
    _assert_params_close(single, want)


def test_evaluation_matches_single_process(runs, single):
    """``evaluate_partition`` with the mesh: each rank its rows of every
    padded batch, the metric sums summed over the data group."""
    root, found = runs
    model = worker.model(root)
    model.load_state_dict(train_core.convert.model_params_from_jax(
        model.config, _params(found['multihost'][0][0])))
    want = train_core.evaluate_partition(None, 0, model, model.config,
                                         worker.loader_fn, 'valid')
    for _, scalars in found['multihost']:
        got = scalars['scalars']
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-6, abs=1e-9), key


def test_metric_aggregation_is_exact(runs):
    """Each rank accumulates a disjoint half of a batch; their sums
    summed are the whole batch's metrics."""
    _, found = runs
    logits, targets = worker.metrics_batch()
    metrics = Metrics(config=worker.make_config(), device='cpu')
    metrics.update(logits, targets)
    want = {k: v for k, v in metrics().items()
            if isinstance(v, (int, float))}
    for _, scalars in found['multihost']:
        got = scalars['aggregated']
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, int):
                assert got[key] == value, key
            else:
                assert got[key] == pytest.approx(value, rel=1e-6,
                                                 abs=1e-9), key


def test_multihost_helpers_across_ranks(runs):
    """shard_iterator deals every 2nd item, local_slice the rank's block,
    any_process ORs one rank's flag into every rank's answer."""
    _, found = runs
    for rank, (arrays, scalars) in enumerate(found['multihost']):
        assert scalars['shard_iterator'] == list(range(7))[rank::2]
        np.testing.assert_array_equal(arrays['local_slice'],
                                      np.arange(4 * rank, 4 * rank + 4) * 10)
        assert scalars['any_one'] is True
        assert scalars['any_none'] is False
        # rank 0's values on every rank; a rank's rows placed as they are
        np.testing.assert_array_equal(arrays['replicated'], [10.0] * 3)
        np.testing.assert_array_equal(arrays['placed'],
                                      np.arange(3 * rank, 3 * rank + 3))


def test_multihost_helpers_single_process():
    """Without a process group every helper is its single-process
    equivalent, and ``initialize`` without configuration is a no-op."""
    assert multihost.initialize(device='cpu') is None
    assert multihost.process_count() == 1 and multihost.is_primary()
    assert list(multihost.shard_iterator(range(5))) == [0, 1, 2, 3, 4]
    tree = (np.arange(8), np.ones((8, 3)))
    out = multihost.local_slice(tree)
    assert out[0] is tree[0] and out[1] is tree[1]
    assert multihost.any_process(True) is True
    assert multihost.any_process(False) is False
    mesh = multihost.make_hybrid_mesh((-1,), ('data',))
    assert mesh.shape == {'data': 1}
    state = {'count': torch.tensor(3)}
    assert multihost.aggregate_across_processes(state) is state
    placed = multihost.shard_global_batch(mesh, (np.arange(4), np.ones(4)),
                                          device='cpu')
    assert isinstance(placed[0], torch.Tensor)
    np.testing.assert_array_equal(placed[0].numpy(), np.arange(4))
    replicated = multihost.replicate_global(mesh, {'w': np.arange(3.0)})
    np.testing.assert_array_equal(replicated['w'].numpy(), np.arange(3.0))
    with pytest.raises(ValueError, match='PPGS_NUM_PROCESSES'):
        multihost.initialize(coordinator_address='127.0.0.1:1',
                             device='cpu')


def test_orbax_checkpoint_kill_resume(runs, single6):
    """Phase A trains 3 steps on 2 ranks (collective saves at steps 2 and
    3) and its processes exit; a fresh pair resumes from step 3 to 6
    (saves at 4 and 6), and matches an uninterrupted single-process 6-step
    run."""
    root, found = runs
    run_dir = root / 'orbax'
    assert train_core.ckpt.orbax_steps(run_dir) == [2, 3, 4, 6]
    assert not list(run_dir.glob('*.partial'))
    for arrays, _ in found['orbax_phase_b']:
        _assert_params_close(_params(arrays), single6, steps=6)
    with open(run_dir / '6' / 'meta.json') as file:
        assert json.load(file)['step'] == 6


def test_orbax_interrupt_coordinated_save(tmp_path):
    """SIGTERM lands on the two ranks at different moments; the OR of
    their flags every 25 steps stops both at one step, and the collective
    save of that step completes."""
    worker.write_inputs(tmp_path)
    ready = tmp_path / 'ready'
    procs = [p for p in worker.launch(
        'orbax_interrupt', tmp_path, 2,
        env={'PPGS_TEST_READY': str(ready)})]
    deadline = time.time() + worker.TIMEOUT
    while not ready.exists():
        if time.time() > deadline or any(p.poll() is not None
                                         for p in procs):
            for p in procs:
                p.kill()
            raise AssertionError('the ranks never took a step')
        time.sleep(0.1)
    time.sleep(0.3)
    procs[0].send_signal(signal.SIGTERM)
    time.sleep(0.2)
    procs[1].send_signal(signal.SIGTERM)
    worker.wait(procs)
    steps = {s['latest_step'] for _, s in worker.results(
        'orbax_interrupt', tmp_path, 2)}
    assert len(steps) == 1 and None not in steps
    assert (tmp_path / 'interrupted' / str(steps.pop())).is_dir()


def test_npz_checkpoint_written_by_rank_zero(runs):
    """The npz backend's checkpoint of a DP run is one file, written by
    rank 0, equal to the returned parameters."""
    root, found = runs
    path = train_core.latest_checkpoint(root / 'run2')
    flat, step, _ = train_core.ckpt.npz_restore(path)
    assert step == STEPS
    for key, value in _params(found['multihost'][0][0]).items():
        np.testing.assert_array_equal(flat[f'params.{key}'], value)
    assert parallel.world() == (1, 0)
