"""Worker of the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_multihost.py and test_torch_pipeline_parallel.py).

    python tests/torch_parallel_worker.py MODE DIR

runs one mode's scenarios on one rank of a gloo group (PPGS_COORDINATOR,
PPGS_NUM_PROCESSES and PPGS_PROCESS_ID set by the test's fixture) and
writes DIR/MODE-rank{r}.npz (arrays) and .json (scalars). The fixture
writes the weights and inputs into DIR first (``write_inputs``), and the
tests compute the single-process side in their own process from the same
files, with the same functions. Sizes are tests/multihost_worker.py's
``make_config()``.
"""

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import ppgs_tpu_torch  # noqa: E402
from ppgs_tpu_torch import convert, load, parallel  # noqa: E402
from ppgs_tpu_torch.models import conformer, transformer, w2v2  # noqa: E402
from ppgs_tpu_torch.parallel import comm, multihost  # noqa: E402
from ppgs_tpu_torch.preprocess import bottleneck, w2v2fb  # noqa: E402
from ppgs_tpu_torch.train import core as train_core  # noqa: E402

TIMEOUT = 600                  # seconds a rank may take
TINY_W2V2 = w2v2.W2V2Config(
    conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
    hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
TINY_CONFORMER = conformer.ConformerConfig(num_blocks=2)
CP_T = (300, 192)              # not a multiple of stride x 2 = 96, and one
FRONTEND_SAMPLES = 8000        # 0.5 s a row


def make_config(**overrides):
    """tests/multihost_worker.py's ``make_config()`` in the port."""
    return ppgs_tpu_torch.Config(
        num_hidden_layers=2, hidden_channels=64, ffn_channels=128,
        max_len=64, chunk_length=64, chunk_overlap=8,
        compute_dtype='float32', dropout=0.0,
        evaluation_interval=10 ** 9, checkpoint_interval=10 ** 9
    ).replace(**overrides)


def pipeline_config(**overrides):
    """tests/test_pipeline.py's CONFIG: 4 layers over the stages."""
    return ppgs_tpu_torch.Config(
        num_hidden_layers=4, hidden_channels=32, ffn_channels=64,
        attention_heads=2, max_len=64, chunk_length=64, chunk_overlap=8,
        compute_dtype='float32', dropout=0.0).replace(**overrides)


###############################################################################
# Inputs, written once by the fixture
###############################################################################


def write_inputs(root):
    """Seeded weights and inputs of every scenario under ``root``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    load.save_params(root / 'model.npz',
                     transformer.init(make_config(), gen))
    load.save_params(root / 'pipeline.npz',
                     transformer.init(pipeline_config(), gen))
    load.save_params(root / 'w2v2.npz', w2v2.init(TINY_W2V2, gen))
    load.save_params(root / 'conformer.npz',
                     conformer.init(TINY_CONFORMER, gen))
    rng = np.random.default_rng(0)
    arrays = {}
    for T in CP_T:
        arrays[f'cp_features_{T}'] = rng.standard_normal(
            (4, 80, T)).astype(np.float32)
        arrays[f'cp_lengths_{T}'] = np.array([T, T - 40, 57, 33])
    arrays['audio'] = (0.1 * rng.standard_normal(
        (4, 1, FRONTEND_SAMPLES))).astype(np.float32)
    arrays['audio_lengths'] = np.array([8000, 7000, 6400, 4800])
    arrays['pp_features'] = rng.standard_normal(
        (8, 80, 48)).astype(np.float32)
    arrays['pp_lengths'] = np.array([48 - (i % 3) for i in range(8)])
    np.savez(root / 'inputs.npz', **arrays)
    from ppgs_tpu_torch.data import audio as audio_io

    wavs = root / 'wavs'
    wavs.mkdir(exist_ok=True)
    for i, seconds in enumerate((0.7, 1.3, 0.4, 2.1, 0.9)):
        audio_io.save_wav(wavs / f'utt{i}.wav', (0.1 * rng.standard_normal(
            (1, int(16000 * seconds)))).astype(np.float32))


def inputs(root):
    with np.load(Path(root) / 'inputs.npz') as data:
        return {k: data[k] for k in data.files}


def point_frontends(root):
    """The w2v2fb and bottleneck frontends at the tiny trunks' npz."""
    w2v2.BASE = TINY_W2V2
    w2v2fb.W2V2FB_CHECKPOINT = Path(root) / 'w2v2.npz'
    conformer.BOTTLENECK = TINY_CONFORMER
    bottleneck.BOTTLENECK_CHECKPOINT = Path(root) / 'conformer.npz'


def model(root, name='model.npz', config=None, grad=False):
    net = load.model(checkpoint=Path(root) / name,
                     config=config or make_config(), device='cpu')[0]
    return net.requires_grad_(grad)


def frontend_features(root, config):
    """The w2v2fb and bottleneck frontends' features of the test audio."""
    data = inputs(root)
    audio = torch.from_numpy(data['audio'])
    lengths = data['audio_lengths']
    return {'w2v2fb': w2v2fb.from_audios(audio, lengths, config=config,
                                         device='cpu'),
            'bottleneck': bottleneck.from_audios(audio, lengths,
                                                 config=config,
                                                 device='cpu')}


def wav_files(root):
    return sorted((Path(root) / 'wavs').glob('*.wav'))


def loader_fn(partition):
    """tests/multihost_worker.py's stream: B = 5 (no multiple of any mesh
    size), ragged lengths, -100 past them."""
    rng = np.random.default_rng(42 if partition == 'train' else 43)
    for _ in range(3):
        B, T = 5, 64
        feats = rng.standard_normal((B, 80, T)).astype('f4')
        targets = rng.integers(0, 40, size=(B, T)).astype(np.int64)
        lengths = np.array([64, 50, 33, 8, 64], dtype=np.int64)
        for i, length in enumerate(lengths):
            feats[i, :, length:] = 0
            targets[i, length:] = -100
        yield feats, targets, lengths


def endless_loader(partition):
    """An endless seeded stream that marks, once the first step is taken,
    that the signal handler is installed."""
    rng = np.random.default_rng(11)
    marker = os.environ.get('PPGS_TEST_READY')
    i = 0
    while True:
        if i == 1 and marker:
            Path(marker).touch()
        feats = rng.standard_normal((4, 80, 64)).astype('f4')
        targets = rng.integers(0, 40, size=(4, 64)).astype(np.int64)
        time.sleep(0.05)
        i += 1
        yield feats, targets, np.full((4,), 64, dtype=np.int64)


def jax_layout(model):
    return convert.model_params_to_jax(model.config, model.state_dict())


def train_params(directory, config, max_steps=3, loader=loader_fn):
    """``train()`` for ``max_steps`` steps; its parameters, JAX layout."""
    model = train_core.train(directory=directory, config=config,
                             max_steps=max_steps, loader_fn=loader,
                             device='cpu')
    return jax_layout(model)


def metrics_batch():
    """tests/multihost_worker.py's metrics batch: 4 rows, -100 past 50."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 40, 64)).astype('f4')
    targets = rng.integers(0, 40, size=(4, 64)).astype(np.int64)
    targets[:, 50:] = -100
    return logits, targets


def pipeline_inputs(root):
    data = inputs(root)
    return (torch.from_numpy(data['pp_features']),
            torch.from_numpy(data['pp_lengths']))


def square_loss(out):
    return out.square().mean()


###############################################################################
# Modes (one rank's share)
###############################################################################


def mode_parallel(root, out):
    """CP through ``infer``, the frontends under TP, and the DP branch of
    ``from_dataloader``, on 2 ranks."""
    data = inputs(root)
    seq = make_config(mesh_shape=(2,), mesh_axis_names=('seq',))
    mesh = parallel.make_mesh((2,), ('seq',))
    for T in CP_T:
        out[f'cp_{T}'] = ppgs_tpu_torch.infer(
            data[f'cp_features_{T}'], data[f'cp_lengths_{T}'],
            checkpoint=Path(root) / 'model.npz', softmax=False, config=seq,
            device='cpu').numpy()
    padded, true_frames = parallel.pad_frames_for_context(
        torch.from_numpy(data['cp_features_300']), seq, 2)
    local = parallel.context.shard_frames(padded, mesh, 'seq')
    out['cp_local'] = parallel.context_parallel_chunked_forward(
        model(root), local, data['cp_lengths_300'], mesh, 'seq',
        true_frames=true_frames).numpy()
    counts = dict(comm.counts)

    point_frontends(root)
    tp = make_config(mesh_shape=(2,), mesh_axis_names=('model',))
    for name, got in frontend_features(root, tp).items():
        out[f'tp_{name}'] = got.numpy()
    scalars = {'counts': {f'{k[0]}/{k[1]}': v for k, v in counts.items()}}
    for name, placement in parallel._FRONTEND_TP_CACHE.items():
        view = placement.model
        local = view.module
        scalars[f'bytes_{name[0]}'] = [
            parallel.local_bytes(local, set(view._dims)),
            parallel.local_bytes(local)]

    outputs = Path(root) / 'dp_outputs'
    outputs.mkdir(exist_ok=True)
    files = wav_files(root)
    ppgs_tpu_torch.from_files_to_files(
        files, [outputs / f'{f.stem}.npy' for f in files],
        checkpoint=Path(root) / 'model.npz', num_workers=2,
        config=make_config(), device='cpu')
    return scalars


def mode_parallel4(root, out):
    """DP x CP on 4 ranks: rows over 'data', time over 'seq'."""
    data = inputs(root)
    config = make_config()
    mesh = parallel.make_mesh((2, 2), ('data', 'seq'))
    padded, true_frames = parallel.pad_frames_for_context(
        torch.from_numpy(data['cp_features_300']), config, 2)
    local = parallel.context.shard_frames(padded, mesh, 'seq', 'data')
    rows = parallel.batch_sharding(mesh, 'data').block(
        data['cp_lengths_300'])
    logits = parallel.context_parallel_chunked_forward(
        model(root), local, rows, mesh, 'seq', batch_axis='data',
        true_frames=true_frames)
    out['dpcp_local'] = logits.numpy()
    out['dpcp'] = parallel.context.gather_frames(
        logits, mesh, 'seq', 'data').numpy()
    return {}


def mode_multihost(root, out):
    """DP training over 2 ranks, its evaluation, and the helpers."""
    params = train_params(Path(root) / 'run2', make_config())
    out.update({f'params.{k}': v for k, v in params.items()})
    mesh = parallel.make_mesh((-1,), ('data',))
    whole = model(root)
    whole.load_state_dict(convert.model_params_from_jax(
        whole.config, params))
    scalars = train_core.evaluate_partition(
        None, 0, whole, whole.config, loader_fn, 'valid', mesh=mesh)

    from ppgs_tpu_torch.evaluate.metrics import Metrics

    logits, targets = metrics_batch()
    i = multihost.process_index()
    metrics = Metrics(config=make_config(), device='cpu')
    metrics.update(logits[i * 2:(i + 1) * 2], targets[i * 2:(i + 1) * 2])
    metrics.state = multihost.aggregate_across_processes(metrics.state)
    aggregated = {k: v for k, v in metrics().items()
                  if isinstance(v, (int, float))}
    out['local_slice'] = multihost.local_slice(np.arange(8) * 10)
    out['replicated'] = multihost.replicate_global(
        mesh, np.full(3, 10.0 * (i + 1)), 'cpu').numpy()
    rows = multihost.shard_global_batch(mesh, multihost.local_slice(
        np.arange(6)), device='cpu')
    out['placed'] = rows.numpy()
    return {'scalars': scalars, 'aggregated': aggregated,
            'process_count': multihost.process_count(),
            'is_primary': multihost.is_primary(),
            'shard_iterator': list(multihost.shard_iterator(range(7))),
            'any_one': multihost.any_process(i == 1),
            'any_none': multihost.any_process(False)}


def mode_train4(root, out):
    """DP training over 4 ranks (rank 3's rows all padding)."""
    params = train_params(Path(root) / 'run4', make_config())
    out.update({f'params.{k}': v for k, v in params.items()})
    return {}


def mode_train_tp(root, out):
    """Training with a 'model' axis of 2: the parameters and Adam's moments
    sharded, each layer gathered before it runs."""
    params = train_params(Path(root) / 'run_tp', make_config(
        mesh_shape=(2,), mesh_axis_names=('model',)))
    out.update({f'params.{k}': v for k, v in params.items()})
    return {'counts': {f'{k[0]}/{k[1]}': v
                       for k, v in comm.counts.items()}}


def mode_train_tp_resume(root, out):
    """New processes resume ``train_tp``'s run from its step-3 checkpoint
    (the gathered JAX layout) to step 6, each keeping its slices of the
    parameters and of Adam's moments."""
    params = train_params(Path(root) / 'run_tp', make_config(
        mesh_shape=(2,), mesh_axis_names=('model',)), 6)
    out.update({f'params.{k}': v for k, v in params.items()})
    return {}


def mode_train_pp(root, out):
    """Training with a 'pipe' axis of 2: the GPipe schedule in the step."""
    params = train_params(Path(root) / 'run_pp', make_config(
        mesh_shape=(2,), mesh_axis_names=('pipe',)))
    out.update({f'params.{k}': v for k, v in params.items()})
    return {'counts': {f'{k[0]}/{k[1]}': v
                       for k, v in comm.counts.items()}}


def mode_orbax_phase_a(root, out):
    """3 steps, orbax saves at 2 and 3 (collective), then exit."""
    config = make_config(checkpoint_backend='orbax', checkpoint_interval=2)
    train_params(Path(root) / 'orbax', config, 3)
    return {}


def mode_orbax_phase_b(root, out):
    """New processes resume from phase A's step 3 and run to step 6."""
    config = make_config(checkpoint_backend='orbax', checkpoint_interval=2)
    params = train_params(Path(root) / 'orbax', config, 6)
    out.update({f'params.{k}': v for k, v in params.items()})
    return {}


def mode_orbax_interrupt(root, out):
    """An endless run that the test stops with SIGTERM, at another moment
    on each rank; the ranks must agree on one saved step."""
    config = make_config(checkpoint_backend='orbax')
    directory = Path(root) / 'interrupted'
    train_params(directory, config, 10 ** 9, endless_loader)
    latest = train_core.latest_checkpoint(directory, 'orbax')
    return {'latest_step': None if latest is None else int(latest.name)}


def pipeline_grads(view, mesh, features, lengths, **kwargs):
    """(logits of this rank's rows, the parameters' gradients summed over
    the replicas) of ``square_loss`` over the global batch, as the train
    step reduces them; TP shards' gradients gathered whole."""
    module = getattr(view, 'module', view)
    module.zero_grad(set_to_none=True)
    n_pipe = mesh.shape['pipe']
    out = parallel.pipeline_forward(view, features, lengths, mesh, 'pipe',
                                    train=True, seed=0, **kwargs)
    # the global mean: this rank's rows' sum over every row's count
    loss = out.square().sum() / (features.shape[0] * out[0].numel())
    (loss / n_pipe).backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in module.named_parameters()}
    replicas = mesh.group(tuple(a for a in mesh.axis_names if a != 'model'))
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    comm.all_reduce_sum(flat, replicas)
    offset, whole = 0, {}
    dims = getattr(view, '_dims', {})
    for name, g in grads.items():
        g = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
        if name in dims:
            g = comm.gather_along(g.contiguous(), mesh.group('model'),
                                  *dims[name])
        whole[name] = g.numpy()
    return out.detach(), whole


def mode_pipeline(root, out):
    """PP on 2 stages: inference, gradients, dropout."""
    features, lengths = pipeline_inputs(root)
    mesh = parallel.make_mesh((2,), ('pipe',))
    net = model(root, 'pipeline.npz', pipeline_config(), grad=True)
    out['pp_forward'] = parallel.pipeline_forward(
        net, features, lengths, mesh, num_microbatches=4).numpy()
    out['pp_forward_m2'] = parallel.pipeline_forward(
        net, features, lengths, mesh).numpy()
    logits, grads = pipeline_grads(net, mesh, features, lengths,
                                   num_microbatches=4)
    out['pp_train'] = logits.numpy()
    out.update({f'pp_grad.{k}': v for k, v in grads.items()})
    drop = model(root, 'pipeline.npz', pipeline_config(dropout=0.1))
    for name, seed in (('a', 5), ('a2', 5), ('b', 6)):
        out[f'pp_dropout_{name}'] = parallel.pipeline_forward(
            drop, features, lengths, mesh, num_microbatches=4, train=True,
            seed=seed).detach().numpy()
    return {}


def mode_pipeline4(root, out):
    """DP x PP and TP x PP on 4 ranks."""
    features, lengths = pipeline_inputs(root)
    net = model(root, 'pipeline.npz', pipeline_config(), grad=True)
    dp = parallel.make_mesh((2, 2), ('data', 'pipe'))
    logits, grads = pipeline_grads(net, dp, features, lengths,
                                   batch_axis='data', num_microbatches=2)
    out['dppp_rows'] = parallel.pipeline.pipeline_rows(8, 2, dp, 'data')
    out['dppp'] = logits.numpy()
    out.update({f'dppp_grad.{k}': v for k, v in grads.items()})
    tp = parallel.make_mesh((2, 2), ('pipe', 'model'))
    local = model(root, 'pipeline.npz', pipeline_config(), grad=True)
    view = parallel.shard_module(local, parallel.w2v2_module_dims(local),
                                 tp, 'model')
    logits, grads = pipeline_grads(view, tp, features, lengths,
                                   tp_axis='model')
    out['tppp'] = logits.numpy()
    out.update({f'tppp_grad.{k}': v for k, v in grads.items()})
    return {'tppp_bytes': [parallel.local_bytes(local, set(view._dims)),
                           parallel.local_bytes(local)]}


MODES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith('mode_')}


@contextlib.contextmanager
def one_thread():
    """The workers' one intra-op thread, for the single-process side of a
    comparison: CPU convs and products sum in another order on more
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def quiet(patch):
    """No tensorboard (which imports TensorFlow where it is installed: the
    scalar writer keeps metrics.jsonl only) and no evaluation figures, on
    ``patch`` (a pytest MonkeyPatch)."""
    patch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    patch.setattr(train_core, 'figures_available', lambda: False)


def main():
    import pytest

    mode, root = sys.argv[1], Path(sys.argv[2])
    quiet(pytest.MonkeyPatch())
    torch.set_num_threads(1)
    multihost.initialize(device='cpu')
    rank = multihost.process_index()
    out = {}
    scalars = MODES[mode](root, out)
    np.savez(root / f'{mode}-rank{rank}.npz', **out)
    with open(root / f'{mode}-rank{rank}.json', 'w') as file:
        json.dump(scalars, file)
    multihost.shutdown()


###############################################################################
# Launching, for the tests
###############################################################################


def free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def launch(mode, root, ranks, env=None):
    """Start ``ranks`` processes of ``mode`` on a fresh gloo group."""
    port = free_port()
    procs = []
    for rank in range(ranks):
        child = dict(os.environ, PYTHONPATH=str(REPO),
                     PPGS_COORDINATOR=f'127.0.0.1:{port}',
                     PPGS_NUM_PROCESSES=str(ranks),
                     PPGS_PROCESS_ID=str(rank), **(env or {}))
        child.pop('PYTEST_XDIST_WORKER', None)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), mode,
             str(root)], env=child, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def wait(procs, timeout=TIMEOUT):
    """Wait for every rank (killing all at ``timeout``); raise with a
    failed rank's output."""
    deadline = time.time() + timeout
    outputs = []
    for proc in procs:
        try:
            output, _ = proc.communicate(
                timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        outputs.append(output.decode(errors='replace'))
    for proc, output in zip(procs, outputs):
        if proc.returncode != 0:
            raise AssertionError(
                f'rank failed (rc {proc.returncode}):\n{output[-6000:]}')
    return outputs


def results(mode, root, ranks):
    """[(arrays, scalars)] of each rank of a finished mode."""
    found = []
    for rank in range(ranks):
        with np.load(Path(root) / f'{mode}-rank{rank}.npz') as data:
            arrays = {k: data[k] for k in data.files}
        with open(Path(root) / f'{mode}-rank{rank}.json') as file:
            found.append((arrays, json.load(file)))
    return found


def terminate(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)


if __name__ == '__main__':
    main()
