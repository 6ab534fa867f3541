"""Training loop (reference: ppgs/train/core.py:17-386).

Counterpart of ``ppgs_tpu/train/core.py``: the masked cross-entropy loss,
Adam (``torch.optim.Adam``, whose update is optax.adam's), a train step
with the reference's conditional gradient clipping, checkpoints in the JAX
package's layout (npz, or the orbax backend's asynchronous collective step
directories), scalar logs (and the evaluation's figures in tensorboard),
and the loop with evaluation, checkpointing and save-on-interrupt. bf16
products replace the reference's fp16 GradScaler (bf16 needs no loss
scaling).

The train step's forward is the model's own (``models.get(config)``) with
``train=True, seed=...``: the transformer's runs the train kernels on the
card and their plain versions on the CPU; the W2V2 model's
(``config='w2v2ft'``) is plain PyTorch, as the JAX package's reaches no
kernel, with its feature encoder frozen. Dropout (and wav2vec2's
spec-augment and LayerDrop) is drawn from the Philox stream of a per-step
seed. The encodec and dac configs' int codes are dequantized to latents
inside the step and the evaluation pass (``frontend.py``).

Without a ``loader_fn`` the batches come from the data loader over the
dataset's cached features (``data/loader.py``, the JAX package's batches
index for index, the sampler re-seeded each epoch).

Several processes (``parallel.multihost``: the ``PPGS_*`` variables, NCCL
on cards, gloo on the CPU) train on the config's mesh
(``config.mesh_shape`` / ``mesh_axis_names``), as in the JAX package:

- 'data': every process materialises the same global batch, padded to
  data x pipe rows (targets with -100), and keeps its block. The gradient
  is the global batch's: each rank's loss is its weighted numerator over
  the denominator summed across the data group (an all-reduce before the
  backward), and the gradients (with the loss) are summed in one
  all-reduce after it; clipping then sees the global norm, as the single
  process does. One rank in a group runs the same arithmetic, bit for
  bit;
- 'model': the parameters and Adam's moments stay sharded by the w2v2
  rule (``parallel.shard_module``); a layer's shards are all-gathered
  before its kernels run on the whole weight;
- 'pipe': the forward is the GPipe schedule (``parallel.pipeline``);
  each stage backpropagates 1 / stages of the replicated loss, and the
  gradient all-reduce over the stages sums the stages' parts.

Rank 0 writes the scalars and the npz checkpoints; the orbax backend's
saves are collective. A SIGTERM sets a flag that the processes OR
together every ``STOP_POLL_INTERVAL`` steps, so that all of them stop, and
save, at one step.
"""

import json
import signal
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import config as config_mod
from .. import convert
from .. import devices
from .. import frontend as frontend_mod
from .. import load as load_mod
from .. import models
from .. import parallel
from ..evaluate.metrics import Metrics, close_figures, figures_available
from ..parallel import comm, multihost
from ..utils import notify as _notify_mod
from . import checkpoint as ckpt

LOG_INTERVAL = 100      # steps between logs of the loss and gradient stats
# Steps between the processes' polls of the stop flag (a blocking host
# collective that every process joins at the same steps)
STOP_POLL_INTERVAL = 25


###############################################################################
# Loss
###############################################################################


def _weighted_nll(logits, targets, class_weights):
    """(per-frame nll, weights, valid) of the masked cross-entropy."""
    num_classes = logits.shape[1]
    flat_logits = logits.transpose(1, 2).reshape(-1, num_classes).float()
    flat_targets = targets.reshape(-1)
    valid = flat_targets != -100
    safe_targets = torch.where(valid, flat_targets,
                               torch.zeros_like(flat_targets))
    log_probs = F.log_softmax(flat_logits, dim=-1)
    nll = -log_probs.gather(1, safe_targets[:, None])[:, 0]
    if class_weights is not None:
        weights = class_weights[safe_targets] * valid
    else:
        weights = valid.to(nll.dtype)
    return nll, weights, valid


def loss(logits, targets, config=None, class_weights=None, reduction='mean'):
    """Masked cross-entropy (reference ppgs/train/core.py:373-386).

    logits: (B, C, T); targets: (B, T) int with -100 = ignore."""
    nll, weights, valid = _weighted_nll(logits, targets, class_weights)
    total = (nll * weights).sum()
    if reduction == 'sum':
        return total
    if reduction == 'mean':
        return total / weights.sum().clamp_min(1e-9)
    if reduction in ('none', None):
        return torch.where(valid, nll, torch.zeros_like(nll))
    raise ValueError(f'Reduction {reduction} not defined')


###############################################################################
# Train step
###############################################################################


def make_optimizer(params, config):
    """Adam at config.learning_rate with optax.adam's defaults (betas 0.9,
    0.999, eps 1e-8): the same update as the JAX package's optimizer."""
    return torch.optim.Adam(params, lr=config.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def gradient_stats(grads, sharded=None, group=None):
    """L2 norm / max / min over all gradients (replaces
    torchutil.gradients.stats). ``sharded`` marks the gradients of TP
    shards, whose parts are reduced over ``group``."""
    if group is None:
        return {'gradients/norm': _grad_l2_norm(grads),
                'gradients/max': torch.stack([g.max() for g in grads]).max(),
                'gradients/min': torch.stack([g.min() for g in grads]).min()}
    high = torch.stack([g.max() for g in grads]).max()
    low = torch.stack([g.min() for g in grads]).min()
    extremes = torch.stack([high, -low]).float()
    comm.all_reduce_max(extremes, group, 'gradient_stats')
    return {'gradients/norm': _grad_l2_norm(grads, sharded, group),
            'gradients/max': extremes[0], 'gradients/min': -extremes[1]}


def _grad_l2_norm(grads, sharded=None, group=None):
    if group is None:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    parts = torch.stack([
        sum(g.float().square().sum() for g, s in zip(grads, sharded) if s),
        sum(g.float().square().sum() for g, s in zip(grads, sharded)
            if not s)])
    whole = parts[1].clone()
    comm.all_reduce_sum(parts, group, 'gradient_stats')
    return torch.sqrt(parts[0] + whole)


def _grad_max_abs(grads, group=None):
    value = torch.stack([g.float().abs().max() for g in grads]).max()
    if group is not None:
        value = comm.all_reduce_max(value.reshape(1), group,
                                    'gradient_stats')[0]
    return value


def _mesh_groups(mesh):
    """(data group, the group the gradients are summed over: every axis but
    'model', TP group or None) of a mesh (all None without one)."""
    if mesh is None:
        return None, None, None
    replicas = tuple(a for a in mesh.axis_names if a != 'model')
    tp = mesh.group('model') if mesh.shape.get('model', 1) > 1 else None
    return mesh.group('data'), mesh.group(replicas), tp


def make_train_step(model, config, optimizer, class_weights=None,
                    mesh=None):
    """The train step: forward in train mode, masked CE, backward, the
    conditional clipping of ``ppgs_tpu/train/core.py:149-163``, and the
    optimizer update, in place on ``model`` and ``optimizer``.

    ``step(features, targets, lengths, seed, with_stats=False)`` returns
    (loss, stats): the full gradient statistics only when ``with_stats``
    (logging steps); clipping reuses them then, as the JAX step does.

    A parameter that the step gives no gradient (the frozen feature
    convs, a layer that LayerDrop skipped) gets zeros, as in JAX's
    gradient tree: they count in the statistics, and Adam updates its
    moments with them, which leaves a frozen weight bit for bit as it
    was.

    With a ``mesh`` (``train`` passes the config's), the step's rows are
    this rank's (the loop cuts them; with a 'pipe' axis the pipeline cuts
    each microbatch's rows itself and ``targets`` are the global batch's),
    the loss is the global batch's and the gradients are summed over the
    replicas (module docstring); ``model`` is a ``parallel.TPView`` when
    the mesh has a 'model' axis."""
    clip_l2 = config.gradient_clip_threshold_l2
    clip_inf = config.gradient_clip_threshold_inf
    params = list(model.parameters())
    # Codebook FRONTEND: encodec / dac batches are int codes (cast to fp32
    # by _to_device), dequantized inside the step (reference
    # ppgs/train/core.py:115-119); the codebooks are constants
    codebook_frontend = frontend_mod.maybe_frontend(config)
    data_group, replica_group, tp_group = _mesh_groups(mesh)
    n_pipe = mesh.shape.get('pipe', 1) if mesh is not None else 1
    pipe_rows_axis = ('data' if mesh is not None
                      and mesh.shape.get('data', 1) > 1 else None)
    # The Philox masks are keyed by a row's index in the rank's batch: the
    # data ranks draw from streams of their own (rank 0's is the single
    # process's), lest every rank drop the same elements of its rows
    seed_offset = (0 if mesh is None else
                   (mesh.index('data') * 0x9E3779B97F4A7C15) % 2 ** 62)
    shard_ids = set()
    if tp_group is not None:
        module = model.module
        names = dict(module.named_parameters())
        shard_ids = {id(names[n]) for n in model._dims if n in names}
    sharded = [id(p) in shard_ids for p in params]

    def step(features, targets, lengths, seed, with_stats=False):
        if seed_offset:
            seed = (seed + seed_offset) % 2 ** 62
        if codebook_frontend is not None:
            with torch.no_grad():
                features = codebook_frontend(features)
        optimizer.zero_grad(set_to_none=True)
        if n_pipe > 1:
            logits = parallel.pipeline_forward(
                model, features, lengths, mesh, 'pipe',
                batch_axis=pipe_rows_axis, train=True, seed=seed)
            targets = targets[parallel.pipeline.pipeline_rows(
                features.shape[0], n_pipe, mesh, pipe_rows_axis).to(
                    targets.device)]
        else:
            logits = model(features, lengths, train=True, seed=seed)
        nll, weights, _ = _weighted_nll(logits, targets, class_weights)
        total = (nll * weights).sum()
        # The global batch's denominator: the data group's sum
        denominator = weights.sum()
        if data_group is not None:
            denominator = comm.all_reduce_sum(
                denominator.detach().clone(), data_group, 'loss_denominator')
        train_loss = total / denominator.clamp_min(1e-9)
        if n_pipe > 1:
            # every stage holds the same loss; the drain's backward sums
            # the stages' gradients at the last stage
            train_loss = train_loss / n_pipe
        train_loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        train_loss = train_loss.detach()
        if replica_group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [train_loss.reshape(1).to(grads[0].dtype)])
            comm.all_reduce_sum(flat, replica_group, 'gradients')
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            train_loss = flat[-1]
        stats = (gradient_stats(grads, sharded, tp_group) if with_stats
                 else {})
        with torch.no_grad():
            if clip_l2 is not None:
                norm = (stats['gradients/norm'] if with_stats
                        else _grad_l2_norm(grads, sharded, tp_group))
                scale = torch.clamp(clip_l2 / (norm + 1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale)
            if clip_inf is not None:
                if with_stats:
                    max_abs = torch.maximum(stats['gradients/max'].abs(),
                                            stats['gradients/min'].abs())
                else:
                    max_abs = _grad_max_abs(grads, tp_group)
                scale = torch.clamp(clip_inf / (max_abs + 1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale)
        optimizer.step()
        return train_loss, stats

    return step


###############################################################################
# Checkpointing
###############################################################################


BACKENDS = ('npz', 'orbax')


def _check_backend(backend):
    if backend not in BACKENDS:
        raise NotImplementedError(
            f'checkpoint backend {backend!r}: the backends are npz and '
            f'orbax')


def _full_tensors(module, tensors, dims, group):
    """{parameter name: whole tensor} from ``tensors`` ({name: this rank's
    tensor}), the TP shards in ``dims`` gathered over ``group``
    (collective)."""
    out = {}
    for name, tensor in tensors.items():
        if name in dims and group is not None:
            tensor = comm.gather_along(tensor.detach().contiguous(), group,
                                       *dims[name])
        out[name] = tensor.detach()
    return out


def _flat_state(model, optimizer, dims=None, group=None):
    """The flat JAX-layout checkpoint arrays of ``model`` and its Adam
    state: params.*, opt_state.count, opt_state.mu.*, opt_state.nu.*.
    With ``dims`` the TP shards are gathered first (collective)."""
    dims = dims or {}
    named = dict(model.named_parameters())
    count, mu, nu = 0, {}, {}
    for name, param in named.items():
        state = optimizer.state.get(param, {})
        if state:
            count = int(state['step'])
        mu[name] = state.get('exp_avg', torch.zeros_like(param))
        nu[name] = state.get('exp_avg_sq', torch.zeros_like(param))
    whole = {k: _full_tensors(model, v, dims, group)
             for k, v in (('params', named), ('mu', mu), ('nu', nu))}
    flat = {f'params.{k}': v for k, v in convert.model_params_to_jax(
        model.config, whole['params']).items()}
    flat['opt_state.count'] = np.asarray(count, np.int32)
    for moment in ('mu', 'nu'):
        flat.update({f'opt_state.{moment}.{k}': v for k, v in
                     convert.model_params_to_jax(model.config,
                                                 whole[moment]).items()})
    return flat


def checkpoint_state(directory, step, epoch, model, optimizer,
                     backend='npz'):
    """Save a training checkpoint in the JAX layout: {step:08d}.npz, or the
    orbax backend's step directory {step}/ (collective, written off this
    thread: ``checkpoint.wait_until_finished``)."""
    _check_backend(backend)
    flat = _flat_state(model, optimizer)
    if backend == 'orbax':
        return ckpt.orbax_save(directory, step, epoch, flat)
    return ckpt.npz_save(directory, step, epoch, flat)


def latest_checkpoint(directory, backend='npz'):
    _check_backend(backend)
    if backend == 'orbax':
        return ckpt.orbax_latest(directory)
    return ckpt.npz_latest(directory)


def _restore(path, backend):
    _check_backend(backend)
    if backend == 'orbax':
        ckpt.wait_until_finished(Path(path).parent)
        return ckpt.orbax_restore(path)
    return ckpt.npz_restore(path)


def _part(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def load_checkpoint(path, model, optimizer, backend='npz'):
    """Restore the parameters into ``model`` and the Adam state into
    ``optimizer`` from a checkpoint of either package; returns
    (step, epoch)."""
    flat, step, epoch = _restore(path, backend)
    _load_params(model, flat)
    convert.adam_state_from_jax(model, optimizer,
                                int(flat['opt_state.count']),
                                _part(flat, 'opt_state.mu.'),
                                _part(flat, 'opt_state.nu.'))
    return step, epoch


def _load_params(model, flat):
    state = convert.model_params_from_jax(model.config,
                                          _part(flat, 'params.'))
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(state[name])
    convert.prepare_model(model)


def _load_sharded_adam(model, optimizer, flat, dims, group):
    """Adam's moments of a checkpoint into the optimizer of a TP-sharded
    ``model``: each rank keeps its slices, as of the parameters."""
    count = int(flat['opt_state.count'])
    moments = {m: convert.model_params_from_jax(
        model.config, _part(flat, f'opt_state.{m}.')) for m in ('mu', 'nu')}
    for name, param in model.named_parameters():
        def local(tensor):
            if name in dims:
                tensor = comm.block_of(tensor, group, *dims[name])
            return tensor.to(param.device, param.dtype).clone()

        optimizer.state[param] = {
            'step': torch.tensor(float(count)),
            'exp_avg': local(moments['mu'][name]),
            'exp_avg_sq': local(moments['nu'][name])}


###############################################################################
# Scalars log
###############################################################################


class ScalarWriter:
    """Training metrics sink: metrics.jsonl, and tensorboard event files
    beside it when torch.utils.tensorboard can be used (the reference logs
    to tensorboard, ppgs/train/core.py:141-145, 354-365)."""

    def __init__(self, directory):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.path = self.directory / 'metrics.jsonl'
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=str(self.directory))
        except ImportError:
            pass    # tensorboard not installed: metrics.jsonl only
        except Exception as error:
            import warnings
            warnings.warn(
                'tensorboard mirroring disabled: SummaryWriter failed '
                f'({type(error).__name__}: {error}); metrics are still '
                'written to metrics.jsonl')

    def update(self, step, scalars, figures=None):
        """Append the scalars to metrics.jsonl; mirror them and the
        matplotlib ``figures`` ({tag: figure}) to tensorboard."""
        record = {'step': int(step), 'time': time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, 'a') as file:
            file.write(json.dumps(record) + '\n')
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(key, float(value), int(step))
            for key, figure in (figures or {}).items():
                self._tb.add_figure(key, figure, int(step))
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()


###############################################################################
# Training
###############################################################################


def init_model(config, device, generator=None):
    """config.model's module (``models.build``) with its init's random
    parameters on ``device``, drawn from ``generator`` (seeded by
    config.random_seed when None), its compute-dtype copies prepared (the
    W2V2 model's conv-stack weights among them: its feature convs are
    frozen)."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.random_seed)
    params = models.get(config)[0](config, generator)
    model = models.build(config)
    model.load_state_dict(convert.model_params_from_jax(
        config, load_mod.flatten_params(params)))
    convert.prepare_model(model)
    return model.to(device)


def _to_device(batch, device):
    """(features, targets, lengths), numpy arrays or tensors, on device."""
    return tuple(torch.as_tensor(array).to(device=device, dtype=dtype)
                 for array, dtype in zip(batch[:3], (torch.float32,
                                                     torch.int64,
                                                     torch.int64)))


@_notify_mod.notify('train')
def train(dataset=None, directory=None, config=None, max_steps=None,
          loader_fn=None, device=None, mesh=None):
    """Train a model (reference ppgs/train/core.py:18-281); returns the
    trained model (whole on every rank).

    ``loader_fn(partition) -> iterable of (features, targets, lengths)``
    supplies the batches ('train' and 'valid') when given; otherwise they
    come from the data loader over ``dataset``'s cached features
    (``config.training_dataset`` when None), its train sampler set to each
    epoch as in the JAX package. ``device``: None means 'cuda' and raises
    without one, before any file is read. Resumes from the latest checkpoint in
    ``directory``; the per-step dropout seeds come from a torch.Generator
    seeded by config.random_seed and advanced past the steps already
    taken, so a resumed run draws what an uninterrupted one would. The
    loss and the gradient statistics are logged every ``LOG_INTERVAL``
    steps, as in the JAX package.

    ``multihost.initialize()`` brings up the process group of the
    ``PPGS_*`` variables (a no-op without them), and the run takes the
    config's mesh over the ranks (or ``mesh``): the module docstring says
    how each axis splits the work."""
    config = config_mod.get(config)
    device = devices.resolve(device)
    if config.model == 'transformer':
        # raises for a width the card's train kernels do not take yet
        models.transformer.use_kernels(config, device)
    backend = config.checkpoint_backend
    _check_backend(backend)
    multihost.initialize(device=device)
    if mesh is None:
        mesh = multihost.make_hybrid_mesh(config.mesh_shape,
                                          config.mesh_axis_names)
    n_data, n_pipe = mesh.shape.get('data', 1), mesh.shape.get('pipe', 1)
    tp_group = mesh.group('model') if mesh.shape.get('model', 1) > 1 \
        else None
    # Each pipeline stage ingests whole microbatches, themselves split
    # over the data axis: batches pad to data x pipe rows
    batch_multiple = n_data * n_pipe
    directory = Path(directory or config_mod.RUNS_DIR / config.config)
    directory.mkdir(parents=True, exist_ok=True)
    steps = max_steps or config.steps

    train_sampler = None
    if loader_fn is None:
        from ..data import loader as data_loader

        loaders = {partition: data_loader(
            dataset or config.training_dataset, partition, config=config)
            for partition in ('train', 'valid')}
        train_sampler = loaders['train'].batch_sampler

        def loader_fn(partition):
            return iter(loaders[partition])

    model = init_model(config, device)
    latest = latest_checkpoint(directory, backend)
    restored = _restore(latest, backend) if latest is not None else None
    if restored is not None:
        _load_params(model, restored[0])
    dims, runner = {}, model
    if tp_group is not None:
        dims = parallel.w2v2_module_dims(model)
        runner = parallel.shard_module(model, dims, mesh, 'model')
    optimizer = make_optimizer(model.parameters(), config)
    step, epoch = 0, 0
    if restored is not None:
        flat, step, epoch = restored
        if tp_group is not None:
            _load_sharded_adam(model, optimizer, flat, dims, tp_group)
        else:
            convert.adam_state_from_jax(
                model, optimizer, int(flat['opt_state.count']),
                _part(flat, 'opt_state.mu.'), _part(flat, 'opt_state.nu.'))
    class_weights = (load_mod.phoneme_weights(config, device)
                     if config.class_balanced else None)
    step_fn = make_train_step(runner, config, optimizer, class_weights, mesh)
    seeds = torch.Generator().manual_seed(config.random_seed)

    def next_seed():
        return int(torch.randint(0, 2 ** 62, (1,), generator=seeds))

    for _ in range(step):
        next_seed()

    def whole_model():
        """The model with whole weights (collective under TP)."""
        if tp_group is None:
            return model
        whole = models.build(config)
        whole.load_state_dict(_full_tensors(
            model, dict(model.named_parameters()), dims, tp_group))
        convert.prepare_model(whole)
        return whole.to(device)

    def save(step, epoch):
        flat = _flat_state(model, optimizer, dims, tp_group)
        if backend == 'orbax':
            ckpt.orbax_save(directory, step, epoch, flat)
        elif multihost.is_primary():
            ckpt.npz_save(directory, step, epoch, flat)

    # Host side effects (metric logs, npz checkpoints) belong to rank 0
    writer = ScalarWriter(directory) if multihost.is_primary() else None

    # SIGTERM (preemption) takes the save-on-interrupt path of Ctrl-C. With
    # several processes the handler only sets a flag: the signal lands on
    # each at another moment, and the processes agree on the stop through
    # an OR every STOP_POLL_INTERVAL steps, so that all save one step
    stop_requested = [False]
    coordinated_stop = multihost.process_count() > 1

    def _preempted(signum, frame):
        if coordinated_stop:
            stop_requested[0] = True
        else:
            raise KeyboardInterrupt(f'signal {signum}')

    try:
        previous_handler = signal.signal(signal.SIGTERM, _preempted)
    except ValueError:          # not the main thread
        previous_handler = None

    try:
        while step < steps:
            if train_sampler is not None:
                train_sampler.set_epoch(epoch)
            for batch in loader_fn('train'):
                if batch_multiple > 1:
                    # Every process holds the same global batch and feeds
                    # its block (a pipeline cuts its microbatches' rows)
                    batch = parallel.pad_batch_to_multiple(
                        tuple(_host(b) for b in batch[:3]), batch_multiple,
                        fill=(0, -100, 0))
                    if n_pipe == 1:
                        batch = parallel.shard_batch(mesh, batch, 'data')
                features, targets, lengths = _to_device(batch, device)
                log_step = step % LOG_INTERVAL == 0
                train_loss, stats = step_fn(features, targets, lengths,
                                            next_seed(), with_stats=log_step)
                if log_step and writer is not None:
                    scalars = {'train/loss': float(train_loss)}
                    scalars.update({k: float(v) for k, v in stats.items()})
                    writer.update(step, scalars)
                if step % config.evaluation_interval == 0:
                    evaluate_partition(
                        writer, step, whole_model(), config, loader_fn,
                        'valid', config.default_evaluation_steps, mesh)
                if step and step % config.checkpoint_interval == 0:
                    save(step, epoch)
                step += 1
                if (coordinated_stop and step % STOP_POLL_INTERVAL == 0
                        and multihost.any_process(stop_requested[0])):
                    raise KeyboardInterrupt('coordinated multi-process stop')
                if step >= steps:
                    break
            epoch += 1
    except KeyboardInterrupt:
        pass
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
        save(step, epoch)
        if backend == 'orbax':
            ckpt.wait_until_finished(directory)
        if writer is not None:
            writer.close()
    return whole_model()


def _host(array):
    """A batch array as numpy (a tensor comes to the host)."""
    if isinstance(array, torch.Tensor):
        return array.cpu().numpy()
    return np.asarray(array)


def evaluate_partition(writer, step, model, config, loader_fn, partition,
                       evaluation_steps=None, mesh=None):
    """Evaluation pass writing metric scalars and figures (reference
    train/core.py:288-365): the model's inference forward on its current
    parameters (``convert.prepare_model`` rebuilds its prepared weights
    first: they are a snapshot, stale after any optimizer step), after the
    codebook frontend for the encodec and dac configs. The confusion and
    distance figures go to tensorboard beside the scalars, as the JAX
    package's do, where matplotlib imports, and are closed after use.

    With a ``mesh`` each rank evaluates its block of every batch (padded
    to the data axis with -100 targets), and the metric sums are summed
    over the data group: the exact global metrics on every rank."""
    device = next(model.parameters()).device
    convert.prepare_model(model)
    codebook_frontend = frontend_mod.maybe_frontend(config)
    metrics = Metrics(include_figures=figures_available()
                      and multihost.is_primary(), config=config,
                      device=device)
    n_data = mesh.shape.get('data', 1) if mesh is not None else 1
    for i, batch in enumerate(loader_fn(partition)):
        if n_data > 1:
            batch = parallel.pad_batch_to_multiple(
                tuple(_host(b) for b in batch[:3]), n_data,
                fill=(0, -100, 0))
            batch = parallel.shard_batch(mesh, batch, 'data')
        features, targets, lengths = _to_device(batch, device)
        with torch.no_grad():
            if codebook_frontend is not None:
                features = codebook_frontend(features)
            logits = model(features, lengths)
        metrics.update(logits, targets)
        if evaluation_steps is not None and i + 1 == evaluation_steps:
            break
    if n_data > 1:
        metrics.state = multihost.aggregate_across_processes(
            metrics.state, mesh.group('data'))
    results = metrics()
    scalars = {f'{partition}/{k}': v for k, v in results.items()
               if isinstance(v, (int, float))}
    figures = {f'{partition}/{k}': v for k, v in results.items()
               if not isinstance(v, (int, float))}
    if writer is not None:
        writer.update(step, scalars, figures)
    close_figures(figures.values())
    return scalars
