"""Training loop (reference: ppgs/train/core.py:17-386), one device.

Counterpart of ``ppgs_tpu/train/core.py``: the masked cross-entropy loss,
Adam (``torch.optim.Adam``, whose update is optax.adam's), a train step
with the reference's conditional gradient clipping, npz checkpoints in the
JAX package's layout, scalar logs, and the loop with evaluation,
checkpointing and save-on-interrupt. bf16 products replace the
reference's fp16 GradScaler (bf16 needs no loss scaling).

The train step's forward is ``models.transformer.forward(..., train=True,
seed=...)``: the train kernels on the card, their plain versions on the
CPU, with dropout drawn from the Philox stream of a per-step seed.

Without a ``loader_fn`` the batches come from the data loader over the
dataset's cached features (``data/loader.py``, the JAX package's batches
index for index, the sampler re-seeded each epoch). Not ported here
(ROADMAP.md): meshes and multi-device parallelism (A14), the orbax backend
(A8), the codebook frontend inside the step (A12) and the figures of the
evaluation pass (A13).
"""

import json
import signal
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from .. import config as config_mod
from .. import convert
from .. import devices
from .. import load as load_mod
from .. import models
from ..evaluate.metrics import Metrics
from ..utils import notify as _notify_mod
from . import checkpoint as ckpt

LOG_INTERVAL = 100      # steps between logs of the loss and gradient stats


###############################################################################
# Loss
###############################################################################


def loss(logits, targets, config=None, class_weights=None, reduction='mean'):
    """Masked cross-entropy (reference ppgs/train/core.py:373-386).

    logits: (B, C, T); targets: (B, T) int with -100 = ignore."""
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


def gradient_stats(grads):
    """L2 norm / max / min over all gradients (replaces
    torchutil.gradients.stats)."""
    return {'gradients/norm': _grad_l2_norm(grads),
            'gradients/max': torch.stack([g.max() for g in grads]).max(),
            'gradients/min': torch.stack([g.min() for g in grads]).min()}


def _grad_l2_norm(grads):
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def _grad_max_abs(grads):
    return torch.stack([g.float().abs().max() for g in grads]).max()


def make_train_step(model, config, optimizer, class_weights=None):
    """The train step: forward in train mode, masked CE, backward, the
    conditional clipping of ``ppgs_tpu/train/core.py:149-163``, and the
    optimizer update, in place on ``model`` and ``optimizer``.

    ``step(features, targets, lengths, seed, with_stats=False)`` returns
    (loss, stats): the full gradient statistics only when ``with_stats``
    (logging steps); clipping reuses them then, as the JAX step does."""
    clip_l2 = config.gradient_clip_threshold_l2
    clip_inf = config.gradient_clip_threshold_inf
    params = [p for p in model.parameters() if p.requires_grad]

    def step(features, targets, lengths, seed, with_stats=False):
        optimizer.zero_grad(set_to_none=True)
        logits = model(features, lengths, train=True, seed=seed)
        train_loss = loss(logits, targets, config, class_weights)
        train_loss.backward()
        grads = [p.grad for p in params]
        stats = gradient_stats(grads) if with_stats else {}
        with torch.no_grad():
            if clip_l2 is not None:
                norm = (stats['gradients/norm'] if with_stats
                        else _grad_l2_norm(grads))
                scale = torch.clamp(clip_l2 / (norm + 1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale)
            if clip_inf is not None:
                if with_stats:
                    max_abs = torch.maximum(stats['gradients/max'].abs(),
                                            stats['gradients/min'].abs())
                else:
                    max_abs = _grad_max_abs(grads)
                scale = torch.clamp(clip_inf / (max_abs + 1e-12), max=1.0)
                for g in grads:
                    g.mul_(scale)
        optimizer.step()
        return train_loss.detach(), stats

    return step


###############################################################################
# Checkpointing
###############################################################################


def _check_backend(backend):
    if backend != 'npz':
        raise NotImplementedError(
            f'checkpoint backend {backend!r}: ppgs_tpu_torch ports the npz '
            f'backend only (orbax is queued in ROADMAP.md A8)')


def checkpoint_state(directory, step, epoch, model, optimizer,
                     backend='npz'):
    """Save a training checkpoint, {step:08d}.npz in the JAX layout."""
    _check_backend(backend)
    adam = convert.adam_state_to_jax(model, optimizer)
    flat = {f'params.{k}': v for k, v in
            convert.params_to_jax(model.state_dict()).items()}
    flat['opt_state.count'] = adam['count']
    for moment in ('mu', 'nu'):
        flat.update({f'opt_state.{moment}.{k}': v
                     for k, v in adam[moment].items()})
    return ckpt.npz_save(directory, step, epoch, flat)


def latest_checkpoint(directory, backend='npz'):
    _check_backend(backend)
    return ckpt.npz_latest(directory)


def load_checkpoint(path, model, optimizer, backend='npz'):
    """Restore the parameters into ``model`` and the Adam state into
    ``optimizer`` from a checkpoint of either package; returns
    (step, epoch)."""
    _check_backend(backend)
    flat, step, epoch = ckpt.npz_restore(path)

    def part(prefix):
        return {k[len(prefix):]: v for k, v in flat.items()
                if k.startswith(prefix)}

    state = convert.params_from_jax(part('params.'))
    with torch.no_grad():
        for name, param in model.named_parameters():
            param.copy_(state[name])
    convert.adam_state_from_jax(model, optimizer,
                                int(flat['opt_state.count']),
                                part('opt_state.mu.'), part('opt_state.nu.'))
    return step, epoch


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

    def update(self, step, scalars):
        record = {'step': int(step), 'time': time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, 'a') as file:
            file.write(json.dumps(record) + '\n')
        if self._tb is not None:
            for key, value in scalars.items():
                self._tb.add_scalar(key, float(value), int(step))
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()


###############################################################################
# Training
###############################################################################


def init_model(config, device, generator=None):
    """A Transformer for ``config`` with the init's random parameters on
    ``device``, drawn from ``generator`` (seeded by config.random_seed when
    None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(config.random_seed)
    params = models.transformer.init(config, generator)
    model = models.transformer.Transformer(config)
    model.load_state_dict(convert.params_from_jax(
        load_mod.flatten_params(params)))
    return model.to(device)


def _to_device(batch, device):
    """(features, targets, lengths), numpy arrays or tensors, on device."""
    return tuple(torch.as_tensor(array).to(device=device, dtype=dtype)
                 for array, dtype in zip(batch[:3], (torch.float32,
                                                     torch.int64,
                                                     torch.int64)))


@_notify_mod.notify('train')
def train(dataset=None, directory=None, config=None, max_steps=None,
          loader_fn=None, device=None):
    """Train a model (reference ppgs/train/core.py:18-281) on one device;
    returns the trained model.

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
    steps, as in the JAX package."""
    config = config_mod.get(config)
    config_mod.require_no_frontend(config)
    device = devices.resolve(device)
    # raises for a width the card's train kernels do not take yet
    models.transformer.use_kernels(config, device)
    _check_backend(config.checkpoint_backend)
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
    optimizer = make_optimizer(model.parameters(), config)
    class_weights = (load_mod.phoneme_weights(config, device)
                     if config.class_balanced else None)
    step_fn = make_train_step(model, config, optimizer, class_weights)

    latest = latest_checkpoint(directory)
    step, epoch = (load_checkpoint(latest, model, optimizer)
                   if latest is not None else (0, 0))
    seeds = torch.Generator().manual_seed(config.random_seed)

    def next_seed():
        return int(torch.randint(0, 2 ** 62, (1,), generator=seeds))

    for _ in range(step):
        next_seed()

    writer = ScalarWriter(directory)

    # SIGTERM (preemption) takes the same save-on-interrupt path as Ctrl-C
    def _preempted(signum, frame):
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
                features, targets, lengths = _to_device(batch, device)
                log_step = step % LOG_INTERVAL == 0
                train_loss, stats = step_fn(features, targets, lengths,
                                            next_seed(), with_stats=log_step)
                if log_step:
                    scalars = {'train/loss': float(train_loss)}
                    scalars.update({k: float(v) for k, v in stats.items()})
                    writer.update(step, scalars)
                if step % config.evaluation_interval == 0:
                    evaluate_partition(
                        writer, step, model, config, loader_fn, 'valid',
                        config.default_evaluation_steps)
                if step and step % config.checkpoint_interval == 0:
                    checkpoint_state(directory, step, epoch, model,
                                     optimizer)
                step += 1
                if step >= steps:
                    break
            epoch += 1
    except KeyboardInterrupt:
        pass
    finally:
        if previous_handler is not None:
            signal.signal(signal.SIGTERM, previous_handler)
        checkpoint_state(directory, step, epoch, model, optimizer)
        writer.close()
    return model


def evaluate_partition(writer, step, model, config, loader_fn, partition,
                       evaluation_steps=None):
    """Evaluation pass writing metric scalars (reference
    train/core.py:288-365): the inference forward on ``model``'s current
    parameters (``convert.prepare`` rebuilds its prepared weights first:
    they are a snapshot, stale after any optimizer step). Scalars only:
    the figures wait for the plotting module (ROADMAP.md A13)."""
    config_mod.require_no_frontend(config)
    device = next(model.parameters()).device
    convert.prepare(model)
    metrics = Metrics(config=config, device=device)
    for i, batch in enumerate(loader_fn(partition)):
        features, targets, lengths = _to_device(batch, device)
        logits = models.transformer.forward(model, features, lengths)
        metrics.update(logits, targets)
        if evaluation_steps is not None and i + 1 == evaluation_steps:
            break
    scalars = {f'{partition}/{k}': v for k, v in metrics().items()}
    if writer is not None:
        writer.update(step, scalars)
    return scalars
