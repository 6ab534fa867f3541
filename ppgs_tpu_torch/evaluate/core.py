"""Objective evaluation over test partitions (reference:
ppgs/evaluate/core.py:16-107); the counterpart of
``ppgs_tpu/evaluate/core.py``.

Runs each dataset's test loader through the inference stack
(``from_features``, logits) on the device and accumulates per-dataset and
aggregate metrics; writes ``EVAL_DIR/<config>/<name>.json``,
``overall.json`` and, under ``<name>/``, the confusion and distance figures
(``.jpg`` and ``.pdf``, where matplotlib imports) beside ``tensors.npz``
(the metric accumulators).

In a process group (``parallel.multihost``) each process evaluates every
process_count-th batch of the stream, the metric sums are summed across
processes (exact for any split), and the primary process alone draws the
figures and writes the files.
"""

import json
from pathlib import Path

import numpy as np

from .. import config as config_mod
from .. import devices
from ..parallel import multihost
from ..utils import notify as _notify_mod
from .metrics import Metrics, close_figures, figures_available


@_notify_mod.notify('evaluate')
def datasets(names=None, checkpoint=None, config=None, max_batches=None,
             device=None):
    """Evaluate on datasets' test partitions; returns the results dict
    ({name: scalars, 'aggregate': scalars}). ``device``: None means the
    card, raising without one before any file is read; the metrics
    accumulate there too. The figures are drawn where matplotlib imports
    (``metrics.figures_available``)."""
    from ..core import from_features
    from ..data import loader as data_loader

    device = devices.resolve(device)
    multihost.initialize(device=device)
    config = config_mod.get(config)
    names = names or list(config.datasets)

    primary = multihost.is_primary()
    figures = figures_available() and primary
    aggregate = Metrics(include_figures=figures, config=config,
                        device=device)
    results = {}
    eval_dir = config_mod.EVAL_DIR / config.config
    eval_dir.mkdir(parents=True, exist_ok=True)

    for name in names:
        metrics = Metrics(include_figures=figures, config=config,
                          device=device)
        loader = data_loader(
            name, 'test',
            features=[config.representation, 'phonemes', 'length'],
            config=config)
        for i, batch in enumerate(multihost.shard_iterator(loader)):
            features, indices, lengths = batch[:3]
            logits = from_features(features, lengths, checkpoint=checkpoint,
                                   softmax=False, config=config,
                                   device=device)
            metrics.update(logits, indices)
            if max_batches is not None and i + 1 >= max_batches:
                break
        metrics.state = multihost.aggregate_across_processes(metrics.state)
        aggregate.state = {key: aggregate.state[key] + value
                           for key, value in metrics.state.items()}
        full = metrics()
        results[name] = scalars_of(full)
        if primary:
            save(results[name], eval_dir / f'{name}.json')
            save_artifacts(full, metrics.state, name, eval_dir)

    full = aggregate()
    results['aggregate'] = scalars_of(full)
    if primary:
        save(results['aggregate'], eval_dir / 'overall.json')
        save_artifacts(full, aggregate.state, 'overall', eval_dir)
    return results


def scalars_of(results):
    """The scalars of a Metrics result (its figures left out)."""
    return {key: value for key, value in results.items()
            if isinstance(value, (int, float))}


def save(scalars, path):
    with open(path, 'w') as file:
        json.dump(scalars, file, indent=2, sort_keys=True)


def save_artifacts(results, state, name, directory):
    """Save the confusion and distance figures of ``results`` (jpg + pdf,
    closed after) and the accumulated metric tensors (tensors.npz) under
    {directory}/{name}/, under the JAX package's names (reference
    ppgs/evaluate/core.py:77-107 saves the tensors as .pt)."""
    out_dir = Path(directory) / name
    out_dir.mkdir(parents=True, exist_ok=True)
    figures = [(metric, value) for metric, value in results.items()
               if not isinstance(value, (int, float))]
    for metric, figure in figures:
        stem = metric.replace('/', '-')
        for suffix in ('jpg', 'pdf'):
            figure.savefig(out_dir / f'{stem}.{suffix}', bbox_inches='tight',
                           pad_inches=0)
    close_figures(figure for _, figure in figures)
    tensors = {key: value.cpu().numpy() for key, value in state.items()
               if value.ndim >= 1}
    np.savez(out_dir / 'tensors.npz', **tensors)
