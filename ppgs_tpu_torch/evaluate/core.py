"""Objective evaluation over test partitions (reference:
ppgs/evaluate/core.py:16-107); the counterpart of
``ppgs_tpu/evaluate/core.py``.

Runs each dataset's test loader through the inference stack
(``from_features``, logits) on the device and accumulates per-dataset and
aggregate metrics; writes ``EVAL_DIR/<config>/<name>.json``,
``overall.json`` and each one's ``tensors.npz`` (the metric accumulators).
Not ported yet: the confusion and distance figures (the plotting module,
ROADMAP.md A13) and the cross-process aggregation (A14; one process holds
every batch).
"""

import json
from pathlib import Path

import numpy as np

from .. import config as config_mod
from .. import devices
from ..utils import notify as _notify_mod
from .metrics import Metrics


@_notify_mod.notify('evaluate')
def datasets(names=None, checkpoint=None, config=None, max_batches=None,
             device=None):
    """Evaluate on datasets' test partitions; returns the results dict
    ({name: scalars, 'aggregate': scalars}). ``device``: None means the
    card, raising without one before any file is read; the metrics
    accumulate there too. No figure is written."""
    from ..core import from_features
    from ..data import loader as data_loader

    device = devices.resolve(device)
    config = config_mod.get(config)
    names = names or list(config.datasets)

    aggregate = Metrics(config=config, device=device)
    results = {}
    eval_dir = config_mod.EVAL_DIR / config.config
    eval_dir.mkdir(parents=True, exist_ok=True)

    for name in names:
        metrics = Metrics(config=config, device=device)
        loader = data_loader(
            name, 'test',
            features=[config.representation, 'phonemes', 'length'],
            config=config)
        for i, batch in enumerate(loader):
            features, indices, lengths = batch[:3]
            logits = from_features(features, lengths, checkpoint=checkpoint,
                                   softmax=False, config=config,
                                   device=device)
            metrics.update(logits, indices)
            if max_batches is not None and i + 1 >= max_batches:
                break
        aggregate.state = {key: aggregate.state[key] + value
                           for key, value in metrics.state.items()}
        results[name] = metrics()
        save(results[name], eval_dir / f'{name}.json')
        save_artifacts(metrics.state, name, eval_dir)

    results['aggregate'] = aggregate()
    save(results['aggregate'], eval_dir / 'overall.json')
    save_artifacts(aggregate.state, 'overall', eval_dir)
    return results


def save(scalars, path):
    with open(path, 'w') as file:
        json.dump(scalars, file, indent=2, sort_keys=True)


def save_artifacts(state, name, directory):
    """Save the accumulated metric tensors as {directory}/{name}/
    tensors.npz (reference ppgs/evaluate/core.py:77-107 saves them as
    .pt beside the figures)."""
    out_dir = Path(directory) / name
    out_dir.mkdir(parents=True, exist_ok=True)
    tensors = {key: value.cpu().numpy() for key, value in state.items()
               if value.ndim >= 1}
    np.savez(out_dir / 'tensors.npz', **tensors)
