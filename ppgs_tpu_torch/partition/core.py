"""Dataset partitioning (reference: ppgs/partition/core.py:21-85).

A copy of the JAX package's. Deterministic (seed 1234): commonvoice
80/10/10 shuffled; timit and arctic are test-only. Writes
``config.PARTITION_DIR/{dataset}.json``: by default the JAX package's
tracked assets, which both packages read by path, so point PARTITION_DIR
elsewhere to partition a corpus of your own.
"""

import json
import random

from .. import config as config_mod


def datasets(names=None, config=None):
    config = config_mod.get(config)
    names = names or list(config.datasets)
    for name in names:
        if name == 'arctic':
            partition = arctic(config)
        elif name == 'timit':
            partition = timit(config)
        elif name == 'commonvoice':
            partition = commonvoice(config)
        else:
            raise ValueError(f'Dataset {name} is not defined')
        path = config_mod.PARTITION_DIR / f'{name}.json'
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, 'w') as file:
            json.dump(partition, file, indent=4)


def _stems(name):
    cache = config_mod.CACHE_DIR / name
    return sorted(f.stem for f in cache.glob('*.wav'))


def arctic(config=None):
    """All utterances to the test partition."""
    return {'train': [], 'valid': [], 'test': _stems('arctic')}


def timit(config=None):
    """All utterances to the test partition."""
    return {'train': [], 'valid': [], 'test': _stems('timit')}


def commonvoice(config=None):
    """Deterministic 80/10/10 split."""
    config = config_mod.get(config)
    stems = _stems('commonvoice')
    random.seed(config.random_seed)
    random.shuffle(stems)
    n = len(stems)
    left, right = int(0.8 * n), int(0.9 * n)
    return {
        'train': sorted(stems[:left]),
        'valid': sorted(stems[left:right]),
        'test': sorted(stems[right:]),
    }
