"""Dataset statistics (reference: ppgs/data/stats/core.py:14-40)."""

import itertools
import wave

from ... import config as config_mod
from ... import load as load_mod


def process(datasets=None, config=None):
    """Report hours and file counts per dataset; returns the stats dict."""
    config = config_mod.get(config)
    datasets = datasets or list(config.datasets)
    results = {}
    for dataset in datasets:
        directory = config_mod.CACHE_DIR / dataset
        stems = list(itertools.chain.from_iterable(
            load_mod.partition(dataset).values()))

        duration = 0.0
        for stem in stems:
            with wave.open(str(directory / f'{stem}.wav'), 'rb') as file:
                duration += file.getnframes() / file.getframerate()
        hours = duration / 3600
        results[dataset] = {'hours': hours, 'files': len(stems)}
        print(f'The {dataset} dataset contains {hours:.2f} hours '
              f'across {len(stems)} files')
    return results
