"""Data loader (reference: ppgs/data/loader.py:20-43); a copy of the JAX
package's.

A python-generator loader with a background prefetch thread: it loads and
collates numpy batches ahead of the consumer, so that the host reads files
while the card computes. The thread does numpy work only; every torch call
stays with the consumer. An error raised in the thread is raised in the
consumer.
"""

import queue
import threading

from .. import config as config_mod
from .collate import Collate
from .dataset import Dataset
from .sampler import sampler as make_sampler, Sampler


class Loader:

    def __init__(self, dataset, batch_sampler, collate_fn, num_workers=2,
                 prefetch=4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.batch_sampler)

    def _load(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        batches = list(iter(self.batch_sampler))
        if self.num_workers == 0:
            for indices in batches:
                yield self._load(indices)
            return

        out = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            # A consumer that stopped early drains nothing: give up then,
            # so that the thread ends instead of waiting on a full queue
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass

        def producer():
            try:
                for indices in batches:
                    if stop.is_set():
                        return
                    put(('ok', self._load(indices)))
            except Exception as error:  # propagate to consumer
                put(('error', error))
            finally:
                put(('done', None))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                kind, value = out.get()
                if kind == 'done':
                    return
                if kind == 'error':
                    raise value
                yield value
        finally:
            stop.set()


def loader(
    dataset_or_files,
    partition=None,
    features=None,
    num_workers=None,
    max_frames=None,
    config=None,
):
    """Build a Loader (reference loader.py:20-43)."""
    config = config_mod.get(config)
    if features is None:
        features = [config.representation, 'phonemes', 'length']
    if num_workers is None:
        num_workers = config.num_workers
    if max_frames is None:
        max_frames = config.max_training_frames

    dataset = Dataset(dataset_or_files, partition, features, max_frames,
                      config)
    if partition is not None:
        batch_sampler = make_sampler(dataset, partition, config)
    else:
        batch_sampler = Sampler(dataset, max_frames, config)
    return Loader(dataset, batch_sampler, Collate(features),
                  num_workers=min(num_workers, 2))
