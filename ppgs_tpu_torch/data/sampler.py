"""Batch samplers (reference: ppgs/data/sampler.py:11-85); a copy of the
JAX package's.

Deterministic epoch-seeded shuffling (numpy ``default_rng(seed + epoch)``)
and greedy frame-budget batching, so that the port draws the JAX package's
batches index for index.
"""

import numpy as np

from .. import config as config_mod


def sampler(dataset, partition, config=None):
    """Select a batch sampler by partition (reference sampler.py:11-25)."""
    config = config_mod.get(config)
    if partition.startswith('train') or partition.startswith('valid'):
        return Sampler(dataset, config.max_training_frames, config)
    if partition.startswith('test'):
        if config.batched_test_eval:
            return BatchedSequentialSampler(
                dataset, config.max_inference_frames)
        return SequentialSampler(dataset)
    raise ValueError(f'Partition {partition} is not defined')


class SequentialSampler:
    """Batch-size-1 sequential batches for test partitions."""

    def __init__(self, dataset):
        self.n = len(dataset)

    def __iter__(self):
        return iter([[i] for i in range(self.n)])

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass


class BatchedSequentialSampler:
    """Frame-budget test batches grouped by QUANTIZED padded length.

    The JAX package's redesign of the reference's batch-1 sequential test
    sampler (ppgs/data/sampler.py:18-22): metrics are order-invariant sums,
    so N utterances take ~N/batch model calls instead of N. Grouping by the
    collate quantization bucket means every utterance in a batch pads to
    the SAME frames as it would alone: batched logits match batch-1's (same
    tensor extent, same chunking decision).
    """

    def __init__(self, dataset, max_frames=None, frame_multiple=None,
                 config=None):
        from .collate import FRAME_MULTIPLE, quantize

        config = config_mod.get(config)
        self.max_frames = max_frames or config.max_inference_frames
        if frame_multiple is None:
            frame_multiple = FRAME_MULTIPLE    # must match Collate's
        groups = {}
        for index, length in enumerate(dataset.lengths):
            groups.setdefault(quantize(length, frame_multiple),
                              []).append(index)
        self.batches = []
        for qlen in sorted(groups):
            size = max(1, int(self.max_frames) // qlen)
            members = groups[qlen]
            for i in range(0, len(members), size):
                self.batches.append(members[i:i + size])

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


class Sampler:
    """Greedy variable-size batches capped at (len+1)*max_len <= max_frames."""

    def __init__(self, dataset, max_frames=None, config=None):
        config = config_mod.get(config)
        self.max_frames = max_frames or config.max_training_frames
        self.seed = config.random_seed
        self.epoch = 0
        self.buckets = dataset.buckets()

    def __iter__(self):
        return iter(self.batch())

    def __len__(self):
        return len(self.batch())

    def batch(self):
        """Produce batch index lists for one epoch (reference :46-77)."""
        rng = np.random.default_rng(self.seed + self.epoch)

        batches = []
        for bucket in self.buckets:
            bucket = bucket[rng.permutation(len(bucket))]
            batch, max_length = [], 0
            for index, length in bucket:
                max_length = max(max_length, int(length))
                if batch and (len(batch) + 1) * max_length > self.max_frames:
                    batches.append(batch)
                    max_length = int(length)
                    batch = [int(index)]
                else:
                    batch.append(int(index))
            if batch:
                batches.append(batch)

        return [batches[i] for i in rng.permutation(len(batches))]

    def set_epoch(self, epoch):
        self.epoch = epoch
