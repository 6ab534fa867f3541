"""Batch collation with quantized time extents
(reference: ppgs/data/collate.py:9-62); a copy of the JAX package's.

Audio is zero-padded, phoneme targets padded with -100 (the loss/metric
ignore sentinel), latents zero-padded in their cached dtype. As in the JAX
package, padded time dims are rounded UP to a multiple (100 frames, 16,000
samples): the port yields the JAX package's batches, so that both train and
evaluate on the same tensors. A batch whose frames are an odd multiple of
100 (T % 8 != 0) takes the per-layer train path on the card.
"""

import numpy as np


# Time-dim quantization multiples, the JAX package's.
# BatchedSequentialSampler's bit-identity guarantee (sampler.py) groups test
# utterances by THIS multiple — keep them in lockstep.
FRAME_MULTIPLE = 100
SAMPLE_MULTIPLE = 16000


def quantize(length, multiple):
    return max(multiple, -(-int(length) // multiple) * multiple)


class Collate:

    def __init__(self, features=('audio',), frame_multiple=FRAME_MULTIPLE,
                 sample_multiple=SAMPLE_MULTIPLE):
        self.features = list(features)
        self.frame_multiple = frame_multiple
        self.sample_multiple = sample_multiple

    def __call__(self, batch):
        batch_values = []
        batch_size = len(batch)
        for feature, values in zip(self.features, zip(*batch)):

            if feature == 'audio':
                max_length = quantize(
                    max(a.shape[-1] for a in values), self.sample_multiple)
                padded = np.zeros((batch_size, 1, max_length),
                                  dtype=np.float32)
                for i, a in enumerate(values):
                    padded[i, 0, :a.shape[-1]] = a[0]
                batch_values.append(padded)

            elif feature == 'phonemes':
                max_length = quantize(
                    max(v.shape[-1] for v in values), self.frame_multiple)
                padded = np.full((batch_size, max_length), -100,
                                 dtype=np.int64)
                for i, v in enumerate(values):
                    padded[i, :v.shape[-1]] = v
                batch_values.append(padded)

            elif feature in ('stem', 'audio_file'):
                batch_values.append(list(values))

            elif feature == 'length':
                batch_values.append(np.asarray(values, dtype=np.int64))

            else:  # input representation latents (or int codec codes)
                max_length = quantize(
                    max(v.shape[-1] for v in values), self.frame_multiple)
                shape = (batch_size,) + values[0].shape[:-1] + (max_length,)
                # Preserve the cached dtype: int codes must stay integral;
                # fp16 caches are cast to float32 on the device
                dtype = np.asarray(values[0]).dtype
                padded = np.zeros(shape, dtype=dtype)
                for i, v in enumerate(values):
                    padded[i, ..., :v.shape[-1]] = v
                batch_values.append(padded)

        return batch_values
