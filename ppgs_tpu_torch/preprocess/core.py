"""Feature caching (reference: ppgs/preprocess/core.py:16-221); the
counterpart of ``ppgs_tpu/preprocess/core.py``.

Frame-budget batches from the data loader go through a representation's
frontend on the device (the card unless the caller names the CPU); each
batch comes to the host once, and a thread pool writes one
``{prefix}-{representation}.npy`` per utterance, truncated to its frames,
float32 features stored as float16 (reference mel.py:19), with
backpressure so that pending saves stay bounded. Train's default loader and
``evaluate.datasets`` read these caches. In a process group
(``parallel.multihost``) ``datasets`` caches every process_count-th file on
each process: the work is per utterance.
"""

import concurrent.futures
from pathlib import Path

import numpy as np
import torch

from .. import config as config_mod
from .. import devices
from ..utils import notify as _notify_mod

# Cache file dtype: the reference stores fp16 features (mel.py:19)
SAVE_DTYPE = np.float16
MAX_PENDING_SAVES = 256     # saves in flight before the loop waits


def save_masked(array, file, length):
    """Truncate a host array to its valid length and save it, float32 as
    float16 (reference core.py:205-221)."""
    array = np.asarray(array)[..., :int(length)]
    np.save(file, array.astype(SAVE_DTYPE)
            if array.dtype == np.float32 else array)


def _valid_length(representation, samples, hopsize):
    """Valid trailing extent of a cached feature for one utterance: frames
    for 100 Hz latents, padded samples for the raw-audio passthrough."""
    if representation in ('w2v2ft', 'wav'):
        from . import w2v2ft

        return int(samples) + 2 * w2v2ft.PAD
    return int(samples) // hopsize


def from_audios(audio, lengths, representation=None, config=None,
                device=None):
    """Preprocess a batch of audio into the requested representation on
    ``device``."""
    from .. import preprocess

    config = config_mod.get(config)
    frontend = preprocess.get(representation or config.representation)
    return frontend.from_audios(audio, lengths, config=config, device=device)


def from_audio(audio, sample_rate=None, representation=None, config=None,
               device=None):
    """Preprocess one audio tensor (reference core.py:194-211)."""
    from .. import preprocess

    config = config_mod.get(config)
    frontend = preprocess.get(representation or config.representation)
    return frontend.from_audio(audio, sample_rate, config=config,
                               device=device)


def from_dataloader(dataloader, output_prefixes, representations=None,
                    save_workers=4, config=None, device=None):
    """Batched representation caching (reference core.py:107-184).

    ``dataloader`` yields frame-budget (audio, lengths, audio_file)
    batches; ``output_prefixes`` maps an audio filename to its cache path
    prefix. Each representation's frontend runs once a batch on
    ``device``; the truncated saves run on a pool of ``save_workers``
    threads, which see host arrays only."""
    from .. import preprocess

    device = devices.resolve(device)
    config = config_mod.get(config)
    if representations is None:
        representations = [config.representation]
    frontends = [(r, preprocess.get(r)) for r in representations]

    with concurrent.futures.ThreadPoolExecutor(save_workers) as pool:
        pending = []
        for audios, lengths, batch_files in dataloader:
            lengths = np.asarray(lengths)
            audios = torch.from_numpy(np.asarray(audios)).to(device)
            for representation, frontend in frontends:
                features = frontend.from_audios(audios, lengths,
                                                config=config, device=device)
                host = features.cpu().numpy()
                for i, audio_file in enumerate(batch_files):
                    out = Path(f'{output_prefixes[str(audio_file)]}'
                               f'-{representation}.npy')
                    valid = min(_valid_length(representation, lengths[i],
                                              config.hopsize),
                                host.shape[-1])
                    pending.append(
                        pool.submit(save_masked, host[i], out, valid))
            while len(pending) > MAX_PENDING_SAVES:
                done, not_done = concurrent.futures.wait(
                    pending, return_when=concurrent.futures.FIRST_COMPLETED)
                for future in done:
                    future.result()
                pending = list(not_done)
        for future in pending:
            future.result()


def from_files_to_files(audio_files, output_prefixes, representations=None,
                        config=None, num_workers=2, save_workers=4,
                        device=None):
    """Compute and cache representations for audio files as
    ``{prefix}-{representation}.npy``, the reference's cache layout. Files
    batch together up to ``config.max_preprocess_frames`` a call
    (reference core.py:45-50)."""
    from ..data import loader as data_loader

    device = devices.resolve(device)
    config = config_mod.get(config)
    dataloader = data_loader(
        [Path(f) for f in audio_files],
        features=['audio', 'length', 'audio_file'],
        num_workers=num_workers,
        max_frames=config.max_preprocess_frames,
        config=config)
    prefixes = {str(f): str(p)
                for f, p in zip(audio_files, output_prefixes)}
    from_dataloader(dataloader, prefixes, representations,
                    save_workers=save_workers, config=config, device=device)


@_notify_mod.notify('preprocess')
def datasets(names=None, representations=None, config=None, partition=None,
             num_workers=2, device=None):
    """Cache the representations of datasets' utterances beside their
    audio in ``config.CACHE_DIR/<name>`` (reference:
    ppgs/preprocess/core.py:17-104)."""
    from ..data import Dataset
    from ..parallel import multihost

    device = devices.resolve(device)
    multihost.initialize(device=device)
    config = config_mod.get(config)
    for name in names or list(config.datasets):
        dataset = Dataset(name, partition=partition,
                          features=['audio', 'length', 'audio_file'],
                          config=config)
        pairs = list(multihost.shard_iterator(
            zip(dataset.audio_files, dataset.stems)))
        from_files_to_files([f for f, _ in pairs],
                            [dataset.cache / stem for _, stem in pairs],
                            representations, config=config,
                            num_workers=num_workers, device=device)
