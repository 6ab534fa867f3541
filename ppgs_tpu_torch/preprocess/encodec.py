"""EnCodec code frontend (reference: ppgs/preprocess/encodec.py:12-56); the
counterpart of ``ppgs_tpu/preprocess/encodec.py``.

EnCodec-24 kHz quantizer codes, nearest-upsampled to the config's frame
rate, as int32 codes. The encodec package is an optional dependency, as in
the reference: ``_model`` raises a clear ImportError without it. The codec
model and the audio go to ``device`` (the card unless the caller names the
CPU); the resampling to 24 kHz runs on the host. The codes become the
model's input latents through the config's codebook frontend
(``frontend.py``) at train and inference time.
"""

import numpy as np
import torch

from .. import config as config_mod
from .. import devices


def _model():
    try:
        from encodec import EncodecModel
    except ImportError as error:
        raise ImportError(
            "The 'encodec' package is required for the encodec "
            "representation: pip install encodec") from error
    if not hasattr(_model, 'model'):
        _model.model = EncodecModel.encodec_model_24khz()
    return _model.model


def from_audios(audio, lengths=None, config=None, output_dtype=np.int32,
                device=None):
    """(B, 1, S) audio -> (B, Q, S // hopsize) int codes on ``device``."""
    from ..data import audio as audio_io

    device = devices.resolve(device)
    config = config_mod.get(config)
    audio = torch.as_tensor(audio).detach().cpu().numpy()
    expected_length = audio.shape[-1] // config.hopsize

    resampled = audio_io.resample(audio, config.sample_rate, 24000)
    model = _model().to(device)
    with torch.no_grad():
        codes = model.encode(torch.from_numpy(
            np.ascontiguousarray(resampled)).to(device))[0][0]
        upsampled = torch.nn.functional.interpolate(
            codes.to(torch.float32), size=expected_length, mode='nearest')
    return upsampled.to(getattr(torch, np.dtype(output_dtype).name))


def from_audio(audio, sample_rate=None, config=None, device=None):
    audio = torch.as_tensor(audio)
    if audio.ndim == 2:
        audio = audio[None]
    return from_audios(audio, config=config, device=device)


def from_file(audio_file, config=None, device=None):
    from ..data import audio as audio_io

    return from_audio(audio_io.load(audio_file), config=config, device=device)


def from_file_to_file(audio_file, output_file, config=None, device=None):
    np.save(output_file, from_file(audio_file, config, device).cpu().numpy())


def from_files_to_files(audio_files, output_files, config=None, device=None):
    for audio_file, output_file in zip(audio_files, output_files):
        from_file_to_file(audio_file, output_file, config, device)
