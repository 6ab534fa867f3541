"""Host-side audio I/O: WAV loading, saving and resampling.

A copy of what ``from_file`` needs from the JAX package's ``data/audio.py``:
WAV via the stdlib ``wave`` module and numpy, resampling via scipy's
polyphase filter, mp3 through ffmpeg when it is on PATH. The native batch
reader is not ported yet (ROADMAP.md).
"""

import shutil
import subprocess
import wave
from math import gcd
from pathlib import Path

import numpy as np


def load_wav(path):
    """Read a WAV file -> (channels, samples) float32 in [-1, 1], rate."""
    with wave.open(str(path), 'rb') as f:
        channels = f.getnchannels()
        rate = f.getframerate()
        width = f.getsampwidth()
        frames = f.readframes(f.getnframes())
    if width == 2:
        data = np.frombuffer(frames, dtype='<i2').astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(frames, dtype='<i4').astype(
            np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f'Unsupported WAV sample width: {width}')
    return data.reshape(-1, channels).T.copy(), rate


def load_mp3(path):
    """Decode mp3 via ffmpeg to a (channels, samples) float32 array."""
    if shutil.which('ffmpeg') is None:
        raise RuntimeError(
            'Failed to load mp3 file, make sure ffmpeg is installed')
    out = subprocess.run(
        ['ffmpeg', '-v', 'quiet', '-i', str(path), '-f', 'f32le',
         '-acodec', 'pcm_f32le', '-'],
        capture_output=True, check=True)
    probe = subprocess.run(
        ['ffprobe', '-v', 'quiet', '-show_entries',
         'stream=channels,sample_rate', '-of', 'csv=p=0', str(path)],
        capture_output=True, check=True, text=True)
    rate, channels = (int(x) for x in probe.stdout.strip().split(',')[:2])
    data = np.frombuffer(out.stdout, dtype=np.float32)
    return data.reshape(-1, channels).T.copy(), rate


def resample(audio, sample_rate, target_rate=16000):
    """Polyphase resampling of (..., samples) audio."""
    if sample_rate == target_rate:
        return audio
    from scipy.signal import resample_poly

    g = gcd(int(sample_rate), int(target_rate))
    up, down = int(target_rate) // g, int(sample_rate) // g
    return resample_poly(audio, up, down, axis=-1).astype(np.float32)


def load(file, target_rate=16000):
    """Load audio from disk as (1, samples) float32 at target_rate."""
    path = Path(file)
    if path.suffix.lower() == '.mp3':
        audio, rate = load_mp3(path)
    else:
        audio, rate = load_wav(path)
    # Mix down to mono (first channel, matching the JAX package)
    return resample(audio[:1], rate, target_rate)


def save_wav(path, audio, sample_rate=16000):
    """Write (channels, samples) or (samples,) float32 audio as 16-bit WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None]
    data = np.clip(audio.T, -1.0, 1.0)
    pcm = (data * 32767.0).astype('<i2')
    with wave.open(str(path), 'wb') as f:
        f.setnchannels(audio.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
