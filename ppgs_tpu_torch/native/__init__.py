"""Native (C++) audio/data runtime, bound via ctypes: the port's copy of
``ppgs_tpu/native`` (host code; the card is not involved).

The library is built from ``src/audio_io.cc`` at first use with g++ (the
Makefile in this directory) into ``build/`` here, one file per version of
the source; without a compiler every function returns None and the callers
in ``data/audio.py`` fall back to the pure-Python reader, as in the JAX
package. The batch WAV decoder is multi-threaded C++ and runs without the
GIL.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).parent
_SOURCE = _DIR / 'src' / 'audio_io.cc'


def library_path():
    """Where the library for the current source lives: ``build/`` beside
    this file, named by the source's hash so that an edit rebuilds it."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    return _DIR / 'build' / f'libppgs_native-{digest}.so'


def _build(path):
    """Build into a file of this process's own, then move it into place,
    so that processes building at once never load a half-written file."""
    partial = path.with_name(f'{path.name}.{os.getpid()}.partial')
    try:
        subprocess.run(['make', '-C', str(_DIR), 'lib',
                        f'OUT={partial.relative_to(_DIR)}'],
                       capture_output=True, check=True)
        os.replace(partial, path)
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        partial.unlink(missing_ok=True)
        return False
    return True


@functools.lru_cache(maxsize=1)
def library():
    """Load (building if needed) the native library; None if unavailable."""
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    lib.ppgs_wav_info.restype = ctypes.c_int64
    lib.ppgs_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
    lib.ppgs_wav_read.restype = ctypes.c_int64
    lib.ppgs_wav_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    lib.ppgs_wav_read_batch.restype = None
    lib.ppgs_wav_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32]
    lib.ppgs_framewise_indices.restype = None
    lib.ppgs_framewise_indices.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def available() -> bool:
    return library() is not None


def wav_info(path):
    """(num_samples, sample_rate) without decoding; None on failure."""
    lib = library()
    if lib is None:
        return None
    rate = ctypes.c_int32(0)
    n = lib.ppgs_wav_info(str(path).encode(), ctypes.byref(rate))
    if n < 0:
        return None
    return int(n), int(rate.value)


def wav_read(path, max_samples=None):
    """Decode a WAV's first channel -> (float32 array, sample_rate)."""
    lib = library()
    if lib is None:
        return None
    info = wav_info(path)
    if info is None:
        return None
    n, _ = info
    if max_samples is not None:
        n = min(n, max_samples)
    out = np.zeros(n, dtype=np.float32)
    rate = ctypes.c_int32(0)
    written = lib.ppgs_wav_read(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, ctypes.byref(rate))
    if written < 0:
        return None
    return out[:written], int(rate.value)


def wav_read_batch(paths, max_samples, num_threads=0):
    """Decode a batch concurrently into a (B, max_samples) float32 arena.

    Returns (arena, lengths, sample_rates); lengths[i] == -1 on a per-file
    decode failure.
    """
    lib = library()
    if lib is None:
        return None
    batch = len(paths)
    arena = np.zeros((batch, max_samples), dtype=np.float32)
    lengths = np.zeros(batch, dtype=np.int64)
    rates = np.zeros(batch, dtype=np.int32)
    c_paths = (ctypes.c_char_p * batch)(
        *[str(p).encode() for p in paths])
    lib.ppgs_wav_read_batch(
        c_paths, batch,
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        num_threads)
    return arena, lengths, rates


def framewise_indices(ends, labels, times):
    """Interval -> per-frame label expansion (the semantics of
    textgrid.Alignment.framewise_phoneme_indices)."""
    lib = library()
    if lib is None:
        return None
    ends = np.ascontiguousarray(ends, dtype=np.float64)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    times = np.ascontiguousarray(times, dtype=np.float64)
    out = np.zeros(len(times), dtype=np.int32)
    lib.ppgs_framewise_indices(
        ends.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(ends),
        times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(times),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out.astype(np.int64)
