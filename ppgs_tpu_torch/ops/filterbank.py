"""Mel filterbank construction (host-side, numpy).

Replaces the librosa dependency: reproduces ``librosa.filters.mel`` with
default arguments (Slaney mel scale, Slaney area normalization), which is what
the reference uses to build its 80-band basis
(reference: ppgs/preprocess/mel.py:60-67).
"""

import numpy as np


def hz_to_mel(freq, htk=False):
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney formula: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = freq >= min_log_hz
        mels[log_t] = min_log_mel + np.log(freq[log_t] / min_log_hz) / logstep
    elif freq >= min_log_hz:
        mels = min_log_mel + np.log(freq / min_log_hz) / logstep
    return mels


def mel_to_hz(mels, htk=False):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_frequencies(n_mels, fmin, fmax, htk=False):
    min_mel = hz_to_mel(fmin, htk=htk)
    max_mel = hz_to_mel(fmax, htk=htk)
    mels = np.linspace(min_mel, max_mel, n_mels)
    return mel_to_hz(mels, htk=htk)


def mel_filterbank(
    sample_rate=16000,
    n_fft=1024,
    n_mels=80,
    fmin=0.0,
    fmax=None,
    htk=False,
    norm='slaney',
    dtype=np.float32,
):
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = float(sample_rate) / 2

    n_freqs = 1 + n_fft // 2
    weights = np.zeros((n_mels, n_freqs), dtype=np.float64)
    fftfreqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sample_rate)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax, htk=htk)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    if norm == 'slaney':
        # Area normalization: each triangle integrates to ~2/bandwidth
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f'Unsupported norm: {norm}')

    return weights.astype(dtype)


def hann_window(window_size, dtype=np.float32):
    """Periodic Hann window (matches torch.hann_window default)."""
    n = np.arange(window_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / window_size))).astype(dtype)
