"""WAV file I/O and resampling (host), as ``transformertts_tpu/audio/wav_io.py``:
scipy's wavfile and polyphase resampling, no native audio dependencies."""
from fractions import Fraction

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

_INT_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0}


def load_wav(path, target_sampling_rate: int = None):
    """Read a wav as float32 in [-1, 1], mono, resampled if asked.

    Returns (wav, sampling_rate).
    """
    sr, data = wavfile.read(str(path))
    if data.dtype in _INT_SCALE:
        y = data.astype(np.float32) / _INT_SCALE[data.dtype]
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:
        y = data.astype(np.float32)
    if y.ndim > 1:
        y = y.mean(axis=-1)
    if target_sampling_rate is not None and sr != target_sampling_rate:
        frac = Fraction(target_sampling_rate, sr).limit_denominator(1000)
        y = resample_poly(y, frac.numerator, frac.denominator).astype(np.float32)
        sr = target_sampling_rate
    return y, sr


def save_wav(y: np.ndarray, path, sampling_rate: int):
    """Write a float waveform as 16-bit PCM, rescaled when its peak exceeds 1."""
    y = np.asarray(y, dtype=np.float32)
    peak = np.max(np.abs(y)) if y.size else 0.0
    if peak > 1.0:
        y = y / peak
    wavfile.write(str(path), sampling_rate, (y * 32767.0).astype(np.int16))
