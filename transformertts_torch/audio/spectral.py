"""Spectral bases (numpy, host precompute) and the GEMM-form STFT and ISTFT,
the counterparts of ``transformertts_tpu/audio/spectral.py``: periodic Hann
window, Slaney mel filterbank (librosa ``htk=False, norm='slaney'``), the
windowed real-DFT and inverse-DFT bases that turn the STFT and its inverse
into GEMMs, ``frame_signal``, ``stft``, ``stft_magnitude`` and
``mel_spectrogram`` over batched torch tensors (reflect centering or a
pre-padded signal) and ``istft`` (squared-window-normalized overlap-add), as
librosa computes them. Float32 GEMMs, with ``1e-30`` inside the magnitude's
square root as in the JAX package. Griffin-Lim uses ``stft``/``istft`` only
in its gather form (hops that do not tile n_fft) and the DFT bases only at
an n_fft its FFT kernel does not take (``audio/griffinlim.py``)."""
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_F_SP = 200.0 / 3            # Slaney: linear below 1 kHz ...
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # ... logarithmic above


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def padded_window(n_fft: int, win_length: int) -> np.ndarray:
    window = hann_window(win_length)
    pad = (n_fft - win_length) // 2
    return np.pad(window, (pad, n_fft - win_length - pad))


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    log_part = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_part, f / _F_SP)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    log_part = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return np.where(m >= _MIN_LOG_MEL, log_part, m * _F_SP)


@lru_cache(maxsize=8)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int,
                   f_min: float, f_max: float) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) Slaney-normalized triangular mel filterbank."""
    if f_max is None:
        f_max = sampling_rate / 2.0
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    return weights * enorm[:, None]


@lru_cache(maxsize=8)
def dft_basis(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases (cos, -sin), each (n_fft, 1 + n_fft//2):
    ``frames @ cos`` and ``frames @ sin`` are Re and Im of the one-sided DFT."""
    window = padded_window(n_fft, win_length)
    angles = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(1 + n_fft // 2)[None, :] / n_fft
    return np.cos(angles) * window[:, None], -np.sin(angles) * window[:, None]


@lru_cache(maxsize=8)
def idft_basis(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse one-sided DFT bases (re, im), each (1 + n_fft//2, n_fft), with
    the window applied for overlap-add:
    irfft(X)[n] = (1/N) Σ_k w_k (Re X_k cos(2πkn/N) − Im X_k sin(2πkn/N)),
    w_0 = w_{N/2} = 1, w_k = 2 otherwise."""
    window = padded_window(n_fft, win_length)
    angles = 2.0 * np.pi * np.arange(1 + n_fft // 2)[:, None] * np.arange(n_fft)[None, :] / n_fft
    w = np.full((1 + n_fft // 2, 1), 2.0)
    w[0] = w[-1] = 1.0
    return (w * np.cos(angles)) / n_fft * window[None, :], \
        (-w * np.sin(angles)) / n_fft * window[None, :]


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """(..., T) → (..., 1 + (T' − n_fft) // hop, n_fft) frames, where T' is T
    plus the reflect padding of n_fft//2 on each side when ``center``."""
    if center:
        pad = n_fft // 2
        y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode='reflect').reshape(
            *y.shape[:-1], -1)
    return y.unfold(-1, n_fft, hop_length)


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Waveforms (..., T) → Re and Im of the STFT, each
    (..., n_frames, 1 + n_fft//2): framed (reflect-centered when ``center``,
    1 + T // hop frames) and two GEMMs against the windowed DFT bases."""
    like = dict(dtype=y.dtype, device=y.device)
    frames = frame_signal(y, n_fft, hop_length, center)
    cos_b, sin_b = (torch.as_tensor(b, **like) for b in dft_basis(n_fft, win_length))
    return frames @ cos_b, frames @ sin_b


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                   center: bool = True) -> torch.Tensor:
    re, im = stft(y, n_fft, hop_length, win_length, center)
    return torch.sqrt(re * re + im * im + 1e-30)


def mel_spectrogram(y: torch.Tensor, sampling_rate: int, n_fft: int, hop_length: int,
                    win_length: int, n_mels: int, f_min: float, f_max: float,
                    center: bool = True) -> torch.Tensor:
    """Magnitude mel (power 1), un-normalized: (..., T) → (..., n_frames, n_mels)."""
    S = stft_magnitude(y, n_fft, hop_length, win_length, center)
    fb = mel_filterbank(sampling_rate, n_fft, n_mels, f_min, f_max)
    return S @ torch.as_tensor(fb.T, dtype=S.dtype, device=S.device)


def _overlap_add_index(n_frames: int, n_fft: int, hop_length: int) -> np.ndarray:
    return (np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]).reshape(-1)


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
          win_length: int) -> torch.Tensor:
    """Re, Im (B, n_frames, 1 + n_fft//2) → centered waveforms
    (B, hop·(n_frames − 1)): inverse-DFT GEMMs, windowed overlap-add at any
    hop, divided by the squared-window envelope."""
    b, n_frames, _ = re.shape
    like = dict(dtype=re.dtype, device=re.device)
    re_b, im_b = (torch.as_tensor(x, **like) for x in idft_basis(n_fft, win_length))
    frames = re @ re_b + im @ im_b                              # (B, F, n_fft)
    out_len = n_fft + hop_length * (n_frames - 1)
    idx = _overlap_add_index(n_frames, n_fft, hop_length)
    wsq = np.zeros(out_len)
    np.add.at(wsq, idx, np.tile(padded_window(n_fft, win_length) ** 2, n_frames))
    y = torch.zeros(b, out_len, **like).index_add_(
        1, torch.as_tensor(idx, device=re.device), frames.reshape(b, -1))
    y = y / torch.as_tensor(np.maximum(wsq, 1e-10), **like)
    return y[:, n_fft // 2:out_len - n_fft // 2]
