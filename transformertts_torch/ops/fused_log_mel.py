"""Fused log-mel frontend (K5): the Hopper kernel and its plain PyTorch version.

Counterpart of ``transformertts_tpu/ops/stft_pallas.py::fused_log_mel``: a
centre-padded wav (B, T) float32 → the MelGAN log-mel (B, F, n_mels),
F = 1 + (T − n_fft) // hop: framing, the windowed one-sided DFT,
``sqrt(re² + im² + 1e-30)``, the mel product and ``log(max(·, clip_min))``.
The caller reflect-pads each clip by n_fft//2 (see
``create_training_data.featurize_batch``), so the result equals
``spectral.mel_spectrogram(center=True)`` of the clip.

- ``fused_log_mel`` launches the kernel of ``csrc/fused_log_mel.cu`` (built
  with nvcc at first use, see ``ops/build.py``) for a CUDA tensor, or
  raises; for a CPU tensor it runs ``fused_log_mel_plain``. Launches are
  counted in ``fused_log_mel.launches``.
- The kernel computes each frame's real FFT as one complex FFT of n_fft/2
  points (Stockham passes, ``fft_passes``) and a split step over only the
  bins that carry mel weight, then folds each mel over its nonzero
  filterbank band. Its tables (window, twiddles, bands) are
  ``kernel_layout``, built on the host in float64 once per device and
  settings. It takes n_fft a power of two from 256 to 2048
  (``check_kernel_args``); the plain version takes any.
"""
import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from transformertts_torch.audio import spectral

KERNEL_N_FFT = (256, 512, 1024, 2048)  # the kernel's FFT sizes


def fused_log_mel_plain(wav_centered: torch.Tensor, sampling_rate: int, n_fft: int,
                        hop_length: int, win_length: int, n_mels: int, f_min: float,
                        f_max: float, clip_min: float = 1e-5) -> torch.Tensor:
    """Eager reference: ``spectral.mel_spectrogram`` of the pre-padded wav
    (unfold, two GEMMs against the windowed bases, the magnitude, the mel
    GEMM) and the clipped log; (B, T) → (B, F, n_mels)."""
    mel = spectral.mel_spectrogram(wav_centered.float(), sampling_rate, n_fft, hop_length,
                                   win_length, n_mels, f_min, f_max, center=False)
    return torch.log(torch.clamp(mel, min=clip_min))


def fft_passes(m: int) -> List[Tuple[int, int]]:
    """The kernel's Stockham passes over an m-point complex FFT, m a power of
    two: (radix R, stride Ns) each, radix 8 while 8 divides what is left,
    then one pass of 4 or 2. Pass (R, Ns)'s twiddles start at entry Ns − 1
    of ``KernelLayout.fft_twiddles``."""
    radices, left = [], m
    while left >= 8:
        radices.append(8)
        left //= 8
    if left > 1:
        radices.append(left)
    passes, ns = [], 1
    for r in radices:
        passes.append((r, ns))
        ns *= r
    return passes


def fft_twiddles(m: int) -> np.ndarray:
    """complex128 pass twiddles of an m-point FFT, (m − 1,): pass (R, Ns)'s
    entry Ns − 1 + k·(R − 1) + r − 1 is exp(−2πi k r / (Ns R)), k < Ns, 0 < r < R."""
    return np.concatenate(
        [np.exp(-2j * np.pi * np.outer(np.arange(ns), np.arange(1, r)) / (ns * r)).ravel()
         for r, ns in fft_passes(m)])


class KernelLayout(NamedTuple):
    window: torch.Tensor          # (n_fft,) float32 padded Hann window
    fft_twiddles: torch.Tensor    # (n_fft//2 − 1, 2): pass (R, Ns)'s exp(−2πi k r / (Ns R))
    split_twiddles: torch.Tensor  # (k_hi − k_lo, 2): exp(−2πi k / n_fft) of the bins used
    fb: torch.Tensor              # (n_mels, 1 + n_fft//2) float32 filterbank
    bands: torch.Tensor           # (n_mels, 2) int32: [lo, hi) of each mel's nonzero weights
    k_lo: int                     # first bin with mel weight
    k_hi: int                     # one past the last


def _float_pairs(z: np.ndarray) -> np.ndarray:
    """complex128 (n,) → (n, 2) float32 (re, im), rounded once."""
    return np.stack([z.real, z.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def kernel_layout(device: str, sampling_rate: int, n_fft: int, win_length: int,
                  n_mels: int, f_min: float, f_max: float) -> KernelLayout:
    """The kernel's inputs besides the wav, built once per device and
    settings, every twiddle in float64 and rounded to float32 once."""
    fb = spectral.mel_filterbank(sampling_rate, n_fft, n_mels, f_min, f_max).astype(np.float32)
    nonzero = fb != 0
    bands = np.zeros((n_mels, 2), np.int32)
    for m in range(n_mels):
        idx = np.flatnonzero(nonzero[m])
        if idx.size:
            bands[m] = idx[0], idx[-1] + 1
    used = np.flatnonzero(nonzero.any(axis=0))
    k_lo, k_hi = (int(used[0]), int(used[-1]) + 1) if used.size else (0, 0)
    fft_tw = fft_twiddles(n_fft // 2)
    split_tw = np.exp(-2j * np.pi * np.arange(k_lo, k_hi) / n_fft)
    window = spectral.padded_window(n_fft, win_length).astype(np.float32)
    return KernelLayout(*(torch.as_tensor(a, device=device) for a in (
        window, _float_pairs(fft_tw), _float_pairs(split_tw), fb, bands)), k_lo, k_hi)


def check_kernel_args(b: int, t: int, n_fft: int, hop_length: int, win_length: int,
                      n_mels: int):
    """Raise ``ValueError`` for settings or a wav shape the kernel does not
    take; the plain version takes any n_fft."""
    if n_fft not in KERNEL_N_FFT:
        raise ValueError(f'fused_log_mel: the kernel takes n_fft a power of two from '
                         f'{KERNEL_N_FFT[0]} to {KERNEL_N_FFT[-1]}, got {n_fft}')
    if not 0 < win_length <= n_fft or hop_length < 1 or n_mels < 1:
        raise ValueError(f'fused_log_mel: win_length {win_length} must lie in [1, n_fft], '
                         f'hop {hop_length} and n_mels {n_mels} be >= 1')
    if b < 1 or t < n_fft:
        raise ValueError(f'fused_log_mel: the wav (B={b}, T={t}) needs B >= 1, T >= n_fft')


@functools.cache
def _entry():
    """The ctypes launch entry of ``csrc/fused_log_mel.cu``, built, loaded and typed once."""
    from transformertts_torch.ops import build
    fn = build.load('fused_log_mel').fused_log_mel
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [p, i, i, i, i, i, p, p, p, i, i, p, p, i, ctypes.c_float, p, p]
    fn.restype = i
    return fn


def fused_log_mel(wav_centered: torch.Tensor, sampling_rate: int, n_fft: int,
                  hop_length: int, win_length: int, n_mels: int, f_min: float,
                  f_max: float, clip_min: float = 1e-5) -> torch.Tensor:
    """(B, T) float32 centre-padded wav → (B, F, n_mels) MelGAN log-mel.

    On a CPU tensor this is ``fused_log_mel_plain``; on a CUDA tensor it
    launches the kernel and counts the launch in ``fused_log_mel.launches``.
    """
    if wav_centered.device.type == 'cpu':
        return fused_log_mel_plain(wav_centered, sampling_rate, n_fft, hop_length,
                                   win_length, n_mels, f_min, f_max, clip_min)
    if not wav_centered.is_cuda:
        raise ValueError(f'fused_log_mel: a CUDA or CPU tensor, got {wav_centered.device}')
    if wav_centered.dtype != torch.float32:
        raise TypeError(f'fused_log_mel: the wav must be float32, got {wav_centered.dtype}')
    if wav_centered.dim() != 2 or not wav_centered.is_contiguous():
        raise ValueError('fused_log_mel: the wav must be a contiguous (B, T) tensor')
    b, t = wav_centered.shape
    check_kernel_args(b, t, n_fft, hop_length, win_length, n_mels)
    fn = _entry()
    layout = kernel_layout(str(wav_centered.device), sampling_rate, n_fft, win_length,
                           n_mels, f_min, f_max)
    n_frames = 1 + (t - n_fft) // hop_length
    out = torch.empty(b, n_frames, n_mels, dtype=torch.float32, device=wav_centered.device)
    with torch.cuda.device(wav_centered.device):
        stream = torch.cuda.current_stream(wav_centered.device).cuda_stream
        err = fn(
            wav_centered.data_ptr(), b, t, n_frames, hop_length, n_fft,
            layout.window.data_ptr(), layout.fft_twiddles.data_ptr(),
            layout.split_twiddles.data_ptr(), layout.k_lo, layout.k_hi, layout.fb.data_ptr(),
            layout.bands.data_ptr(), n_mels, clip_min, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'fused_log_mel launch failed at hop {hop_length}, n_fft {n_fft}: '
                           f'CUDA error {err} (a block holds 63·hop + n_fft wav samples '
                           f'in shared memory)')
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0


def kernel_resources(n_fft: int, hop_length: int, n_bins: int) -> dict:
    """What the kernel for ``n_fft`` uses on the card at this hop with
    ``n_bins`` (k_hi − k_lo) bins carrying mel weight: ``build.RESOURCES``."""
    from transformertts_torch.ops import build
    return build.resources('fused_log_mel', 'fused_log_mel_resources',
                           (n_fft, hop_length, n_bins))
