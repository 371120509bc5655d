"""Fused log-mel frontend (K5): the Hopper kernel and its plain PyTorch version.

Counterpart of ``transformertts_tpu/ops/stft_pallas.py::fused_log_mel``: a
centre-padded wav (B, T) float32 → the MelGAN log-mel (B, F, n_mels),
F = 1 + (T − n_fft) // hop, computed as framing, the windowed one-sided DFT
as two GEMMs, ``sqrt(re² + im² + 1e-30)``, the mel GEMM and
``log(max(·, clip_min))``. The caller reflect-pads each clip by n_fft//2 (see
``create_training_data.featurize_batch``), so the result equals
``spectral.mel_spectrogram(center=True)`` of the clip.

- ``fused_log_mel`` launches the kernel of ``csrc/fused_log_mel.cu`` (built
  with nvcc at first use, see ``ops/build.py``) for a CUDA tensor, or
  raises; for a CPU tensor it runs ``fused_log_mel_plain``. Launches are
  counted in ``fused_log_mel.launches``.
- The kernel transforms only the bins that carry mel weight and folds each
  mel over its nonzero filterbank band: the layout ``kernel_layout`` builds
  on the host, once per device and settings.
"""
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from transformertts_torch.audio import spectral

TILE_BINS = 128  # bins a basis tile (csrc/fused_log_mel.cu)
K_CHUNK = 16     # basis rows staged a step: n_fft must be a multiple
MAX_MELS = 80   # mel accumulators a thread keeps: every fourth of 80


def fused_log_mel_plain(wav_centered: torch.Tensor, sampling_rate: int, n_fft: int,
                        hop_length: int, win_length: int, n_mels: int, f_min: float,
                        f_max: float, clip_min: float = 1e-5) -> torch.Tensor:
    """Eager reference: ``spectral.mel_spectrogram`` of the pre-padded wav
    (unfold, two GEMMs against the windowed bases, the magnitude, the mel
    GEMM) and the clipped log; (B, T) → (B, F, n_mels)."""
    mel = spectral.mel_spectrogram(wav_centered.float(), sampling_rate, n_fft, hop_length,
                                   win_length, n_mels, f_min, f_max, center=False)
    return torch.log(torch.clamp(mel, min=clip_min))


class KernelLayout(NamedTuple):
    basis: torch.Tensor  # (n_tiles, n_fft, 2·TILE_BINS): cos | −sin of bins k_lo + j
    fb: torch.Tensor     # (n_mels, 1 + n_fft//2) float32 filterbank
    bands: torch.Tensor  # (n_mels, 2) int32: [lo, hi) of each mel's nonzero weights
    k_lo: int            # first bin with mel weight
    k_hi: int            # one past the last


@functools.lru_cache(maxsize=8)
def kernel_layout(device: str, sampling_rate: int, n_fft: int, win_length: int,
                  n_mels: int, f_min: float, f_max: float) -> KernelLayout:
    """The kernel's inputs besides the wav, built once per device and settings."""
    fb = spectral.mel_filterbank(sampling_rate, n_fft, n_mels, f_min, f_max).astype(np.float32)
    nonzero = fb != 0
    bands = np.zeros((n_mels, 2), np.int32)
    for m in range(n_mels):
        idx = np.flatnonzero(nonzero[m])
        if idx.size:
            bands[m] = idx[0], idx[-1] + 1
    used = np.flatnonzero(nonzero.any(axis=0))
    k_lo, k_hi = (int(used[0]), int(used[-1]) + 1) if used.size else (0, 0)
    n_tiles = -(-(k_hi - k_lo) // TILE_BINS)
    cos_b, sin_b = spectral.dft_basis(n_fft, win_length)
    basis = np.zeros((n_tiles, n_fft, 2, TILE_BINS), np.float32)
    for t in range(n_tiles):
        lo = k_lo + t * TILE_BINS
        hi = min(k_hi, lo + TILE_BINS)
        basis[t, :, 0, :hi - lo] = cos_b[:, lo:hi]
        basis[t, :, 1, :hi - lo] = sin_b[:, lo:hi]
    return KernelLayout(torch.as_tensor(basis.reshape(n_tiles, n_fft, -1), device=device),
                        torch.as_tensor(fb, device=device),
                        torch.as_tensor(bands, device=device), k_lo, k_hi)


@functools.cache
def _entry():
    """The ctypes launch entry of ``csrc/fused_log_mel.cu``, built, loaded and typed once."""
    from transformertts_torch.ops import build
    fn = build.load('fused_log_mel').fused_log_mel
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
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
    if n_fft % K_CHUNK or not 0 < win_length <= n_fft or hop_length < 1:
        raise ValueError(f'fused_log_mel: n_fft {n_fft} must be a multiple of {K_CHUNK}, '
                         f'win_length {win_length} in [1, n_fft], hop {hop_length} >= 1')
    if not 1 <= n_mels <= MAX_MELS:
        raise ValueError(f'fused_log_mel: n_mels {n_mels} must lie in [1, {MAX_MELS}]')
    if b < 1 or t < n_fft:
        raise ValueError(f'fused_log_mel: the wav (B={b}, T={t}) needs B >= 1, T >= n_fft')
    fn = _entry()
    layout = kernel_layout(str(wav_centered.device), sampling_rate, n_fft, win_length,
                           n_mels, f_min, f_max)
    n_frames = 1 + (t - n_fft) // hop_length
    out = torch.empty(b, n_frames, n_mels, dtype=torch.float32, device=wav_centered.device)
    with torch.cuda.device(wav_centered.device):
        stream = torch.cuda.current_stream(wav_centered.device).cuda_stream
        err = fn(wav_centered.data_ptr(), b, t, n_frames, hop_length, n_fft,
                 layout.basis.data_ptr(), layout.basis.shape[0], layout.k_lo,
                 layout.fb.data_ptr(), layout.fb.shape[1], layout.bands.data_ptr(), n_mels,
                 clip_min, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'fused_log_mel launch failed at hop {hop_length}, n_fft {n_fft}: '
                           f'CUDA error {err} (a block holds 63·hop + n_fft wav samples '
                           f'in shared memory)')
    fused_log_mel.launches += 1
    return out


fused_log_mel.launches = 0
