"""Mel inversion and Griffin-Lim, the counterparts of
``transformertts_tpu/audio/griffinlim.py``.

- ``mel_to_linear``: amplitude mel → linear magnitude by the pseudo-inverse
  of the mel filterbank, refined by multiplicative NNLS updates (float32
  GEMMs on the tensors' device).
- ``griffin_lim``: phase recovery by ISTFT→STFT round trips with momentum
  0.99 and zero-phase init, batched. Where the hop tiles n_fft it runs in
  the padded signal domain (the ISTFT lays frames down at hop offsets and
  the STFT re-frames the same signal, no gather); other hops take the gather
  form, a centered ``spectral.istft``/``spectral.stft`` round trip each
  iteration. ``waveform_form`` picks the implementation from what it can
  see: at n_fft 256–2048 (powers of two) with a hop that tiles it, a CUDA
  tensor runs the hand-written FFT kernel (``ops/griffin_lim.py``, one
  launch an iteration) and a CPU tensor its plain version; another n_fft
  with a tiling hop runs the padded form as float32 DFT GEMMs
  (``_griffin_lim_padded``).
"""
from functools import lru_cache

import numpy as np
import torch

from transformertts_torch.audio import spectral
from transformertts_torch.utils import tracing


@lru_cache(maxsize=8)
def mel_pinv(sampling_rate: int, n_fft: int, n_mels: int,
             f_min: float, f_max: float) -> np.ndarray:
    """(n_mels, n_bins) pseudo-inverse of the mel filterbank."""
    fb = spectral.mel_filterbank(sampling_rate, n_fft, n_mels, f_min, f_max)
    return np.linalg.pinv(fb).T.astype(np.float32)


def mel_to_linear(amp_mel: torch.Tensor, sampling_rate: int, n_fft: int,
                  f_min: float, f_max: float, refine_iters: int = 10) -> torch.Tensor:
    """Amplitude mel (..., T, n_mels) → linear magnitude (..., T, 1 + n_fft//2).

    Pseudo-inverse init, then ``refine_iters`` updates
    s ← s · (m fb) / (s fbᵀ fb).
    """
    mels = amp_mel.shape[-1]
    like = dict(dtype=amp_mel.dtype, device=amp_mel.device)
    pinv = torch.as_tensor(mel_pinv(sampling_rate, n_fft, mels, f_min, f_max), **like)
    S = torch.clamp_min(amp_mel @ pinv, 1e-10)
    if refine_iters > 0:
        fb = torch.as_tensor(
            spectral.mel_filterbank(sampling_rate, n_fft, mels, f_min, f_max), **like)
        num = amp_mel @ fb
        for _ in range(refine_iters):
            S = S * num / ((S @ fb.T) @ fb + 1e-10)
    return torch.clamp_min(S, 0.0)


def _wsq_envelope(n_fft: int, hop_length: int, win_length: int,
                  n_frames: int) -> np.ndarray:
    """Squared-window overlap-add envelope over the padded signal length."""
    w2 = spectral.padded_window(n_fft, win_length) ** 2
    wsq = np.zeros(n_fft + hop_length * (n_frames - 1))
    for k in range(n_fft // hop_length):
        strip = np.tile(w2[k * hop_length:(k + 1) * hop_length], n_frames)
        wsq[k * hop_length:k * hop_length + strip.shape[0]] += strip
    return np.maximum(wsq, 1e-10).astype(np.float32)


def waveform_form(device_type: str, n_fft: int, hop_length: int) -> str:
    """Which implementation ``griffin_lim`` runs: 'gather' for a hop that
    does not tile n_fft; 'kernel' (a CUDA tensor) or 'plain' (a CPU tensor)
    at the kernel's n_fft; 'padded' (DFT GEMMs) otherwise."""
    from transformertts_torch.ops.griffin_lim import KERNEL_N_FFT
    if n_fft % hop_length != 0:
        return 'gather'
    if n_fft not in KERNEL_N_FFT:
        return 'padded'
    return 'kernel' if device_type == 'cuda' else 'plain'


def griffin_lim(S: torch.Tensor, n_iter: int, n_fft: int, hop_length: int,
                win_length: int, momentum: float = 0.99) -> torch.Tensor:
    """Magnitude STFT S (B, n_frames, n_bins) → waveforms (B, hop·(n_frames−1)).
    With tracing on, counts the frame slots (B·n_frames) in ``gl_frame_slots``
    and those the kernel took in ``gl_kernel_frame_slots``."""
    S = S.float()
    form = waveform_form(S.device.type, n_fft, hop_length)
    if tracing.enabled():
        slots = S.shape[0] * S.shape[1]
        tracing.count('gl_frame_slots', slots)
        tracing.count('gl_kernel_frame_slots', slots if form == 'kernel' else 0)
    if form == 'gather':
        return _griffin_lim_general(S, n_iter, n_fft, hop_length, win_length, momentum)
    if form == 'padded':
        return _griffin_lim_padded(S, n_iter, n_fft, hop_length, win_length, momentum)
    from transformertts_torch.ops.griffin_lim import griffin_lim_kernel, griffin_lim_plain
    run = griffin_lim_kernel if form == 'kernel' else griffin_lim_plain
    return run(S, n_iter, n_fft, hop_length, win_length, momentum)


def _griffin_lim_padded(S: torch.Tensor, n_iter: int, n_fft: int, hop_length: int,
                        win_length: int, momentum: float) -> torch.Tensor:
    """The padded signal domain as float32 GEMMs against the DFT bases: the
    ISTFT lays frames down with n_fft/hop hop-wide strip adds, the STFT
    re-frames with slices."""
    b, n_frames, _ = S.shape
    k_strips = n_fft // hop_length
    span = n_frames * hop_length
    out_len = n_fft + hop_length * (n_frames - 1)
    like = dict(dtype=torch.float32, device=S.device)
    re_b, im_b = (torch.as_tensor(x, **like) for x in spectral.idft_basis(n_fft, win_length))
    cos_b, sin_b = (torch.as_tensor(x, **like) for x in spectral.dft_basis(n_fft, win_length))
    wsq = torch.as_tensor(_wsq_envelope(n_fft, hop_length, win_length, n_frames), **like)

    def istft_padded(re, im):
        frames = re @ re_b + im @ im_b                          # (B, F, n_fft)
        y = torch.zeros(b, out_len, **like)
        for k in range(k_strips):
            strip = frames[:, :, k * hop_length:(k + 1) * hop_length].reshape(b, span)
            y[:, k * hop_length:k * hop_length + span] += strip
        return y / wsq

    def stft_padded(y):
        frames = torch.cat(
            [y[:, k * hop_length:k * hop_length + span].reshape(b, n_frames, hop_length)
             for k in range(k_strips)], dim=-1)                 # (B, F, n_fft)
        return frames @ cos_b, frames @ sin_b

    m = momentum / (1.0 + momentum)
    ang_re, ang_im = torch.ones_like(S), torch.zeros_like(S)
    prev_re, prev_im = torch.zeros_like(S), torch.zeros_like(S)
    for _ in range(n_iter):
        new_re, new_im = stft_padded(istft_padded(S * ang_re, S * ang_im))
        upd_re, upd_im = new_re - m * prev_re, new_im - m * prev_im
        mag = torch.sqrt(upd_re * upd_re + upd_im * upd_im) + 1e-16
        ang_re, ang_im = upd_re / mag, upd_im / mag
        prev_re, prev_im = new_re, new_im
    y = istft_padded(S * ang_re, S * ang_im)
    return y[:, n_fft // 2:out_len - n_fft // 2]


def _griffin_lim_general(S: torch.Tensor, n_iter: int, n_fft: int, hop_length: int,
                         win_length: int, momentum: float) -> torch.Tensor:
    """The gather form for hops that do not tile n_fft: each iteration is a
    centered ISTFT and a reflect-padded STFT of the signal."""
    m = momentum / (1.0 + momentum)
    ang_re, ang_im = torch.ones_like(S), torch.zeros_like(S)
    prev_re, prev_im = torch.zeros_like(S), torch.zeros_like(S)
    for _ in range(n_iter):
        wav = spectral.istft(S * ang_re, S * ang_im, n_fft, hop_length, win_length)
        new_re, new_im = spectral.stft(wav, n_fft, hop_length, win_length)
        upd_re, upd_im = new_re - m * prev_re, new_im - m * prev_im
        mag = torch.sqrt(upd_re * upd_re + upd_im * upd_im) + 1e-16
        ang_re, ang_im = upd_re / mag, upd_im / mag
        prev_re, prev_im = new_re, new_im
    return spectral.istft(S * ang_re, S * ang_im, n_fft, hop_length, win_length)
