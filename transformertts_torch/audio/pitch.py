"""F0 (pitch) extraction over a batch of clips, the counterpart of
``transformertts_tpu/audio/pitch.py``: a YIN estimator (de Cheveigné &
Kawahara 2002) as FFT cross-correlations and cumulative sums, vectorized over
frames, with the batch dimension written out where the JAX package vmaps.

Frames are hop-centred, ``1 + T // hop`` of them: the mel frame count of the
same clip. The lag is the smallest one whose cumulative-mean-normalized
difference is a local minimum below the threshold (else the global minimum),
refined by a parabola through its neighbours; silent frames (RMS ≤ 1e-4)
and frames outside [f0_floor, f0_ceil] are unvoiced, 0.0.
"""
import numpy as np
import torch
import torch.nn.functional as F


def yin_f0(wav: torch.Tensor, sampling_rate: int, hop_length: int,
           frame_length: int = 2048, f0_floor: float = 65.0, f0_ceil: float = 600.0,
           threshold: float = 0.15) -> torch.Tensor:
    """Per-frame F0 of ``wav`` (B, T) → (B, 1 + T // hop) Hz, 0 = unvoiced,
    on the wav's device."""
    wav = wav.float()
    device = wav.device
    n_frames = 1 + wav.shape[-1] // hop_length
    tau_min = max(2, int(sampling_rate / f0_ceil))
    tau_max = min(frame_length // 2, int(np.ceil(sampling_rate / f0_floor)))
    w_int = frame_length - tau_max  # integration window

    # hop-centred frames with zero padding: (B, F, W)
    pad = frame_length // 2
    y = F.pad(wav, (pad, pad + hop_length))
    frames = y.unfold(-1, frame_length, hop_length)[:, :n_frames]

    # cross-correlation c[tau] = sum_j x[j] x[j+tau] for j < w_int, via FFT
    n_fft = int(2 ** np.ceil(np.log2(frame_length * 2)))
    head = frames * (torch.arange(frame_length, device=device) < w_int)
    spec_all = torch.fft.rfft(frames, n=n_fft, dim=-1)
    spec_head = torch.fft.rfft(head, n=n_fft, dim=-1)
    corr = torch.fft.irfft(torch.conj(spec_head) * spec_all, n=n_fft,
                           dim=-1)[..., :tau_max + 1]

    # sliding power p[tau] = sum_{j=tau}^{tau+w_int-1} x[j]^2
    csum = F.pad(torch.cumsum(frames * frames, dim=-1), (1, 0))
    taus = torch.arange(tau_max + 1, device=device)
    p = csum[..., taus + w_int] - csum[..., taus]             # (B, F, tau_max+1)

    d = torch.clamp(p[..., :1] + p - 2.0 * corr, min=0.0)     # YIN difference
    # cumulative-mean-normalized difference, d'(0) = 1
    cum = torch.cumsum(d[..., 1:], dim=-1)
    cmnd = d[..., 1:] * taus[1:] / torch.clamp(cum, min=1e-12)
    cmnd = F.pad(cmnd, (1, 0), value=1.0)

    band = (taus >= tau_min) & (taus <= tau_max)
    inf = torch.tensor(float('inf'), device=device)
    cmnd_band = torch.where(band, cmnd, inf)
    # the smallest lag that is a local minimum below the threshold; else the
    # global minimum (a global argmin prefers the deeper dip at 2·tau)
    prev = F.pad(cmnd_band[..., :-1], (1, 0), value=float('inf'))
    nxt = F.pad(cmnd_band[..., 1:], (0, 1), value=float('inf'))
    is_dip = (cmnd_band <= prev) & (cmnd_band <= nxt) & (cmnd_band < threshold)
    first_dip = torch.where(is_dip, taus, tau_max + 1).amin(dim=-1)
    tau_global = torch.argmin(cmnd_band, dim=-1)
    tau_star = torch.where(first_dip <= tau_max, first_dip, tau_global)
    min_cmnd = torch.gather(cmnd_band, -1, tau_star[..., None])[..., 0]

    # parabolic interpolation around the minimum
    t0 = torch.clamp(tau_star, 1, tau_max - 1)
    dm, d0, dp = (torch.gather(cmnd, -1, (t0 + o)[..., None])[..., 0] for o in (-1, 0, 1))
    denom = dm - 2.0 * d0 + dp
    curved = denom.abs() > 1e-12
    shift = torch.where(curved, 0.5 * (dm - dp) / torch.where(curved, denom, 1.0), 0.0)
    tau_refined = t0.float() + torch.clamp(shift, -1.0, 1.0)

    f0 = sampling_rate / torch.clamp(tau_refined, min=1.0)
    voiced = (min_cmnd < threshold) & (f0 >= f0_floor) & (f0 <= f0_ceil)
    frame_rms = torch.sqrt(torch.mean(frames * frames, dim=-1) + 1e-12)
    voiced = voiced & (frame_rms > 1e-4)   # energy gate: silent frames are unvoiced
    return torch.where(voiced, f0, 0.0)


def extract_pitch_np(wav: np.ndarray, sampling_rate: int, hop_length: int,
                     device='cuda', **kwargs) -> np.ndarray:
    """One clip (T,) → (1 + T // hop,) F0 as numpy, computed on ``device``."""
    y = torch.as_tensor(np.asarray(wav, np.float32), device=device)[None]
    return yin_f0(y, sampling_rate, hop_length, **kwargs)[0].cpu().numpy()
