"""The waveform stages in plain PyTorch: mel inversion with Griffin-Lim, and
the HiFi-GAN V1 generator.

- ``griffin_lim_wave``: a MelGAN-normalized log-mel (frames, mels) →
  amplitude mel (exp) → linear magnitude by the mel filterbank's
  pseudo-inverse and 10 multiplicative refinements
  s ← s · (m fb) / (s fbᵀ fb + 1e-10) (librosa's ``mel_to_stft``
  approach), then fast Griffin-Lim (Perraudin et al. 2013, momentum 0.99,
  zero initial phase) with real FFTs: each iteration an inverse STFT
  (periodic Hann window, overlap-add over n_fft + hop·(frames − 1) samples,
  divided by the squared-window envelope) and an STFT of that signal's
  frames; the last inverse STFT's centre, hop·(frames − 1) samples, is the
  wave.
- ``hifigan_wave``: the jik876/hifi-gan generator (``models.py``
  ``Generator``, resblock type 1) from its weights, zero-padded convs.

Both return the wave scaled down where its peak exceeds 1, as the served
waves are. ``prec`` rounds the operands of every product and transform.
"""
import numpy as np
import torch
import torch.nn.functional as F

from h100bench.reference.numerics import Precision

LRELU = 0.1


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, f_min: float, f_max: float) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) Slaney mel filterbank (librosa ``htk=False,
    norm='slaney'``)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    ramps = pts[:, None] - freqs[None, :]
    fdiff = np.diff(pts)
    weights = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                         ramps[2:] / fdiff[1:, None]))
    return weights * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]


def peak_scaled(wav: torch.Tensor) -> torch.Tensor:
    return wav / torch.clamp_min(wav.abs().max(), 1.0)


def griffin_lim_wave(log_mel: torch.Tensor, audio: dict, prec: Precision = None
                     ) -> torch.Tensor:
    p = prec or Precision('float32')
    dev = log_mel.device
    n_fft, hop = audio['n_fft'], audio['hop_length']
    fb64 = mel_filterbank(audio['sampling_rate'], n_fft, log_mel.shape[1], audio['f_min'],
                          audio['f_max'])
    fb = torch.as_tensor(fb64, dtype=torch.float32, device=dev)
    pinv = torch.as_tensor(np.linalg.pinv(fb64).T, dtype=torch.float32, device=dev)
    amp = torch.exp(log_mel.float())
    S = torch.clamp_min(p(amp) @ p(pinv), 1e-10)
    num = p(amp) @ p(fb)
    for _ in range(10):
        S = S * num / (p(p(S) @ p(fb).T) @ p(fb) + 1e-10)
    S = torch.clamp_min(S, 0.0)

    frames = S.shape[0]
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=dev)
    out_len = n_fft + hop * (frames - 1)
    starts = torch.arange(frames, device=dev)[:, None] * hop + torch.arange(n_fft, device=dev)
    env = torch.zeros(out_len, device=dev).index_add_(
        0, starts.reshape(-1), (win ** 2).repeat(frames)).clamp_min(1e-10)

    def istft(z):
        fr = torch.fft.irfft(torch.complex(p(z.real), p(z.imag)), n=n_fft) * win
        return torch.zeros(out_len, device=dev).index_add_(0, starts.reshape(-1),
                                                           fr.reshape(-1)) / env

    def stft(y):
        return torch.fft.rfft(p(y[starts] * win))

    m = 0.99 / 1.99
    angles = torch.ones_like(S, dtype=torch.complex64)
    prev = torch.zeros_like(angles)
    for _ in range(audio['griffin_lim_iters']):
        new = stft(istft(S * angles))
        upd = new - m * prev
        angles = upd / (upd.abs() + 1e-16)
        prev = new
    y = istft(S * angles)
    return peak_scaled(y[n_fft // 2:out_len - n_fft // 2])


def hifigan_wave(log_mel: torch.Tensor, w: dict, cfg: dict, prec: Precision = None
                 ) -> torch.Tensor:
    p = prec or Precision('float32')

    def conv(name, x, dilation=1):
        k = w[f'{name}.weight'].shape[2]
        return F.conv1d(p(x), p(w[f'{name}.weight']), w[f'{name}.bias'], dilation=dilation,
                        padding=(k * dilation - dilation) // 2)

    x = conv('conv_pre', log_mel.float().T[None])
    kernels, dilations = cfg['resblock_kernel_sizes'], cfg['resblock_dilation_sizes']
    n = len(kernels)
    for i, (u, k) in enumerate(zip(cfg['upsample_rates'], cfg['upsample_kernel_sizes'])):
        x = F.conv_transpose1d(p(F.leaky_relu(x, LRELU)), p(w[f'ups.{i}.weight']),
                               w[f'ups.{i}.bias'], stride=u, padding=(k - u) // 2)
        total = 0
        for j in range(n):
            r = f'resblocks.{i * n + j}'
            y = x
            for c, d in enumerate(dilations[j]):
                t = conv(f'{r}.convs1.{c}', F.leaky_relu(y, LRELU), d)
                y = y + conv(f'{r}.convs2.{c}', F.leaky_relu(t, LRELU))
            total = total + y
        x = total / n
    x = conv('conv_post', F.leaky_relu(x, 0.01))
    return peak_scaled(torch.tanh(x)[0, 0])
