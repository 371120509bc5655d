"""Config-driven audio for serving, the counterpart of the serving surface of
``transformertts_tpu/audio/__init__.py``: the MelGAN and WaveRNN
normalizers, mel → waveform by mel inversion and Griffin-Lim, and wav
output. Featurization (mel spectrograms, pitch, VAD) comes in a later slice.
"""
import sys

import numpy as np
import torch

from transformertts_torch.audio import griffinlim, wav_io

__all__ = ['Audio', 'Normalizer', 'MelGAN', 'WaveRNN']


def _xp(S):
    return torch if isinstance(S, torch.Tensor) else np


class Normalizer:
    """Maps amplitude mels to the model's normalized scale and back; works
    on numpy arrays and on torch tensors."""

    def normalize(self, S):
        raise NotImplementedError

    def denormalize(self, S):
        raise NotImplementedError


class MelGAN(Normalizer):
    """log-mel with a 1e-5 amplitude floor."""

    clip_min = 1.0e-5

    def normalize(self, S):
        xp = _xp(S)
        return xp.log(xp.clip(S, self.clip_min, None))

    def denormalize(self, S):
        return _xp(S).exp(S)


class WaveRNN(Normalizer):
    """dB-scaled mel in [-4, 4]."""

    min_level_db = -100
    max_norm = 4

    def normalize(self, S):
        xp = _xp(S)
        S = 20 * xp.log10(xp.clip(S, 1e-5, None))
        S = xp.clip((S - self.min_level_db) / -self.min_level_db, 0, 1)
        return (S * 2 * self.max_norm) - self.max_norm

    def denormalize(self, S):
        S = (S + self.max_norm) / (2 * self.max_norm)
        S = (_xp(S).clip(S, 0, 1) * -self.min_level_db) + self.min_level_db
        return 10.0 ** (S * 0.05)


class Audio:
    """Audio settings of a model config (extra config keys are ignored)."""

    def __init__(self, sampling_rate: int, n_fft: int, mel_channels: int,
                 hop_length: int, win_length: int, f_min: int, f_max: int,
                 normalizer: str, griffin_lim_iters: int = 32, **kwargs):
        self.sampling_rate = sampling_rate
        self.n_fft = n_fft
        self.mel_channels = mel_channels
        self.hop_length = hop_length
        self.win_length = win_length
        self.f_min = f_min
        self.f_max = f_max
        self.griffin_lim_iters = griffin_lim_iters
        self.normalizer = getattr(sys.modules[__name__], normalizer)()

    @classmethod
    def from_config(cls, config: dict) -> 'Audio':
        return cls(**config)

    def silence_level(self) -> float:
        """The normalized value of a silent (1e-10 amplitude) mel bin."""
        return float(self.normalizer.normalize(np.full((1, 1), 1e-10, np.float32))[0, 0])

    def mels_to_waveforms(self, mels: torch.Tensor, n_iter: int = None) -> torch.Tensor:
        """Normalized log-mels (B, T, mel_channels) on any device →
        waveforms (B, hop·(T−1)) on the same device."""
        n_iter = n_iter if n_iter is not None else self.griffin_lim_iters
        amp = self.normalizer.denormalize(mels.float())
        S = griffinlim.mel_to_linear(amp, self.sampling_rate, self.n_fft,
                                     self.f_min, self.f_max)
        return griffinlim.griffin_lim(S, n_iter, self.n_fft, self.hop_length,
                                      self.win_length)

    def reconstruct_waveform_batch(self, mels, device, n_iter: int = None) -> np.ndarray:
        """Batched Griffin-Lim on ``device``: (B, T, mel_channels) normalized
        log-mels → (B, samples) numpy waveforms."""
        mels = torch.as_tensor(np.asarray(mels, np.float32), device=device)
        # the padded-domain iteration needs n_fft//hop frames: edge-pad
        # degenerate (untrained-model) mels
        min_frames = max(self.n_fft // self.hop_length, 2)
        if mels.shape[1] < min_frames:
            pad = mels[:, -1:].expand(-1, min_frames - mels.shape[1], -1)
            mels = torch.cat([mels, pad], dim=1)
        return self.mels_to_waveforms(mels, n_iter).cpu().numpy()

    def reconstruct_waveform(self, mel, device, n_iter: int = None) -> np.ndarray:
        """One normalized log-mel (T, mel_channels), or (mel_channels, T) as
        the reference accepts, → waveform, computed on ``device``."""
        mel = np.asarray(mel, np.float32)
        if mel.shape[0] == self.mel_channels:
            mel = mel.T
        return self.reconstruct_waveform_batch(mel[None], device, n_iter)[0]

    def save_wav(self, y, wav_path):
        wav_io.save_wav(np.asarray(y), wav_path, self.sampling_rate)
