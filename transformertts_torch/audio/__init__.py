"""Config-driven audio, the counterpart of ``transformertts_tpu/audio/__init__.py``:
the MelGAN and WaveRNN normalizers; featurization (mel spectrograms, the
fused log-mel of centre-padded batches, YIN pitch) on the card unless the
caller names another device; wav loading with the offline cleanup (volume normalization, VAD
silence trimming) on the host; mel → waveform by mel inversion and
Griffin-Lim; wav output; a mel plot (``display_mel``, which needs matplotlib,
imported only there).
"""
import sys

import numpy as np
import torch

from transformertts_torch.audio import griffinlim, pitch, spectral, vad, wav_io

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
    """Audio settings of a model or session config (extra keys are ignored)."""

    def __init__(self, sampling_rate: int, n_fft: int, mel_channels: int,
                 hop_length: int, win_length: int, f_min: int, f_max: int,
                 normalizer: str, norm_wav: bool = None, target_dBFS: int = None,
                 int16_max: int = None, trim_long_silences: bool = None,
                 trim_silence: bool = None, trim_silence_top_db: int = None,
                 vad_window_length: int = None, vad_sample_rate: int = None,
                 vad_moving_average_width: int = None, vad_max_silence_length: int = None,
                 griffin_lim_iters: int = 32, **kwargs):
        # the settings as given, to rebuild this Audio in a worker process
        self.config = {k: v for k, v in locals().items()
                       if k not in ('self', 'kwargs', '__class__')}
        self.config.update(kwargs)
        self.sampling_rate = sampling_rate
        self.n_fft = n_fft
        self.mel_channels = mel_channels
        self.hop_length = hop_length
        self.win_length = win_length
        self.f_min = f_min
        self.f_max = f_max
        self.norm_wav = norm_wav
        self.target_dBFS = target_dBFS
        self.int16_max = int16_max
        self.trim_long_silences = trim_long_silences
        self.trim_silence = trim_silence
        self.trim_silence_top_db = trim_silence_top_db
        self.vad_window_length = vad_window_length
        self.vad_sample_rate = vad_sample_rate
        self.vad_moving_average_width = vad_moving_average_width
        self.vad_max_silence_length = vad_max_silence_length
        self.griffin_lim_iters = griffin_lim_iters
        self.normalizer = getattr(sys.modules[__name__], normalizer)()

    @classmethod
    def from_config(cls, config: dict) -> 'Audio':
        return cls(**config)

    # --- featurization (device) ----------------------------------------------

    def _mel_args(self):
        return (self.sampling_rate, self.n_fft, self.hop_length, self.win_length,
                self.mel_channels, self.f_min, self.f_max)

    def mel_spectrogram(self, wav, device='cuda') -> np.ndarray:
        """One waveform (T,) → normalized log-mel (1 + T // hop, mel_channels),
        computed on ``device``: what the models are trained to reproduce."""
        y = torch.as_tensor(np.asarray(wav, np.float32), device=device)
        return self.mel_spectrogram_batch(y[None])[0].cpu().numpy()

    def mel_spectrogram_batch(self, wavs: torch.Tensor) -> torch.Tensor:
        """(B, T) → normalized log-mel (B, 1 + T // hop, mel_channels) on the
        wavs' device, reflect-centred."""
        return self.normalizer.normalize(
            spectral.mel_spectrogram(wavs.float(), *self._mel_args()))

    def log_mel_batch_centered(self, wavs_centered: torch.Tensor) -> torch.Tensor:
        """Normalized log-mel of centre-pre-padded wavs (B, T + n_fft) on their
        device: the fused frontend (K5) for the MelGAN normalizer, whose clipped
        log it fuses; the GEMM path and the normalizer otherwise."""
        if isinstance(self.normalizer, MelGAN):
            from transformertts_torch.ops.fused_log_mel import fused_log_mel
            return fused_log_mel(wavs_centered, *self._mel_args(),
                                 clip_min=self.normalizer.clip_min)
        return self.normalizer.normalize(spectral.mel_spectrogram(
            wavs_centered.float(), *self._mel_args(), center=False))

    def extract_pitch(self, y, device='cuda') -> np.ndarray:
        """Frame-aligned F0 of one clip (the mel's frame count), on ``device``."""
        return pitch.extract_pitch_np(np.asarray(y, np.float32), self.sampling_rate,
                                      self.hop_length, device=device)

    # --- wav loading and cleanup (host, offline) -----------------------------

    def load_wav(self, wav_path, preprocess=True):
        y, sr = wav_io.load_wav(wav_path, self.sampling_rate)
        if preprocess:
            y = self.preprocess(y)
        return y, sr

    def preprocess(self, y: np.ndarray) -> np.ndarray:
        """Volume normalization (raise only), long-silence and edge-silence
        trimming as the config enables them; a clip whose length is a multiple
        of the hop gains one zero sample, so its frame count is unambiguous."""
        if self.norm_wav:
            y = self.normalize_volume(y, increase_only=True)
        if self.trim_long_silences:
            y = self.trim_audio_long_silences(y)
        if self.trim_silence:
            y = self.trim_audio_silence(y)
        if y.shape[0] % self.hop_length == 0:
            y = np.pad(y, (0, 1))
        return y

    def normalize_volume(self, wav, increase_only=False, decrease_only=False):
        """Scale the clip toward ``target_dBFS`` (the log-RMS of the float wav)."""
        if increase_only and decrease_only:
            raise ValueError('increase_only and decrease_only are exclusive')
        rms = np.sqrt(np.mean(np.square(wav)))
        gain_db = self.target_dBFS - 20.0 * np.log10(rms + 1e-12)
        if (gain_db < 0 and increase_only) or (gain_db > 0 and decrease_only):
            return wav
        return wav * 10.0 ** (gain_db / 20.0)

    def trim_audio_silence(self, wav):
        return vad.trim_silence_top_db(wav, self.trim_silence_top_db,
                                       frame_length=256, hop_length=64)

    def trim_audio_long_silences(self, wav):
        return vad.trim_long_silences(wav, self.sampling_rate, self.vad_window_length,
                                      self.vad_moving_average_width,
                                      self.vad_max_silence_length)

    # --- mel → waveform --------------------------------------------------------

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

    def reconstruct_waveform_batch(self, mels, device='cuda',
                                   n_iter: int = None) -> np.ndarray:
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

    def reconstruct_waveform(self, mel, device='cuda', n_iter: int = None) -> np.ndarray:
        """One normalized log-mel (T, mel_channels), or (mel_channels, T) as
        the reference accepts, → waveform, computed on ``device``."""
        mel = np.asarray(mel, np.float32)
        if mel.shape[0] == self.mel_channels:
            mel = mel.T
        return self.reconstruct_waveform_batch(mel[None], device, n_iter)[0]

    def save_wav(self, y, wav_path):
        wav_io.save_wav(np.asarray(y), wav_path, self.sampling_rate)

    # --- plots -----------------------------------------------------------------

    def display_mel(self, mel, is_normal: bool = True):
        """A mel, (frames, mel_channels) or (mel_channels, frames), normalized
        unless ``is_normal`` is False, as a matplotlib Figure of its dB image
        against its peak, mel bins up."""
        import matplotlib
        matplotlib.use('Agg')
        from matplotlib import pyplot as plt
        mel = np.asarray(mel)
        if is_normal:
            mel = self.normalizer.denormalize(mel)
        if mel.shape[0] != self.mel_channels:
            mel = mel.T
        f = plt.figure(figsize=(10, 4))
        s_db = 20.0 * np.log10(np.maximum(mel, 1e-10) / np.max(mel))
        plt.imshow(s_db, origin='lower', aspect='auto', cmap='magma')
        plt.xlabel('frames')
        plt.ylabel('mel bins')
        return f
