"""What the check that decides ``correct`` in a serving cell shares across
model families. A family's ``judge`` (``families/<model_family>.py``) gives
the compared numbers over the sampled records, with the helpers here; the
configuration's ``limits`` name the numbers its cell compares (``checks``).
"""
import numpy as np
import torch

from h100bench.reference import waveform
from h100bench.reference.numerics import Precision


def rel_gap(mine: torch.Tensor, want: torch.Tensor) -> float:
    return float((mine.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def reference_wave(mel: torch.Tensor, cfg: dict, vocoder_weights, prec: Precision = None):
    """The reference waveform stage on a (frames, mels) mel: Griffin-Lim, or
    the configuration's HiFi-GAN generator."""
    if cfg.get('vocoder'):
        return waveform.hifigan_wave(mel, vocoder_weights, cfg['vocoder'], prec)
    return waveform.griffin_lim_wave(mel, cfg['audio'], prec)


def hop_of(cfg: dict) -> int:
    if cfg.get('vocoder'):
        return int(np.prod(cfg['vocoder']['upsample_rates']))
    return cfg['audio']['hop_length']


def checks(numbers: dict, limits: dict) -> tuple:
    """({name: (value, limit)} of the numbers ``limits`` names, and whether
    all hold over at least one checked sentence."""
    out = {name: (numbers[name], limit) for name, limit in limits.items()}
    ok = numbers['checked_sentences'] >= 1 and all(numbers[k] <= v for k, v in limits.items())
    return out, ok
