"""Lengths from padding, the counterpart of
``transformertts_tpu/utils/spectrogram_ops.py``. Each takes a torch tensor or
a numpy array and returns the same kind (int64)."""


def mel_lengths(mel_batch, padding_value: float = 0.0):
    """(B, T, C) → (B,) count of frames that are not all ``padding_value``."""
    return (mel_batch != padding_value).any(-1).sum(-1)


def phoneme_lengths(phonemes, phoneme_padding: int = 0):
    """(B, N) → (B,) count of non-padding token ids."""
    return (phonemes != phoneme_padding).sum(-1)
