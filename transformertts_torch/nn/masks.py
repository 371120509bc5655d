"""Mask construction, the counterpart of ``transformertts_tpu/nn/masks.py``.

Masks are float tensors where **1 = masked**, applied additively to attention
logits as ``logits + mask * -1e9``, broadcasting to (batch, heads, q, k).
"""
import torch


def encoder_padding_mask(seq: torch.Tensor) -> torch.Tensor:
    """Token id 0 is padding. (B, T) int → (B, 1, 1, T) float32."""
    return (seq == 0).float()[:, None, None, :]


def mel_padding_mask(mel: torch.Tensor) -> torch.Tensor:
    """All-zero mel frames are padding. (B, T, C) → (B, 1, 1, T) float32."""
    return (mel.abs().sum(dim=-1) == 0).float()[:, None, None, :]


def look_ahead_mask(size: int, device=None) -> torch.Tensor:
    """Causal mask: (size, size) float32, 1 above the diagonal (masked)."""
    return 1.0 - torch.tril(torch.ones(size, size, device=device))
