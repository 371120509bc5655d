"""Mask construction, the counterpart of ``transformertts_tpu/nn/masks.py``.

Masks are float tensors where **1 = masked**, applied additively to attention
logits as ``logits + mask * -1e9``, broadcasting to (batch, heads, q, k).
"""
import torch


def encoder_padding_mask(seq: torch.Tensor) -> torch.Tensor:
    """Token id 0 is padding. (B, T) int → (B, 1, 1, T) float32."""
    return (seq == 0).float()[:, None, None, :]

