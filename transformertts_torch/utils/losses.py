"""Masked losses for TTS training, the counterparts of
``transformertts_tpu/utils/losses.py`` (the ForwardTransformer's part):
masked MAE and MSE, whose mask by default marks the target positions that
are not zero in every channel, and the weighted sum of per-output losses.
All reduce in float32.
"""
from typing import Callable, List, Sequence, Tuple

import torch


def _nonzero_mask(targets: torch.Tensor) -> torch.Tensor:
    """1.0 where a position holds any signal: padding is exactly zero in
    every channel."""
    if targets.dim() == 3:
        return (targets.abs().sum(dim=-1) > 0).float()
    return (targets.abs() > 0).float()


def _masked_mean(err: torch.Tensor, targets: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        mask = _nonzero_mask(targets)
    if err.dim() == 3:
        err = err.mean(dim=-1)
    return (err * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def masked_mean_absolute_error(targets: torch.Tensor, predictions: torch.Tensor,
                               mask: torch.Tensor = None) -> torch.Tensor:
    """MAE over non-padding positions; targets/predictions (B, T, C) or (B, T)."""
    return _masked_mean((targets.float() - predictions.float()).abs(), targets, mask)


def masked_mean_squared_error(targets: torch.Tensor, predictions: torch.Tensor,
                              mask: torch.Tensor = None) -> torch.Tensor:
    """MSE over non-padding positions; targets/predictions (B, T, C) or (B, T)."""
    return _masked_mean((targets.float() - predictions.float()).square(), targets, mask)


def weighted_sum_losses(targets: Sequence, predictions: Sequence,
                        loss_functions: Sequence[Callable], coeffs: Sequence[float]
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(Σ coeff·loss, [loss per output])."""
    losses = [fn(t, p) for fn, t, p in zip(loss_functions, targets, predictions)]
    return sum(c * l for c, l in zip(coeffs, losses)), losses
