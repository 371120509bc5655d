"""Masked losses for TTS training, the counterparts of
``transformertts_tpu/utils/losses.py``: masked MAE and MSE, whose mask by
default marks the target positions that are not zero in every channel; the
Aligner's stop-token crossentropy, where class 0 marks padding; and the
weighted sum of per-output losses. All reduce in float32.
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


def masked_crossentropy(targets: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Sparse crossentropy over the positions whose class is not 0 (padding);
    targets (B, T) class ids, logits (B, T, C)."""
    return new_scaled_crossentropy(scaling=1.0)(targets, logits)


def new_scaled_crossentropy(index: int = 2, scaling: float = 1.0
                            ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The stop-token loss: ``masked_crossentropy`` with the positions of
    class ``index`` weighted ``scaling`` times, over the count of non-padding
    positions (clamped at 1). Targets (B, T) in {0 pad, 1 continue, 2 stop},
    logits (B, T, 3)."""

    def loss_fn(targets: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        targets = targets.long()
        mask = (targets > 0).float()
        weight = torch.where(targets == index, float(scaling), 1.0) * mask
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -torch.gather(logp, -1, targets[..., None])[..., 0]
        return (ce * weight).sum() / torch.clamp_min(mask.sum(), 1.0)

    return loss_fn


def weighted_sum_losses(targets: Sequence, predictions: Sequence,
                        loss_functions: Sequence[Callable], coeffs: Sequence[float]
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(Σ coeff·loss, [loss per output])."""
    losses = [fn(t, p) for fn, t, p in zip(loss_functions, targets, predictions)]
    return sum(c * l for c, l in zip(coeffs, losses)), losses
