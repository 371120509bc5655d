"""Training step of the ForwardTransformer, the counterpart of
``transformertts_tpu/training/forward_trainer.py``: the teacher-forced
forward with target durations and pitch, weighted masked-MAE losses
[mel 1, duration 1, pitch 3], one Adam update. ``mesh=`` trains over the
mesh (``training/base_trainer.py``).
"""
import functools

import torch

from transformertts_torch.training.base_trainer import BaseTrainer
from transformertts_torch.utils.losses import (masked_mean_absolute_error,
                                               weighted_sum_losses)

LOSS_WEIGHTS = (1.0, 1.0, 3.0)  # mel, duration, pitch


def forward_loss(model, batch: dict, training: bool, generator=None,
                 need_weights: bool = False, mesh=None):
    """(total loss, (losses, model outputs)). The duration and pitch masks
    come from the token padding, not from nonzero targets: a phoneme may
    rightly have zero duration or zero pitch and must still be supervised.
    ``need_weights`` takes the eager attention, which also returns the
    attention weights, in place of the fused kernels. With ``mesh`` each
    loss divides by the count of the whole batch over the mesh's data ranks."""
    tokens = batch['tokens']
    mel_target = batch['mel']
    dur_target = batch['durations'][..., None].float()
    pitch_target = batch['pitch'][..., None].float()
    out = model.apply(tokens, mel_target.shape[1], target_durations=dur_target,
                      target_pitch=pitch_target, need_weights=need_weights,
                      training=training, generator=generator)
    tok_mask = (tokens > 0).float()
    mae = functools.partial(masked_mean_absolute_error, mesh=mesh)
    total, (l_mel, l_dur, l_pitch) = weighted_sum_losses(
        (mel_target, dur_target, pitch_target),
        (out['mel'], out['duration'], out['pitch']),
        (mae, lambda t, p: mae(t, p, mask=tok_mask), lambda t, p: mae(t, p, mask=tok_mask)),
        LOSS_WEIGHTS)
    losses = {'loss': total, 'mel': l_mel, 'duration': l_dur, 'pitch': l_pitch}
    return total, (losses, out)


class ForwardTrainer(BaseTrainer):

    def loss(self, batch, training, generator):
        total, (losses, out) = forward_loss(self.model, batch, training, generator,
                                            mesh=self.mesh)
        aux = dict(losses)
        aux['duration_pred'] = out['duration'][..., 0]
        if not training:
            aux['mel_pred'] = out['mel']
            aux['pitch_pred'] = out['pitch'][..., 0]
        return total, aux
