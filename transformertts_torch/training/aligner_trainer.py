"""Training step of the Aligner, the counterpart of
``transformertts_tpu/training/aligner_trainer.py``: shifted teacher forcing
with the decoder input strided by the reduction factor r, the masked-MAE mel
loss and the stop-token crossentropy with the stop class scaled
(``stop_scaling``, 8 in the published config), weights [mel 1, stop 1], and
the diagonal-forcing penalties of early training, one Adam update.

Attention routes: a step that forces a diagonal reads every attention map,
and so does a plotting step (``return_attention``) and validation; those run
the eager attention (``need_weights=True``). Every other step runs each
attention whose map nobody reads on the fused kernels: K2 forward, K3/K4
backward, in float32 for the published Aligner (13 of each a micro-batch:
4 encoder, 5 decoder causal self-attentions, 4 cross-attentions); the last
block's cross-attention is eager in every step, as in inference.

``mesh=`` trains over the mesh (``training/base_trainer.py``); the
diagonal penalty then counts the real samples of the whole batch over the
data ranks, as the JAX loss counts them over the whole sharded batch.
"""
import functools
from typing import Optional

import torch

from transformertts_torch.training.base_trainer import BaseTrainer
from transformertts_torch.utils.losses import (global_count, masked_mean_absolute_error,
                                               new_scaled_crossentropy, weighted_sum_losses)
from transformertts_torch.utils.metrics import batch_diagonal_mask

LOSS_WEIGHTS = (1.0, 1.0)  # mel, stop


def aligner_loss(model, batch: dict, r: int, stop_loss, force_encoder_diagonal: bool,
                 force_decoder_diagonal: bool, training: bool,
                 generator: Optional[torch.Generator] = None, need_weights: bool = None,
                 mesh=None):
    """Shift → stride → forward → weighted losses (+ diagonal penalties).
    Returns (total loss, (losses, model outputs)). ``need_weights`` (by
    default: when a diagonal is forced) takes the eager attention, which
    returns every map. With ``mesh`` every count is the whole batch's over
    the mesh's data ranks."""
    if need_weights is None:
        need_weights = force_encoder_diagonal or force_decoder_diagonal
    tokens = batch['tokens']
    mel = batch['mel']                  # (B, T, C) with the start and end frames
    stop_probs = batch['stop_probs']    # (B, T) {0 pad, 1 continue, 2 stop}
    tar_inp = mel[:, :-1]
    tar_real = mel[:, 1:]
    tar_stop = stop_probs[:, 1:]
    mel_len = tar_inp.shape[1]
    strided = tar_inp[:, ::r]
    out = model.apply(tokens, strided, r, need_weights=need_weights, training=training,
                      generator=generator)
    total, (l_mel, l_stop) = weighted_sum_losses(
        (tar_real, tar_stop),
        (out['mel'][:, :mel_len], out['stop_prob'][:, :mel_len]),
        (functools.partial(masked_mean_absolute_error, mesh=mesh),
         functools.partial(stop_loss, mesh=mesh)), LOSS_WEIGHTS)

    phon_len = (1.0 - out['text_mask'][:, 0, 0, :]).sum(dim=1)
    # per REAL sample: all-zero rows that pad a bucket's batch add nothing to
    # the sum and must not grow the denominator
    n_real = torch.clamp_min(
        global_count(((tokens != 0).sum(dim=1) > 0).float().sum(), mesh), 1.0)

    def diag_penalty(att, dmask):
        per_sample = (att * dmask).sum(dim=(-2, -1))      # (B, H)
        return per_sample.sum() / (n_real * per_sample.shape[1]) / 10.0

    d_loss = torch.zeros((), device=total.device)
    norm = 1.0
    if force_decoder_diagonal:
        dec_len = (1.0 - out['mel_mask'][:, 0, 0, :]).sum(dim=1)
        maps = list(out['decoder_attention'].values())
        dmask = batch_diagonal_mask(maps[0].shape, dec_len, phon_len)
        for att in maps:
            d_loss = d_loss + diag_penalty(att, dmask)
        norm += len(maps)
    if force_encoder_diagonal:
        maps = list(out['encoder_attention'].values())
        dmask = batch_diagonal_mask(maps[0].shape, phon_len, phon_len)
        for att in maps:
            d_loss = d_loss + diag_penalty(att, dmask)
        norm += len(maps)
    d_loss = d_loss / norm
    total = total + d_loss
    losses = {'loss': total, 'mel': l_mel, 'stop_prob': l_stop, 'diag_loss': d_loss}
    return total, (losses, out)


class AlignerTrainer(BaseTrainer):
    """``train_step(batch, r, force_encoder_diagonal, force_decoder_diagonal,
    return_attention)`` and ``val_step(batch, r, force_*)``; r defaults to
    the model's. Under ``grad_accumulation`` the flags apply to every
    micro-batch, and the maps are concatenated along the batch."""

    def __init__(self, model: torch.nn.Module, learning_rate_schedule,
                 stop_scaling: float = 8.0, base_rng_seed: int = 42,
                 grad_accumulation: int = 1, narrow_pv: bool = False, mesh=None):
        """``narrow_pv`` is accepted and ignored: the port's kernels compute
        P·V in float32, which is the JAX trainer's ``narrow_pv: false``."""
        super().__init__(model, learning_rate_schedule, base_rng_seed, grad_accumulation,
                         mesh)
        self.stop_loss = new_scaled_crossentropy(index=2, scaling=stop_scaling)

    def loss(self, batch, training, generator, r: int = None,
             force_encoder_diagonal: bool = False, force_decoder_diagonal: bool = False,
             return_attention: bool = False):
        r = self.model.r if r is None else r
        # validation returns the maps, as the JAX trainer's does
        need_weights = (force_encoder_diagonal or force_decoder_diagonal
                        or return_attention or not training)
        total, (losses, out) = aligner_loss(
            self.model, batch, r, self.stop_loss, force_encoder_diagonal,
            force_decoder_diagonal, training, generator, need_weights, self.mesh)
        aux = dict(losses)
        if return_attention or not training:
            for key in ('decoder_attention', 'encoder_attention', 'text_mask', 'mel_mask'):
                aux[key] = out[key]
        if not training:
            aux['mel_pred'] = out['mel']
        return total, aux

    def train_step(self, batch, r: int = None, force_encoder_diagonal: bool = False,
                   force_decoder_diagonal: bool = False,
                   return_attention: bool = False) -> dict:
        return super().train_step(batch, r=r, force_encoder_diagonal=force_encoder_diagonal,
                                  force_decoder_diagonal=force_decoder_diagonal,
                                  return_attention=return_attention)

    def val_step(self, batch, r: int = None, force_encoder_diagonal: bool = False,
                 force_decoder_diagonal: bool = False) -> dict:
        return super().val_step(batch, r=r, force_encoder_diagonal=force_encoder_diagonal,
                                force_decoder_diagonal=force_decoder_diagonal)
