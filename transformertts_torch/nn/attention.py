"""Multi-head attention with the reference's concat-q output projection.

Counterpart of ``transformertts_tpu/nn/attention.py``. The output projection
takes ``concat([q_in, attention_output], -1)``, a (2·d → d) dense; this is
checkpoint-shape critical.

Two paths compute the same function:

- ``need_weights=True``: eager ``scaled_dot_product_attention``, which also
  returns the float32 attention weights (diagnostics, the Aligner's last
  cross-attention that duration extraction reads);
- ``need_weights=False``: the fused kernels of ``ops.flash_attention``,
  which never materialize the weights: ``flash_attention`` (K1) when no
  gradient is taken (synthesis, validation, the Aligner's inference),
  ``flash_attention_trainable`` (K2, with K3/K4 in the backward) when one
  is, or when training drops out weights. A head wider than the kernels
  take (``MAX_HEAD_WIDTH``, 256) runs the eager path here too: the choice
  depends on the shape alone, on either device.

Masks are key masks, (B or 1, 1, 1, Tk) with 1 = masked; ``causal`` adds the
look-ahead mask. The eager path combines the two as the JAX package does,
``maximum(key mask, look-ahead)``; the kernels take the key mask as their
(B, Tk) bias and the look-ahead as their ``causal`` flag. Both set a masked
logit to about -1e9. Both run the softmax and the weights·v product in
float32 and return the output in the compute dtype. In training both drop
out the attention weights and the output at the model's ``dropout_rate``, as
the JAX package does.

``project_kv``, ``apply_kv`` and ``apply_cached`` are the autoregressive
decode's pieces: K/V of a fixed memory projected once, attention against
them, and self-attention of one new position against a static per-layer
K/V cache that it writes in place.
"""
from typing import Optional, Tuple

import torch
from torch import nn

from transformertts_torch.nn import core, masks
from transformertts_torch.ops.flash_attention import (MAX_HEAD_WIDTH, NEG_INF,
                                                      flash_attention,
                                                      flash_attention_trainable)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, mask: Optional[torch.Tensor],
                                 dropout_rate: float = 0.0,
                                 generator: Optional[torch.Generator] = None,
                                 training: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, H, T, D); mask broadcastable to (B, H, Tq, Tk), 1 = masked.

    Returns (output (B,H,Tq,D) in v's dtype, weights (B,H,Tq,Tk) float32);
    in training the output takes the dropped-out weights, the returned
    weights are the undropped ones.
    """
    logits = torch.matmul(q, k.transpose(-1, -2)).float()
    logits = logits / torch.sqrt(torch.tensor(q.shape[-1], dtype=torch.float32))
    if mask is not None:
        logits = logits + mask.float() * NEG_INF
    weights = torch.softmax(logits, dim=-1)
    used = core.dropout(weights, dropout_rate, generator, training)
    out = torch.matmul(used, v.float()).to(v.dtype)
    return out, weights


class MultiHeadAttention(nn.Module):

    def __init__(self, model_dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        if model_dim % num_heads != 0:
            raise ValueError(f'model_dim {model_dim} is not a multiple of '
                             f'num_heads {num_heads}')
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.depth = model_dim // num_heads
        self.wq = core.Dense(model_dim, model_dim)
        self.wk = core.Dense(model_dim, model_dim)
        self.wv = core.Dense(model_dim, model_dim)
        self.wo = core.Dense(2 * model_dim, model_dim)

    def _split_heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, self.depth).transpose(1, 2)

    @staticmethod
    def _merge_heads(x: torch.Tensor) -> torch.Tensor:
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def _attend(self, q, k, v, mask, need_weights: bool, causal: bool = False,
                training: bool = False, generator: Optional[torch.Generator] = None):
        """Split-head q (B,H,Tq,D), k/v (B,H,Tk,D) and a key mask → (merged
        output (B,Tq,d), weights (B,H,Tq,Tk) or None). A head wider than
        the kernels take goes to the eager path, which is this module's own
        plain attention: the width is one the kernels do not serve."""
        rate = self.dropout_rate if training else 0.0
        if need_weights or q.shape[-1] > MAX_HEAD_WIDTH:
            if causal:
                look_ahead = masks.look_ahead_mask(q.shape[2], q.device)
                mask = look_ahead if mask is None else torch.maximum(mask, look_ahead)
            attn, weights = scaled_dot_product_attention(q, k, v, mask, rate, generator,
                                                         training)
            weights = weights if need_weights else None
        else:
            b, tk = k.shape[0], k.shape[2]
            if mask is None:
                bias = torch.zeros(b, tk, device=k.device)
            else:
                bias = (mask.float() * NEG_INF).expand(b, 1, 1, tk).reshape(b, tk)
            args = (q.contiguous(), k.contiguous(), v.contiguous(), bias.contiguous(), causal)
            if rate > 0.0 or (torch.is_grad_enabled() and q.requires_grad):
                attn = flash_attention_trainable(*args, dropout_rate=rate,
                                                 generator=generator)
            else:
                attn = flash_attention(*args)
            weights = None
        return self._merge_heads(attn), weights

    def forward(self, v_in: torch.Tensor, k_in: torch.Tensor, q_in: torch.Tensor,
                mask: Optional[torch.Tensor], need_weights: bool = True,
                training: bool = False, generator: Optional[torch.Generator] = None,
                causal: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """mask: (B, 1, 1, Tk) key mask, 1 = masked; ``causal`` adds the
        look-ahead. Returns (out, weights or None)."""
        q = self._split_heads(self.wq(q_in))
        k = self._split_heads(self.wk(k_in))
        v = self._split_heads(self.wv(v_in))
        attn, weights = self._attend(q, k, v, mask, need_weights, causal, training,
                                     generator)
        out = self.wo(torch.cat([q_in, attn], dim=-1))
        rate = self.dropout_rate if training else 0.0
        return core.dropout(out, rate, generator, training), weights

    def project_kv(self, kv_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Split-head K/V projections (B, H, T, D) of a fixed memory (the
        encoder output), computed once for every step of a decode."""
        return (self._split_heads(self.wk(kv_in)).contiguous(),
                self._split_heads(self.wv(kv_in)).contiguous())

    def apply_kv(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], need_weights: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Attention of ``q_in`` against already-projected K/V (decode path,
        no dropout). Returns (out, weights or None)."""
        q = self._split_heads(self.wq(q_in))
        attn, weights = self._attend(q, k, v, mask, need_weights)
        return self.wo(torch.cat([q_in, attn], dim=-1)), weights

    def apply_cached(self, q_in: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, new_kv_in: torch.Tensor, cache_index: int,
                     mask: Optional[torch.Tensor], need_weights: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Self-attention of one decode position against a static cache.

        ``k_cache``/``v_cache`` are (B, H, T_max, D); the new position's K/V,
        projected from ``new_kv_in`` (B, 1, d), are written into them in place
        at ``cache_index``. ``mask`` (B or 1, 1, 1, T_max) masks the cache
        positions after ``cache_index``, which keeps the decode causal.
        Deterministic (no dropout). Returns (out, weights or None).
        """
        q = self._split_heads(self.wq(q_in))
        k_cache[:, :, cache_index:cache_index + 1] = self._split_heads(
            self.wk(new_kv_in)).to(k_cache.dtype)
        v_cache[:, :, cache_index:cache_index + 1] = self._split_heads(
            self.wv(new_kv_in)).to(v_cache.dtype)
        attn, weights = self._attend(q, k_cache, v_cache, mask, need_weights)
        return self.wo(torch.cat([q_in, attn], dim=-1)), weights
