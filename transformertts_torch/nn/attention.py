"""Multi-head attention with the reference's concat-q output projection.

Counterpart of ``transformertts_tpu/nn/attention.py``. The output projection
takes ``concat([q_in, attention_output], -1)``, a (2·d → d) dense; this is
checkpoint-shape critical.

Two paths compute the same function:

- ``need_weights=True``: eager ``scaled_dot_product_attention``, which also
  returns the float32 attention weights (diagnostics, and the Aligner and
  duration extraction in later slices);
- ``need_weights=False``: the fused kernels of ``ops.flash_attention``,
  which never materialize the weights: ``flash_attention`` (K1) when no
  gradient is taken (synthesis, validation), ``flash_attention_trainable``
  (K2, with K3/K4 in the backward) when one is, or when training drops out
  weights.

Both run the softmax and the weights·v product in float32 and return the
output in the compute dtype. In training both drop out the attention
weights and the output at the model's ``dropout_rate``, as the JAX package
does.
"""
from typing import Optional, Tuple

import torch
from torch import nn

from transformertts_torch.nn import core
from transformertts_torch.ops.flash_attention import (NEG_INF, flash_attention,
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

    def forward(self, v_in: torch.Tensor, k_in: torch.Tensor, q_in: torch.Tensor,
                mask: Optional[torch.Tensor], need_weights: bool = True,
                training: bool = False, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """mask: (B, 1, 1, Tk) key mask, 1 = masked. Returns (out, weights or None)."""
        q = self._split_heads(self.wq(q_in))
        k = self._split_heads(self.wk(k_in))
        v = self._split_heads(self.wv(v_in))
        rate = self.dropout_rate if training else 0.0
        if need_weights:
            attn, weights = scaled_dot_product_attention(q, k, v, mask, rate, generator,
                                                         training)
        else:
            b, tk = k.shape[0], k.shape[2]
            if mask is None:
                bias = torch.zeros(b, tk, device=k.device)
            else:
                bias = (mask.float() * NEG_INF).reshape(b, tk)
            args = (q.contiguous(), k.contiguous(), v.contiguous(), bias.contiguous())
            if rate > 0.0 or (torch.is_grad_enabled() and q.requires_grad):
                attn = flash_attention_trainable(*args, dropout_rate=rate,
                                                 generator=generator)
            else:
                attn = flash_attention(*args)
            weights = None
        out = self.wo(torch.cat([q_in, self._merge_heads(attn)], dim=-1))
        return core.dropout(out, rate, generator, training), weights
