"""The ForwardTransformer of TransformerTTS in plain PyTorch, one sentence at a time.

It follows the published model (as-ideas/TransformerTTS ``model/models.py``
``ForwardTransformer``): token embedding → encoder (LayerNorm, + the scaled
sinusoidal position encoding, then blocks of self-attention and a residual
conv pair, each closed by LayerNorm) → duration and pitch predictors (convs
each followed by ReLU and LayerNorm, then a dense head) → the pitch
embedding added to the encoder output → each token's features repeated by
its duration → a decoder of the encoder's form → the mel projection. The
attention's output projection takes ``[query input, attention output]``
concatenated, as the published layer does. LayerNorm's epsilon is 1e-6.
Dropout is off (inference).

Weights are the dict the benchmark draws from its seed, keyed by the
published parameter tree. A sentence runs at the length it was served at:
its tokens followed by padding (id 0) up to the served token budget, its
frames by empty frames up to the served frame budget. As in the published
model, padded keys are masked out of attention, each conv block's input and
output are zeroed at padded positions, and the convs are SAME-padded over
the whole padded sequence, so a sentence's last positions see a padded
neighbour's values inside a conv pair.
``prec`` rounds the operands of every product (``numerics.Precision``):
float32 for the reference, float8 for the control.
"""
import math

import numpy as np
import torch

from h100bench.reference.numerics import Precision


def positional_encoding(n: int, dim: int, device) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(dim)[None, :]
    angles = pos / np.power(10000.0, (2 * (i // 2)) / np.float64(dim))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return torch.as_tensor(angles, dtype=torch.float32, device=device)


class ReferenceForward:
    """``encode(tokens)`` → features, durations, pitch of one sentence;
    ``decode(features, pitch, durations)`` → its mel (frames, mels)."""

    def __init__(self, weights: dict, cfg: dict, prec: Precision = None):
        self.w = weights
        self.cfg = cfg
        self.p = prec or Precision('float32')

    # primitives --------------------------------------------------------

    def dense(self, name: str, x: torch.Tensor, act: str = None) -> torch.Tensor:
        y = self.p(x) @ self.p(self.w[f'{name}.weight']).T + self.w[f'{name}.bias']
        return torch.relu(y) if act == 'relu' else y

    def conv(self, name: str, x: torch.Tensor, act: str = None) -> torch.Tensor:
        """SAME-padded conv over (T, C): pad (k-1)//2 before and k//2 after."""
        w = self.w[f'{name}.weight']                      # (out, in, k)
        k = w.shape[2]
        xp = torch.nn.functional.pad(x.T[None], ((k - 1) // 2, k // 2))
        y = torch.nn.functional.conv1d(self.p(xp), self.p(w), self.w[f'{name}.bias'])
        y = y[0].T
        return torch.relu(y) if act == 'relu' else y

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-6) * self.w[f'{name}.weight'] \
            + self.w[f'{name}.bias']

    def attention(self, name: str, x: torch.Tensor, heads: int, keep: torch.Tensor
                  ) -> torch.Tensor:
        t, d = x.shape
        depth = d // heads
        q, k, v = (self.dense(f'{name}.{p}', x).reshape(t, heads, depth).transpose(0, 1)
                   for p in ('wq', 'wk', 'wv'))
        logits = (self.p(q) @ self.p(k).transpose(1, 2)) / math.sqrt(depth)
        logits = logits.masked_fill(keep[:, 0] == 0, float('-inf'))
        out = self.p(torch.softmax(logits, dim=-1)) @ self.p(v)
        out = out.transpose(0, 1).reshape(t, d)
        return self.dense(f'{name}.wo', torch.cat([x, out], dim=-1))

    # stacks --------------------------------------------------------------

    def stack(self, name: str, x: torch.Tensor, heads, filters, keep: torch.Tensor
              ) -> torch.Tensor:
        """LayerNorm, + scalar · position encoding, then the conv blocks;
        ``keep`` (T, 1) is 1 at real positions."""
        y = self.layer_norm(f'{name}.ln', x)
        y = y + self.w[f'{name}.pos_encoding_scalar'] * positional_encoding(
            x.shape[0], x.shape[1], x.device)
        for i, h in enumerate(heads):
            block = f'{name}.conv_{i}'
            a = self.layer_norm(f'{block}.sarn.ln',
                                self.attention(f'{block}.sarn.mha', y, h, keep) + y) * keep
            z = a
            for j in range(len(filters)):
                z = self.conv(f'{block}.conv.conv_{j}', z,
                              'relu' if j < len(filters) - 1 else None)
            y = self.layer_norm(f'{block}.conv.ln', a + z) * keep
        return y

    def predictor(self, name: str, x: torch.Tensor, filters, act: str,
                  keep: torch.Tensor) -> torch.Tensor:
        x = x * keep
        for i in range(len(filters)):
            x = self.layer_norm(f'{name}.conv_blocks.ln_{i}',
                                self.conv(f'{name}.conv_blocks.conv_{i}', x, 'relu'))
        return (self.dense(f'{name}.linear', x, act) * keep)[:, 0]

    # the model -----------------------------------------------------------

    def encode(self, tokens, n_pad: int) -> dict:
        """``tokens`` of one sentence, padded to ``n_pad`` positions: the
        features, durations and pitch of its real tokens."""
        dev = self.w['out.weight'].device
        ids = torch.zeros(n_pad, dtype=torch.long, device=dev)
        ids[:len(tokens)] = torch.as_tensor(tokens, device=dev)
        keep = (ids != 0).float()[:, None]
        x = self.w['encoder_prenet.weight'][ids]
        cfg = self.cfg
        x = self.stack('encoder', x, cfg['encoder_num_heads'],
                       cfg['encoder_attention_conv_filters'], keep)
        n = len(tokens)
        return {'features': x[:n],
                'durations': self.predictor('dur_pred', x, cfg['duration_conv_filters'], 'relu',
                                            keep)[:n],
                'pitch': self.predictor('pitch_pred', x, cfg['pitch_conv_filters'], None,
                                        keep)[:n]}

    def decode(self, features: torch.Tensor, pitch: torch.Tensor, durations,
               frames: int) -> torch.Tensor:
        """Expand by integer ``durations`` (one a token), pad with empty
        frames to ``frames`` and decode: the mel of the real frames."""
        x = features + self.dense('pitch_embed', pitch[:, None], 'relu')
        reps = torch.as_tensor(durations, device=x.device).long().clamp_min(0)
        x = torch.repeat_interleave(x, reps, dim=0)
        total = x.shape[0]
        x = torch.cat([x, x.new_zeros(frames - total, x.shape[1])])
        keep = (torch.arange(frames, device=x.device) < total).float()[:, None]
        cfg = self.cfg
        x = self.stack('decoder', x, cfg['decoder_num_heads'],
                       cfg['decoder_attention_conv_filters'], keep)
        return self.dense('out', x)[:total]
