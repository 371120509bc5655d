"""The Aligner's training step in plain PyTorch: forward, loss, backward and
Adam, followed step by step.

The model is the published Aligner (as-ideas/TransformerTTS
``model/models.py`` ``Aligner``): token embedding → encoder of dense blocks
(self-attention, then a ReLU feed-forward pair, each closed by LayerNorm
over the residual sum) → the mel strided by the reduction factor through a
two-layer ReLU prenet → a decoder of blocks (causal self-attention,
cross-attention over the encoder, feed-forward) → Dense(mel · max_r) cut to r
frames a step → a postnet of two denses (mel, three stop classes). Masks:
token 0 and all-zero mel frames are padding; padded keys are masked out of
every attention, the encoder's blocks zero their padded positions. The
loss is the masked mean absolute error of the mel plus the stop
cross-entropy with the stop class weighted ``stop_scaling`` times, each over
the real frames. Adam: β (0.9, 0.98), ε 1e-9 outside the square root, bias
corrected (``torch.optim.Adam``'s arithmetic).

Dropout (rate ``dropout_rate`` on the embeddings' sum with the position
encoding, on every attention's weights and output, on the feed-forward
output; ``decoder_prenet_dropout`` after each prenet layer) draws its masks
as the training step under test defines them, so that both sides drop the
same units: each step's generator is seeded with base seed · 2³² + step on
the card; an elementwise mask keeps where ``torch.rand`` of its shape from
that generator is at least the rate; an attention's mask on its weights is
the counter hash of (seed, offset) taken from the generator (its Philox
offset, then advanced by 4), (b·h, row, column), MurmurHash3's finalizer,
kept where at least ⌊rate · 2³²⌋. The draws follow the order of the
forward pass.
"""
import math

import numpy as np
import torch

from h100bench.reference.forward_tts import positional_encoding

_M32 = 0xFFFFFFFF
_BH_MUL, _ROW_MUL, _COL_MUL = 0x9E3779B9, 0x85EBCA77, 0x27D4EB2F


def _mul32(x, c):
    if isinstance(x, int):
        return (x * c) & _M32
    return ((x & 0xFFFF) * c + (((x >> 16) * c) & 0xFFFF) * 65536) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_keep(seed: int, offset: int, b: int, h: int, tq: int, tk: int, rate: float,
              device) -> torch.Tensor:
    thr = int(rate * 2.0 ** 32)
    key = _fmix32((seed & _M32) ^ _fmix32((offset + _BH_MUL) & _M32))
    idx = dict(dtype=torch.int64, device=device)
    bh = torch.arange(b * h, **idx).reshape(b, h, 1, 1)
    rows = torch.arange(tq, **idx).reshape(1, 1, tq, 1)
    cols = torch.arange(tk, **idx).reshape(1, 1, 1, tk)
    hb = _fmix32((key + _mul32(bh, _BH_MUL)) & _M32)
    hr = _fmix32((hb + _mul32(rows, _ROW_MUL)) & _M32)
    return _fmix32((hr + _mul32(cols, _COL_MUL)) & _M32) >= thr


class Masks:
    """One step's dropout draws, in the order the forward pass makes them."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def elementwise(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = torch.rand(x.shape, device=x.device, generator=self.gen) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def attention_key(self):
        if self.gen.device.type == 'cuda':
            offset = self.gen.get_offset()
            self.gen.set_offset(offset + 4)
            seed = self.gen.initial_seed()
            return (seed ^ (seed >> 32)) & _M32, offset & _M32
        seed, offset = torch.randint(0, 2 ** 32, (2,), generator=self.gen).tolist()
        return seed, offset


class ReferenceAligner:
    """``loss(params, batch, masks)`` of one step; ``params`` maps the
    published parameter names to float32 tensors."""

    def __init__(self, cfg: dict, r: int):
        self.cfg, self.r = cfg, r

    def dense(self, p, name, x, act=None):
        y = x @ p[f'{name}.weight'].T + p[f'{name}.bias']
        return torch.relu(y) if act == 'relu' else y

    def layer_norm(self, p, name, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-6) * p[f'{name}.weight'] + p[f'{name}.bias']

    def attention(self, p, name, q_in, kv_in, key_pad, heads, causal, masks, eager):
        """key_pad: (B, Tk) bool, True at padded keys."""
        rate = self.cfg['dropout_rate']
        b, tq, d = q_in.shape
        tk, depth = kv_in.shape[1], d // heads

        def split(x, t):
            return x.reshape(b, t, heads, depth).transpose(1, 2)

        q = split(self.dense(p, f'{name}.wq', q_in), tq)
        k = split(self.dense(p, f'{name}.wk', kv_in), tk)
        v = split(self.dense(p, f'{name}.wv', kv_in), tk)
        logits = q @ k.transpose(-1, -2) / math.sqrt(depth)
        logits = logits + key_pad[:, None, None, :].float() * -1e9
        if causal:
            ahead = torch.arange(tk, device=q.device)[None, :] > torch.arange(
                tq, device=q.device)[:, None]
            logits = logits.masked_fill(ahead, -1e9)
        weights = torch.softmax(logits, dim=-1)
        if eager:
            used = masks.elementwise(weights, rate)
        else:
            seed, offset = masks.attention_key()
            keep = hash_keep(seed, offset, b, heads, tq, tk, rate, q.device)
            used = weights * keep.float() / (1.0 - rate)
        out = (used @ v).transpose(1, 2).reshape(b, tq, d)
        out = self.dense(p, f'{name}.wo', torch.cat([q_in, out], dim=-1))
        return masks.elementwise(out, rate)

    def forward(self, p, tokens, mel_inp, masks):
        cfg, rate = self.cfg, self.cfg['dropout_rate']
        tok_pad = tokens == 0
        keep = (~tok_pad).float()[:, :, None]
        x = p['encoder_prenet.weight'][tokens]
        y = self.layer_norm(p, 'encoder.ln', x)
        y = y + p['encoder.pos_encoding_scalar'] * positional_encoding(
            x.shape[1], x.shape[2], x.device)
        y = masks.elementwise(y, rate)
        for i, h in enumerate(cfg['encoder_num_heads']):
            blk = f'encoder.dense_{i}'
            a = self.layer_norm(p, f'{blk}.sarn.ln', self.attention(
                p, f'{blk}.sarn.mha', y, y, tok_pad, h, False, masks, False) + y) * keep
            f = masks.elementwise(self.dense(p, f'{blk}.ffn.d2',
                                             self.dense(p, f'{blk}.ffn.d1', a, 'relu')), rate)
            y = self.layer_norm(p, f'{blk}.ffn.ln', f + a) * keep
        enc = y

        mel_pad = mel_inp.abs().sum(dim=-1) == 0
        prate = cfg['decoder_prenet_dropout']
        z = masks.elementwise(self.dense(p, 'decoder_prenet.d1', mel_inp, 'relu'), prate)
        z = masks.elementwise(self.dense(p, 'decoder_prenet.d2', z, 'relu'), prate)
        t = z.shape[1]
        pe = positional_encoding(t * self.r, z.shape[2], z.device)[::self.r]
        y = self.layer_norm(p, 'decoder.ln', z) + p['decoder.pos_encoding_scalar'] * pe
        y = masks.elementwise(y, rate)
        heads = cfg['decoder_num_heads']
        for i, h in enumerate(heads):
            blk = f'decoder.block_{i}'
            a1 = self.layer_norm(p, f'{blk}.sarn.ln', self.attention(
                p, f'{blk}.sarn.mha', y, y, mel_pad, h, True, masks, False) + y)
            a2 = self.layer_norm(p, f'{blk}.carn.ln', self.attention(
                p, f'{blk}.carn.mha', a1, enc, tok_pad, h, False, masks,
                i == len(heads) - 1) + a1)
            f = masks.elementwise(self.dense(p, f'{blk}.ffn.d2',
                                             self.dense(p, f'{blk}.ffn.d1', a2, 'relu')), rate)
            y = self.layer_norm(p, f'{blk}.ffn.ln', f + a2)
        proj = self.dense(p, 'final_proj_mel', y)[:, :, :self.r * cfg['mel_channels']]
        lin = proj.reshape(proj.shape[0], t * self.r, cfg['mel_channels'])
        return (self.dense(p, 'decoder_postnet.mel_out', lin),
                self.dense(p, 'decoder_postnet.stop_linear', lin))

    def loss(self, p, batch, masks):
        mel, stop, tokens = batch['mel'], batch['stop_probs'].long(), batch['tokens'].long()
        tar_inp, tar_real, tar_stop = mel[:, :-1], mel[:, 1:], stop[:, 1:]
        n = tar_inp.shape[1]
        mel_out, stop_logits = self.forward(p, tokens, tar_inp[:, ::self.r], masks)
        mel_out, stop_logits = mel_out[:, :n], stop_logits[:, :n]
        frame = (tar_real.abs().sum(dim=-1) > 0).float()
        mae = ((tar_real - mel_out).abs().mean(dim=-1) * frame).sum() / frame.sum().clamp_min(1)
        real = (tar_stop > 0).float()
        weight = torch.where(tar_stop == 2, float(self.cfg['stop_loss_scaling']), 1.0) * real
        ce = -torch.gather(torch.log_softmax(stop_logits, dim=-1), -1, tar_stop[..., None])[..., 0]
        stop_loss = (ce * weight).sum() / real.sum().clamp_min(1)
        return mae + stop_loss


def adam_steps(ref: ReferenceAligner, params: dict, batches, step_seeds, lr: float,
               betas=(0.9, 0.98), eps: float = 1e-9):
    """Train ``params`` (copies) through ``batches``; returns (losses, the
    first step's gradients, the parameters after the last step)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    for step, (batch, seed) in enumerate(zip(batches, step_seeds), start=1):
        loss = ref.loss(p, batch, Masks(seed, next(iter(p.values())).device))
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: (gr if gr is not None else torch.zeros_like(p[k]))
                 for k, gr in zip(p, grads)}
            if first_grad is None:
                first_grad = {k: v.clone() for k, v in g.items()}
            for k in p:
                m[k].mul_(betas[0]).add_(g[k], alpha=1 - betas[0])
                s[k].mul_(betas[1]).addcmul_(g[k], g[k], value=1 - betas[1])
                mhat = m[k] / (1 - betas[0] ** step)
                denom = (s[k] / (1 - betas[1] ** step)).sqrt() + eps
                p[k].sub_(lr * mhat / denom)
    return losses, first_grad, {k: v.detach() for k, v in p.items()}


def norm_gaps(mine: dict, want: dict, leaves=None) -> tuple:
    """The worst leaf's gap between two norms, | ‖mine‖ − ‖want‖ |, over the
    larger of ‖want‖ of that leaf and the median leaf's; and that leaf."""
    leaves = list(leaves if leaves is not None else want)
    norms = {k: float(want[k].norm()) for k in leaves}
    floor = float(np.median(list(norms.values())))
    worst, leaf = 0.0, None
    for k in leaves:
        gap = abs(float(mine[k].norm()) - norms[k]) / max(norms[k], floor, 1e-30)
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf
