"""Encoder, decoder and predictor blocks, the counterparts of
``transformertts_tpu/nn/blocks.py``.

Submodules carry the JAX parameter-tree names (``sarn``, ``conv_0``,
``ln``, ...), so a state-dict key is the JAX ``flatten_params`` path with
``.`` for ``/`` (see ``models/persistence.py``). ``need_weights`` selects the
attention path: eager with float32 weights returned, or the fused kernels
with none (``nn/attention.py``). ``training`` turns on the JAX package's
dropouts, drawn from ``generator``.
"""
from typing import List, Optional

import torch
from torch import nn

from transformertts_torch.nn import core
from transformertts_torch.nn.attention import MultiHeadAttention
from transformertts_torch.nn.posenc import positional_encoding


def _keep(mask: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, 1, 1, T) 1 = masked → (B, T, 1) 1 = kept, in the compute dtype
    (a float32 mask would promote the bfloat16 path)."""
    return (1.0 - mask[:, 0, 0, :])[:, :, None].to(dtype)


class FFNResNorm(nn.Module):
    """x → LN(x + dropout(W2(relu(W1 x))))."""

    def __init__(self, model_dim: int, hidden: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d1 = core.Dense(model_dim, hidden, activation='relu')
        self.d2 = core.Dense(hidden, model_dim)
        self.ln = core.LayerNorm(model_dim)
        self.dropout_rate = dropout_rate

    def forward(self, x, training: bool = False, generator=None):
        y = core.dropout(self.d2(self.d1(x)), self.dropout_rate, generator, training)
        return self.ln(y + x)


class CNNResNorm(nn.Module):
    """Residual conv stack: inner convs with activation, last conv linear,
    dropout, LN(inputs + x)."""

    def __init__(self, in_dim: int, filters: List[int], kernel_size: int,
                 inner_activation: str, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        dims = [in_dim] + list(filters)
        self.convs = []
        for i in range(len(filters)):
            act = inner_activation if i < len(filters) - 1 else None
            conv = core.Conv1D(dims[i], dims[i + 1], kernel_size, activation=act)
            self.add_module(f'conv_{i}', conv)
            self.convs.append(conv)
        self.ln = core.LayerNorm(filters[-1])

    def forward(self, x, training: bool = False, generator=None):
        y = x
        for conv in self.convs:
            y = conv(y)
        y = core.dropout(y, self.dropout_rate, generator, training)
        return self.ln(x + y)


class CNNDropout(nn.Module):
    """Stat-predictor conv stack: each layer conv → act → LN → dropout."""

    def __init__(self, in_dim: int, filters: List[int], kernel_size: int,
                 inner_activation: str, last_activation: str, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        dims = [in_dim] + list(filters)
        acts = [inner_activation] * (len(filters) - 1) + [last_activation]
        self.layers = []
        for i in range(len(filters)):
            conv = core.Conv1D(dims[i], dims[i + 1], kernel_size, activation=acts[i])
            ln = core.LayerNorm(filters[i])
            self.add_module(f'conv_{i}', conv)
            self.add_module(f'ln_{i}', ln)
            self.layers.append((conv, ln))

    def forward(self, x, training: bool = False, generator=None):
        for conv, ln in self.layers:
            x = core.dropout(ln(conv(x)), self.dropout_rate, generator, training)
        return x


class StatPredictor(nn.Module):
    """Duration/pitch predictor: mask → CNNDropout → Dense(1, act) → mask."""

    def __init__(self, in_dim: int, conv_filters: List[int], kernel_size: int,
                 conv_activation: str, dense_activation: str, dropout_rate: float = 0.0):
        super().__init__()
        self.conv_blocks = CNNDropout(in_dim, conv_filters, kernel_size,
                                      conv_activation, conv_activation, dropout_rate)
        self.linear = core.Dense(conv_filters[-1], 1, activation=dense_activation)

    def forward(self, x, mask, training: bool = False, generator=None):
        """mask: (B, T, 1), 1 = real data."""
        mask = mask.to(x.dtype)
        return self.linear(self.conv_blocks(x * mask, training, generator)) * mask


class SelfAttentionResNorm(nn.Module):

    def __init__(self, model_dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.mha = MultiHeadAttention(model_dim, num_heads, dropout_rate)
        self.ln = core.LayerNorm(model_dim)

    def forward(self, x, mask, need_weights: bool = True, training: bool = False,
                generator=None, causal: bool = False):
        attn_out, weights = self.mha(x, x, x, mask, need_weights, training, generator,
                                     causal)
        return self.ln(attn_out + x), weights


class SelfAttentionDenseBlock(nn.Module):

    def __init__(self, model_dim: int, num_heads: int, hidden: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads, dropout_rate)
        self.ffn = FFNResNorm(model_dim, hidden, dropout_rate)

    def forward(self, x, mask, need_weights: bool = True, training: bool = False,
                generator=None):
        attn_out, weights = self.sarn(x, mask, need_weights, training, generator)
        keep = _keep(mask, attn_out.dtype)
        return self.ffn(attn_out * keep, training, generator) * keep, weights


class SelfAttentionConvBlock(nn.Module):

    def __init__(self, model_dim: int, num_heads: int, conv_filters: List[int],
                 kernel_size: int, conv_activation: str, dropout_rate: float = 0.0):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads, dropout_rate)
        self.conv = CNNResNorm(model_dim, conv_filters, kernel_size, conv_activation,
                               dropout_rate)

    def forward(self, x, mask, need_weights: bool = True, training: bool = False,
                generator=None):
        attn_out, weights = self.sarn(x, mask, need_weights, training, generator)
        keep = _keep(mask, attn_out.dtype)
        return self.conv(attn_out * keep, training, generator) * keep, weights


def _pos_encoding(table: torch.Tensor, seq_len: int, reduction_factor: int,
                  pos_offset: int) -> torch.Tensor:
    """(1, seq_len, d) rows of ``table`` from ``pos_offset · r`` with stride r;
    the start is clamped so the span fits the table, as ``lax.dynamic_slice``
    clamps it in the JAX package."""
    span = seq_len * reduction_factor
    start = max(0, min(pos_offset * reduction_factor, table.shape[1] - span))
    return table[:, start:start + span:reduction_factor]


class SelfAttentionBlocks(nn.Module):
    """Stack: LN → +scalar·posenc → dropout → dense blocks → conv blocks."""

    def __init__(self, model_dim: int, feed_forward_dimension: Optional[int],
                 num_heads: List[int], maximum_position_encoding: int,
                 conv_filters: Optional[List[int]], dense_blocks: int,
                 kernel_size: Optional[int],
                 conv_activation: Optional[str], name: str = 'Encoder',
                 dropout_rate: float = 0.0):
        super().__init__()
        self.name = name
        self.dropout_rate = dropout_rate
        self.register_buffer(
            'pos_encoding',
            torch.from_numpy(positional_encoding(maximum_position_encoding, model_dim)),
            persistent=False)
        self.ln = core.LayerNorm(model_dim)
        self.pos_encoding_scalar = nn.Parameter(torch.ones(()))
        self.dense_layers, self.conv_layers = [], []
        for i, h in enumerate(num_heads[:dense_blocks]):
            block = SelfAttentionDenseBlock(model_dim, h, feed_forward_dimension,
                                            dropout_rate)
            self.add_module(f'dense_{i}', block)
            self.dense_layers.append(block)
        for i, h in enumerate(num_heads[dense_blocks:]):
            block = SelfAttentionConvBlock(model_dim, h, conv_filters, kernel_size,
                                           conv_activation, dropout_rate)
            self.add_module(f'conv_{i}', block)
            self.conv_layers.append(block)

    def forward(self, x, mask, need_weights: bool = True, training: bool = False,
                generator=None):
        """Returns (y, {block name: weights}); the dict is empty when
        ``need_weights`` is False."""
        y = self.ln(x)
        pe = _pos_encoding(self.pos_encoding, x.shape[1], 1, 0)
        # keep the compute dtype: the float32 scalar would promote the stack
        y = y + self.pos_encoding_scalar.to(y.dtype) * pe.to(y.dtype)
        y = core.dropout(y, self.dropout_rate, generator, training)
        attention_weights = {}
        for kind, layers in (('DenseBlock', self.dense_layers),
                             ('ConvBlock', self.conv_layers)):
            for i, block in enumerate(layers):
                y, w = block(y, mask, need_weights, training, generator)
                if need_weights:
                    attention_weights[f'{self.name}_{kind}{i + 1}_SelfAttention'] = w
        return y, attention_weights


class CrossAttentionResnorm(nn.Module):

    def __init__(self, model_dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.mha = MultiHeadAttention(model_dim, num_heads, dropout_rate)
        self.ln = core.LayerNorm(model_dim)

    def forward(self, q, k, v, mask, need_weights: bool = True, training: bool = False,
                generator=None):
        attn, weights = self.mha(v, k, q, mask, need_weights, training, generator)
        return self.ln(attn + q), weights


class CrossAttentionDenseBlock(nn.Module):
    """Causal self-attention → cross-attention over the encoder → FFN."""

    def __init__(self, model_dim: int, num_heads: int, hidden: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.sarn = SelfAttentionResNorm(model_dim, num_heads, dropout_rate)
        self.carn = CrossAttentionResnorm(model_dim, num_heads, dropout_rate)
        self.ffn = FFNResNorm(model_dim, hidden, dropout_rate)

    def forward(self, x, enc_output, decoder_padding_mask, encoder_padding_mask,
                need_weights: bool = True, need_cross_weights: bool = True,
                training: bool = False, generator=None):
        """Returns (out, self-attention weights, cross-attention weights); the
        self-attention's are None unless ``need_weights``, the
        cross-attention's unless ``need_cross_weights``."""
        attn1, w1 = self.sarn(x, decoder_padding_mask, need_weights, training, generator,
                              causal=True)
        attn2, w2 = self.carn(attn1, enc_output, enc_output, encoder_padding_mask,
                              need_cross_weights, training, generator)
        return self.ffn(attn2, training, generator), w1, w2


class CrossAttentionBlocks(nn.Module):
    """The Aligner's decoder stack: LN → +scalar·posenc (strided by the
    reduction factor from ``pos_offset``) → dropout → cross-attention dense
    blocks. The last block's cross-attention always returns its weights:
    they are what duration extraction and the Aligner's ``predict`` read. The
    other attentions return theirs only with ``need_weights``; without, they
    run on the fused kernels."""

    def __init__(self, model_dim: int, feed_forward_dimension: int,
                 num_heads: List[int], maximum_position_encoding: int,
                 dropout_rate: float = 0.0, name: str = 'Decoder'):
        super().__init__()
        self.name = name
        self.dropout_rate = dropout_rate
        self.register_buffer(
            'pos_encoding',
            torch.from_numpy(positional_encoding(maximum_position_encoding, model_dim)),
            persistent=False)
        self.ln = core.LayerNorm(model_dim)
        self.pos_encoding_scalar = nn.Parameter(torch.ones(()))
        self.blocks = []
        for i, h in enumerate(num_heads):
            block = CrossAttentionDenseBlock(model_dim, h, feed_forward_dimension,
                                             dropout_rate)
            self.add_module(f'block_{i}', block)
            self.blocks.append(block)

    def embed(self, x, reduction_factor: int = 1, pos_offset: int = 0):
        """LN(x) + scalar · the r-strided positional encoding, in x's dtype."""
        y = self.ln(x)
        pe = _pos_encoding(self.pos_encoding, x.shape[1], reduction_factor, pos_offset)
        return y + self.pos_encoding_scalar.to(y.dtype) * pe.to(y.dtype)

    def weights_key(self, i: int) -> str:
        """The JAX package's name of block ``i``'s cross-attention map."""
        if i == len(self.blocks) - 1:
            return f'{self.name}_LastBlock_CrossAttention'
        return f'{self.name}_DenseBlock{i + 1}_CrossAttention'

    def forward(self, x, enc_output, decoder_padding_mask, encoder_padding_mask,
                need_weights: bool = True, training: bool = False, generator=None,
                reduction_factor: int = 1, pos_offset: int = 0):
        """Returns (y, {block name: cross-attention weights})."""
        y = core.dropout(self.embed(x, reduction_factor, pos_offset), self.dropout_rate,
                         generator, training)
        attention_weights = {}
        last = len(self.blocks) - 1
        for i, block in enumerate(self.blocks):
            y, _, w = block(y, enc_output, decoder_padding_mask, encoder_padding_mask,
                            need_weights, need_weights or i == last, training, generator)
            if w is not None:
                attention_weights[self.weights_key(i)] = w
        return y, attention_weights


class DecoderPrenet(nn.Module):
    """Two relu denses, each followed by dropout at ``dropout_rate`` in
    training only, as the JAX package applies it."""

    def __init__(self, in_dim: int, model_dim: int, dense_hidden_units: int,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.d1 = core.Dense(in_dim, dense_hidden_units, activation='relu')
        self.d2 = core.Dense(dense_hidden_units, model_dim, activation='relu')
        self.dropout_rate = dropout_rate

    def forward(self, x, training: bool = False, generator=None):
        x = core.dropout(self.d1(x), self.dropout_rate, generator, training)
        return core.dropout(self.d2(x), self.dropout_rate, generator, training)


class Postnet(nn.Module):
    """Final projections: mel and the 3-way stop logits."""

    def __init__(self, in_dim: int, mel_channels: int):
        super().__init__()
        self.stop_linear = core.Dense(in_dim, 3)
        self.mel_out = core.Dense(in_dim, mel_channels)

    def forward(self, x) -> dict:
        return {'mel': self.mel_out(x), 'stop_prob': self.stop_linear(x)}
