"""NN primitives as ``nn.Module``s, the counterparts of ``transformertts_tpu/nn/core.py``.

Parameters are stored in float32 and cast to the input's dtype at use, so a
bfloat16 forward runs bfloat16 GEMMs and convolutions (float32 accumulation
inside cuBLAS/cuDNN) while the weights stay exact. Layouts follow PyTorch
(``Linear.weight`` is (out, in), ``Conv1d.weight`` is (out, in, width));
``models/persistence.py`` maps them to and from the JAX package's Keras
layouts. Initializers match the JAX package's Keras defaults (glorot-uniform
kernels, zero biases, uniform(-0.05, 0.05) embeddings), drawn from an
explicit ``torch.Generator``.

Under tensor parallelism (``parallel/tensor_parallel.py``) a Dense or a
Conv1D may hold only this model rank's part of its weight: a column
module's input then passes through ``tp_input``, and a row module sums its
partial products with ``tp_partial_sum`` before adding its bias.

Dropout takes an explicit ``torch.Generator`` on the tensor's device and a
``training`` flag, in place of the JAX package's rng keys and
``deterministic``.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {None: lambda x: x, 'linear': lambda x: x, 'relu': torch.relu}


def _activation(name: Optional[str]):
    if name not in _ACTIVATIONS:
        raise ValueError(f'unknown activation: {name}')
    return _ACTIVATIONS[name]


def glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-limit, limit, generator=generator)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            training: bool) -> torch.Tensor:
    """Inverted dropout; the identity when not training or at rate 0. The
    mask is drawn from ``generator`` (on x's device)."""
    if not training or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Module):
    """y = act(x @ weightᵀ + bias) in x's dtype."""

    tp_input = None          # set on a column-parallel module
    tp_partial_sum = None    # set on a row-parallel module

    def __init__(self, in_dim: int, out_dim: int, activation: Optional[str] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.act = _activation(activation)
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.weight, self.in_dim, self.out_dim, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_input is not None:
            x = self.tp_input(x)
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.tp_partial_sum is None:
            y = F.linear(x, w, b)
        else:
            y = self.tp_partial_sum(F.linear(x, w)) + b
        return self.act(y)


class Conv1D(nn.Module):
    """SAME-padded time-wise convolution over (batch, time, channels).

    SAME pads ``((k-1)//2, k//2)`` as ``lax`` does; both frameworks
    cross-correlate, so the weights carry over without flipping.
    """

    tp_input = None          # set on a column-parallel module
    tp_partial_sum = None    # set on a row-parallel module

    def __init__(self, in_dim: int, filters: int, kernel_size: int,
                 activation: Optional[str] = None):
        super().__init__()
        self.in_dim, self.filters, self.kernel_size = in_dim, filters, kernel_size
        self.act = _activation(activation)
        self.weight = nn.Parameter(torch.empty(filters, in_dim, kernel_size))
        self.bias = nn.Parameter(torch.zeros(filters))

    def reset_parameters(self, generator: torch.Generator) -> None:
        k = self.kernel_size
        glorot_uniform_(self.weight, self.in_dim * k, self.filters * k, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_input is not None:
            x = self.tp_input(x)
        k = self.kernel_size
        xt = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if self.tp_partial_sum is None:
            y = F.conv1d(xt, w, b)
        else:
            y = self.tp_partial_sum(F.conv1d(xt, w)) + b[:, None]
        return self.act(y.transpose(1, 2))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with float32 statistics, eps 1e-6."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class Embedding(nn.Module):
    """Token embedding table; row order is fixed by the tokenizer alphabet."""

    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.uniform_(-0.05, 0.05, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every primitive under ``module`` from ``generator``, in
    module-registration order (deterministic for a given seed)."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv1D, LayerNorm, Embedding)):
            m.reset_parameters(generator)
