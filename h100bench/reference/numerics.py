"""The reference's arithmetic, in plain PyTorch.

A control is the reference computed one precision below what the
configuration states: float8 (e4m3) operands for a bfloat16 model, TF32
operands for a float32 stage with TF32 off, bfloat16 operands for a float32
stage that allows TF32. ``Precision`` rounds the operands of every product
the reference computes; the products themselves accumulate in float32, as
the tensor cores accumulate. ``exact_float32`` keeps cuBLAS and cuDNN from
rounding the reference's own float32 products to TF32; the program runs
under whatever it sets itself.
"""
import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale that maps its
    largest magnitude to the format's largest value, back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest), back in float32."""
    bits = x.detach().float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    """What the reference rounds the operands of its products to: nothing
    (``float32``), ``tf32``, ``bf16`` or ``fp8``."""

    def __init__(self, name: str = 'float32'):
        if name not in ('float32', 'tf32', 'bf16', 'fp8'):
            raise ValueError(f'unknown precision {name!r}')
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == 'fp8':
            return round_fp8(x.float())
        if self.name == 'tf32':
            return round_tf32(x)
        if self.name == 'bf16':
            return x.to(torch.bfloat16).float()
        return x.float()


@contextlib.contextmanager
def tf32_products(on: bool):
    """TF32 on or off in cuBLAS and cuDNN inside the block, the settings
    before it restored after."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def exact_float32():
    """Float32 products on the card inside the block: TF32 off."""
    return tf32_products(False)
