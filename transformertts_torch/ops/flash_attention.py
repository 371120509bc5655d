"""Fused attention forward: the Hopper kernel and its plain PyTorch version.

Counterpart of ``transformertts_tpu/ops/flash_attention.py`` (forward only):
``softmax(q·kᵀ/√d + bias [+ causal look-ahead])·v`` with the softmax in
float32, the output in q's dtype, and the attention weights never returned.

- ``flash_attention`` is the public entry. For a CUDA tensor it launches the
  kernel in ``csrc/flash_attention_fwd.cu`` (built with nvcc at first use,
  see ``ops/build.py``) or raises; for a CPU tensor it runs
  ``attention_plain``. There is no other fallback.
- ``attention_plain`` is eager PyTorch, the counterpart of the JAX
  ``attention_reference``: the CPU tests and the on-card comparison use it.

The bias is the (B, Tk) additive key mask, 0 or ``NEG_INF``; ``causal`` sets
the logits of keys after the query to ``NEG_INF``. Keys at or beyond Tk take
no part in the softmax, so a fully masked row is the mean of v, finite.
"""
import ctypes
import math

import torch

NEG_INF = -1e9

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Eager reference: q (B,H,Tq,D), k/v (B,H,Tk,D), bias (B,Tk) → (B,H,Tq,D)."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    logits = logits + bias[:, None, None, :].float()
    if causal:
        tq, tk = logits.shape[-2:]
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows, NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def _check(q, k, v, bias):
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and bias.device == q.device):
        raise ValueError('flash_attention: q, k, v and bias must lie on one '
                         'CUDA device')
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'flash_attention: q, k, v must share float32 or '
                        f'bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}')
    if bias.dtype != torch.float32:
        raise TypeError(f'flash_attention: bias must be float32, got {bias.dtype}')
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or bias.dim() != 2:
        raise ValueError('flash_attention: q, k, v are (B,H,T,D), bias (B,Tk)')
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if k.shape != (b, h, tk, d) or v.shape != k.shape or bias.shape != (b, tk):
        raise ValueError(f'flash_attention: shapes q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}, bias '
                         f'{tuple(bias.shape)} do not agree')
    if d % 8 != 0 or not 8 <= d <= 256:
        raise ValueError(f'flash_attention: head width {d} must be a multiple '
                         f'of 8 in [8, 256]')
    if min(tq, tk) < 1:
        raise ValueError('flash_attention: empty sequence')
    if not all(x.is_contiguous() for x in (q, k, v, bias)):
        raise ValueError('flash_attention: q, k, v and bias must be contiguous')
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError('flash_attention: q, k and v must be 16-byte aligned')


def _library():
    from transformertts_torch.ops import build
    lib = build.load('flash_attention_fwd')
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Fused attention; q (B,H,Tq,D), k/v (B,H,Tk,D), bias (B,Tk) float32.

    Returns (B,H,Tq,D) in q's dtype. On a CPU tensor this is
    ``attention_plain``; on a CUDA tensor it launches the kernel and counts
    the launch in ``flash_attention.launches``.
    """
    if q.device.type == 'cpu':
        return attention_plain(q, k, v, bias, causal)
    _check(q, k, v, bias)
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    fn = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, h, tq, k.shape[2], d, int(causal),
                 _DTYPES[q.dtype], 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f'flash_attention_fwd launch failed: error {err}')
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
