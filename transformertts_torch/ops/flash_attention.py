"""Fused attention: the Hopper kernels and their plain PyTorch versions.

Counterpart of ``transformertts_tpu/ops/flash_attention.py``:
``softmax(q·kᵀ/√d + bias [+ causal look-ahead])·v`` with the softmax in
float32, the output in q's dtype, and the attention weights never returned.

- ``flash_attention`` is the forward-only entry (K1, serving). For a CUDA
  tensor it launches the kernel in ``csrc/flash_attention_fwd.cu`` (built
  with nvcc at first use, see ``ops/build.py``) or raises; for a CPU tensor
  it runs ``attention_plain``. There is no other fallback.
- ``flash_attention_trainable`` is differentiable (training). Its forward
  is ``flash_attention_fwd_lse`` (K2: the output plus the per-row
  logsumexp), its backward ``flash_attention_bwd_dq`` (K3) and
  ``flash_attention_bwd_dkv`` (K4, ``csrc/flash_attention_bwd.cu``), which
  recompute the weights from the logsumexp. Unlike the TPU kernels they take
  attention-weight dropout: inverted dropout on the softmax weights at
  ``dropout_rate``, the JAX training path's semantics, with the mask drawn
  from the counter-based hash ``dropout_keep_mask`` of (seed, offset, b·h,
  row, col), so the backward regenerates it instead of storing it. The mask
  stream is not JAX's; at rate 0 the function is exactly the TPU kernels'.
  The logsumexp is kept as the pair (m, log l), row max and log row sum,
  (B, H, Tq, 2): summed in float32, a fully masked row's would round onto
  the −1e9 mask and lose log l, and the backward would weigh each key 1
  instead of the forward's 1/Tk.
- ``attention_plain``, ``attention_fwd_lse_plain`` and
  ``attention_bwd_plain`` are eager PyTorch: the CPU path, and what the
  kernels are held against on the card.

The bias is the (B, Tk) additive key mask, 0 or ``NEG_INF``; ``causal`` sets
the logits of keys after the query to ``NEG_INF``. Keys at or beyond Tk take
no part in the softmax, so a fully masked row is the mean of v, finite, and
its gradients are those of that mean, finite.
"""
import ctypes
import functools
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


@functools.cache
def _entry(library: str, name: str, n_pointers: int, dropout: bool):
    """The ctypes function ``name`` of ``csrc/<library>.cu``, built, loaded
    and typed once: ``n_pointers`` tensor pointers, B, H, Tq, Tk, D, causal,
    dtype, the scale, (with ``dropout``) key, thr and keep_scale, the stream."""
    from transformertts_torch.ops import build
    fn = getattr(build.load(library), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + ([ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float] if dropout else [])
                   + [ctypes.c_void_p])
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
    fn = _entry('flash_attention_fwd', 'flash_attention_fwd', 5, False)
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


# ---------------------------------------------------------------------------
# trainable: K2 forward with logsumexp, K3/K4 backward, dropout on the weights
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
# multipliers of the per-(b·h), per-row and per-column hash steps
_BH_MUL, _ROW_MUL, _COL_MUL = 0x9E3779B9, 0x85EBCA77, 0x27D4EB2F


def _mul32(x, c: int):
    """x · c mod 2³² for x in [0, 2³²): an int, or an int64 tensor (split into
    16-bit halves, so no product leaves int64)."""
    if isinstance(x, int):
        return (x * c) & _MASK32
    return ((x & 0xFFFF) * c + (((x >> 16) * c) & 0xFFFF) * 65536) & _MASK32


def _fmix32(h):
    """MurmurHash3's 32-bit finalizer (``fmix32`` in csrc/dropout_hash.cuh)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _dropout_key(seed: int, offset: int) -> int:
    """The 32-bit key of one call's mask."""
    return _fmix32((seed & _MASK32) ^ _fmix32((offset + _BH_MUL) & _MASK32))


def _dropout_params(rate: float):
    """(thr, keep_scale): drop where the hash is below thr = ⌊rate·2³²⌋ and
    scale the kept weights by 1/(1 − rate); (0, 1.0) when nothing drops."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f'attention dropout rate {rate} is not in [0, 1)')
    thr = int(rate * 2.0 ** 32)
    return (thr, 1.0 / (1.0 - rate)) if thr > 0 else (0, 1.0)


def dropout_keep_mask(seed: int, offset: int, b: int, h: int, tq: int, tk: int,
                      rate: float, device='cpu') -> torch.Tensor:
    """(b, h, tq, tk) bool, True where the weight is kept: the kernels' mask
    (csrc/dropout_hash.cuh), computed in int64 torch ops."""
    thr, _ = _dropout_params(rate)
    idx = dict(dtype=torch.int64, device=device)
    bh = torch.arange(b * h, **idx).reshape(b, h, 1, 1)
    rows = torch.arange(tq, **idx).reshape(1, 1, tq, 1)
    cols = torch.arange(tk, **idx).reshape(1, 1, 1, tk)
    hb = _fmix32((_dropout_key(seed, offset) + _mul32(bh, _BH_MUL)) & _MASK32)
    hr = _fmix32((hb + _mul32(rows, _ROW_MUL)) & _MASK32)
    return _fmix32((hr + _mul32(cols, _COL_MUL)) & _MASK32) >= thr


def _acc(x: torch.Tensor) -> torch.Tensor:
    """float32 for float32 and bfloat16; float64 stays (gradcheck)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _look_ahead(tq: int, tk: int, device) -> torch.Tensor:
    """(tq, tk) bool, True at the keys after the query."""
    return (torch.arange(tk, device=device)[None, :]
            > torch.arange(tq, device=device)[:, None])


def _logits(q, k, bias, causal):
    logits = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    logits = logits + _acc(bias)[:, None, None, :]
    if causal:
        logits = logits.masked_fill(_look_ahead(*logits.shape[-2:], q.device), NEG_INF)
    return logits


def _dropout_scale(q, k, rate, seed, offset):
    """(B, H, Tq, Tk) float32 keep / (1 − rate), or None at rate 0."""
    thr, keep_scale = _dropout_params(rate)
    if thr == 0:
        return None
    b, h, tq, _ = q.shape
    keep = dropout_keep_mask(seed, offset, b, h, tq, k.shape[2], rate, q.device)
    return keep.to(torch.promote_types(q.dtype, torch.float32)) * keep_scale


def attention_fwd_lse_plain(q, k, v, bias, causal: bool = False,
                            dropout_rate: float = 0.0, seed: int = 0, offset: int = 0):
    """Eager K2: (out (B,H,Tq,D) in q's dtype, lse (B,H,Tq,2) float32, or
    float64 for float64 inputs). ``lse[..., 0]`` is the row's max logit m,
    ``lse[..., 1]`` log Σ exp(x − m); their sum is the row's logsumexp."""
    logits = _logits(q, k, bias, causal)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    total = e.sum(dim=-1, keepdim=True)
    weights = e / total
    scale = _dropout_scale(q, k, dropout_rate, seed, offset)
    if scale is not None:
        weights = weights * scale
    out = torch.matmul(weights, _acc(v)).to(q.dtype)
    return out, torch.cat([m, torch.log(total)], dim=-1)


def attention_bwd_plain(q, k, v, bias, out, lse, dout, causal: bool = False,
                        dropout_rate: float = 0.0, seed: int = 0, offset: int = 0):
    """Eager K3 + K4 from the formulas of the JAX flash backward, with the
    weights P = exp((x − m) − log l) recomputed from ``lse`` = (m, log l)
    (clamped at 0: exact, as x ≤ m and l ≥ 1) and the dropout mask M
    regenerated:
    dV = (P∘M)ᵀdO, dS = P∘((dO·Vᵀ)∘M − D), dQ = dS·K/√d, dK = dSᵀ·Q/√d,
    with D = rowsum(dO∘O), and dS = 0 at the causal look-ahead, whose logit
    is the constant −1e9 (its P is 0 unless the whole row is masked).
    Returns (dq, dk, dv) in q's dtype."""
    x = _logits(q, k, bias, causal)
    p = torch.exp(torch.clamp_max(x - lse[..., :1] - lse[..., 1:], 0.0))
    do = _acc(dout)
    dsum = (do * _acc(out)).sum(dim=-1, keepdim=True)
    dp = torch.matmul(do, _acc(v).transpose(-1, -2))
    scale = _dropout_scale(q, k, dropout_rate, seed, offset)
    pd = p if scale is None else p * scale
    dp = dp if scale is None else dp * scale
    ds = p * (dp - dsum)
    if causal:
        ds = ds.masked_fill(_look_ahead(*ds.shape[-2:], q.device), 0.0)
    inv = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.matmul(ds, _acc(k)) * inv
    dk = torch.matmul(ds.transpose(-1, -2), _acc(q)) * inv
    dv = torch.matmul(pd.transpose(-1, -2), do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(tensors):
    q, lse = tensors[0], tensors[5]
    if lse.shape != (*q.shape[:3], 2) or lse.dtype != torch.float32:
        raise ValueError(f'flash attention backward: lse must be (B, H, Tq, 2) '
                         f'float32, got {tuple(lse.shape)} {lse.dtype}')
    if not all(x.device == q.device for x in tensors):
        raise ValueError('flash attention backward: all tensors must lie on one '
                         'CUDA device')
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError('flash attention backward: tensors must be contiguous')


def flash_attention_fwd_lse(q, k, v, bias, causal: bool = False,
                            dropout_rate: float = 0.0, seed: int = 0, offset: int = 0):
    """K2: (out, lse) as ``attention_fwd_lse_plain``. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel (counted in
    ``flash_attention_fwd_lse.launches``) or raises."""
    if q.device.type == 'cpu':
        return attention_fwd_lse_plain(q, k, v, bias, causal, dropout_rate, seed, offset)
    _check(q, k, v, bias)
    b, h, tq, d = q.shape
    thr, keep_scale = _dropout_params(dropout_rate)
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, 2, device=q.device, dtype=torch.float32)
    fn = _entry('flash_attention_fwd', 'flash_attention_fwd_lse', 6, True)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), b, h, tq, k.shape[2], d, int(causal),
                 _DTYPES[q.dtype], 1.0 / math.sqrt(d), _dropout_key(seed, offset), thr,
                 keep_scale, stream)
    if err != 0:
        raise RuntimeError(f'flash_attention_fwd_lse launch failed: error {err}')
    flash_attention_fwd_lse.launches += 1
    return out, lse


def row_dot(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO∘O) in float32, (B, H, Tq): the input K3 and K4 share."""
    return (dout.float() * out.float()).sum(dim=-1)


def _launch_bwd(name, outputs, q, k, v, bias, out, lse, dout, causal, dropout_rate,
                seed, offset, dsum):
    _check(q, k, v, bias)
    _check_bwd((q, k, v, bias, out, lse, dout))
    if dout.dtype != q.dtype:
        raise TypeError('flash attention backward: dout takes q\'s dtype')
    b, h, tq, d = q.shape
    thr, keep_scale = _dropout_params(dropout_rate)
    if dsum is None:
        dsum = row_dot(dout, out)
    fn = _entry('flash_attention_bwd', name, 7 + len(outputs), True)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 *(o.data_ptr() for o in outputs), b, h, tq, k.shape[2], d,
                 int(causal), _DTYPES[q.dtype], 1.0 / math.sqrt(d),
                 _dropout_key(seed, offset), thr, keep_scale, stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: error {err}')


def flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, causal: bool = False,
                           dropout_rate: float = 0.0, seed: int = 0, offset: int = 0,
                           dsum=None):
    """K3: dq as ``attention_bwd_plain``. CPU tensors run the plain version;
    a CUDA tensor launches the kernel (``flash_attention_bwd_dq.launches``)
    or raises. ``dsum``, ``row_dot(dout, out)``, is computed when not given."""
    if q.device.type == 'cpu':
        return attention_bwd_plain(q, k, v, bias, out, lse, dout, causal,
                                   dropout_rate, seed, offset)[0]
    dq = torch.empty_like(q)
    _launch_bwd('flash_attention_bwd_dq', (dq,), q, k, v, bias, out, lse, dout,
                causal, dropout_rate, seed, offset, dsum)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, causal: bool = False,
                            dropout_rate: float = 0.0, seed: int = 0, offset: int = 0,
                            dsum=None):
    """K4: (dk, dv) as ``attention_bwd_plain``. CPU tensors run the plain
    version; a CUDA tensor launches the kernel
    (``flash_attention_bwd_dkv.launches``) or raises. ``dsum`` as for K3."""
    if q.device.type == 'cpu':
        return attention_bwd_plain(q, k, v, bias, out, lse, dout, causal,
                                   dropout_rate, seed, offset)[1:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd('flash_attention_bwd_dkv', (dk, dv), q, k, v, bias, out, lse, dout,
                causal, dropout_rate, seed, offset, dsum)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd_lse.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def fwd_resources(d: int, train: bool, dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the forward at head width ``d`` uses on the card, K1's instance
    or (``train``) K2's, for ``dtype`` (the bfloat16 ``wgmma`` kernel or the
    float32 3×TF32 one): ``build.RESOURCES``, its ring's stages and the keys
    of a tile."""
    from transformertts_torch.ops import build
    return build.resources('flash_attention_fwd', 'flash_attention_fwd_resources',
                           (d, int(train), _DTYPES[dtype]),
                           build.RESOURCES + ('stages', 'key_tile'))


def dq_resources(d: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """What K3's kernel for ``dtype`` at head width ``d`` uses on the card:
    ``build.RESOURCES`` and, for the bfloat16 ``mma.sync`` kernel, its key
    tile; for the float32 SIMT kernel, its query rows a block (64, or 32 at
    d > 224)."""
    from transformertts_torch.ops import build
    tile = 'key_tile' if dtype == torch.bfloat16 else 'query_rows'
    return build.resources('flash_attention_bwd', 'flash_attention_bwd_dq_resources',
                           (d, _DTYPES[dtype]), build.RESOURCES + (tile,))


def dkv_resources(d: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """What K4's kernel for ``dtype`` at head width ``d`` uses on the card:
    ``build.RESOURCES`` and its query tile."""
    from transformertts_torch.ops import build
    return build.resources('flash_attention_bwd', 'flash_attention_bwd_dkv_resources',
                           (d, _DTYPES[dtype]), build.RESOURCES + ('query_tile',))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, dropout_rate, seed, offset):
        out, lse = flash_attention_fwd_lse(q, k, v, bias, causal, dropout_rate,
                                           seed, offset)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.args = (causal, dropout_rate, seed, offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        args = (q, k, v, bias, out, lse, dout, *ctx.args)
        dsum = row_dot(dout, out)
        dq = flash_attention_bwd_dq(*args, dsum=dsum)
        dk, dv = flash_attention_bwd_dkv(*args, dsum=dsum)
        # the bias is a mask, not a parameter: no gradient, as in the TPU design
        return dq, dk, dv, None, None, None, None, None


def draw_seed_offset(generator: torch.Generator):
    """(seed, offset) of one call's dropout mask, taken from ``generator``
    without a device round trip: a CUDA generator's seed and Philox offset
    (advanced past the slot this call takes), or two draws of a CPU one."""
    if generator.device.type == 'cuda':
        offset = generator.get_offset()
        generator.set_offset(offset + 4)
        seed = generator.initial_seed()
        return (seed ^ (seed >> 32)) & _MASK32, offset & _MASK32
    seed, offset = torch.randint(0, 2 ** 32, (2,), generator=generator).tolist()
    return seed, offset


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              bias: torch.Tensor, causal: bool = False,
                              dropout_rate: float = 0.0,
                              generator: torch.Generator = None) -> torch.Tensor:
    """Differentiable fused attention, the contract of ``flash_attention``
    plus inverted dropout on the weights at ``dropout_rate``, keyed by
    (seed, offset) drawn from ``generator`` (needed when the rate is above
    0). The bias gets no gradient."""
    seed = offset = 0
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError('flash_attention_trainable: dropout needs a generator')
        seed, offset = draw_seed_offset(generator)
    return _FlashAttention.apply(q, k, v, bias, causal, float(dropout_rate), seed, offset)
