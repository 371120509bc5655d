"""Griffin-Lim's phase iterations in FFT form: the Hopper kernel and its plain
PyTorch version.

Phase recovery from a magnitude STFT S (B, F, n_fft/2 + 1) by ``n_iter``
inverse-STFT → STFT round trips with momentum (m = momentum / (1 + momentum),
zero-phase init), in the padded signal domain of the JAX package's fast path
(``transformertts_tpu/audio/griffinlim.py::griffin_lim``, hop dividing
n_fft): frame f lies at samples [f·hop, f·hop + n_fft) of an n_fft +
hop·(F − 1) signal, divided by the squared-window envelope of the frames
that exist (floored at 1e-10); the wav is the signal's centre,
hop·(F − 1) samples.

- ``griffin_lim_kernel`` launches ``csrc/griffin_lim.cu`` (built with nvcc
  at first use, see ``ops/build.py``) on a CUDA tensor once an iteration
  and once for the final inverse, n_iter + 1 launches counted in
  ``griffin_lim_kernel.launches``. It takes n_fft a power of two from 256 to
  2048 and a hop that divides it (``check_kernel_args``), and picks its tile
  from the grid (``launch_tile``), so that a small batch still spreads over
  the SMs.
- ``griffin_lim_plain`` does what the kernel does, float32 operation for
  float32 operation: tiles of ``tile_frames`` frames with their halos of
  n_fft/hop − 1 frames recomputed, each real FFT as one complex FFT of n_fft/2
  points in the kernel's Stockham passes (``fused_log_mel.fft_passes``) from
  the same tables (``kernel_layout``), the overlap-add of a position's frames
  in ascending order, the envelope summed in float64. Its result does not
  depend on the tile.

The JAX package has no Pallas kernel here: its Griffin-Lim is matmuls
against DFT bases, which the port ran as float32 GEMMs on the card (now
``audio.griffinlim._griffin_lim_padded``, for the shapes the kernel does not
take).
"""
import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from transformertts_torch.audio import spectral
from transformertts_torch.ops.fused_log_mel import (KERNEL_N_FFT, _float_pairs, fft_passes,
                                                    fft_twiddles)

TILE_FRAMES = 32          # frames a block owns
SEGMENT_FLOATS = 24576    # the most signal a block holds in shared memory (96 KB)
FFT_BUFFER_POINTS = 2048  # complex points a block transforms at once: 4096 / n_fft frames


def tile_frames(n_fft: int, hop_length: int) -> int:
    """Frames a block of the kernel owns: 32, or fewer where the block's
    signal segment, (tile + n_fft/hop − 1)·hop floats, would pass 96 KB."""
    halo = n_fft // hop_length - 1
    return max(1, min(TILE_FRAMES, SEGMENT_FLOATS // hop_length - halo))


def launch_tile(b: int, n_frames: int, n_fft: int, hop_length: int, n_sms: int) -> int:
    """Frames a block owns in a launch over (b, n_frames): ``tile_frames``,
    halved while the grid, b·ceil(n_frames / tile) blocks, gives fewer than
    two blocks an SM, down to the frames a block transforms at once (a
    smaller tile leaves its forward pass part empty); below that, halved
    only while some SM has no block. A smaller tile recomputes more halo
    frames, which only a grid that leaves the card idle can afford."""
    tile = tile_frames(n_fft, hop_length)
    at_once = max(1, FFT_BUFFER_POINTS // (n_fft // 2))

    def blocks(t):
        return b * -(-n_frames // t)
    while tile > at_once and blocks(tile) < 2 * n_sms:
        tile = -(-tile // 2)
    while tile > 1 and blocks(tile) < n_sms:
        tile = -(-tile // 2)
    return tile


class KernelLayout(NamedTuple):
    window: torch.Tensor          # (n_fft,) float32 padded Hann window
    fft_twiddles: torch.Tensor    # (n_fft//2 − 1, 2): the Stockham passes' twiddles
    split_twiddles: torch.Tensor  # (n_fft//2 + 1, 2): exp(−2πi k / n_fft), k = 0 … n_fft/2
    wsq: torch.Tensor             # (n_fft,) float64 squared window, for the envelope


@functools.lru_cache(maxsize=8)
def kernel_layout(device: str, n_fft: int, win_length: int) -> KernelLayout:
    """The kernel's tables, built once per device and settings, every
    twiddle in float64 and rounded to float32 once."""
    window = spectral.padded_window(n_fft, win_length)
    split = np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft)
    return KernelLayout(*(torch.as_tensor(a, device=device) for a in (
        window.astype(np.float32), _float_pairs(fft_twiddles(n_fft // 2)),
        _float_pairs(split), window ** 2)))


def check_kernel_args(n_iter: int, n_fft: int, hop_length: int, win_length: int):
    """Raise ``ValueError`` for settings the kernel (and ``griffin_lim_plain``)
    does not take."""
    if n_fft not in KERNEL_N_FFT:
        raise ValueError(f'griffin_lim: the kernel takes n_fft a power of two from '
                         f'{KERNEL_N_FFT[0]} to {KERNEL_N_FFT[-1]}, got {n_fft}')
    if hop_length < 1 or n_fft % hop_length != 0:
        raise ValueError(f'griffin_lim: the kernel takes a hop that divides n_fft '
                         f'{n_fft}, got {hop_length}')
    if not 0 < win_length <= n_fft or n_iter < 0:
        raise ValueError(f'griffin_lim: win_length {win_length} must lie in [1, n_fft] '
                         f'and n_iter {n_iter} be >= 0')


# --- the plain version ---------------------------------------------------------
# Complex values are (re, im) pairs of float32 tensors, and every line below
# is one rounding of the kernel's (csrc/stockham_fft.cuh, csrc/griffin_lim.cu).

_H = 0.70710678118654752  # sqrt(1/2), dft8's float32 constant


def _cadd(a, b):
    return a[0] + b[0], a[1] + b[1]


def _csub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _neg_i(a):
    return a[1], -a[0]


def _dft2(p):
    return [_cadd(p[0], p[1]), _csub(p[0], p[1])]


def _dft4(p):
    a0, a1 = _cadd(p[0], p[2]), _csub(p[0], p[2])
    a2, a3 = _cadd(p[1], p[3]), _neg_i(_csub(p[1], p[3]))
    return [_cadd(a0, a2), _cadd(a1, a3), _csub(a0, a2), _csub(a1, a3)]


def _dft8(p):
    e, o = _dft4(p[0::2]), _dft4(p[1::2])
    o = [o[0],
         (_H * (o[1][0] + o[1][1]), _H * (o[1][1] - o[1][0])),
         _neg_i(o[2]),
         (_H * (o[3][1] - o[3][0]), -_H * (o[3][0] + o[3][1]))]
    return [_cadd(e[k], o[k]) for k in range(4)] + [_csub(e[k], o[k]) for k in range(4)]


_DFT = {2: _dft2, 4: _dft4, 8: _dft8}


class _Pass(NamedTuple):
    radix: int
    stride: int
    twiddles: Tuple[torch.Tensor, torch.Tensor]  # (R − 1, M/R) re, im (unused at stride 1)


@functools.lru_cache(maxsize=8)
def _stockham(device: str, n_fft: int) -> List[_Pass]:
    """The kernel's passes over M = n_fft/2 points: pass point (r, j) is input
    point j + r·M/R, twiddled by entry Ns − 1 + (j mod Ns)(R − 1) + r − 1."""
    m = n_fft // 2
    tw = torch.as_tensor(_float_pairs(fft_twiddles(m)), device=device)
    passes = []
    for r, ns in fft_passes(m):
        j = np.arange(m // r)
        entry = ns - 1 + (j % ns)[None, :] * (r - 1) + np.arange(r - 1)[:, None]
        idx = torch.as_tensor(entry, device=device)
        passes.append(_Pass(r, ns, (tw[:, 0][idx], tw[:, 1][idx])))
    return passes


def _fft(z, passes: List[_Pass]):
    """Complex FFT over the last dim in the kernel's Stockham passes. Pass
    point (r, j), j = h·Ns + k, lands at (j − k)·R + k + r·Ns = h·R·Ns + r·Ns + k:
    the R outputs stacked between h and k."""
    re, im = z
    *lead, m = re.shape
    for p in passes:
        r, ns = p.radix, p.stride
        xr, xi = re.reshape(*lead, r, m // r), im.reshape(*lead, r, m // r)
        pts = [(xr[..., k, :], xi[..., k, :]) for k in range(r)]
        if ns > 1:
            pts = pts[:1] + [_cmul(pts[k], (p.twiddles[0][k - 1], p.twiddles[1][k - 1]))
                             for k in range(1, r)]
        out = _DFT[r](pts)
        re, im = (torch.stack([o[c].reshape(*lead, m // (r * ns), ns) for o in out],
                              -2).reshape(*lead, m) for c in (0, 1))
    return re, im


def _rfft(frames, layout: KernelLayout, passes):
    """(…, n_fft) signal frames → Re, Im (…, n_fft/2 + 1) of their windowed
    one-sided DFT: the FFT of z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], then the
    split step."""
    w = layout.window
    zr, zi = _fft((w[0::2] * frames[..., 0::2], w[1::2] * frames[..., 1::2]), passes)
    m = zr.shape[-1]
    k = torch.arange(m + 1, device=zr.device)
    a, c = k % m, (m - k) % m
    ar, ai, cr, ci = zr[..., a], zi[..., a], zr[..., c], zi[..., c]
    er, ei = 0.5 * (ar + cr), 0.5 * (ai - ci)
    odr, odi = 0.5 * (ai + ci), -0.5 * (ar - cr)
    wr, wi = layout.split_twiddles[:, 0], layout.split_twiddles[:, 1]
    return er + (wr * odr - wi * odi), ei + (wr * odi + wi * odr)


def _irfft_windowed(xr, xi, layout: KernelLayout, passes):
    """Re, Im (…, n_fft/2 + 1) → (…, n_fft) windowed inverse real DFT, the
    imaginary parts of bins 0 and n_fft/2 dropped: the forward passes on
    conj(Z)/M, Z[n] = E + iO."""
    m = xr.shape[-1] - 1
    xi = xi.clone()
    xi[..., 0] = 0.0
    xi[..., m] = 0.0
    n = torch.arange(m, device=xr.device)
    ar, ai, cr, ci = xr[..., :m], xi[..., :m], xr[..., m - n], xi[..., m - n]
    h = 0.5 / m
    er, ei = (ar + cr) * h, (ai - ci) * h
    dr, di = (ar - cr) * h, (ai + ci) * h
    wr, wi = layout.split_twiddles[:m, 0], layout.split_twiddles[:m, 1]
    odr, odi = dr * wr + di * wi, di * wr - dr * wi
    zr, zi = _fft((er - odi, -(ei + odr)), passes)       # conj(z), z[n] = x[2n] + i x[2n+1]
    w = layout.window
    return torch.stack([w[0::2] * zr, w[1::2] * -zi], -1).flatten(-2)


def griffin_lim_plain(S: torch.Tensor, n_iter: int, n_fft: int, hop_length: int,
                      win_length: int, momentum: float = 0.99) -> torch.Tensor:
    """Eager version of the kernel on any device: magnitudes S (B, F,
    n_fft/2 + 1) → waveforms (B, hop·(F − 1)), in tiles of ``tile_frames``
    frames (the result is the same for any tile)."""
    check_kernel_args(n_iter, n_fft, hop_length, win_length)
    S = S.float()
    b, n_frames, n_bins = S.shape
    dev = S.device
    layout = kernel_layout(str(dev), n_fft, win_length)
    passes = _stockham(str(dev), n_fft)
    hop, k_strips = hop_length, n_fft // hop_length
    halo = k_strips - 1
    tile = tile_frames(n_fft, hop)
    n_tiles = -(-n_frames // tile)
    tiles = torch.arange(n_tiles, device=dev)[:, None] * tile
    # each tile's inverse frames, f0 − halo … f0 + tile + halo − 1
    inv = tiles - halo + torch.arange(tile + 2 * halo, device=dev)
    inv_ok = ((inv >= 0) & (inv < n_frames))[..., None]
    inv = inv.clamp(0, n_frames - 1)
    # the envelope of each tile's segment positions (hop index q, residue r),
    # frames q − halo … q in ascending order, in float64
    q = tiles + torch.arange(tile + halo, device=dev)
    strips = layout.wsq.reshape(k_strips, hop)
    env = torch.zeros(n_tiles, tile + halo, hop, dtype=torch.float64, device=dev)
    for d in range(k_strips):
        f = q - halo + d
        env = env + torch.where(((f >= 0) & (f < n_frames))[..., None], strips[halo - d], 0.0)
    env = env.float().clamp_min(1e-10)

    def segments(xr, xi):
        """(B, n_tiles, (tile + halo)·hop) signal segments of X = (xr, xi)."""
        zero = torch.zeros((), device=dev)
        fr = _irfft_windowed(torch.where(inv_ok, xr[:, inv], zero),
                             torch.where(inv_ok, xi[:, inv], zero), layout, passes)
        fr = fr.reshape(b, n_tiles, tile + 2 * halo, k_strips, hop)
        seg = torch.zeros(b, n_tiles, tile + halo, hop, device=dev)
        for d in range(k_strips):   # position q's frame q + d, at its strip halo − d
            seg = seg + fr[:, :, d:d + tile + halo, halo - d]
        return (seg / env).reshape(b, n_tiles, -1)

    m = momentum / (1.0 + momentum)
    xr, xi = S, torch.zeros_like(S)
    pr, pi = torch.zeros_like(S), torch.zeros_like(S)
    for _ in range(n_iter):
        frames = segments(xr, xi).unfold(-1, n_fft, hop)          # (B, n_tiles, tile, n_fft)
        nr, ni = (v.reshape(b, n_tiles * tile, n_bins)[:, :n_frames]
                  for v in _rfft(frames, layout, passes))
        ur, ui = nr - m * pr, ni - m * pi
        # the square root of a float32 taken in float64 and rounded once is the
        # correctly rounded one, the kernel's sqrtf (torch's float32 sqrt on
        # the CPU can be an ulp off)
        mag = torch.sqrt((ur * ur + ui * ui).double()).float() + 1e-16
        xr, xi = S * (ur / mag), S * (ui / mag)
        pr, pi = nr, ni
    seg = segments(xr, xi)
    # each tile's own positions, then the last tile's tail
    y = torch.cat([seg[:, :, :tile * hop].reshape(b, -1), seg[:, -1, tile * hop:]], dim=-1)
    return y[:, n_fft // 2:n_fft // 2 + hop * (n_frames - 1)]


# --- the kernel ----------------------------------------------------------------

@functools.cache
def _entry():
    """The ctypes launch entry of ``csrc/griffin_lim.cu``, built, loaded and typed once."""
    from transformertts_torch.ops import build
    fn = build.load('griffin_lim').griffin_lim_iteration
    i, p = ctypes.c_int, ctypes.c_void_p
    fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p, p, p, p, p]
    fn.restype = i
    return fn


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def griffin_lim_kernel(S: torch.Tensor, n_iter: int, n_fft: int, hop_length: int,
                       win_length: int, momentum: float = 0.99) -> torch.Tensor:
    """Magnitudes S (B, F, n_fft/2 + 1), a float32 CUDA tensor → waveforms
    (B, hop·(F − 1)), in n_iter + 1 launches counted in
    ``griffin_lim_kernel.launches``."""
    if not S.is_cuda:
        raise ValueError(f'griffin_lim: the kernel takes a CUDA tensor, got {S.device}')
    if S.dtype != torch.float32:
        raise TypeError(f'griffin_lim: S must be float32, got {S.dtype}')
    check_kernel_args(n_iter, n_fft, hop_length, win_length)
    if S.dim() != 3 or S.shape[-1] != n_fft // 2 + 1 or S.shape[1] < 1 or S.shape[0] < 1:
        raise ValueError(f'griffin_lim: S must be (B, F, {n_fft // 2 + 1}) with B, F >= 1, '
                         f'got {tuple(S.shape)}')
    S = S.contiguous()
    b, n_frames, n_bins = S.shape
    fn = _entry()
    layout = kernel_layout(str(S.device), n_fft, win_length)
    tile = launch_tile(b, n_frames, n_fft, hop_length, _sm_count(S.device))
    like = dict(dtype=torch.float32, device=S.device)
    xs = [torch.empty(b, n_frames, n_bins, 2, **like) for _ in range(min(n_iter, 2))]
    prev = torch.empty(b, n_frames, n_bins, 2, **like) if n_iter else None
    wav = torch.empty(b, hop_length * (n_frames - 1), **like)
    m = momentum / (1.0 + momentum)
    # (mode, x_in, x_out): the first iteration from S, the others from the
    # previous one's X, the final inverse into wav
    steps = [(0, None, xs[0])] if n_iter else []
    steps += [(1, xs[(i - 1) % 2], xs[i % 2]) for i in range(1, n_iter)]
    steps.append((2, xs[(n_iter - 1) % 2], None) if n_iter else (3, None, None))
    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        for mode, x_in, x_out in steps:
            err = fn(mode, S.data_ptr(), ptr(x_in), ptr(x_out), ptr(prev), wav.data_ptr(), b,
                     n_frames, n_fft, hop_length, tile, m, layout.window.data_ptr(),
                     layout.fft_twiddles.data_ptr(), layout.split_twiddles.data_ptr(),
                     layout.wsq.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(
                    f'griffin_lim launch failed at n_fft {n_fft}, hop {hop_length}, tile '
                    f'{tile}: CUDA error {err}')
            griffin_lim_kernel.launches += 1
    return wav


griffin_lim_kernel.launches = 0


def kernel_resources(n_fft: int, hop_length: int) -> dict:
    """What an iteration's kernel for ``n_fft`` uses on the card at this hop
    and its tile: ``build.RESOURCES``."""
    from transformertts_torch.ops import build
    return build.resources('griffin_lim', 'griffin_lim_resources',
                           (n_fft, hop_length, tile_frames(n_fft, hop_length)))
