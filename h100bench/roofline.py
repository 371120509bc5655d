"""Peaks of the card and the operations each part of a step needs.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit:
989 TFLOP/s bfloat16, 495 TFLOP/s TF32 (the rate float32 work is held to:
no float32-accurate scheme runs faster on this card, so no share can pass
100 %), 3.35 TB/s of HBM.

Work is counted in the form that needs the least, whatever implements it:
dense layers and convolutions as 2 × their multiply-adds at the real
(unpadded) rows; attention as the products the causal or padding mask
keeps (S and P·V, 2 · kept · D each); Griffin-Lim and mel inversion as real
FFTs of 2.5 · n · log2 n a frame plus the filterbank products. Elementwise
work, normalization and softmax are not counted.
"""
import math

PEAK_FLOPS = {'bf16': 989e12, 'f32': 495e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: str) -> float:
    """The least time: the larger of the operations over the peak rate of
    their type and the bytes over the memory rate (``chip_smoke.bound``)."""
    return max(flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S)


def attention_bound_s(kernel: str, b: int, h: int, tq: int, tk: int, d: int, kept: int,
                      elem: int, peak: str) -> float:
    """K1–K4's bound at (B, H, Tq, Tk, D) with ``kept`` (query, key) pairs
    summed over the batch rows and heads that the mask keeps: K1 and K2 two
    products (S, P·V), K3 three (S, dP, dS·K), K4 four (S, dP, dV, dK), each
    2·kept·D; bytes: each input read and each output written once, rows of
    ``elem`` bytes (q, k, v, dO, O and the gradients) and the float32 bias,
    (m, log l) pairs and D rows (``chip_smoke._attention_bounds``)."""
    q_row, k_row = elem * b * h * tq * d, elem * b * h * tk * d
    lse, dsum, bias = 8 * b * h * tq, 4 * b * h * tq, 4 * b * tk
    flops, nbytes = {
        'K1': (4 * kept * d, 2 * q_row + 2 * k_row + bias),
        'K2': (4 * kept * d, 2 * q_row + 2 * k_row + lse + bias),
        'K3': (6 * kept * d, 3 * q_row + 2 * k_row + lse + dsum + bias),
        'K4': (8 * kept * d, 2 * q_row + 4 * k_row + lse + dsum + bias)}[kernel]
    return bound_s(flops, nbytes, peak)


def fft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def _stack_flops(t: int, d: int, heads: list, filters: list, kernel: int) -> float:
    """One self-attention stack of conv blocks over t positions."""
    per_block = (2 * t * d * d * 3          # q, k, v
                 + 4 * t * t * d            # S and P·V over all heads
                 + 2 * t * 2 * d * d)       # the output projection of [x, attention]
    dims = [d] + list(filters)
    per_block += sum(2 * t * dims[i] * dims[i + 1] * kernel for i in range(len(filters)))
    return per_block * len(heads)


def forward_tts_flops(m: dict, n_tok: int, frames: int) -> float:
    """The ForwardTransformer on one sentence of ``n_tok`` tokens and
    ``frames`` frames."""
    d = m['encoder_model_dimension']
    f = _stack_flops(n_tok, d, m['encoder_num_heads'], m['encoder_attention_conv_filters'],
                     m['encoder_attention_conv_kernel'])
    for key in ('duration_conv_filters', 'pitch_conv_filters'):
        dims = [d] + list(m[key])
        k = m['duration_kernel_size']
        f += sum(2 * n_tok * dims[i] * dims[i + 1] * k for i in range(len(m[key])))
        f += 2 * n_tok * dims[-1]
    f += 2 * n_tok * d                     # the pitch embedding
    dd = m['decoder_model_dimension']
    f += _stack_flops(frames, dd, m['decoder_num_heads'], m['decoder_attention_conv_filters'],
                      m['decoder_attention_conv_kernel'])
    return f + 2 * frames * dd * m['mel_channels']


def griffin_lim_flops(a: dict, frames: int, mels: int) -> float:
    """Mel inversion (pseudo-inverse, the numerator, 10 refinements) and
    ``griffin_lim_iters`` iterations of an inverse and a forward real FFT a
    frame, plus the last inverse."""
    bins = a['n_fft'] // 2 + 1
    inversion = 2 * frames * mels * bins * (2 + 2 * 10)
    return inversion + frames * fft_flops(a['n_fft']) * (2 * a['griffin_lim_iters'] + 1)


def hifigan_flops(v: dict, frames: int, mels: int) -> float:
    """The generator on ``frames`` mel frames."""
    ch, t = v['upsample_initial_channel'], frames
    f = 2 * t * mels * ch * 7
    for u, k in zip(v['upsample_rates'], v['upsample_kernel_sizes']):
        f += 2 * t * ch * (ch // 2) * k      # each input position reaches k outputs
        t, ch = t * u, ch // 2
        for rk, dil in zip(v['resblock_kernel_sizes'], v['resblock_dilation_sizes']):
            f += len(dil) * 2 * (2 * t * ch * ch * rk)
    return f + 2 * t * ch * 7
