"""What the per-layer readers (``metrics/<name>.py``) share.

A reader is ``read(ctx) -> float | None``; ``ctx`` holds the cell, the
traced windows' readings (``trace.device_window`` as ``ctx['a']``,
``trace.stack_window`` as ``ctx['b']``) and what the driver knew of the work
in each window (``ctx['a_work']``, ``ctx['b_work']``). A serving cell's
``ctx`` also holds the program's spans and counters of window A
(``ctx['spans']``, ``ctx['counters']``: ``transformertts_torch.utils.tracing``),
read by ``spans.py``. ``None`` means nothing to read, and the harness leaves
the metric out.
"""
import importlib.util

import numpy as np

from h100bench import roofline
from h100bench.common import BENCH_DIR, family_of


def load_reader(name: str):
    path = BENCH_DIR / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'h100bench_metric_{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def idle_share(ctx) -> float:
    a = ctx['a']
    return 100.0 * (1.0 - a['busy_s'] / a['window_s']) if a['window_s'] > 0 else None


def kernel_seconds(ctx, parts) -> float:
    return sum(s for name, s in ctx['a']['kernels'] if any(p in name for p in parts))


def serve_flop_seconds(ctx) -> float:
    """The least device seconds of the serving window's work, as the
    configuration's model family counts it (its ``flop_seconds``)."""
    return family_of(ctx['cell']['config_data']).flop_seconds(ctx)


def serve_attention_bound_s(ctx):
    """Σ K1 bound over the serving window's launches, as the configuration's
    model family counts it (its ``attention_bound_s``), or None for a family
    that launches no K1."""
    bound = family_of(ctx['cell']['config_data']).attention_bound_s
    return None if bound is None else bound(ctx)


def aligner_forward_flops(m: dict, n_tok: int, frames: int, r: int) -> float:
    """The Aligner's forward on one clip of ``n_tok`` tokens and ``frames``
    decoder inputs (the mel frames and the start frame, strided by r): each
    dense as 2 × its multiply-adds, attention's S and P·V over the pairs the
    masks keep (causal in the decoder's self-attention), the mel projection
    at the r · mels outputs that are used."""
    d, ff, t, n = m['encoder_model_dimension'], m['encoder_feed_forward_dimension'], frames, n_tok
    enc = len(m['encoder_num_heads']) * (2 * n * d * d * 3 + 4 * n * n * d + 2 * n * 2 * d * d
                                         + 2 * 2 * n * d * ff)
    dd, dff = m['decoder_model_dimension'], m['decoder_feed_forward_dimension']
    pre = 2 * t * m['mel_channels'] * m['decoder_prenet_dimension'] \
        + 2 * t * m['decoder_prenet_dimension'] * dd
    block = (2 * t * dd * dd * 3 + 4 * (t * (t + 1) // 2) * dd + 2 * t * 2 * dd * dd   # self
             + 2 * t * dd * dd + 2 * 2 * n * dd * dd + 4 * t * n * dd + 2 * t * 2 * dd * dd
             + 2 * 2 * t * dd * dff)
    mels = m['mel_channels']
    out = 2 * t * dd * mels * r + 2 * t * r * mels * (mels + 3)
    return enc + pre + len(m['decoder_num_heads']) * block + out


def train_flop_seconds(ctx) -> float:
    """The least device seconds of the training window's steps: forward and
    backward (3 × the forward) at the float32 peak."""
    cfg = ctx['cell']['config_data']
    r = cfg['training']['reduction_factor']
    total = 0.0
    for step in ctx['a_work']:
        for t, n in zip(step['frames'], step['n_tokens']):
            total += 3 * aligner_forward_flops(cfg['model'], int(n), -(-(int(t) + 1) // r), r)
    return total / roofline.PEAK_FLOPS['f32']


def train_attention_bound_s(ctx) -> float:
    """Σ K2 + K3 + K4 bound over the training window's steps: every
    attention on the kernels (the encoder's, the decoder's causal
    self-attentions, every cross-attention but the last block's), at the
    batch's padded shapes, with the pairs the masks keep in each row."""
    cfg = ctx['cell']['config_data']
    m, r = cfg['model'], cfg['training']['reduction_factor']
    total = 0.0
    for step in ctx['a_work']:
        b, frames_pad = step['shape'][0], step['shape'][1]
        tq = -(-(frames_pad - 1) // r)
        n_pad = step['tok_pad']
        n = np.asarray(step['n_tokens'], np.int64)
        t = -(-(np.asarray(step['frames'], np.int64) + 1) // r)
        calls = []
        d = m['encoder_model_dimension']
        for h in m['encoder_num_heads']:
            calls.append((h, n_pad, n_pad, d // h, int(h * (n * n).sum())))
        heads = m['decoder_num_heads']
        d = m['decoder_model_dimension']
        for i, h in enumerate(heads):
            calls.append((h, tq, tq, d // h, int(h * (t * (t + 1) // 2).sum())))
            if i < len(heads) - 1:
                calls.append((h, tq, n_pad, d // h, int(h * (t * n).sum())))
        for h, q_len, k_len, depth, kept in calls:
            for kernel in ('K2', 'K3', 'K4'):
                total += roofline.attention_bound_s(kernel, b, h, q_len, k_len, depth, kept, 4,
                                                    'f32')
    return total
