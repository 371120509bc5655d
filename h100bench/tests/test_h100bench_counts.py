"""The operation and byte counts behind ``mfu`` and the rooflines, against
hand counts at tiny shapes, and the trace reductions."""
import math

import pytest

from conftest import tiny_serve_config, tiny_train_config
from h100bench import readers, roofline, trace
from h100bench.families import forward_tts


def test_attention_bound_counts_the_kept_products_of_a_causal_mask():
    b, h, t, d = 2, 3, 5, 8
    kept = b * h * sum(r + 1 for r in range(t))          # 15 pairs a head
    assert kept == 90
    flops = 4 * kept * d                                  # S and P·V
    nbytes = 2 * (2 * b * h * t * d) + 2 * (2 * b * h * t * d) + 4 * b * t
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert roofline.attention_bound_s('K1', b, h, t, t, d, kept, 2, 'bf16') == pytest.approx(want)
    # K3 three products, K4 four, and the (m, log l) and D rows read
    k4 = max(8 * kept * d / 495e12,
             (2 * 4 * b * h * t * d + 4 * 4 * b * h * t * d + 8 * b * h * t + 4 * b * h * t
              + 4 * b * t) / 3.35e12)
    assert roofline.attention_bound_s('K4', b, h, t, t, d, kept, 4, 'f32') == pytest.approx(k4)


def test_griffin_lim_counts_real_ffts_and_the_mel_products():
    a = {'n_fft': 16, 'griffin_lim_iters': 2}
    frames, mels, bins = 3, 4, 9
    fft = 2.5 * 16 * 4                                    # 2.5 n log2 n
    want = 2 * frames * mels * bins * 22 + frames * fft * 5
    assert roofline.griffin_lim_flops(a, frames, mels) == pytest.approx(want)


def test_hifigan_v1_counts_52_9_gflop_an_audio_second():
    cfg = {'upsample_rates': [8, 8, 2, 2], 'upsample_kernel_sizes': [16, 16, 4, 4],
           'upsample_initial_channel': 512, 'resblock_kernel_sizes': [3, 7, 11],
           'resblock_dilation_sizes': [[1, 3, 5]] * 3}
    per_s = roofline.hifigan_flops(cfg, 22050 / 256, 80) / 1e9
    assert per_s == pytest.approx(52.9, abs=0.05)


def test_hifigan_counts_a_tiny_generator_by_hand():
    cfg = {'upsample_rates': [2], 'upsample_kernel_sizes': [4], 'upsample_initial_channel': 4,
           'resblock_kernel_sizes': [3], 'resblock_dilation_sizes': [[1]]}
    t, mels = 5, 2
    want = (2 * t * mels * 4 * 7            # conv_pre
            + 2 * t * 4 * 2 * 4             # the transposed conv, 4 → 2 channels
            + 2 * (2 * 10 * 2 * 2 * 3)      # one dilation: two 3-wide convs at 10 samples
            + 2 * 10 * 2 * 7)               # conv_post
    assert roofline.hifigan_flops(cfg, t, mels) == want


def test_forward_transformer_counts_by_hand():
    m = tiny_serve_config()['model']
    n, t, d = 7, 20, 32

    def stack(x):
        return 2 * (2 * x * d * d * 3 + 4 * x * x * d + 2 * x * 2 * d * d
                    + 2 * x * d * 64 * 3 + 2 * x * 64 * 32 * 3)

    predictors = 2 * (2 * n * 32 * 16 * 3 + 2 * n * 16 * 16 * 3 + 2 * n * 16)
    want = stack(n) + predictors + 2 * n * d + stack(t) + 2 * t * d * 80
    assert roofline.forward_tts_flops(m, n, t) == want


def test_aligner_counts_by_hand():
    m = tiny_train_config()['model']
    n, t, d, ff = 6, 10, 32, 64
    enc = 2 * (2 * n * d * d * 3 + 4 * n * n * d + 2 * n * 2 * d * d + 2 * 2 * n * d * ff)
    pre = 2 * t * 80 * 32 + 2 * t * 32 * 32
    block = (2 * t * d * d * 3 + 4 * (t * (t + 1) // 2) * d + 2 * t * 2 * d * d
             + 2 * t * d * d + 2 * 2 * n * d * d + 4 * t * n * d + 2 * t * 2 * d * d
             + 2 * 2 * t * d * ff)
    out = 2 * t * d * 80 + 2 * t * 80 * 83
    assert readers.aligner_forward_flops(m, n, t, 1) == enc + pre + 3 * block + out


def test_busy_time_is_the_union_of_device_intervals():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert trace.union_seconds([]) == 0


def test_a_launch_is_charged_to_the_innermost_frame():
    frames = [(0, 10, 'outer'), (2, 5, 'inner'), (6, 9, 'second')]
    assert trace._stacks_at(frames, [1, 3, 5.5, 7, 11]) == ['outer', 'inner', 'outer',
                                                              'second', None]
    name = '/x/transformertts_torch/audio/griffinlim.py(93): istft_padded'
    assert trace._frame_module(name) == 'audio/griffinlim.py:istft_padded'


def test_fft_flops():
    assert roofline.fft_flops(1024) == 2.5 * 1024 * 10
    assert math.isclose(roofline.bound_s(989e12, 0, 'bf16'), 1.0)


def test_serving_readers_count_the_real_rows_of_each_chunk():
    import torch
    cfg = tiny_serve_config()
    tokens = torch.tensor([[5, 6, 7, 0], [8, 9, 0, 0], [0, 0, 0, 0]])
    dur = torch.tensor([[[2.4], [3.6], [1.0], [0.0]], [[2.0], [2.5], [0.0], [0.0]],
                        [[0.0]] * 4], dtype=torch.bfloat16)
    ctx = {'cell': {'config_data': cfg}, 'a_work': [{'chunks': [(tokens, dur, (3, 128, 80))]}]}
    # 2 + 4 + 1; 2 + 2 (half to even)
    assert forward_tts.work_rows(ctx['a_work']) == [(3, 7), (2, 4)]
    m = cfg['model']
    want = sum(roofline.forward_tts_flops(m, n, t) / 989e12
               + roofline.griffin_lim_flops(cfg['audio'], t, 80) / 495e12 for n, t in ((3, 7), (2, 4)))
    assert readers.serve_flop_seconds(ctx) == pytest.approx(want)
    bound = 0.0
    for tq, kept_rows in ((4, [3, 2, 0]), (128, [7, 4, 0])):
        for h in (2, 2):
            kept = h * sum(k * k for k in kept_rows)
            bound += roofline.attention_bound_s('K1', 3, h, tq, tq, 16, kept, 2, 'bf16')
    assert readers.serve_attention_bound_s(ctx) == pytest.approx(bound)


def test_training_readers_count_every_kernel_attention_of_a_step():
    cfg = tiny_train_config()
    m = cfg['model']
    step = {'frames': [10, 6], 'n_tokens': [4, 3], 'shape': (2, 13, 80), 'tok_pad': 32}
    ctx = {'cell': {'config_data': cfg}, 'a_work': [step],
           'a': {'launches': 500, 'kernels': [], 'window_s': 1.0, 'busy_s': 0.25}}
    t = [11, 7]                                 # decoder inputs: the start frame and T frames
    want = 3 * sum(readers.aligner_forward_flops(m, n, tt, 1) for n, tt in zip((4, 3), t))
    assert readers.train_flop_seconds(ctx) == pytest.approx(want / 495e12)
    bound = 0.0
    calls = [(2, 32, 32, 16, 2 * (16 + 9))] * 2                          # the encoder
    for i, h in enumerate((2, 2, 1)):
        calls.append((h, 12, 12, 32 // h, h * (66 + 28)))                # causal self
        if i < 2:
            calls.append((h, 12, 32, 32 // h, h * (44 + 21)))            # cross, on the kernels
    for h, tq, tk, d, kept in calls:
        bound += sum(roofline.attention_bound_s(k, 2, h, tq, tk, d, kept, 4, 'f32')
                     for k in ('K2', 'K3', 'K4'))
    assert readers.train_attention_bound_s(ctx) == pytest.approx(bound)
    assert readers.idle_share(ctx) == pytest.approx(75.0)
    assert readers.load_reader('launches_per_step.train')(ctx) == 500
