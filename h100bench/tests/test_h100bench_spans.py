"""The readings of window A against the program's spans and counters
(``h100bench/spans.py``) on hand-built records, and the program's counters
against what the harness's hooks saw of the same window on the CPU."""
import time

import pytest

from conftest import cell, tiny_serve_config, tiny_serve_mix
from h100bench import serve, spans
from h100bench.common import seed_streams
from h100bench.families import forward_tts
from h100bench.traffic import paragraphs

BASE_NS = 1_700_000_000_000_000_000


def span(name, start_us, end_us, parent=None, **attrs):
    return {'name': name, 'start_ns': BASE_NS + int(start_us * 1e3),
            'end_ns': BASE_NS + int(end_us * 1e3), 'parent': parent, 'request': 0,
            'attrs': attrs}


def ctx_of(span_list, device, launches, window_us=100.0, audio_s=0.5, counters=None):
    """``device``: [(start µs, end µs, correlation)]; ``launches``: {correlation: µs}."""
    return {'spans': span_list, 'counters': counters or {},
            'a_work': [{'audio_s': audio_s}],
            'a': {'window_s': window_us * 1e-6, 'base_ns': BASE_NS,
                  'device_events': [(s, e - s, c) for s, e, c in device],
                  'launch_events': [(t, c) for c, t in launches.items()]}}


# request [0, 100] µs holds frontend [2, 8], encode [10, 40], decode [40, 70]
# and waveform [70, 80]
SPANS = [span('request', 0, 100), span('frontend', 2, 8, 0), span('encode', 10, 40, 0),
         span('decode', 40, 70, 0), span('waveform', 70, 80, 0)]


def test_an_idle_interval_is_cut_at_the_span_boundaries():
    # busy [0, 20] and [60, 100]: the idle [20, 60] is 20 µs of encode, 20 of decode
    ctx = ctx_of(SPANS, [(0, 20, 1), (60, 100, 2)], {1: 11, 2: 45})
    idle = spans.idle_ns_by_span(ctx)
    assert idle['encode'] == pytest.approx(20e3)
    assert idle['decode'] == pytest.approx(20e3)
    assert idle['request'] == pytest.approx(0.0) and idle['frontend'] == 0.0
    assert spans.launch_idle_share(ctx) == pytest.approx(40.0)


def test_the_request_time_between_its_phases_is_the_requests_own():
    ctx = ctx_of(SPANS, [(50, 51, 1)], {1: 45})
    segments = spans.innermost_segments(SPANS)
    assert [(round((s - BASE_NS) / 1e3), round((e - BASE_NS) / 1e3), n) for s, e, n in segments] \
        == [(0, 2, 'request'), (2, 8, 'frontend'), (8, 10, 'request'), (10, 40, 'encode'),
            (40, 70, 'decode'), (70, 80, 'waveform'), (80, 100, 'request')]
    idle = spans.idle_ns_by_span(ctx)
    assert idle['request'] == pytest.approx(24e3) and idle['decode'] == pytest.approx(29e3)
    # idle in encode 30 + decode 29 + waveform 10 of 100 µs
    assert spans.launch_idle_share(ctx) == pytest.approx(69.0)


def test_a_kernel_launched_inside_waveform_counts_when_it_runs_after_the_span():
    # launched at 75 µs inside waveform, run [85, 95]; launched at 90, after
    # it, run [93, 99]: only the first counts
    ctx = ctx_of(SPANS, [(85, 95, 7), (93, 99, 8)], {7: 75, 8: 90}, audio_s=0.5)
    assert spans.wave_busy_ms_per_audio_s(ctx) == pytest.approx(10e-3 / 0.5)
    # two launched inside, overlapping on the device: their union
    ctx = ctx_of(SPANS, [(85, 95, 7), (93, 99, 8)], {7: 75, 8: 79}, audio_s=0.5)
    assert spans.wave_busy_ms_per_audio_s(ctx) == pytest.approx(14e-3 / 0.5)


def test_frontend_time_and_padding():
    ctx = ctx_of(SPANS, [], {}, audio_s=0.004,
                 counters={'frames_real': 300, 'frame_slots': 1024})
    assert spans.frontend_ms_per_audio_s(ctx) == pytest.approx(6e-3 / 0.004)
    assert spans.frame_pad_share(ctx) == pytest.approx(100 * (1 - 300 / 1024))


def test_without_the_programs_records_each_reading_is_none():
    # what the parent's program gives: no spans, no counters
    ctx = ctx_of([], [(0, 20, 1)], {1: 5})
    assert all(f(ctx) is None for f in spans.READINGS.values())
    # the harness's window A as it is: no device events, no launches
    ctx = ctx_of(SPANS, [], {}, counters={'frames_real': 1, 'frame_slots': 2})
    del ctx['a']['device_events'], ctx['a']['launch_events']
    assert spans.wave_busy_ms_per_audio_s(ctx) is None
    assert spans.launch_idle_share(ctx) is None
    assert spans.frame_pad_share(ctx) == pytest.approx(50.0)
    # a window that returned no audio
    ctx = ctx_of(SPANS, [(85, 95, 7)], {7: 75}, audio_s=0.0)
    assert spans.frontend_ms_per_audio_s(ctx) is None
    assert spans.wave_busy_ms_per_audio_s(ctx) is None


def test_the_programs_frame_counters_match_the_harness_hooks(on_cpu):
    """frames_real / frame_slots as the program counts them equal the same
    sums from what the harness's hooks recorded of each chunk."""
    import numpy as np
    from transformertts_torch.utils import tracing

    c = cell(tiny_serve_config(), tiny_serve_mix())
    cfg, mix = c['config_data'], c['traffic_data']
    seed = 2 ** 31 + 11
    built = forward_tts.build(cfg, mix, seed, 'cpu')
    capture = forward_tts.Capture(built)
    a_work = []
    tracing.take()
    tracing.enable()
    try:
        w = serve.run_window(forward_tts, built, mix, paragraphs(mix, seed, stream=0), 0.5,
                             capture, serve.Sample(2, seed_streams(seed, 3)), a_work)
    finally:
        tracing.disable()
    records = tracing.take()
    capture.close()
    real, slots = 0, 0
    for request in a_work:
        for tokens, dur, out_shape in request['chunks']:
            n_tok, frames = forward_tts.row_lengths(tokens, dur)
            real += int(np.maximum(1, frames[n_tok > 0]).sum())
            slots += out_shape[0] * out_shape[1]
    counters = records['counters']
    assert counters['requests'] == w['attempted'] >= 1
    assert (counters['frames_real'], counters['frame_slots']) == (real, slots)
    assert counters['audio_samples'] == round(w['audio_s'] * built['sampling_rate'])
    ctx = {'spans': records['spans'], 'counters': counters, 'a_work': a_work}
    assert spans.frame_pad_share(ctx) == pytest.approx(100 * (1 - real / slots))
    assert spans.frontend_ms_per_audio_s(ctx) > 0
    assert sum(s['name'] == 'request' for s in records['spans']) == w['attempted']
    assert time.time_ns() > max(s['end_ns'] for s in records['spans'])
