"""Window A read against the program's own spans and counters
(``transformertts_torch.utils.tracing``), and a tool that measures them on
the card (not part of a run).

    python -m h100bench.spans --workload <cell> --seed <n> [--seconds 10]
        [--order off,on,on,off]

For each entry of ``--order``, in one process after one set-up: window A as
a traced run makes it (``serve.window_a``: the same request stream from the
seed every time), with the program's tracing on or off. One JSON line a
window on standard output: the requests, window A's audio rate and idle
share, and with tracing on the spans a request, the four readings below and
the idle seconds by the host's innermost open span. The runs do not judge
``correct``.

The readings take the traced run's ``ctx`` (``readers.py``):
``ctx['spans']`` and ``ctx['counters']`` (``tracing.take()`` after window
A), and under ``ctx['a']`` ``device_events`` [(ts µs, dur µs,
correlation)], ``launch_events`` [(ts µs, correlation)] and ``base_ns``
(``trace.device_window``). Each returns None where its records are
missing.

- ``frontend_ms_per_audio_s``: host ms inside ``frontend`` spans per audio
  second returned;
- ``frame_pad_share``: 100 × (1 − frames_real / frame_slots);
- ``wave_busy_ms_per_audio_s``: the union of the device intervals of every
  kernel, copy and fill whose launch falls inside a ``waveform`` span, in
  ms per audio second;
- ``launch_idle_share``: 100 × the device's idle seconds while the host's
  innermost open span is ``encode``, ``decode`` or ``waveform``, over the
  window's seconds; each idle interval is cut at the span boundaries.
"""
import argparse
import bisect
import json
import sys
from collections import defaultdict

from h100bench.trace import union_seconds

LAUNCHING = ('encode', 'decode', 'waveform')


def _audio_s(ctx) -> float:
    return sum(r['audio_s'] for r in ctx.get('a_work', []))


def _epoch_ns(a, ts_us: float) -> int:
    """A trace time in µs as epoch ns, in integers: a float of epoch ns
    would round to 256 ns."""
    return round(ts_us * 1e3) + int(a['base_ns'])


def _device_ns(a) -> list:
    """[(start ns, end ns, correlation)] of window A's device events."""
    return [(_epoch_ns(a, ts), _epoch_ns(a, ts + dur), corr)
            for ts, dur, corr in a['device_events']]


def innermost_segments(spans) -> list:
    """[(start ns, end ns, name)], sorted and disjoint: each stretch of
    host time with the innermost open span it lies in. ``spans`` nest
    properly, each naming its parent by index."""
    children = defaultdict(list)
    for i, s in enumerate(spans):
        children[s['parent']].append(i)
    out = []
    for i, s in enumerate(spans):
        t = s['start_ns']
        for c in sorted(children[i], key=lambda c: spans[c]['start_ns']):
            if spans[c]['start_ns'] > t:
                out.append((t, spans[c]['start_ns'], s['name']))
            t = max(t, spans[c]['end_ns'])
        if s['end_ns'] > t:
            out.append((t, s['end_ns'], s['name']))
    return sorted(out)


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_ns_by_span(ctx) -> dict:
    """{innermost span name: ns of it in which the device ran nothing}."""
    busy = merged((s, e) for s, e, _ in _device_ns(ctx['a']))
    starts = [b[0] for b in busy]
    idle = defaultdict(float)
    for s, e, name in innermost_segments(ctx['spans']):
        covered, j = 0.0, max(0, bisect.bisect_right(starts, s) - 1)
        while j < len(busy) and busy[j][0] < e:
            covered += max(0.0, min(busy[j][1], e) - max(busy[j][0], s))
            j += 1
        idle[name] += (e - s) - covered
    return dict(idle)


def _within(intervals, launched: dict) -> set:
    """The correlation ids in ``launched`` ({id: ns}) whose time falls in
    one of ``intervals`` ((start ns, end ns), sorted, disjoint)."""
    starts = [i[0] for i in intervals]
    out = set()
    for corr, t in launched.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= intervals[i][1]:
            out.add(corr)
    return out


def _launched_ns(a) -> dict:
    return {corr: _epoch_ns(a, ts) for ts, corr in a['launch_events']}


def frontend_ms_per_audio_s(ctx):
    spans, audio_s = ctx.get('spans'), _audio_s(ctx)
    if not spans or audio_s <= 0:
        return None
    ns = sum(s['end_ns'] - s['start_ns'] for s in spans if s['name'] == 'frontend')
    return ns * 1e-6 / audio_s


def frame_pad_share(ctx):
    counters = ctx.get('counters') or {}
    if counters.get('frame_slots', 0) <= 0:
        return None
    return 100.0 * (1.0 - counters['frames_real'] / counters['frame_slots'])


def wave_busy_ms_per_audio_s(ctx):
    spans, a, audio_s = ctx.get('spans'), ctx['a'], _audio_s(ctx)
    if not spans or 'device_events' not in a or audio_s <= 0:
        return None
    wave = sorted((s['start_ns'], s['end_ns']) for s in spans if s['name'] == 'waveform')
    if not wave:
        return None
    ours = _within(wave, _launched_ns(a))
    return union_seconds((s, e) for s, e, corr in _device_ns(a) if corr in ours) * 1e-6 / audio_s


def launch_idle_share(ctx):
    spans, a = ctx.get('spans'), ctx['a']
    if not spans or 'device_events' not in a or a['window_s'] <= 0:
        return None
    idle = idle_ns_by_span(ctx)
    return 100.0 * sum(idle.get(n, 0.0) for n in LAUNCHING) * 1e-9 / a['window_s']


READINGS = {'frontend_ms_per_audio_s.serve': frontend_ms_per_audio_s,
            'frame_pad_share.serve': frame_pad_share,
            'wave_busy_ms_per_audio_s.serve': wave_busy_ms_per_audio_s,
            'launch_idle_share.serve': launch_idle_share}


def measure(cell, seed: int, seconds: float, order) -> list:
    """Set-up once, then one window A an entry of ``order`` ('on' or 'off':
    the program's tracing), each on the seed's measured request stream."""
    import numpy as np

    from h100bench import serve
    from h100bench.common import family_of, seed_streams
    from h100bench.traffic import paragraphs
    cfg, mix = cell['config_data'], cell['traffic_data']
    family = family_of(cfg)
    built = family.build(cfg, mix, seed)
    capture = family.Capture(built)
    serve.warm_up(family, built, mix, seed, capture)
    out = []
    for i, mode in enumerate(order):
        a_work = []
        sample = serve.Sample(mix['check_requests'], seed_streams(seed, 3))
        requests = paragraphs(mix, seed, stream=0)
        w, a, records = serve.window_a(family, built, mix, requests, seconds, capture, sample,
                                       a_work, program_trace=mode == 'on')
        ctx = {'cell': cell, 'a': a, 'a_work': a_work, **records}
        line = {'cell': cell['name'], 'seed': seed, 'window': i, 'program_trace': mode,
                'requests': w['attempted'], 'failed': w['failed'],
                'audio_rate_a': w['audio_s'] / w['window_s'],
                'idle_share': 100.0 * (1.0 - a['busy_s'] / a['window_s']),
                'wave_ms_per_audio_s': 1e3 * a['wave_stage_s'] / w['audio_s'],
                'device_events': len(a['device_events']),
                'launch_events': len(a['launch_events']),
                'p50_ms': 1e3 * float(np.median(w['latencies']))}
        if mode == 'on':
            launched = _launched_ns(a)
            in_request = _within(sorted((s['start_ns'], s['end_ns']) for s in records['spans']
                                        if s['name'] == 'request'), launched)
            line['launches_in_requests'] = len(in_request) / max(1, len(launched))
            line['unlaunched_device_events'] = sum(
                1 for _, _, corr in a['device_events'] if corr not in launched)
            line['spans'] = len(records['spans'])
            line['spans_per_request'] = len(records['spans']) / max(1, w['attempted'])
            line['counters'] = records['counters']
            line.update({k: f(ctx) for k, f in READINGS.items()})
            line['idle_s_by_span'] = {k: v * 1e-9 for k, v in sorted(idle_ns_by_span(ctx).items())}
            line['idle_s_outside_spans'] = (a['window_s'] - a['busy_s']
                                            - sum(line['idle_s_by_span'].values()))
        out.append(line)
        print(json.dumps(line), flush=True)
    capture.close()
    return out


def main(argv=None) -> int:
    from h100bench.common import load_cell
    ap = argparse.ArgumentParser(prog='python -m h100bench.spans')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--order', default='off,on,on,off')
    args = ap.parse_args(argv)
    order = args.order.split(',')
    if set(order) - {'on', 'off'}:
        ap.error('--order lists on and off only')
    measure(load_cell(args.workload), args.seed, args.seconds, order)
    return 0


if __name__ == '__main__':
    sys.exit(main())
