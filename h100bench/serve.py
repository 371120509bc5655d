"""A serving cell: one closed-loop caller sends paragraphs to the program.

What depends on the model comes from the configuration's model family
(``families/<model_family>.py``): building the program with weights drawn
from the seed, the serve call, the hooks that record each chunk, the
checked records, the check and the work counts. Set-up builds the program,
then runs a few requests of a separate warm-up stream, among them one of
the mix's largest size. The window sends the measured stream's requests
back to back until ``--seconds`` have passed and the last one has returned;
a request's latency runs from its call to its waves on the host. The
family's hooks record what each chunk was fed and produced, without a
device sync; the records of a seed-drawn sample of the finished requests,
and of the longest, are kept for the check, which runs after the window,
once the program's state is freed. The program runs with the settings it
makes itself: the harness sets no precision.
"""
import gc
import sys
import time
import traceback

import numpy as np
import torch

from h100bench import check_serve
from h100bench.common import family_of, seed_streams
from h100bench.traffic import paragraphs

TRAFFIC_KIND = 'paragraphs'


class StageClock:
    """CUDA events at the waveform stage's entry and return in every chunk
    (the family's ``stage``: ``owner.attribute``, wrapped on the instance),
    recorded without a sync. A pair spans the stage on the card: from the
    work before it, or the host's arrival if that is later, to the stage's
    last kernel's end. Installed for the traced window A alone."""

    def __init__(self, owner, attribute: str):
        self.events = []
        real = getattr(owner, attribute)

        def timed(*args, **kwargs):
            self._mark()
            out = real(*args, **kwargs)
            self._mark()
            return out

        setattr(owner, attribute, timed)
        self.undo = lambda: delattr(owner, attribute)

    def _mark(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)

    def close(self) -> float:
        """Removes the clock; the seconds of every recorded stage."""
        self.undo()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in zip(self.events[0::2], self.events[1::2])) / 1e3


class Sample:
    """A reservoir of ``k`` finished requests drawn from the seed, and the
    longest finished request (most sentences, the first of a tie). A
    request that leaves both drops its waves and chunks."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.kept, self.longest, self.seen = [], None, 0

    def offer(self, item: dict):
        before = self.items()
        self.seen += 1
        if self.longest is None or len(item['sentences']) > len(self.longest['sentences']):
            self.longest = item
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.kept[j] = item
        now = self.items()
        for x in before + [item]:
            if all(x is not y for y in now):
                x['chunks'] = x['wavs'] = None

    def items(self) -> list:
        out = list(self.kept)
        if self.longest is not None and all(self.longest is not x for x in out):
            out.append(self.longest)
        return out


def run_window(family, built, mix, requests, seconds, capture, sample, log_work=None) -> dict:
    """Requests back to back until ``seconds`` have passed. Returns the
    window's readings; keeps the sampled requests' chunks. With
    ``log_work`` (a list) each request's audio seconds and the family's
    ``chunk_work`` of each chunk are appended to it, for the traced
    readings."""
    sr = built['sampling_rate']
    latencies, audio_s, attempted, failed = [], 0.0, 0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        sentences = next(requests)
        attempted += 1
        t0 = time.perf_counter()
        try:
            wavs = family.serve(built, sentences, mix)
        except Exception:
            failed += 1
            latencies.append(time.perf_counter() - t0)
            print(f'request {attempted} failed:', file=sys.stderr)
            traceback.print_exc()
            capture.take()
            continue
        latencies.append(time.perf_counter() - t0)
        audio_s += sum(len(w) for w in wavs) / sr
        chunks = capture.take()
        if log_work is not None:
            log_work.append({'audio_s': sum(len(w) for w in wavs) / sr,
                             'chunks': [family.chunk_work(c) for c in chunks]})
        sample.offer({'sentences': sentences, 'wavs': wavs, 'chunks': chunks})
    window_s = time.perf_counter() - start
    return {'latencies': latencies, 'audio_s': audio_s, 'attempted': attempted,
            'failed': failed, 'window_s': window_s}


def warm_up(family, built, mix, seed, capture):
    """The first ``warmup_requests`` of warm-up stream 1, then its first
    request of the mix's largest size, each waited for."""
    stream = paragraphs(mix, seed, stream=1)
    biggest = mix['sentences']['max']
    done_big = False
    for i in range(10 ** 6):
        sentences = next(stream)
        if i >= mix['warmup_requests']:
            if len(sentences) != biggest:
                continue
            done_big = True
        family.serve(built, sentences, mix)
        capture.take()
        if done_big:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def window_a(family, built, mix, requests, seconds, capture, sample, work,
             program_trace: bool):
    """The device-traced window A (``trace.device_window``) with the
    family's waveform stage timed by ``StageClock``, and with
    ``program_trace`` the program's spans and counters recorded
    (``transformertts_torch.utils.tracing``). Returns (the window's
    readings, the traced readings, {'spans', 'counters'})."""
    from transformertts_torch.utils import tracing

    from h100bench import trace
    clock = StageClock(*family.stage(built))
    tracing.take()
    if program_trace:
        tracing.enable()
    try:
        w, a = trace.device_window(lambda: run_window(
            family, built, mix, requests, seconds, capture, sample, work))
    finally:
        tracing.disable()
    a['wave_stage_s'] = clock.close()
    return w, a, tracing.take()


def free_program():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sampled_records(family, sample) -> list:
    """The sampled requests' records, on the host."""
    records = []
    for item in sample.items():
        records.extend(family.records(item['sentences'], item['wavs'], item['chunks']))
        item['chunks'] = None
    return records


TRACE_A_SECONDS = 10.0   # the device-traced window, at most
TRACE_B_SECONDS = 1.0    # the stack-traced window (the breakdown): the requests begun in it


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, t_start: float,
             device: str = 'cuda'):
    """One run of a serving cell: (end-to-end or traced readings, the
    window's counts, the sampled records, the freed-program hand-over)."""
    from h100bench import trace
    from h100bench.common import device_info, log_phase, require_devices
    cfg, mix = cell['config_data'], cell['traffic_data']
    require_devices(cell['chips'])
    log_phase(t_start, 'imports')
    family = family_of(cfg)
    built = family.build(cfg, mix, seed, device)
    log_phase(t_start, 'model and weights on the device')
    capture = family.Capture(built)
    warm_up(family, built, mix, seed, capture)
    log_phase(t_start, 'warm-up requests (kernels built or loaded)')
    setup_s = time.time() - t_start
    requests = paragraphs(mix, seed, stream=0)
    sample = Sample(mix['check_requests'], seed_streams(seed, 3))
    readings, extra = {}, {}
    if not traced:
        w = run_window(family, built, mix, requests, seconds, capture, sample)
        readings = {'setup_s': setup_s,
                    'audio_rate': w['audio_s'] / w['window_s'],
                    'request_p95_ms': 1e3 * float(np.quantile(w['latencies'], 0.95))}
        counts = (w['attempted'], w['failed'])
    else:
        a_work, b_work = [], []
        w, a, program = window_a(family, built, mix, requests, min(seconds, TRACE_A_SECONDS),
                                 capture, sample, a_work, program_trace=True)
        wb, b = trace.stack_window(lambda: run_window(
            family, built, mix, requests, TRACE_B_SECONDS, capture, sample, b_work))
        extra = {'ctx': {'cell': cell, 'a': a, 'b': b, 'a_work': a_work, 'b_work': b_work,
                         'spans': program['spans'], 'counters': program['counters']}}
        counts = (w['attempted'] + wb['attempted'], w['failed'] + wb['failed'])
    info = device_info(cell['chips'])
    capture.close()
    records = sampled_records(family, sample)
    weights = built['weights']
    del built, capture, sample, requests
    free_program()
    return readings, counts, info, records, weights, extra


def judge_cell(cell: dict, records, weights) -> tuple:
    cfg = cell['config_data']
    numbers = family_of(cfg).judge(records, cfg, weights)
    print(f'check detail: {numbers}', file=sys.stderr)
    return check_serve.checks(numbers, cfg['limits'])


def control_readings(cell, seed, seconds, program_only=False) -> dict:
    """``control.py``'s readings of a serving cell on one seed: the
    program's compared numbers and the audio rate of a short window, and
    (unless ``program_only``) the numbers of the family's control over the
    sentences the program's check sampled."""
    cfg = cell['config_data']
    family = family_of(cfg)
    readings, _, _, records, weights, _ = run_cell(cell, seed, seconds, False, time.time())
    program = family.judge(records, cfg, weights)
    program['audio_rate'] = readings['audio_rate']
    if program_only:
        return {'program': program}
    low = family.control_records([r['sentence'] for r in records], cfg, weights)
    return {'program': program, 'control': family.judge(low, cfg, weights)}
