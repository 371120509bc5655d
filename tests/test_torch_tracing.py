"""The serving path's spans and counters (``transformertts_torch.utils.tracing``)
on the tiny config over config/test_sentences.txt: their tree and order,
the counters against the same numbers worked out from the lines and the
returned wavs, the wavs unchanged by tracing, no clock read while off, and
the spans on ``torch.profiler``'s clock."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_nn import TINY_CONFIG
from transformertts_torch.audio import Audio
from transformertts_torch.models.forward_tts import (FRAME_BUCKET, TOKEN_BUCKET,
                                                     ForwardTransformer)
from transformertts_torch.models.synthesis import (_batch_bucket, synthesize_lines,
                                                   warmup_serving)
from transformertts_torch.utils import tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LINES = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
         if l.strip()]
# two chunks at max_batch 4 (4 rows, then 3 in a bucket of 4) and a line
# with no tokens
REQUEST = LINES + LINES[:3] + ['']
MAX_BATCH = 4
CHUNK_PHASES = ['encode', 'frame_budget', 'decode', 'waveform', 'to_host', 'trim']


@pytest.fixture(scope='module')
def served():
    model = ForwardTransformer(**TINY_CONFIG).init_params(torch.Generator().manual_seed(5))
    return model, Audio.from_config(model.config)


@pytest.fixture
def traced():
    tracing.take()
    tracing.enable()
    yield
    tracing.disable()
    tracing.take()


def _synthesize(served, lines=REQUEST):
    model, audio = served
    return synthesize_lines(model, audio, lines, n_iter=1, max_batch=MAX_BATCH)


def _children(spans, parent):
    return [s for s in spans if s['parent'] == parent]


def test_off_span_is_the_shared_no_op_and_reads_no_clock(served, monkeypatch):
    def no_clock():
        raise AssertionError('the clock was read with tracing off')

    monkeypatch.setattr(tracing, '_clock', no_clock)
    assert not tracing.enabled()
    assert tracing.span('request', sentences=3) is tracing.NO_SPAN
    with tracing.span('chunk') as sp:
        sp.set(frames=128)
    tracing.count('chunks', 5)
    wavs = _synthesize(served)
    assert len(wavs) == len(REQUEST)
    assert tracing.take() == {'spans': [], 'counters': {}}


def test_spans_nest_as_the_serving_path_calls(served, traced):
    _synthesize(served)
    spans = tracing.take()['spans']
    roots = [i for i, s in enumerate(spans) if s['parent'] is None]
    assert len(roots) == 1 and spans[roots[0]]['name'] == 'request'
    root = roots[0]
    assert spans[root]['attrs'] == {'sentences': len(REQUEST)}
    assert len({s['request'] for s in spans}) == 1
    top = _children(spans, root)
    assert [s['name'] for s in top] == ['frontend', 'chunk', 'chunk']
    assert _children(spans, spans.index(top[0])) == []
    for chunk in top[1:]:
        phases = _children(spans, spans.index(chunk))
        assert [s['name'] for s in phases] == CHUNK_PHASES
        assert all(_children(spans, spans.index(p)) == [] for p in phases)
        assert set(chunk['attrs']) == {'rows', 'batch', 'tokens', 'frames'}
        starts = [p['start_ns'] for p in phases]
        assert starts == sorted(starts)
    for s in spans:
        assert s['start_ns'] <= s['end_ns']
        if s['parent'] is not None:
            p = spans[s['parent']]
            assert p['start_ns'] <= s['start_ns'] and s['end_ns'] <= p['end_ns']
    # siblings do not overlap
    for parent in range(len(spans)):
        kids = _children(spans, parent)
        for a, b in zip(kids, kids[1:]):
            assert a['end_ns'] <= b['start_ns']


def test_counters_equal_the_lines_buckets_and_wavs(served, traced):
    model, audio = served
    wavs = _synthesize(served)
    records = tracing.take()
    hop = audio.hop_length
    # the path's order: lines with tokens, shortest first (a stable sort)
    lines = [(model.encode_text(l), w) for l, w in zip(REQUEST, wavs)]
    lines = sorted(((t, w) for t, w in lines if len(t)), key=lambda x: len(x[0]))
    tokens = [t for t, _ in lines]
    kept_sorted = [len(w) // hop for _, w in lines]
    want = {'requests': 1, 'sentences': len(REQUEST), 'chunks': 0, 'rows_real': 0,
            'row_slots': 0, 'tokens_real': 0, 'token_slots': 0, 'frames_real': 0,
            'frame_slots': 0, 'audio_samples': sum(len(w) for w in wavs)}
    chunk_attrs = [s['attrs'] for s in records['spans'] if s['name'] == 'chunk']
    for c, s in enumerate(range(0, len(tokens), MAX_BATCH)):
        rows, frames = tokens[s:s + MAX_BATCH], kept_sorted[s:s + MAX_BATCH]
        batch = _batch_bucket(len(rows), MAX_BATCH)
        n_tok = -(-max(len(t) for t in rows) // TOKEN_BUCKET) * TOKEN_BUCKET
        # a row keeps max(1, total - 1) frames of its total, so its total is
        # at most kept + 1, and exactly that wherever it fills a bucket
        frame_bucket = -(-max(f + 1 for f in frames) // FRAME_BUCKET) * FRAME_BUCKET
        assert chunk_attrs[c] == {'rows': len(rows), 'batch': batch, 'tokens': n_tok,
                                  'frames': frame_bucket}
        want['chunks'] += 1
        want['rows_real'] += len(rows)
        want['row_slots'] += batch
        want['tokens_real'] += sum(len(t) for t in rows)
        want['token_slots'] += batch * n_tok
        want['frames_real'] += sum(frames)
        want['frame_slots'] += batch * frame_bucket
    assert want['chunks'] == 2 and want['rows_real'] == 7 and want['row_slots'] == 8
    # the waveform stage counts the frame slots it is fed, and on the CPU none
    # goes through the kernel
    want.update(gl_frame_slots=want['frame_slots'], gl_kernel_frame_slots=0)
    assert records['counters'] == want


def test_tracing_leaves_the_wavs_bitwise_unchanged(served):
    off = _synthesize(served)
    tracing.enable()
    try:
        on = _synthesize(served)
    finally:
        tracing.disable()
        tracing.take()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_warmup_serving_records_the_chunk_phases(served, traced):
    model, audio = served
    n = warmup_serving(model, audio, max_batch=2, token_buckets=(32,), frame_buckets=(128,),
                       n_iter=1, include_ragged_batches=False)
    records = tracing.take()
    # no request counters; the waveform stage's, for its 2 × 128 frame slots
    assert n == 1 and records['counters'] == {'gl_frame_slots': 256, 'gl_kernel_frame_slots': 0}
    assert [s['name'] for s in records['spans']] == ['encode', 'frame_budget', 'decode',
                                                     'waveform']


def test_a_span_closes_and_its_parent_stays_on_an_exception(traced):
    with tracing.span('outer'):
        with pytest.raises(ValueError):
            with tracing.span('inner'):
                raise ValueError
        with tracing.span('after'):
            pass
    spans = tracing.take()['spans']
    assert [(s['name'], s['parent']) for s in spans] == [('outer', None), ('inner', 0),
                                                         ('after', 0)]
    assert all(s['end_ns'] is not None for s in spans)
    with tracing.span('next'):
        pass
    again = tracing.take()['spans']
    assert again[0]['parent'] is None and again[0]['request'] != spans[0]['request']


def test_a_span_holds_a_profiler_range_opened_inside_it(traced, tmp_path):
    """The spans' clock is the profiler trace's: ts (µs) · 1e3 + the trace's
    ``baseTimeNanoseconds`` is epoch ns."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tracing.span('outer', i=i):
                with torch.profiler.record_function(f'range_{i}'):
                    torch.ones(64).sum()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace['baseTimeNanoseconds']
    ranges = {e['name']: e for e in trace['traceEvents'] if e.get('name', '').startswith('range_')
              and e.get('ph') == 'X'}
    spans = tracing.take()['spans']
    assert len(spans) == len(ranges) == 5
    for s in spans:
        e = ranges[f"range_{s['attrs']['i']}"]
        start = round(e['ts'] * 1e3) + base
        end = round((e['ts'] + e['dur']) * 1e3) + base
        assert s['start_ns'] <= start and end <= s['end_ns'], (s, start, end)
