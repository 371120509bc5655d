"""A serving cell: one closed-loop caller sends paragraphs to
``transformertts_torch.models.synthesis.synthesize_lines``.

Set-up builds the configuration's ForwardTransformer (and vocoder) on the
card with weights drawn from the seed (those that set each token's frames,
the configuration's ``fixed_stream_weights``, from one stream for every
seed, so that a seed changes what is said and in what order, not how much
work a window holds), then runs a few requests of a
separate warm-up stream, among them one of the mix's largest size. The
window sends the measured stream's requests back to back until
``--seconds`` have passed and the last one has returned; a request's
latency runs from its call to its waves on the host. Forward hooks on three
of the model's modules (its token embedding, its duration head and its mel
projection) record what each chunk was fed and produced, without a device
sync; the records of a seed-drawn sample of the finished requests, and of
the longest, are kept for the check (``check_serve``), which runs after the
window, once the program's state is freed. The program runs with the
settings it makes itself: the harness sets no precision.
"""
import gc
import sys
import time
import traceback

import numpy as np
import torch

from h100bench import check_serve
from h100bench.common import keras_limits, seed_streams, uniform_weights
from h100bench.reference.numerics import exact_float32
from h100bench.traffic import paragraphs

MEL_SILENCE = check_serve.LOG_MEL_SILENCE


def build(cfg: dict, mix: dict, seed: int, device='cuda'):
    """(model, vocoder or None, audio, weights, vocoder weights) with weights
    from ``seed``."""
    from transformertts_torch.audio import Audio
    from transformertts_torch.models.forward_tts import ForwardTransformer
    model = ForwardTransformer(**cfg['model']).to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    limits, constants = keras_limits(shapes, embeddings=('encoder_prenet.weight',))
    weights = uniform_weights(shapes, limits, constants, seed, device,
                              shared=cfg.get('fixed_stream_weights', ()))
    calibrate_durations(weights, cfg, mix)
    model.load_state_dict(weights)
    model.eval()
    vocoder, vweights = None, None
    if cfg.get('vocoder'):
        from transformertts_torch.models.hifigan import HiFiGANVocoder
        vcfg = {k: v for k, v in cfg['vocoder'].items() if k not in ('family', 'gain')}
        vocoder = HiFiGANVocoder(cfg['model']['mel_channels'], vcfg).to(device)
        shapes = {k: tuple(v.shape) for k, v in vocoder.state_dict().items()}
        gain = cfg['vocoder']['gain']
        # a ConvTranspose1d weight is (in, out, k), a Conv1d one (out, in, k)
        vlimits = {k: gain / np.sqrt((s[0] if k.startswith('ups.') else s[1]) * s[2])
                   for k, s in shapes.items() if k.endswith('.weight')}
        vconst = {k: 0.0 for k in shapes if k.endswith('.bias')}
        vweights = uniform_weights(shapes, vlimits, vconst, seed + 1, device)
        vocoder.load_state_dict(vweights)
        vocoder.eval()
    return model, vocoder, Audio.from_config(cfg['audio']), weights, vweights


CALIBRATION_SENTENCES = 48


def calibrate_durations(weights: dict, cfg: dict, mix: dict):
    """Rescale the duration head (its weight, then its bias) so that the
    reference's durations over a fixed sample of the traffic's sentences
    (the same for every seed) have the configuration's mean and standard
    deviation: a trained model's frames a phoneme. Random weights alone give
    an arbitrary speaking rate and spread of lengths."""
    from h100bench.reference import forward_tts, frontend
    lexicon = frontend.read_lexicon()
    stream = paragraphs(mix, 0, stream=9)
    sentences = []
    while len(sentences) < CALIBRATION_SENTENCES:
        sentences.extend(next(stream))
    ref = forward_tts.ReferenceForward(weights, cfg['model'])
    filters = cfg['model']['duration_conv_filters']

    def pre_activations():
        out = []
        for sentence in sentences[:CALIBRATION_SENTENCES]:
            tokens = frontend.tokens(sentence, lexicon)
            x = ref.encode(tokens, len(tokens))['features']
            out.append(ref.predictor('dur_pred', x, filters, None,
                                     torch.ones(len(tokens), 1, device=x.device)))
        return torch.cat(out)

    with torch.no_grad(), exact_float32():
        weights['dur_pred.linear.weight'] *= (cfg['assumed']['duration_sd']
                                              / float(pre_activations().std()))
        weights['dur_pred.linear.bias'] += (cfg['assumed']['mean_duration']
                                            - float(pre_activations().mean()))


class Capture:
    """Forward hooks that record, for every chunk of the current request,
    the tokens fed to the embedding, the duration head's output and the mel
    projection's output, as device tensors (no sync)."""

    def __init__(self, model):
        self.chunks = []
        self.handles = [
            model.encoder_prenet.register_forward_hook(
                lambda m, args, out: self.chunks.append({'tokens': args[0]})),
            model.dur_pred.register_forward_hook(
                lambda m, args, out: self.chunks[-1].__setitem__('dur', out)),
            model.out.register_forward_hook(
                lambda m, args, out: self.chunks[-1].__setitem__('out', out)),
        ]

    def take(self) -> list:
        chunks, self.chunks = self.chunks, []
        return chunks

    def close(self):
        for h in self.handles:
            h.remove()


class StageClock:
    """CUDA events at the waveform stage's entry and return in every chunk
    (Griffin-Lim's ``audio.mels_to_waveforms``, or the vocoder's forward),
    recorded without a sync. A pair spans the stage on the card: from the
    decoder's end, or the host's arrival if that is later, to the stage's
    last kernel's end. Installed for the traced window A alone."""

    def __init__(self, audio, vocoder):
        self.events = []
        if vocoder is not None:
            self.handles = [vocoder.register_forward_pre_hook(lambda m, a: self._mark()),
                            vocoder.register_forward_hook(lambda m, a, o: self._mark())]
            self.undo = lambda: [h.remove() for h in self.handles]
        else:
            real = audio.mels_to_waveforms

            def timed(*args, **kwargs):
                self._mark()
                out = real(*args, **kwargs)
                self._mark()
                return out

            audio.mels_to_waveforms = timed
            self.undo = lambda: delattr(audio, 'mels_to_waveforms')

    def _mark(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)

    def close(self) -> float:
        """Removes the clock; the seconds of every recorded stage."""
        self.undo()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in zip(self.events[0::2], self.events[1::2])) / 1e3


def chunk_rows(chunks) -> list:
    """The real rows of a request's chunks on the host: each row's tokens,
    durations as the model rounded them, and the mel its waveform stage was
    fed (the chunk's frame budget, padding frames at silence)."""
    rows = []
    for c in chunks:
        tok = c['tokens'].cpu().numpy()
        dur = np.round(c['dur'][:, :, 0].float().cpu().numpy()).astype(np.int64)
        out = c['out'].float().cpu().numpy()
        for r in range(tok.shape[0]):
            n_tok = int((tok[r] != 0).sum())
            if n_tok == 0:
                continue
            n = np.maximum(dur[r, :n_tok], 0)
            total = int(n.sum())
            mel = np.full(out.shape[1:], MEL_SILENCE, np.float32)
            mel[:total] = out[r, :total]
            rows.append({'tokens': tok[r, :n_tok].tolist(), 'n_pad': tok.shape[1],
                         'durations': n, 'mel': mel})
    return rows


def match(sentences, wavs, rows, lexicon) -> list:
    """Pair each sentence with the row whose tokens equal the reference
    frontend's; a sentence with none takes the first unused row, or an
    empty one, so a wrong token shows as a mismatch, never as a skip."""
    from h100bench.reference import frontend
    records, used = [], set()
    for sentence, wav in zip(sentences, wavs):
        want = frontend.tokens(sentence, lexicon)
        pick = next((i for i, r in enumerate(rows) if i not in used and r['tokens'] == want),
                    None)
        if pick is None:
            pick = next((i for i in range(len(rows)) if i not in used), None)
        if pick is None:
            rec = {'tokens': [], 'n_pad': 0, 'durations': np.zeros(0, np.int64), 'mel': None}
        else:
            used.add(pick)
            rec = dict(rows[pick])
        rec.update(sentence=sentence, wav=np.asarray(wav))
        records.append(rec)
    return records


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


def run_window(model, vocoder, audio, mix, requests, seconds, capture, sample,
               log_shapes=None) -> dict:
    """Requests back to back until ``seconds`` have passed. Returns the
    window's readings; keeps the sampled requests' chunks. With
    ``log_shapes`` (a list) each request's chunk shapes and small tensors
    (tokens, durations) are appended to it, for the traced readings."""
    from transformertts_torch.models.synthesis import synthesize_lines
    sr = audio.sampling_rate
    latencies, audio_s, attempted, failed = [], 0.0, 0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        sentences = next(requests)
        attempted += 1
        t0 = time.perf_counter()
        try:
            wavs = synthesize_lines(model, audio, sentences, speed_regulator=mix['speed'],
                                    max_batch=mix['max_batch'], vocoder=vocoder)
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
        if log_shapes is not None:
            log_shapes.append({'audio_s': sum(len(w) for w in wavs) / sr,
                               'chunks': [(c['tokens'], c['dur'], tuple(c['out'].shape))
                                          for c in chunks]})
        sample.offer({'sentences': sentences, 'wavs': wavs, 'chunks': chunks})
    window_s = time.perf_counter() - start
    return {'latencies': latencies, 'audio_s': audio_s, 'attempted': attempted,
            'failed': failed, 'window_s': window_s}


def warm_up(model, vocoder, audio, mix, seed, capture):
    """The first ``warmup_requests`` of warm-up stream 1, then its first
    request of the mix's largest size, each waited for."""
    from transformertts_torch.models.synthesis import synthesize_lines
    stream = paragraphs(mix, seed, stream=1)
    biggest = mix['sentences']['max']
    done_big = False
    for i in range(10 ** 6):
        sentences = next(stream)
        if i >= mix['warmup_requests']:
            if len(sentences) != biggest:
                continue
            done_big = True
        synthesize_lines(model, audio, sentences, speed_regulator=mix['speed'],
                         max_batch=mix['max_batch'], vocoder=vocoder)
        capture.take()
        if done_big:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def free_program():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sampled_records(sample) -> list:
    """The sampled requests' chunks copied to the host and matched to
    their sentences."""
    from h100bench.reference import frontend
    lexicon = frontend.read_lexicon()
    records = []
    for item in sample.items():
        rows = chunk_rows(item['chunks'])
        records.extend(match(item['sentences'], item['wavs'], rows, lexicon))
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
    model, vocoder, audio, weights, vweights = build(cfg, mix, seed, device)
    log_phase(t_start, 'model and weights on the device')
    capture = Capture(model)
    warm_up(model, vocoder, audio, mix, seed, capture)
    log_phase(t_start, 'warm-up requests (kernels built or loaded)')
    setup_s = time.time() - t_start
    requests = paragraphs(mix, seed, stream=0)
    sample = Sample(mix['check_requests'], seed_streams(seed, 3))
    readings, extra = {}, {}
    if not traced:
        w = run_window(model, vocoder, audio, mix, requests, seconds, capture, sample)
        readings = {'setup_s': setup_s,
                    'audio_rate': w['audio_s'] / w['window_s'],
                    'request_p95_ms': 1e3 * float(np.quantile(w['latencies'], 0.95))}
        counts = (w['attempted'], w['failed'])
    else:
        a_work, b_work = [], []
        clock = StageClock(audio, vocoder)
        w, a = trace.device_window(lambda: run_window(
            model, vocoder, audio, mix, requests, min(seconds, TRACE_A_SECONDS), capture,
            sample, a_work))
        a['wave_stage_s'] = clock.close()
        wb, b = trace.stack_window(lambda: run_window(
            model, vocoder, audio, mix, requests, TRACE_B_SECONDS, capture, sample, b_work))
        extra = {'ctx': {'cell': cell, 'a': a, 'b': b, 'a_work': a_work, 'b_work': b_work}}
        counts = (w['attempted'] + wb['attempted'], w['failed'] + wb['failed'])
    info = device_info(cell['chips'])
    capture.close()
    records = sampled_records(sample)
    del model, vocoder, capture, sample, requests
    free_program()
    return readings, counts, info, records, (weights, vweights), extra


def judge_cell(cell: dict, records, weights) -> tuple:
    cfg = cell['config_data']
    numbers = check_serve.judge(records, cfg, weights[0], weights[1],
                                weights[0]['out.weight'].device)
    print(f'check detail: {numbers}', file=sys.stderr)
    return check_serve.checks(numbers, cfg['limits'])
