"""The ForwardTransformer family (``model_family: forward_tts``): the
configuration's ForwardTransformer served by
``transformertts_torch.models.synthesis.synthesize_lines``, through
Griffin-Lim or the configuration's HiFi-GAN generator.

Set-up builds the model (and vocoder) on the card with weights drawn from
the seed (those that set each token's frames, the configuration's
``fixed_stream_weights``, from one stream for every seed, so that a seed
changes what is said and in what order, not how much work a window holds).
Forward hooks on three of the model's modules (its token embedding, its
duration head and its mel projection) record what each chunk was fed and
produced.

The check judges each sampled sentence's record: the token ids the model
was fed, each token's duration in frames as the model rounded it, the mel
the waveform stage was fed (the chunk's frame budget, padding frames at
silence) and the wave it returned. The reference (``reference/``, plain
PyTorch in float32, TF32 off) gives:

- ``mismatched_sentences``: records whose tokens differ from the reference
  frontend's, or whose wave is not the length its durations give
  (max(1, Σ durations) hops). Exact: limit 0.
- ``duration_gap_frames``: the widest distance by which the reference's
  duration of a token lies outside the rounding interval [n − ½, n + ½] of
  the duration n the model used (a near-tie rounds either way).
- ``mel_gap``: the widest relative L2 gap, over a sentence's frames, between
  the model's mel and the reference's decoded from the same token
  durations.
- ``wave_gap``: the widest relative L2 gap between a returned wave and the
  reference waveform stage run on the mel the program's stage was fed (the
  wave is judged from the program's own mel; the mel itself is judged
  above); ``wave_gap_median``: the median of those gaps over the sentences;
  ``wave_gap_outliers``: the sentences whose gap exceeds the
  configuration's ``sentence_wave_gap``, above what rounding gives one
  sentence and below what a wrong wave gives (about 1 or more). Griffin-Lim's
  32 momentum iterations amplify float32 rounding until the widest of a
  hundred sentences nears the gap that TF32 operands give, so a Griffin-Lim
  cell compares the median, steady from seed to seed, and the outliers, which
  see a fault in a few rows; a vocoder cell compares the widest.

The reference runs with TF32 off in cuBLAS and cuDNN (``exact_float32``);
the program runs as it sets itself. A configuration's ``limits`` name the
numbers its cell compares; its ``control`` names the precision of each stage
one step below the configuration's (``control_records``).
"""
import numpy as np
import torch

from h100bench import roofline
from h100bench.check_serve import hop_of, reference_wave, rel_gap
from h100bench.common import keras_limits, uniform_weights
from h100bench.reference import frontend
from h100bench.reference.forward_tts import ReferenceForward
from h100bench.reference.numerics import Precision, exact_float32
from h100bench.traffic import paragraphs

LOG_MEL_SILENCE = float(np.log(1e-5))   # a silent bin of a MelGAN-normalized mel


def build(cfg: dict, mix: dict, seed: int, device='cuda') -> dict:
    """The model, vocoder (or None) and audio on ``device``, with weights
    from ``seed``; ``weights`` is (model weights, vocoder weights or None)."""
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
    audio = Audio.from_config(cfg['audio'])
    return {'model': model, 'vocoder': vocoder, 'audio': audio, 'weights': (weights, vweights),
            'sampling_rate': audio.sampling_rate}


CALIBRATION_SENTENCES = 48


def calibrate_durations(weights: dict, cfg: dict, mix: dict):
    """Rescale the duration head (its weight, then its bias) so that the
    reference's durations over a fixed sample of the traffic's sentences
    (the same for every seed) have the configuration's mean and standard
    deviation: a trained model's frames a phoneme. Random weights alone give
    an arbitrary speaking rate and spread of lengths."""
    lexicon = frontend.read_lexicon()
    stream = paragraphs(mix, 0, stream=9)
    sentences = []
    while len(sentences) < CALIBRATION_SENTENCES:
        sentences.extend(next(stream))
    ref = ReferenceForward(weights, cfg['model'])
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


def serve(built: dict, sentences, mix: dict):
    """One request: ``synthesize_lines`` over the paragraph's sentences."""
    from transformertts_torch.models import synthesis
    return synthesis.synthesize_lines(built['model'], built['audio'], sentences,
                                      speed_regulator=mix['speed'], max_batch=mix['max_batch'],
                                      vocoder=built['vocoder'])


def stage(built: dict) -> tuple:
    """The waveform stage: the vocoder's forward, or Griffin-Lim's
    ``audio.mels_to_waveforms``."""
    if built['vocoder'] is not None:
        return built['vocoder'], 'forward'
    return built['audio'], 'mels_to_waveforms'


class Capture:
    """Forward hooks that record, for every chunk of the current request,
    the tokens fed to the embedding, the duration head's output and the mel
    projection's output, as device tensors (no sync)."""

    def __init__(self, built: dict):
        model = built['model']
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


def chunk_work(chunk: dict) -> tuple:
    """(tokens, durations, mel shape) of a captured chunk, for the readers."""
    return chunk['tokens'], chunk['dur'], tuple(chunk['out'].shape)


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
            mel = np.full(out.shape[1:], LOG_MEL_SILENCE, np.float32)
            mel[:total] = out[r, :total]
            rows.append({'tokens': tok[r, :n_tok].tolist(), 'n_pad': tok.shape[1],
                         'durations': n, 'mel': mel})
    return rows


def match(sentences, wavs, rows, lexicon) -> list:
    """Pair each sentence with the row whose tokens equal the reference
    frontend's; a sentence with none takes the first unused row, or an
    empty one, so a wrong token shows as a mismatch, never as a skip."""
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


def records(sentences, wavs, chunks) -> list:
    """A finished request's chunks copied to the host and matched to its
    sentences."""
    return match(sentences, wavs, chunk_rows(chunks), frontend.read_lexicon())


def judge(records, cfg: dict, weights) -> dict:
    """The compared numbers over ``records`` (see the module docstring)."""
    weights, vocoder_weights = weights
    device = weights['out.weight'].device
    lexicon = frontend.read_lexicon()
    ref = ReferenceForward(weights, cfg['model'])
    hop = hop_of(cfg)
    out = {'checked_sentences': 0, 'mismatched_sentences': 0, 'duration_gap_frames': 0.0,
           'mel_gap': 0.0, 'wave_gap': 0.0, 'wave_gap_median': 0.0, 'wave_gap_outliers': 0}
    waves = []
    with torch.no_grad(), exact_float32():
        for rec in records:
            out['checked_sentences'] += 1
            want = frontend.tokens(rec['sentence'], lexicon)
            n = np.asarray(rec['durations'], np.int64)
            if list(rec['tokens']) != want or len(rec['wav']) != max(1, int(n.sum())) * hop:
                out['mismatched_sentences'] += 1
                continue
            enc = ref.encode(want, rec['n_pad'])
            d = enc['durations'].double().cpu().numpy()
            out['duration_gap_frames'] = max(out['duration_gap_frames'],
                                             float(np.max(np.abs(d - n)) - 0.5))
            total = int(n.sum())
            served_mel = torch.as_tensor(rec['mel'], device=device)
            if total > 0:
                mel = ref.decode(enc['features'], enc['pitch'], n, served_mel.shape[0])
                out['mel_gap'] = max(out['mel_gap'], rel_gap(served_mel[:total], mel))
            wave = reference_wave(served_mel, cfg, vocoder_weights)[:len(rec['wav'])]
            waves.append(rel_gap(torch.as_tensor(rec['wav'], device=device), wave))
    out['duration_gap_frames'] = max(out['duration_gap_frames'], 0.0)
    if waves:
        out.update(wave_gap=max(waves), wave_gap_median=float(np.median(waves)),
                   wave_gap_outliers=sum(g > cfg.get('sentence_wave_gap', np.inf)
                                         for g in waves))
    return out


def control_records(sentences, cfg: dict, weights, token_bucket: int = 32,
                    frame_bucket: int = 128):
    """Records as the reference would serve them one precision below the
    configuration: the model and the waveform stage with the operands of
    the configuration's ``control`` (float8 for the bfloat16 model, TF32 for
    Griffin-Lim's float32 with TF32 off, bfloat16 for a vocoder's float32
    that allows TF32). The same frontend, frame budget and trimming."""
    weights, vocoder_weights = weights
    device = weights['out.weight'].device
    lexicon = frontend.read_lexicon()
    low = ReferenceForward(weights, cfg['model'], Precision(cfg['control']['model']))
    wave_prec = Precision(cfg['control']['waveform'])
    hop = hop_of(cfg)
    records = []
    with torch.no_grad(), exact_float32():
        for sentence in sentences:
            toks = frontend.tokens(sentence, lexicon)
            n_pad = max(token_bucket, -(-len(toks) // token_bucket) * token_bucket)
            enc = low.encode(toks, n_pad)
            n = torch.round(enc['durations']).long().clamp_min(0).cpu().numpy()
            total = int(n.sum())
            frames = max(frame_bucket, -(-(total + 1) // frame_bucket) * frame_bucket)
            mel = torch.full((frames, cfg['model']['mel_channels']), LOG_MEL_SILENCE,
                             device=device)
            if total > 0:
                mel[:total] = low.decode(enc['features'], enc['pitch'], n, frames)
            wav = reference_wave(mel, cfg, vocoder_weights, wave_prec)
            records.append({'sentence': sentence, 'tokens': toks, 'n_pad': n_pad,
                            'durations': n,
                            'mel': mel.cpu().numpy(),
                            'wav': wav[:max(1, total) * hop].cpu().numpy()})
    return records


def row_lengths(tokens, dur):
    """Each row's real tokens and the frames its rounded durations give."""
    n_tok = (tokens != 0).sum(dim=1).cpu().numpy().astype(np.int64)
    frames = np.maximum(np.round(dur[:, :, 0].float().cpu().numpy()), 0).sum(axis=1)
    return n_tok, frames.astype(np.int64)


def work_rows(work) -> list:
    """Each real row of the serving chunks of a window: (tokens, frames)."""
    rows = []
    for request in work:
        for tokens, dur, _ in request['chunks']:
            rows.extend((int(n), int(t)) for n, t in zip(*row_lengths(tokens, dur)) if n > 0)
    return rows


def flop_seconds(ctx) -> float:
    """The least device seconds of the serving window's work: the model at
    the bfloat16 peak, the waveform stage at the float32 one."""
    cfg = ctx['cell']['config_data']
    m = cfg['model']
    total = 0.0
    for n, t in work_rows(ctx['a_work']):
        total += roofline.forward_tts_flops(m, n, t) / roofline.PEAK_FLOPS['bf16']
        wave = (roofline.hifigan_flops(cfg['vocoder'], t, m['mel_channels'])
                if cfg.get('vocoder') else
                roofline.griffin_lim_flops(cfg['audio'], t, m['mel_channels']))
        total += wave / roofline.PEAK_FLOPS['f32']
    return total


def attention_bound_s(ctx) -> float:
    """Σ K1 bound over the serving window's launches: per chunk one launch
    a block of each stack, over the chunk's padded tensors, with the real
    (query, key) pairs of each row."""
    m = ctx['cell']['config_data']['model']
    total = 0.0
    for request in ctx['a_work']:
        for tokens, dur, out_shape in request['chunks']:
            b, n_bucket = tokens.shape
            n_tok, frames = row_lengths(tokens, dur)
            for heads, tq, kept_rows, dim in (
                    (m['encoder_num_heads'], n_bucket, n_tok, m['encoder_model_dimension']),
                    (m['decoder_num_heads'], out_shape[1], frames, m['decoder_model_dimension'])):
                for h in heads:
                    kept = int(h * (kept_rows ** 2).sum())
                    total += roofline.attention_bound_s('K1', b, h, tq, tq, dim // h, kept, 2,
                                                        'bf16')
    return total
