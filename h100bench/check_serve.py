"""The comparison that decides ``correct`` in a serving cell.

Each checked sentence is a record of what the timed path produced for it:
the token ids the model was fed, each token's duration in frames as the
model rounded it, the mel the waveform stage was fed (the chunk's frame
budget, padding frames at silence) and the wave it returned. The reference
(``reference/``, plain PyTorch in float32, TF32 off) judges each record:

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

from h100bench.reference import forward_tts, frontend, waveform
from h100bench.reference.numerics import Precision, exact_float32

LOG_MEL_SILENCE = float(np.log(1e-5))   # a silent bin of a MelGAN-normalized mel


def rel_gap(mine: torch.Tensor, want: torch.Tensor) -> float:
    return float((mine.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def reference_wave(mel: torch.Tensor, cfg: dict, vocoder_weights, prec: Precision = None):
    """The reference waveform stage on a (frames, mels) mel: Griffin-Lim, or
    the configuration's HiFi-GAN generator."""
    if cfg.get('vocoder'):
        return waveform.hifigan_wave(mel, vocoder_weights, cfg['vocoder'], prec)
    return waveform.griffin_lim_wave(mel, cfg['audio'], prec)


def hop_of(cfg: dict) -> int:
    if cfg.get('vocoder'):
        return int(np.prod(cfg['vocoder']['upsample_rates']))
    return cfg['audio']['hop_length']


def judge(records, cfg: dict, weights: dict, vocoder_weights, device) -> dict:
    """The compared numbers over ``records`` (see the module docstring)."""
    lexicon = frontend.read_lexicon()
    ref = forward_tts.ReferenceForward(weights, cfg['model'])
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


def control_records(sentences, cfg: dict, weights: dict, vocoder_weights, device,
                    token_bucket: int = 32, frame_bucket: int = 128):
    """Records as the reference would serve them one precision below the
    configuration: the model and the waveform stage with the operands of
    the configuration's ``control`` (float8 for the bfloat16 model, TF32 for
    Griffin-Lim's float32 with TF32 off, bfloat16 for a vocoder's float32
    that allows TF32). The same frontend, frame budget and trimming."""
    lexicon = frontend.read_lexicon()
    low = forward_tts.ReferenceForward(weights, cfg['model'], Precision(cfg['control']['model']))
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


def checks(numbers: dict, limits: dict) -> tuple:
    """({name: (value, limit)} of the numbers ``limits`` names, and whether
    all hold over at least one checked sentence."""
    out = {name: (numbers[name], limit) for name, limit in limits.items()}
    ok = numbers['checked_sentences'] >= 1 and all(numbers[k] <= v for k, v in limits.items())
    return out, ok
