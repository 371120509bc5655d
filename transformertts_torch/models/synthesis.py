"""Batched text→wav synthesis (serving path), the counterpart of
``transformertts_tpu/models/synthesis.py::synthesize_lines``.

Sentences are tokenized on the host, sorted by length and cut into chunks
of at most ``max_batch``. Each chunk is padded to bucketed shapes (tokens to
a multiple of 32, batch to a power of two, frames to a multiple of 128) and
runs on the model's device: the encoder, then the durations come to the host
to size the frame budget, then one decode → waveform pass: mel inversion and
Griffin-Lim, or a neural vocoder (``vocoder=``, ``models/melgan.py`` or
``models/hifigan.py``) fed mels whose padding frames sit at its silence
level. Each wav is trimmed on the host to its own predicted length, at
least one frame, as ``predict`` keeps: an untrained model's durations can
all round to zero.

``warmup_serving`` runs every (batch, token, frame) bucket once before the
first request, through the same encode and decode → waveform pass, so no
request pays a shape's first-call costs (the kernels' load, cuBLAS/cuDNN
handles and plans, the caching allocator's growth, the DFT bases).

``mesh=`` (``parallel.make_mesh``'s devices) spreads each chunk over a copy
of the model (and vocoder) on each device, as the JAX package shards a
chunk's batch over its mesh's ``data`` axis: batch buckets start at the
number of devices, each device takes a contiguous share of the chunk's
rows, and every share decodes at the chunk's one frame bucket, so the wavs
are those of one device. The caller's model is not moved. A mesh with a
``model`` axis spreads rows over its ``data`` axis only, with the
parameters replicated, as the JAX package's ``_prepare_mesh`` does
(``make_mesh`` returns each data row's first device).

With ``utils.tracing`` enabled, a call records the spans ``request`` (the
root), ``frontend``, then per chunk ``chunk`` holding ``encode`` and
``frame_budget`` (per replica), ``decode`` and ``waveform`` (per replica),
``to_host`` and ``trim``, and the counters ``requests``, ``sentences``,
``chunks``, ``rows_real`` / ``row_slots``, ``tokens_real`` /
``token_slots``, ``frames_real`` / ``frame_slots`` (the frames kept against
batch bucket × frame bucket) and ``audio_samples``, all from host numbers
the path already has. ``warmup_serving`` records the same chunk phases.
"""
from typing import List, Sequence

import numpy as np
import torch

from transformertts_torch.models.forward_tts import FRAME_BUCKET, TOKEN_BUCKET
from transformertts_torch.parallel.mesh import replicate
from transformertts_torch.utils import tracing


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _batch_bucket(b: int, max_batch: int, min_batch: int = 1) -> int:
    """Round a chunk size up to a power-of-two multiple of ``min_batch``
    (the number of devices, so every bucket divides over them), at most
    ``max_batch``."""
    if b >= max_batch:
        return max_batch
    p = max(1, min_batch)
    while p < b:
        p *= 2
    return min(p, max_batch)


def _replicas(model, vocoder, mesh) -> list:
    """(model, vocoder) on each device of ``mesh``: the caller's own where
    they already lie, copies elsewhere; just the caller's without a mesh."""
    if mesh is None:
        return [(model, vocoder)]
    models = replicate(model, mesh)
    vocoders = replicate(vocoder, mesh) if vocoder is not None else [None] * len(mesh)
    return list(zip(models, vocoders))


def encode_chunk(model, tok: np.ndarray, n_rows: int, scalar: float = 1.0, replica: int = 0):
    """A chunk's padded tokens (its first ``n_rows`` rows real) through the
    encoder on ``model.device``: (encoder outputs, scaled durations, each
    row's frame total, the chunk's frame bucket). Row r's wav keeps
    ``max(1, totals[r] - 1)`` frames."""
    with tracing.span('encode', replica=replica):
        enc = model.encode(torch.as_tensor(tok, device=model.device))
        use = model.scaled_durations(enc, scalar)
    with tracing.span('frame_budget', replica=replica):
        totals = np.round(use.cpu().numpy()).sum(axis=1).astype(int) + 1
        frames = _round_up(int(totals[:n_rows].max(initial=1)), FRAME_BUCKET)
    return enc, use, totals, frames


def decode_to_wav(model, audio, enc: dict, use: torch.Tensor, frames: int,
                  n_iter: int, vocoder=None):
    """One decode → waveform pass over an encoded chunk at ``frames``:
    Griffin-Lim's ``n_iter`` iterations on the mel with its padding at the
    normalizer's silence, or ``vocoder``. Returns the peak-normalized
    (B, samples) wavs on the model's device and their hop."""
    if vocoder is not None:
        with tracing.span('decode'):
            mel = model.vocoder_mel(enc['features'], enc['pitch'], use, frames)
        with tracing.span('waveform'):
            return model.peak_normalize(vocoder(mel)), vocoder.hop_length
    with tracing.span('decode'):
        dec = model.decode_features(enc['features'], enc['pitch'], use, frames)
        mel = model.mask_mel_to_silence(dec, audio.silence_level())
    with tracing.span('waveform'):
        return model.peak_normalize(audio.mels_to_waveforms(mel, n_iter)), audio.hop_length


def _run_chunk(replicas, audio, tok: np.ndarray, n_rows: int, scalar: float, n_iter: int):
    """A chunk's padded tokens (its first ``n_rows`` rows real) split into
    contiguous shares, one a replica: each share encoded, then decoded at
    the chunk's one frame bucket, the largest any real row needs. Returns
    (wavs (B, samples) on the host, each row's frame total, the hop, the
    frame bucket)."""
    shares = np.split(tok, len(replicas))
    per = len(tok) // len(replicas)
    encoded = [encode_chunk(model, share, min(max(n_rows - i * per, 0), per), scalar, i)
               for i, ((model, _), share) in enumerate(zip(replicas, shares))]
    frames = max(e[3] for e in encoded)
    decoded = [decode_to_wav(model, audio, enc, use, frames, n_iter, vocoder)
               for (model, vocoder), (enc, use, _, _) in zip(replicas, encoded)]
    with tracing.span('to_host'):
        wav = np.concatenate([w.cpu().numpy() for w, _ in decoded])
    return wav, np.concatenate([e[2] for e in encoded]), decoded[0][1], frames


@torch.inference_mode()
def synthesize_lines(model, audio, lines: Sequence[str],
                     speed_regulator: float = 1.0, n_iter: int = None,
                     max_batch: int = 32, vocoder=None, mesh=None) -> List[np.ndarray]:
    """Synthesize many sentences on ``model.device``; returns float32 wavs
    (peak-normalized to [-1, 1]) in input order, each at least one hop
    (``audio.hop_length``, or ``vocoder.hop_length`` with a vocoder) long. A
    line that tokenizes to nothing gives an empty wav, as in the JAX
    package. ``vocoder``: a neural vocoder on the model's device, in place
    of Griffin-Lim; the model must be MelGAN-normalized. ``mesh``: the
    devices (``parallel.make_mesh``) each chunk is spread over;
    ``max_batch`` is then rounded up to a multiple of their number."""
    with tracing.span('request', sentences=len(lines)):
        wavs = _synthesize(model, audio, lines, speed_regulator, n_iter, max_batch, vocoder,
                           mesh)
    if tracing.enabled():
        tracing.count('requests')
        tracing.count('sentences', len(lines))
        tracing.count('audio_samples', sum(len(w) for w in wavs))
    return wavs


def _synthesize(model, audio, lines, speed_regulator, n_iter, max_batch, vocoder, mesh):
    n_iter = n_iter if n_iter is not None else audio.griffin_lim_iters
    replicas = _replicas(model, vocoder, mesh)
    n_data = len(replicas)
    max_batch = _round_up(max_batch, n_data)
    scalar = float(np.float32(1.0 / speed_regulator))
    wavs: List[np.ndarray] = [None] * len(lines)
    entries = []   # (input index, tokens)
    with tracing.span('frontend'):
        for i, line in enumerate(lines):
            tokens = np.asarray(model.encode_text(line), np.int64)
            if tokens.size == 0:
                wavs[i] = np.zeros((0,), np.float32)
            else:
                entries.append((i, tokens))
    entries.sort(key=lambda e: len(e[1]))

    for s in range(0, len(entries), max_batch):
        chunk = entries[s:s + max_batch]
        n_tok = _round_up(max(len(t) for _, t in chunk), TOKEN_BUCKET)
        batch = _batch_bucket(len(chunk), max_batch, n_data)
        with tracing.span('chunk', rows=len(chunk), batch=batch, tokens=n_tok) as sp:
            tok = np.zeros((batch, n_tok), np.int64)
            for row, (_, t) in enumerate(chunk):
                tok[row, :len(t)] = t
            wav, totals, hop, frames = _run_chunk(replicas, audio, tok, len(chunk), scalar,
                                                  n_iter)
            sp.set(frames=frames)
            kept = 0
            with tracing.span('trim'):
                for row, (orig_idx, _) in enumerate(chunk):
                    frames_kept = max(1, int(totals[row]) - 1)
                    wavs[orig_idx] = wav[row, :frames_kept * hop]
                    kept += frames_kept
        if tracing.enabled():
            tracing.count('chunks')
            tracing.count('rows_real', len(chunk))
            tracing.count('row_slots', batch)
            tracing.count('tokens_real', sum(len(t) for _, t in chunk))
            tracing.count('token_slots', batch * n_tok)
            tracing.count('frames_real', kept)
            tracing.count('frame_slots', batch * frames)
    return wavs


@torch.inference_mode()
def warmup_serving(model, audio, max_batch: int = 32,
                   token_buckets: Sequence[int] = (32, 64, 96, 128),
                   frame_buckets: Sequence[int] = (128, 256, 384),
                   n_iter: int = None, vocoder=None,
                   include_ragged_batches: bool = True, mesh=None) -> int:
    """Run the serving menu once so that no request pays a shape's first
    call: for each batch bucket (``max_batch``, and with
    ``include_ragged_batches`` the powers of two below it, which the last
    chunk of a request takes) and each token bucket, one ``encode_chunk`` on
    all-ones tokens, then for each frame bucket the decode → waveform pass
    ``synthesize_lines`` runs (Griffin-Lim, or ``vocoder``). With ``mesh``,
    the buckets ``synthesize_lines(mesh=)`` takes, each on every device's
    share. Waits for the devices and returns the number of (batch, token,
    frame) combinations warmed."""
    n_iter = n_iter if n_iter is not None else audio.griffin_lim_iters
    replicas = _replicas(model, vocoder, mesh)
    n_data = len(replicas)
    max_batch = _round_up(max_batch, n_data)
    batches = [max_batch]
    if include_ragged_batches:
        p = n_data
        while p < max_batch:
            batches.append(p)
            p *= 2
    count = 0
    for b in batches:
        for n_tok in token_buckets:
            share = np.ones((b // n_data, n_tok), np.int64)
            encoded = [encode_chunk(m, share, len(share), replica=i)
                       for i, (m, _) in enumerate(replicas)]
            for frames in frame_buckets:
                for (m, voc), (enc, use, _, _) in zip(replicas, encoded):
                    decode_to_wav(m, audio, enc, use, frames, n_iter, voc)
                count += 1
    for m, _ in replicas:
        if m.device.type == 'cuda':
            torch.cuda.synchronize(m.device)
    return count
