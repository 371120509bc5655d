"""The general traffic generators. A traffic mix (``traffic/<mix>.json``) is
parameters only; its ``kind`` picks the generator here.

Every seed gets the same sizes in another order, so the seed changes what
is said and the order, not how much work a window holds:

- ``paragraphs``: requests of ``sentences.min``–``sentences.max`` sentences,
  each size once in every block of requests (a shuffled block of all the
  sizes); sentence lengths in words cycle through the mix's deck
  (``words.deck``, the word counts of real sentences), each once in every
  pass, in an order drawn from the seed; words drawn uniformly from the
  lexicon, a comma after a word with probability ``comma_share``.
- ``aligner_batches``: training batches; see ``aligner_batches``.
"""
from typing import Iterator, List

import numpy as np

from h100bench.common import BENCH_DIR, seed_streams
from h100bench.reference.frontend import read_lexicon


def word_count_deck(words: dict) -> np.ndarray:
    """The fixed multiset of sentence lengths in words, the same for every
    seed."""
    return np.asarray(words['deck'], dtype=int)


def paragraphs(mix: dict, seed: int, stream: int = 0) -> Iterator[List[str]]:
    """Endless requests (lists of sentences) of ``mix`` for ``seed``;
    ``stream`` 0 is the measured traffic, others are warm-up streams."""
    rng = seed_streams(seed, stream)
    lexicon = sorted(read_lexicon(BENCH_DIR / mix['lexicon']))
    deck = word_count_deck(mix['words'])
    sizes = np.arange(mix['sentences']['min'], mix['sentences']['max'] + 1)
    lengths: list = []
    while True:
        for n_sent in rng.permutation(sizes):
            request = []
            for _ in range(int(n_sent)):
                if not lengths:
                    lengths = list(rng.permutation(deck))
                n_words = int(lengths.pop())
                words = [lexicon[i] for i in rng.integers(0, len(lexicon), n_words)]
                commas = rng.random(n_words) < mix['comma_share']
                words = [w + (',' if c and j < n_words - 1 else '')
                         for j, (w, c) in enumerate(zip(words, commas))]
                words[0] = words[0][0].upper() + words[0][1:]
                request.append(' '.join(words) + '.')
            yield request


def _bucket_of(length: int, boundaries) -> int:
    for i, b in enumerate(boundaries):
        if length <= b:
            return i
    return len(boundaries)


def aligner_batches(mix: dict, training: dict, vocab_size: int, mel_channels: int,
                    start_value: float, end_value: float, seed: int) -> list:
    """A pool of ``pool_batches`` Aligner training batches for ``seed``, in
    the layout of the port's length-bucketed loader: each clip's mel framed
    by the start and end vectors (its sample length T + 2), stop targets 1 …
    1, 2, the mel padded with zero frames to its bucket's boundary and the
    tokens (start, T / U(frames_per_token) phoneme ids, end) with zeros to a
    multiple of 32; every row of a batch real. Each item is (batch, its
    rows' mel frames T and token counts).

    Clip lengths T follow a beta distribution over [frames.min,
    frames.max]; the pool holds each bucket's batches in proportion to the
    batches that distribution gives it (its share of clips over its batch
    size, by largest remainder, the same for every seed); the rows' lengths,
    the tokens, the mels and the order are drawn from the seed."""
    rng = seed_streams(seed, 4)
    fr, fpt = mix['frames'], mix['frames_per_token']
    bounds, sizes = training['bucket_boundaries'], training['bucket_batch_sizes']
    probe = np.random.default_rng(0).beta(fr['beta_a'], fr['beta_b'], 200_000)
    lengths = np.round(fr['min'] + probe * (fr['max'] - fr['min'])).astype(int)
    share = np.bincount([_bucket_of(t + 2, bounds) for t in lengths],
                        minlength=len(sizes)) / len(lengths)
    weight = share / np.asarray(sizes)
    exact = weight / weight.sum() * mix['pool_batches']
    counts = np.floor(exact).astype(int)
    for i in np.argsort(-(exact - counts))[:mix['pool_batches'] - counts.sum()]:
        counts[i] += 1
    buckets = rng.permutation(np.repeat(np.arange(len(sizes)), counts))
    pool = []
    for bkt in buckets:
        lo = bounds[bkt - 1] if bkt > 0 else 0          # sample lengths T + 2 in (lo, hi]
        hi = bounds[bkt] if bkt < len(bounds) else 10 ** 9
        rows = []
        while len(rows) < sizes[bkt]:
            t = int(round(fr['min'] + rng.beta(fr['beta_a'], fr['beta_b'])
                          * (fr['max'] - fr['min'])))
            if lo < t + 2 <= hi:
                rows.append(t)
        frames = max(hi if bkt < len(bounds) else 0, max(rows) + 2)
        n_tok = [max(3, int(round(t / rng.uniform(fpt['min'], fpt['max'])))) for t in rows]
        tok_pad = -(-max(n_tok) // 32) * 32
        mel = np.zeros((len(rows), frames, mel_channels), np.float32)
        stop = np.zeros((len(rows), frames), np.int32)
        tokens = np.zeros((len(rows), tok_pad), np.int32)
        for i, (t, n) in enumerate(zip(rows, n_tok)):
            mel[i, 0] = start_value
            mel[i, 1:t + 1] = rng.normal(mix['log_mel']['mean'], mix['log_mel']['std'],
                                         (t, mel_channels))
            mel[i, t + 1] = end_value
            stop[i, :t + 2] = 1
            stop[i, t + 1] = 2
            tokens[i, 0], tokens[i, n - 1] = vocab_size - 2, vocab_size - 1
            tokens[i, 1:n - 1] = rng.integers(1, vocab_size - 2, n - 2)
        pool.append(({'mel': mel, 'tokens': tokens, 'stop_probs': stop},
                     {'frames': np.asarray(rows), 'n_tokens': np.asarray(n_tok)}))
    return pool
