"""The traffic generators: deterministic per seed, the stated distributions,
the same sizes for every seed."""
import itertools
import json

import numpy as np

from conftest import BENCH, tiny_train_config
from h100bench.reference import frontend
from h100bench.traffic import aligner_batches, paragraphs, word_count_deck


def mix(name):
    return json.loads((BENCH / 'traffic' / f'{name}.json').read_text())


def take(gen, n):
    return list(itertools.islice(gen, n))


def test_paragraphs_are_deterministic_per_seed():
    m = mix('paragraphs-48')
    a = take(paragraphs(m, 2 ** 31 + 11), 60)
    assert a == take(paragraphs(m, 2 ** 31 + 11), 60)
    assert a != take(paragraphs(m, 2 ** 31 + 12), 60)
    assert a != take(paragraphs(m, 2 ** 31 + 11, stream=1), 60)


def test_each_block_of_requests_holds_every_size_once():
    for name, top in (('paragraphs-48', 48), ('paragraphs-16', 16)):
        m = mix(name)
        for seed in (0, 7, 2 ** 33 + 1):
            reqs = take(paragraphs(m, seed), 2 * top)
            for block in (reqs[:top], reqs[top:]):
                assert sorted(len(r) for r in block) == list(range(1, top + 1))


def test_sentences_follow_the_word_count_deck_and_the_lexicon():
    m = mix('paragraphs-48')
    deck = word_count_deck(m['words'])
    assert len(deck) == 27 and deck.min() == 2 and deck.max() == 52
    assert abs(deck.mean() - 16.48) < 0.01
    lexicon = frontend.read_lexicon()
    sentences = [s for r in take(paragraphs(m, 5), 48) for s in r]
    counts = [len(s.split(' ')) for s in sentences]
    # every pass through the deck holds each length once
    for start in range(0, len(counts) - len(deck), len(deck)):
        assert sorted(counts[start:start + len(deck)]) == sorted(deck.tolist())
    for s in sentences[:200]:
        assert s.endswith('.') and s[0].isupper()
        assert all(w.rstrip(',.').lower() in lexicon for w in s.split(' '))
        assert frontend.tokens(s, lexicon)
    words = sum(counts)
    commas = sum(s.count(',') for s in sentences)
    assert abs(commas / words - m['comma_share']) < 0.015


def test_word_count_deck_is_the_same_for_every_seed_in_another_order():
    m = mix('paragraphs-16')
    first = [len(s.split(' ')) for r in take(paragraphs(m, 1), 160) for s in r]
    other = [len(s.split(' ')) for r in take(paragraphs(m, 2), 160) for s in r]
    n = len(word_count_deck(m['words'])) * (min(len(first), len(other)) // 27)
    assert first[:n] != other[:n]
    assert sorted(first[:n]) == sorted(other[:n])


def test_aligner_pool_is_deterministic_with_the_same_buckets_for_every_seed():
    cfg = tiny_train_config()
    m = mix('aligner-ljspeech-r1')
    m.update(frames={'min': 20, 'max': 55, 'beta_a': 2.5, 'beta_b': 1.61}, pool_batches=8)
    args = (m, cfg['training'], 129, 80, 0.5, -0.5)
    a, b = aligner_batches(*args, seed=3), aligner_batches(*args, seed=3)
    c = aligner_batches(*args, seed=4)
    for (x, _), (y, _) in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    shapes = sorted(x['mel'].shape[:2] for x, _ in a)
    assert shapes == sorted(x['mel'].shape[:2] for x, _ in c)
    assert any(not np.array_equal(x['mel'], y['mel']) for (x, _), (y, _) in zip(a, c))


def test_aligner_batches_have_the_loader_layout():
    cfg = tiny_train_config()
    m = mix('aligner-ljspeech-r1')
    m.update(frames={'min': 20, 'max': 55, 'beta_a': 2.5, 'beta_b': 1.61}, pool_batches=6)
    bounds = cfg['training']['bucket_boundaries']
    for batch, meta in aligner_batches(m, cfg['training'], 129, 80, 0.5, -0.5, seed=9):
        b, frames, _ = batch['mel'].shape
        assert frames in bounds or frames == max(meta['frames']) + 2
        assert batch['tokens'].shape[1] % 32 == 0
        for i, (t, n) in enumerate(zip(meta['frames'], meta['n_tokens'])):
            assert 20 <= t <= 55
            assert t / 7.0 - 1 <= n <= t / 5.0 + 1
            assert np.all(batch['mel'][i, 0] == 0.5) and np.all(batch['mel'][i, t + 1] == -0.5)
            assert np.all(batch['mel'][i, t + 2:] == 0)
            assert np.all(np.abs(batch['mel'][i, :t + 2]).sum(axis=-1) > 0)
            assert batch['stop_probs'][i, t + 1] == 2 and np.all(batch['stop_probs'][i, :t + 1] == 1)
            assert batch['tokens'][i, 0] == 127 and batch['tokens'][i, n - 1] == 128
            assert np.all(batch['tokens'][i, n:] == 0)
