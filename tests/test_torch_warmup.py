"""``warmup_serving``: the port's against the JAX package's, on the tiny config
of ``tests/test_torch_nn.py``.

- It returns what the JAX function returns for the same arguments (72 for
  the defaults, 12 without the ragged batches, the same with a vocoder). The
  JAX function's count comes from its own loops over a stand-in model whose
  compiled functions return zeros, because compiling the JAX serving menu (96
  executables) would take minutes on the CPU; the port's runs the real model.
- It decodes at exactly the (batch, token, frame) buckets it counts.
- ``synthesize_lines`` gives the same wavs after a warm-up as before it.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_nn import TINY_CONFIG
from transformertts_torch.audio import Audio as TAudio
from transformertts_torch.models import synthesis
from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
from transformertts_torch.models.melgan import MelGANVocoder
from transformertts_tpu.models import synthesis as jsynthesis

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LINES = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
         if l.strip()]
DEFAULT_TOKEN_BUCKETS = (32, 64, 96, 128)
DEFAULT_FRAME_BUCKETS = (128, 256, 384)


@pytest.fixture(scope='module')
def served():
    """The tiny port model and audio settings, and a small MelGAN (hop 4)."""
    gen = torch.Generator().manual_seed(3)
    model = TFT(**TINY_CONFIG).init_params(gen).eval()
    vocoder = MelGANVocoder(base_channels=32, upsample_rates=(2, 2)).init_params(gen).eval()
    return model, TAudio.from_config(model.config), vocoder


class _JaxStandIn:
    """What ``transformertts_tpu``'s ``warmup_serving`` calls on a model, its
    audio settings and a vocoder, returning zeros of the serving shapes."""

    params = {}
    hop_length = 4

    def _encode_jit(self):
        def encode(params, tok):
            b, n = np.shape(tok)
            return (np.zeros((b, n, 8), np.float32), np.zeros((b, n, 1), np.float32),
                    np.zeros((b, n, 1), np.float32), np.ones((b, n, 1), np.float32))
        return encode

    def _decode_wav_jit(self, audio, n_iter):
        return lambda params, features, *rest: (np.zeros((len(features), rest[-1])), None)

    def _decode_vocoder_jit(self, vocoder):
        return lambda params, voc_params, features, *rest: (
            np.zeros((len(features), rest[-1])), None)


def _jax_count(vocoder: bool, **kwargs) -> int:
    stand_in = _JaxStandIn()
    return jsynthesis.warmup_serving(stand_in, stand_in, n_iter=1,
                                     vocoder=stand_in if vocoder else None, **kwargs)


@pytest.mark.parametrize('case', [
    dict(),
    dict(include_ragged_batches=False),
    dict(vocoder=True),
    dict(max_batch=24, token_buckets=(32, 64), frame_buckets=(128,)),
], ids=['defaults', 'no-ragged', 'vocoder', 'max-batch-24'])
def test_warmup_count_and_buckets_match_jax(served, monkeypatch, case):
    model, audio, vocoder = served
    case = dict(case)
    with_vocoder = case.pop('vocoder', False)
    seen = []
    decode = TFT.decode_features

    def recording(self, features, pitch, durations, max_frames):
        seen.append((features.shape[0], features.shape[1], max_frames))
        return decode(self, features, pitch, durations, max_frames)

    monkeypatch.setattr(TFT, 'decode_features', recording)
    count = synthesis.warmup_serving(model, audio, n_iter=1,
                                     vocoder=vocoder if with_vocoder else None, **case)
    assert count == _jax_count(with_vocoder, **case)
    max_batch = case.get('max_batch', 32)
    batches = [max_batch]
    if case.get('include_ragged_batches', True):
        batches += [2 ** k for k in range(max_batch.bit_length()) if 2 ** k < max_batch]
    buckets = [(b, t, f) for b in batches
               for t in case.get('token_buckets', DEFAULT_TOKEN_BUCKETS)
               for f in case.get('frame_buckets', DEFAULT_FRAME_BUCKETS)]
    assert seen == buckets and count == len(buckets)
    if not case:
        assert count == 72
    if case == dict(include_ragged_batches=False):
        assert count == 12


@pytest.mark.parametrize('with_vocoder', [False, True], ids=['griffin-lim', 'vocoder'])
def test_synthesize_lines_gives_the_same_wavs_after_warmup(served, with_vocoder):
    model, audio, vocoder = served
    vocoder = vocoder if with_vocoder else None
    before = synthesis.synthesize_lines(model, audio, LINES, n_iter=2, vocoder=vocoder)
    assert synthesis.warmup_serving(model, audio, max_batch=4, token_buckets=(32,),
                                    frame_buckets=(128,), n_iter=2, vocoder=vocoder) == 3
    after = synthesis.synthesize_lines(model, audio, LINES, n_iter=2, vocoder=vocoder)
    assert len(after) == len(before) == len(LINES)
    for a, b in zip(after, before):
        assert a.size > 0
        np.testing.assert_array_equal(a, b)
