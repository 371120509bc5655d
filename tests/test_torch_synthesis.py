"""Batched serving: the port's ``synthesize_lines`` against the JAX one over
config/test_sentences.txt on the tiny config, and the port's predict_tts CLI.

The JAX side ships PCM16 (peak-normalized, truncated to 1/32767 steps); the
port returns the same peak-normalized float. Per-sample agreement is held at
two Griffin-Lim iterations, to 1/32767 for the quantization plus 1e-3 for
the phase iteration's growth of float32 rounding (test_torch_griffinlim.py);
at the default 32 iterations lengths and range are checked. The JAX package
computes Griffin-Lim as float32 DFT GEMMs, the port on the CPU as the FFT
kernel's plain version: two float32 forms whose rounding is not shared. So
both are also held to a float64 Griffin-Lim (numpy's real FFTs) of the
port's own magnitudes: the served form within 5e-4 (it reads 2.2e-4 on
these lines), the JAX package within 1/32767 + 1.5e-3 (it reads 1.07e-3,
its rounding and the two models' mels apart). Served against JAX, the 1e-3
bar holds on every line but the third, where the JAX wav itself lies 1.07e-3
from the float64 one.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_nn import TINY_CONFIG, jax_and_port_models
from transformertts_torch.audio import Audio as TAudio
from transformertts_torch.audio import griffinlim, spectral
from transformertts_torch.audio.wav_io import load_wav
from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
from transformertts_torch.models.synthesis import synthesize_lines as t_synthesize
from transformertts_tpu.audio import Audio as JAudio
from transformertts_tpu.models.synthesis import synthesize_lines as j_synthesize

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LINES = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
         if l.strip()]
PCM16_STEP = 1.0 / 32767
SERVED_TO_FLOAT64 = 5e-4
JAX_TO_FLOAT64 = PCM16_STEP + 1.5e-3
JAX_BAR_LINES = (0, 1, 3)   # where served and JAX meet at the original bar


def _griffin_lim_float64(S, n_iter, n_fft, hop_length, win_length, momentum=0.99):
    """Griffin-Lim in the padded signal domain in float64 with numpy's real
    FFTs: the same iteration as the port's (zero-phase init, momentum, the
    squared-window envelope of the frames that exist floored at 1e-10)."""
    S = S.double().cpu().numpy()
    b, n_frames, _ = S.shape
    w = spectral.padded_window(n_fft, win_length)
    out_len = n_fft + hop_length * (n_frames - 1)
    starts = np.arange(n_frames) * hop_length
    env = np.zeros(out_len)
    for f0 in starts:
        env[f0:f0 + n_fft] += w * w
    env = np.maximum(env, 1e-10)
    idx = starts[:, None] + np.arange(n_fft)

    def istft(X):
        frames = np.fft.irfft(X, n_fft, axis=-1) * w
        y = np.zeros((b, out_len))
        for f, f0 in enumerate(starts):
            y[:, f0:f0 + n_fft] += frames[:, f]
        return y / env

    m = momentum / (1.0 + momentum)
    X, prev = S.astype(np.complex128), np.zeros(S.shape, np.complex128)
    for _ in range(n_iter):
        new = np.fft.rfft(istft(X)[:, idx] * w, axis=-1)
        upd = new - m * prev
        X, prev = S * upd / (np.abs(upd) + 1e-16), new
    y = istft(X)[:, n_fft // 2:n_fft // 2 + hop_length * (n_frames - 1)]
    return torch.from_numpy(y)


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    model_dir = tmp_path_factory.mktemp('tiny')
    jm, tm = jax_and_port_models(model_dir)
    return jm, tm, model_dir


def test_synthesize_lines_matches_jax(models, monkeypatch):
    jm, tm, _ = models
    j_wavs = j_synthesize(jm, JAudio.from_config(jm.config), LINES, n_iter=2)
    t_wavs = t_synthesize(tm, TAudio.from_config(tm.config), LINES, n_iter=2)
    monkeypatch.setattr(griffinlim, 'griffin_lim', _griffin_lim_float64)
    r_wavs = t_synthesize(tm, TAudio.from_config(tm.config), LINES, n_iter=2)
    assert len(t_wavs) == len(j_wavs) == len(r_wavs) == len(LINES)
    for line, (t, j, r) in enumerate(zip(t_wavs, j_wavs, r_wavs)):
        assert t.shape == j.shape == r.shape and t.size > 0
        np.testing.assert_allclose(t, r, rtol=0, atol=SERVED_TO_FLOAT64)
        np.testing.assert_allclose(j, r, rtol=0, atol=JAX_TO_FLOAT64)
        if line in JAX_BAR_LINES:
            np.testing.assert_allclose(t, j, rtol=0, atol=PCM16_STEP + 1e-3)


def test_synthesize_lines_default_iterations(models):
    jm, tm, _ = models
    j_wavs = j_synthesize(jm, JAudio.from_config(jm.config), LINES, speed_regulator=1.3)
    t_wavs = t_synthesize(tm, TAudio.from_config(tm.config), LINES[::-1], max_batch=2,
                          speed_regulator=1.3)[::-1]
    for t, j in zip(t_wavs, j_wavs):
        assert t.shape == j.shape
        assert np.isfinite(t).all() and 0 < np.abs(t).max() <= 1.0


def test_lines_without_tokens_give_empty_wavs(models):
    _, tm, _ = models
    wavs = t_synthesize(tm, TAudio.from_config(tm.config), ['', LINES[2]], n_iter=1)
    assert wavs[0].shape == (0,) and wavs[1].size > 0


def test_empty_line_contract_matches_jax(models):
    """A line that tokenizes to nothing ('' and '漢字', which the phonemizer
    drops) gives an empty float32 wav in both packages; '???' keeps three '?'
    tokens, so it is no empty line, and both synthesize the same wav."""
    jm, tm, _ = models
    lines = ['', '???', '漢字']
    j_wavs = j_synthesize(jm, JAudio.from_config(jm.config), lines, n_iter=2)
    t_wavs = t_synthesize(tm, TAudio.from_config(tm.config), lines, n_iter=2)
    for line, t, j in zip(lines, t_wavs, j_wavs):
        assert t.dtype == j.dtype == np.float32
        if len(jm.encode_text(line)) == 0:
            assert len(tm.encode_text(line)) == 0
            assert t.shape == j.shape == (0,)
        else:
            assert tm.encode_text(line) == jm.encode_text(line)
            assert t.shape == j.shape and t.size > 0
            np.testing.assert_allclose(t, j, rtol=0, atol=PCM16_STEP + 1e-3)
    assert [w.size == 0 for w in t_wavs] == [True, False, True]


def test_zero_durations_keep_one_frame_a_line():
    """Durations that all round to zero (an untrained model's) still give
    each line one frame of audio, as ``predict`` keeps one mel frame."""
    tm = TFT(**TINY_CONFIG).init_params(torch.Generator().manual_seed(5))
    with torch.no_grad():
        tm.dur_pred.linear.bias.fill_(-10.0)
    audio = TAudio.from_config(tm.config)
    with torch.inference_mode():
        tok = torch.as_tensor([tm.encode_text(LINES[0])])
        assert torch.round(tm.scaled_durations(tm.encode(tok), 1.0)).sum() == 0
    wavs = t_synthesize(tm, audio, LINES, n_iter=1, max_batch=2)
    assert [w.size for w in wavs] == [audio.hop_length] * len(LINES)
    assert all(np.isfinite(w).all() for w in wavs)


@pytest.mark.parametrize('batched', [True, False])
def test_predict_tts_writes_a_readable_wav(models, tmp_path, batched):
    from transformertts_torch import predict_tts
    _, tm, model_dir = models
    text = tmp_path / 'lines.txt'
    text.write_text('\n'.join(LINES[:2]) + '\n')
    args = ['-p', str(model_dir), '-f', str(text), '-o', str(tmp_path), '--device', 'cpu']
    predict_tts.main(args + ([] if batched else ['--per_line']))
    wav, sr = load_wav(next((tmp_path / 'outputs' / 'lines').glob('*.wav')))
    assert sr == 22050
    assert wav.size > 0 and np.isfinite(wav).all() and np.abs(wav).max() > 0


def test_predict_tts_trace_writes_the_spans_as_a_chrome_trace(models, tmp_path):
    """``--trace PATH``: one complete event a span on the epoch clock (ts ·
    1e3 + baseTimeNanoseconds), the request's attrs, the counters; tracing
    is off again afterwards."""
    import json
    import time

    from transformertts_torch import predict_tts
    from transformertts_torch.utils import tracing
    _, _, model_dir = models
    text = tmp_path / 'lines.txt'
    text.write_text('\n'.join(LINES) + '\n')
    path = tmp_path / 'spans.json'
    before = time.time_ns()
    predict_tts.main(['-p', str(model_dir), '-f', str(text), '-o', str(tmp_path),
                      '--device', 'cpu', '--trace', str(path)])
    after = time.time_ns()
    assert not tracing.enabled()
    trace = json.loads(path.read_text())
    events = trace['traceEvents']
    assert all(e['ph'] == 'X' for e in events)
    names = [e['name'] for e in events]
    assert names[:3] == ['request', 'frontend', 'chunk'] and names.count('chunk') == 1
    assert events[0]['args']['sentences'] == len(LINES)
    for e in events:
        start = e['ts'] * 1e3 + trace['baseTimeNanoseconds']
        assert before <= start and start + e['dur'] * 1e3 <= after
    counters = trace['counters']
    assert counters['requests'] == 1 and counters['rows_real'] == len(LINES)
    wav, _ = load_wav(next((tmp_path / 'outputs' / 'lines').glob('*.wav')))
    assert counters['audio_samples'] == wav.size
