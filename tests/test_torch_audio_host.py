"""The port's host audio ops against the JAX package's, on the CPU:

- the native VAD mask (``native.vad_long_silence_mask``) against the JAX
  package's native mask and against the NumPy path of both packages, on
  seeded speech-like clips with long gaps, lengths that are not a multiple
  of the window, and an all-silent clip: element for element;
- ``trim_long_silences`` takes the native mask where the library is built
  and the NumPy path where it is not, and a native call that fails raises;
- ``Audio.display_mel``'s image against the JAX ``display_mel``'s, for
  normalized and raw mels in both orientations.
"""
import numpy as np
import pytest

from test_torch_nn import TINY_CONFIG
from transformertts_torch import native
from transformertts_torch.audio import Audio
from transformertts_torch.audio import vad
from transformertts_tpu import native as jnative
from transformertts_tpu.audio import Audio as JAudio
from transformertts_tpu.audio import vad as jvad

SR = 22050
# (window ms, moving-average width, max silence length): the published
# settings (config/training_config.yaml) and a narrower window
VAD_SETTINGS = [(30, 8, 12), (20, 4, 2)]


def _clip(seed: int, seconds: float, extra: int = 0) -> np.ndarray:
    """A voice's harmonics with vibrato and syllabic loudness over faint
    noise, with a gap of near silence, ``extra`` samples past whole seconds."""
    rng = np.random.default_rng(seed)
    n = int(SR * seconds) + extra
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 260) * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voice = sum(rng.uniform(0.1, 0.3) / k * np.sin(k * phase) for k in range(1, 9))
    loud = 0.35 + 0.65 * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t))
    y = voice * loud + 0.005 * rng.standard_normal(n)
    gap = int(SR * rng.uniform(0.6, 1.0))
    start = int(rng.integers(SR // 2, n - SR // 2 - gap))
    y[start:start + gap] = 1e-4 * rng.standard_normal(gap)
    return y.astype(np.float32)


CLIPS = {f'seed{s}-{sec}s+{extra}': (s, sec, extra)
         for s, sec, extra in ((0, 3.0, 0), (1, 2.5, 17), (2, 4.0, 331), (3, 1.7, 1))}


def _wav(name):
    if name == 'silent':
        return np.zeros(SR + 123, np.float32)
    return _clip(*CLIPS[name])


@pytest.fixture(autouse=True)
def _native_built():
    assert native.available() and jnative.available()


@pytest.mark.parametrize('settings', VAD_SETTINGS, ids=['30ms', '20ms'])
@pytest.mark.parametrize('name', [*CLIPS, 'silent'])
def test_native_mask_equals_jax_native_and_both_numpy_paths(name, settings, monkeypatch):
    y = _wav(name)
    window_ms = settings[0]
    spw = window_ms * SR // 1000
    whole = len(y) - len(y) % spw
    mine = native.vad_long_silence_mask(y, SR, *settings)
    # the same C++ on the same samples, whole windows or not
    np.testing.assert_array_equal(mine, jnative.vad_long_silence_mask(y, SR, *settings))
    assert mine.shape == y.shape and not mine[whole:].any()
    # on the whole windows that trim_long_silences keeps: the NumPy path
    cut = y[:whole]
    mask = native.vad_long_silence_mask(cut, SR, *settings)
    numpy_mask = vad.long_silence_mask(cut, SR, *settings)
    assert numpy_mask.dtype == bool
    np.testing.assert_array_equal(mask, numpy_mask)
    # the JAX package's NumPy path (its native branch switched off)
    monkeypatch.setenv('TTS_TPU_DISABLE_NATIVE', '1')
    np.testing.assert_array_equal(cut[numpy_mask], jvad.trim_long_silences(y, SR, *settings))
    if name != 'silent':
        assert 0 < mask.sum() < len(mask)


def test_trim_long_silences_takes_the_native_path_where_it_is_built(monkeypatch):
    y = _wav('seed2-4.0s+331')
    calls = []
    bound = native.vad_long_silence_mask

    def spy(*args, **kwargs):
        calls.append(len(args[0]))
        return bound(*args, **kwargs)

    monkeypatch.setattr(native, 'vad_long_silence_mask', spy)
    trimmed = vad.trim_long_silences(y, SR, 30, 8, 12)
    spw = 30 * SR // 1000
    assert calls == [len(y) - len(y) % spw]
    cut = y[:calls[0]]
    np.testing.assert_array_equal(trimmed, cut[vad.long_silence_mask(cut, SR, 30, 8, 12)])
    assert len(trimmed) < len(cut)
    # without the library: the NumPy path, the same samples
    monkeypatch.setattr(native, 'available', lambda: False)
    np.testing.assert_array_equal(vad.trim_long_silences(y, SR, 30, 8, 12), trimmed)
    assert len(calls) == 1


def test_a_native_call_that_fails_raises(monkeypatch):
    with pytest.raises(ValueError, match='1-d wav'):
        native.vad_long_silence_mask(np.zeros((2, 3000), np.float32), SR, 30, 8, 12)
    with pytest.raises(ValueError, match='moving_average_width'):
        native.vad_long_silence_mask(np.zeros(3000, np.float32), SR, 30, 0, 12)

    def broken(*args, **kwargs):
        raise RuntimeError('native call failed')

    monkeypatch.setattr(native, 'vad_long_silence_mask', broken)
    with pytest.raises(RuntimeError, match='native call failed'):
        vad.trim_long_silences(_wav('seed0-3.0s+0'), SR, 30, 8, 12)


@pytest.mark.parametrize('transpose', [False, True], ids=['frames-mels', 'mels-frames'])
@pytest.mark.parametrize('is_normal', [True, False], ids=['normalized', 'raw'])
def test_display_mel_image_equals_jax(is_normal, transpose):
    from matplotlib import pyplot as plt
    rng = np.random.default_rng(5)
    log_mel = rng.normal(-4.0, 1.5, (57, TINY_CONFIG['mel_channels'])).astype(np.float32)
    mel = log_mel if is_normal else np.exp(log_mel)
    mel = mel.T if transpose else mel
    mine = Audio.from_config(TINY_CONFIG).display_mel(mel, is_normal=is_normal)
    theirs = JAudio.from_config(TINY_CONFIG).display_mel(mel, is_normal=is_normal)
    try:
        a, b = mine.axes[0].images[0].get_array(), theirs.axes[0].images[0].get_array()
        assert a.shape == (TINY_CONFIG['mel_channels'], 57)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).max() == 0.0
        assert mine.get_size_inches().tolist() == theirs.get_size_inches().tolist()
    finally:
        plt.close(mine)
        plt.close(theirs)
