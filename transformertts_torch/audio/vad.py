"""Voice activity detection for long-silence trimming.

The reference uses the webrtcvad C library over 30 ms windows with a moving
average + binary dilation smoothing (data/audio.py:172-194). webrtcvad's GMM
classifier is replaced by an adaptive log-energy detector over the same
window/smoothing structure, with the same config knobs
(vad_window_length ms, vad_moving_average_width, vad_max_silence_length),
plus a speech-anchor classification stage (round 5) that recovers the GMM's
level-independent behavior on structured noise:

* a window is a **speech anchor** when it is simultaneously periodic in the
  pitch range (normalized autocorrelation peak over 70–400 Hz lags — a
  single voice is strongly periodic; babble, clicks and broadband noise are
  not), syllabically modulated (local energy-envelope variation over a
  ±0.24 s context — sustained tones and steady hum are not), and audible;
* anchors are always kept (they rescue quiet speech the energy midpoint
  would cut), and long anchor-free stretches (≥ ~0.4 s, longer than any
  in-speech unvoiced span) are classified non-speech even when their energy
  sits above the adaptive threshold — which trims loud babble/music/click
  gaps the energy gate alone must conservatively keep.

Clips with no anchors at all (no harmonic speech found — e.g. pure noise
fixtures) keep the pure energy-gate behavior. Offline preprocessing only:
the port's copy of ``transformertts_tpu/audio/vad.py``.
``trim_long_silences`` takes the native C++ mask
(``native.vad_long_silence_mask``) where the native library is built, as the
JAX package does, and ``long_silence_mask``, the NumPy path, where it is not;
the two give the same mask.
"""
import numpy as np

from transformertts_torch import native

# Speech-anchor classifier constants. Margins measured on the structured
# fixtures in scripts/measure_dsp_fidelity.py (see BASELINE.md): voiced
# speech has periodicity ≥0.85 / modulation ≥3 dB; summed-voice babble
# ≤0.21 / chord ≤0.46 / clicks ≤0.38 periodicity; sustained chord ≤1.7 dB
# modulation.
_ANCHOR_PERIODICITY = 0.80   # min normalized autocorr peak (70–400 Hz)
_ANCHOR_MOD_DB = 2.0         # min local envelope std (dB)
_ANCHOR_MIN_DB = -35.0       # anchors must be audible (dB vs p95 window)
_MOD_CONTEXT = 8             # ± windows for the envelope-std context
_NONSPEECH_MIN_RUN = 14      # anchor-free windows ≈0.42 s at 30 ms — longer
                             # than any in-speech unvoiced (fricative) span
_PITCH_LO_HZ = 70.0
_PITCH_HI_HZ = 400.0
_ANA_MS = 60                 # periodicity analysis frame (≥2 pitch periods)


def _moving_average(array: np.ndarray, width: int) -> np.ndarray:
    """Centered running mean with zero boundary handling.

    Output i averages array[i-(width-1)//2 .. i+width//2] — the same window
    alignment the reference smoothing uses (data/audio.py:185-191), expressed
    as a convolution: that window ends at full-conv index i + width//2.
    """
    summed = np.convolve(np.asarray(array, dtype=float), np.ones(width),
                         mode='full')
    return summed[width // 2:width // 2 + len(array)] / width


def _binary_dilation(mask: np.ndarray, width: int) -> np.ndarray:
    """1-D binary dilation with a flat structuring element of ``width``."""
    if width <= 1:
        return mask
    kernel = np.ones(width)
    conv = np.convolve(mask.astype(float), kernel, mode='same')
    return conv > 0


def adaptive_threshold_db(rms: np.ndarray, ref: float,
                          fallback_db: float = -48.0) -> float:
    """Bimodal energy threshold relative to the p95 level.

    The noise floor is the 10th-percentile window RMS. When the floor sits
    clearly below the speech level (>12 dB gap) the threshold is the
    midpoint between the two, clamped to [-48, -12] dB — so noisy silences
    (recording hiss well above -48 dBFS, which a fixed gate keeps) are still
    trimmed. Without a clear gap (clip is all speech, or SNR too low for an
    energy gate to separate safely) the conservative ``fallback_db`` gate
    applies and only near-digital silence is removed.
    """
    floor_db = 20.0 * np.log10((np.percentile(rms, 10) + 1e-12) / ref)
    if floor_db <= -12.0:
        return float(np.clip(floor_db / 2.0, -48.0, -12.0))
    return fallback_db


def _window_periodicity(wav: np.ndarray, sampling_rate: int,
                        samples_per_window: int, n_windows: int) -> np.ndarray:
    """Max normalized autocorrelation over pitch-range lags, per window.

    The analysis frame is a centered ``_ANA_MS`` span around each window
    (≥2 periods at 70 Hz); frames too short for the longest lag score 0.
    Linear (zero-padded) autocorrelation normalized by frame energy: a
    single voiced source scores ~0.9, summed voices / clicks / noise <0.5.
    """
    ana = (_ANA_MS * sampling_rate) // 1000
    lag_lo = int(sampling_rate / _PITCH_HI_HZ)
    lag_hi = int(sampling_rate / _PITCH_LO_HZ)
    nfft = 1 << int(np.ceil(np.log2(2 * ana)))
    out = np.zeros(n_windows)
    w = np.asarray(wav, np.float64)
    for i in range(n_windows):
        c = i * samples_per_window + samples_per_window // 2
        a = max(0, c - ana // 2)
        x = w[a:a + ana]
        if len(x) < lag_hi + 32:
            continue
        x = x - x.mean()
        e = float(np.sum(x * x)) + 1e-12
        spec = np.fft.rfft(x, nfft)
        ac = np.fft.irfft(spec * np.conj(spec), nfft)[:lag_hi + 1]
        out[i] = float(np.max(ac[lag_lo:lag_hi + 1])) / e
    return out


def _local_mod_std(db: np.ndarray, context: int = _MOD_CONTEXT) -> np.ndarray:
    """Std of window-dB over a centered ±``context`` neighborhood: the
    syllabic-rate modulation depth of the energy envelope."""
    n = len(db)
    out = np.empty(n)
    for i in range(n):
        seg = db[max(0, i - context):min(n, i + context + 1)]
        out[i] = float(np.std(seg))
    return out


def _anchor_free_runs(anchors: np.ndarray, min_run: int) -> np.ndarray:
    """True for windows inside maximal anchor-free runs of ≥ ``min_run``."""
    out = np.zeros(len(anchors), bool)
    i, n = 0, len(anchors)
    while i < n:
        if anchors[i]:
            i += 1
            continue
        j = i
        while j < n and not anchors[j]:
            j += 1
        if j - i >= min_run:
            out[i:j] = True
        i = j
    return out


def detect_voice_flags(wav: np.ndarray, sampling_rate: int,
                       window_ms: int, energy_threshold_db: float = -48.0) -> np.ndarray:
    """Per-window speech flags: adaptive log-energy + speech anchors.

    A window is speech if its RMS is above an adaptive threshold (see
    :func:`adaptive_threshold_db`) relative to the 95th-percentile window
    RMS (robust to overall level); ``energy_threshold_db`` is the fallback
    gate when the clip has no clear silence mode. When the clip contains
    speech anchors (periodic + modulated + audible windows, see module
    docstring) the energy decision is amended both ways: anchors are always
    speech, and long anchor-free runs are never speech.
    """
    samples_per_window = (window_ms * sampling_rate) // 1000
    n_windows = len(wav) // samples_per_window
    if n_windows == 0:
        return np.ones(0, dtype=bool)
    frames = wav[:n_windows * samples_per_window].reshape(n_windows, samples_per_window)
    rms = np.sqrt(np.mean(frames ** 2, axis=-1) + 1e-12)
    ref = np.percentile(rms, 95) + 1e-12
    db = 20.0 * np.log10(rms / ref)
    flags = db > adaptive_threshold_db(rms, ref, energy_threshold_db)
    anchors = ((_window_periodicity(wav, sampling_rate, samples_per_window,
                                    n_windows) >= _ANCHOR_PERIODICITY)
               & (_local_mod_std(db) >= _ANCHOR_MOD_DB)
               & (db > _ANCHOR_MIN_DB))
    if anchors.any():
        flags = (flags | anchors) & ~_anchor_free_runs(
            anchors, _NONSPEECH_MIN_RUN)
    return flags


def long_silence_mask(wav: np.ndarray, sampling_rate: int, window_ms: int,
                      moving_average_width: int, max_silence_length: int,
                      energy_threshold_db: float = -48.0) -> np.ndarray:
    """Per-sample keep mask of a wav of whole windows, the NumPy path of
    ``trim_long_silences``: the reference smoothing chain (moving average of
    the voice flags → round → dilation → repeat to samples)."""
    samples_per_window = (window_ms * sampling_rate) // 1000
    voice_flags = detect_voice_flags(wav, sampling_rate, window_ms,
                                     energy_threshold_db).astype(float)
    audio_mask = _moving_average(voice_flags, moving_average_width)
    audio_mask = np.round(audio_mask).astype(bool)
    audio_mask = _binary_dilation(audio_mask, max_silence_length + 1)
    return np.repeat(audio_mask, samples_per_window)


def trim_long_silences(wav: np.ndarray, sampling_rate: int, window_ms: int,
                       moving_average_width: int, max_silence_length: int,
                       energy_threshold_db: float = -48.0) -> np.ndarray:
    """Cut the wav to whole windows and remove its long internal silences,
    by the native mask where the native library is built, else by
    ``long_silence_mask``."""
    samples_per_window = (window_ms * sampling_rate) // 1000
    wav = wav[:len(wav) - (len(wav) % samples_per_window)]
    if len(wav) == 0:
        return wav
    args = (sampling_rate, window_ms, moving_average_width, max_silence_length,
            energy_threshold_db)
    if native.available():
        return wav[native.vad_long_silence_mask(wav, *args)]
    return wav[long_silence_mask(wav, *args)]


def trim_silence_top_db(wav: np.ndarray, top_db: float, frame_length: int = 256,
                        hop_length: int = 64) -> np.ndarray:
    """Leading/trailing silence trim (librosa.effects.trim semantics:
    drop edges quieter than ``top_db`` below the peak RMS)."""
    if len(wav) < frame_length:
        return wav
    n_frames = 1 + (len(wav) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n_frames)[:, None]
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=-1) + 1e-12)
    ref = np.max(rms) + 1e-12
    db = 20.0 * np.log10(rms / ref)
    non_silent = np.where(db > -top_db)[0]
    if len(non_silent) == 0:
        return wav[:0]
    start = non_silent[0] * hop_length
    end = min(len(wav), non_silent[-1] * hop_length + frame_length)
    return wav[start:end]
