"""ctypes bindings of the port's native host ops (``csrc/native_ops.cpp``).

The library is built with g++ at first use, never at import, into
``build/native/`` beside the package (listed in ``.gitignore``), keyed on a
hash of the source: an edited source rebuilds, an unchanged one loads the
library already built. ``available()`` is False where it cannot be built (no
compiler): duration extraction then takes its torch path, and long-silence
trimming its NumPy path (``audio/vad.py``).
"""
import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'csrc' / 'native_ops.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build' / 'native'
FLAGS = ('-O3', '-shared', '-fPIC', '-pthread', '-std=c++17')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + ' '.join(FLAGS).encode())
    return BUILD_DIR / f'libnative_ops-{digest.hexdigest()[:16]}.so'


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never load
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(['g++', *FLAGS, str(SOURCE), '-o', tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            print(f'native_ops unavailable: {e}')
            return None
        lib.duration_dp_range.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.duration_dp_range.restype = None
        lib.vad_long_silence_mask.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.vad_long_silence_mask.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True where the library is built (or builds now) and loads."""
    return _load() is not None


def duration_dp_batch(costs: np.ndarray, ms: np.ndarray, ns: np.ndarray,
                      max_workers: int = 8) -> np.ndarray:
    """(B, m_pad, n_pad) padded costs and each sample's (m, n) → (B, n_pad)
    int32 durations, the first n of row b summing to m. Threads over slices
    of the batch (ctypes releases the GIL during each call)."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native_ops could not be built (g++ is needed)')
    costs = np.ascontiguousarray(costs, np.float32)
    b, m_pad, n_pad = costs.shape
    ms = np.ascontiguousarray(ms, np.int32)
    ns = np.ascontiguousarray(ns, np.int32)
    if ms.shape != (b,) or ns.shape != (b,) or (ms < 1).any() or (ns < 1).any() \
            or (ms > m_pad).any() or (ns > n_pad).any():
        raise ValueError(f'duration_dp_batch: dims must lie in [1, {m_pad}] x [1, {n_pad}], '
                         f'one pair a sample of {b}')
    out = np.zeros((b, n_pad), np.int32)
    bounds = np.linspace(0, b, max(1, min(max_workers, b)) + 1).astype(int)

    def run(w):
        lib.duration_dp_range(costs.ctypes.data, ms.ctypes.data, ns.ctypes.data,
                              int(bounds[w]), int(bounds[w + 1]), m_pad, n_pad,
                              out.ctypes.data)

    with ThreadPoolExecutor(max_workers=len(bounds) - 1) as pool:
        list(pool.map(run, range(len(bounds) - 1)))
    return out


def vad_long_silence_mask(wav: np.ndarray, sampling_rate: int, window_ms: int,
                          moving_average_width: int, max_silence_length: int,
                          energy_threshold_db: float = -48.0) -> np.ndarray:
    """(T,) waveform → (T,) boolean keep mask, the semantics of
    ``audio/vad.py``'s NumPy path (``long_silence_mask``) on the whole
    windows; samples past the last whole window are False."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native_ops could not be built (g++ is needed)')
    wav = np.ascontiguousarray(wav, np.float32)
    if wav.ndim != 1 or (window_ms * sampling_rate) // 1000 < 1 \
            or moving_average_width < 1 or max_silence_length < 0:
        raise ValueError(f'vad_long_silence_mask: a 1-d wav, a window of at least one '
                         f'sample, moving_average_width >= 1 and max_silence_length >= 0; '
                         f'got shape {wav.shape}, {window_ms} ms at {sampling_rate} Hz, '
                         f'{moving_average_width}, {max_silence_length}')
    mask = np.zeros(len(wav), np.uint8)
    lib.vad_long_silence_mask(wav.ctypes.data, len(wav), sampling_rate, window_ms,
                              moving_average_width, max_silence_length,
                              energy_threshold_db, mask.ctypes.data)
    return mask.astype(bool)
