"""Sinusoidal positional encodings (the table of ``transformertts_tpu/nn/posenc.py``)."""
import numpy as np


def positional_encoding(max_position: int, model_dim: int) -> np.ndarray:
    """(1, max_position, model_dim) float32, sin on even dims, cos on odd."""
    pos = np.arange(max_position, dtype=np.float64)[:, None]
    i = np.arange(model_dim)[None, :]
    angles = pos * (1.0 / np.power(10000.0, (2 * (i // 2)) / np.float64(model_dim)))
    angles[:, 0::2] = np.sin(angles[:, 0::2])
    angles[:, 1::2] = np.cos(angles[:, 1::2])
    return angles[None].astype(np.float32)
