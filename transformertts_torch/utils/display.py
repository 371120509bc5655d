"""Matplotlib → PNG rendering for TensorBoard images
(reference: utils/display.py, utils/logging_utils.py:113-193)."""
import io

import numpy as np


def _fig_to_png(fig) -> tuple:
    import matplotlib.pyplot as plt
    buf = io.BytesIO()
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    fig.savefig(buf, format='png', bbox_inches=None)
    plt.close(fig)
    return buf.getvalue(), h, w


def attention_grid_png(attention: np.ndarray) -> tuple:
    """(H, Tq, Tk) head maps → tight grid PNG. Returns (bytes, h, w)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    attention = np.asarray(attention)
    n_heads = attention.shape[0]
    cols = min(n_heads, 4)
    rows = -(-n_heads // cols)
    fig, axes = plt.subplots(rows, cols, squeeze=False,
                             figsize=(3 * cols, 3 * rows))
    for h in range(rows * cols):
        ax = axes[h // cols][h % cols]
        if h < n_heads:
            ax.imshow(attention[h], aspect='auto', origin='lower')
        ax.axis('off')
    fig.subplots_adjust(wspace=0.02, hspace=0.02)
    return _fig_to_png(fig)


def mel_png(mel: np.ndarray) -> tuple:
    """(T, C) mel → PNG. Returns (bytes, h, w)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.imshow(np.asarray(mel).T, aspect='auto', origin='lower')
    ax.set_xlabel('frames')
    fig.tight_layout()
    return _fig_to_png(fig)
