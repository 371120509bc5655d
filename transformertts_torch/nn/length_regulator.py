"""Length regulator, the counterpart of ``transformertts_tpu/nn/length_regulator.py``.

Durations are rounded half-to-even (``torch.round``, as ``jnp.round``),
clamped at 0 and summed; frame t takes the features of the phoneme whose
span [start, end) holds it, found by ``searchsorted`` over the cumulative
ends and gathered. Frames at or beyond the total are zero rows. Selection is
exact, so in float32 the output is bit-equal to the JAX one-hot matmul.
"""
from typing import Tuple

import torch


def regulate_length(x: torch.Tensor, durations: torch.Tensor, max_frames: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, N, D), durations (B, N) float → (out (B, T, D), frame_valid (B, T)).

    ``frame_valid`` is 1/0 in x's dtype; T = ``max_frames``.
    """
    dur = torch.round(durations.float()).long().clamp_min(0)
    ends = torch.cumsum(dur, dim=1)                                    # (B, N)
    total = ends[:, -1:]                                               # (B, 1)
    t = torch.arange(max_frames, device=x.device).expand(x.shape[0], -1)
    # first phoneme whose end lies after t: zero-duration phonemes own no frame
    idx = torch.searchsorted(ends, t.contiguous(), right=True)
    idx = idx.clamp_max(x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    valid = (t < total).to(x.dtype)                                    # (B, T)
    return torch.where(valid[:, :, None] > 0, out, torch.zeros_like(out)), valid
