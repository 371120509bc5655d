"""Training schedules, the counterpart of ``transformertts_tpu/utils/scheduling.py``.
The port evaluates the learning-rate schedule on the host and sets the
optimizer's rate before every step, as the reference trainer does; the JAX
package evaluates the same interpolation on device inside its step. The
Aligner's reduction factor is a host-side step function in both.
"""
from typing import Sequence, Tuple

import numpy as np


def piecewise_linear_schedule(step, schedule: Sequence[Tuple[float, float]]) -> float:
    """Linear interpolation through (step, value) knots, clamped at the ends,
    in float32 as the JAX package computes it."""
    sched = np.asarray(schedule, dtype=np.float32)
    return float(np.float32(np.interp(np.float32(step), sched[:, 0], sched[:, 1])))


def reduction_schedule(step: int, schedule: Sequence[Tuple[int, int]]) -> int:
    """Piecewise-constant reduction factor: the value of the last knot whose
    step is <= ``step`` (the first knot's value before it)."""
    sched = sorted((int(s), int(v)) for s, v in schedule)
    value = sched[0][1]
    for s, v in sched:
        if step >= s:
            value = v
    return int(value)
