"""Training schedules, the counterpart of the learning-rate half of
``transformertts_tpu/utils/scheduling.py``. The port evaluates the schedule
on the host and sets the optimizer's rate before every step, as the
reference trainer does; the JAX package evaluates the same interpolation on
device inside its step.
"""
from typing import Sequence, Tuple

import numpy as np


def piecewise_linear_schedule(step, schedule: Sequence[Tuple[float, float]]) -> float:
    """Linear interpolation through (step, value) knots, clamped at the ends,
    in float32 as the JAX package computes it."""
    sched = np.asarray(schedule, dtype=np.float32)
    return float(np.float32(np.interp(np.float32(step), sched[:, 0], sched[:, 1])))
