"""Optimizer of the training state, the counterpart of
``transformertts_tpu/training/state.py``.

Adam with β (0.9, 0.98) and ε 1e-9, ε added outside the square root as optax
adds it (``torch.optim.Adam`` does the same). The learning rate is the
piecewise-linear schedule of the config, evaluated at the number of updates
already taken and set before every update, which is the step optax's
schedule sees. The training state is the model's parameters, this
optimizer's moments and the step count; ``training/checkpointing.py`` stores
it in the JAX package's layout.
"""
from typing import Iterable, Sequence, Tuple

import torch

from transformertts_torch.utils.scheduling import piecewise_linear_schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], beta_1: float = 0.9,
                   beta_2: float = 0.98, eps: float = 1e-9) -> torch.optim.Adam:
    """Adam over ``params``; ``set_learning_rate`` sets its rate each step."""
    return torch.optim.Adam(params, lr=0.0, betas=(beta_1, beta_2), eps=eps)


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      schedule: Sequence[Tuple[float, float]], step: int) -> float:
    """Set and return the schedule's rate at ``step`` updates taken."""
    lr = piecewise_linear_schedule(step, schedule)
    for group in optimizer.param_groups:
        group['lr'] = lr
    return lr
