"""Shared trainer scaffolding, the counterpart of
``transformertts_tpu/training/base_trainer.py`` on one device: the optimizer
and its step count, batches moved to the device, the per-step dropout
generator, and gradient accumulation. The mesh, tensor parallelism and
ZeRO-1 of the JAX package wait for the multi-GPU slice.
"""
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from transformertts_torch.training.state import make_optimizer, set_learning_rate


def split_batch(batch: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """``n`` micro-batches of consecutive rows; the batch must divide by n."""
    b = next(iter(batch.values())).shape[0]
    if b % n != 0:
        raise ValueError(f'batch size {b} not divisible by grad_accumulation={n}')
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def merge_aux(auxes: List[dict]) -> dict:
    """Scalars: the mean over micro-batches; per-sample tensors: concatenated."""
    return {k: (torch.stack([a[k] for a in auxes]).mean() if auxes[0][k].dim() == 0
                else torch.cat([a[k] for a in auxes]))
            for k in auxes[0]}


class BaseTrainer:
    """Owns the optimizer, the step count and the dropout generators.
    Subclasses define ``loss(batch, training, generator) -> (loss, aux)``."""

    def __init__(self, model: torch.nn.Module,
                 learning_rate_schedule: Sequence[Tuple[float, float]],
                 base_rng_seed: int = 42, grad_accumulation: int = 1):
        self.model = model
        self.schedule = learning_rate_schedule
        self.optimizer = make_optimizer(model.parameters())
        self.base_rng_seed = int(base_rng_seed)
        self.grad_accumulation = int(grad_accumulation)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout generator of ``step``, seeded from (base seed, step):
        a step is reproducible, and resuming does not replay earlier masks."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(self.base_rng_seed * 2 ** 32 + int(step))

    def to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Numeric fields as tensors on the model's device (integer fields as
        int64); bookkeeping strings such as ``fname`` stay behind."""
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if v.dtype.kind in 'US':
                continue
            t = torch.as_tensor(v)
            out[k] = (t.long() if v.dtype.kind in 'iu' else t.float()).to(self.device)
        return out

    def loss(self, batch: Dict[str, torch.Tensor], training: bool,
             generator: torch.Generator) -> Tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def train_step(self, batch: Dict[str, np.ndarray]) -> dict:
        """One Adam update on the mean of the micro-batch gradients (one
        micro-batch unless ``grad_accumulation`` > 1). Returns the detached
        losses and per-sample outputs."""
        micro = split_batch(self.to_device(batch), self.grad_accumulation)
        set_learning_rate(self.optimizer, self.schedule, self.step)
        generator = self.step_generator(self.step)
        self.optimizer.zero_grad(set_to_none=True)
        auxes = []
        for mb in micro:
            loss, aux = self.loss(mb, True, generator)
            (loss / len(micro)).backward()
            auxes.append({k: v.detach() for k, v in aux.items()})
        self.optimizer.step()
        self.step += 1
        return merge_aux(auxes)

    @torch.no_grad()
    def val_step(self, batch: Dict[str, np.ndarray]) -> dict:
        """Losses and predictions without dropout and without gradients."""
        _, aux = self.loss(self.to_device(batch), False, None)
        return aux
