"""Shared trainer scaffolding, the counterpart of
``transformertts_tpu/training/base_trainer.py``: the optimizer and its step
count, batches moved to the device, the per-step dropout generator,
gradient accumulation, and the mesh: data parallelism over its ``data``
axis, tensor parallelism over its ``model`` axis and ZeRO-1.

The mesh (``mesh``, a ``parallel.ProcessMesh`` with a process group):
every rank is handed the same global batch. It is padded with zero rows to
a multiple of the mesh's data size, split into the ``grad_accumulation``
micro-batches, and only then does each data rank take its contiguous slice
of each micro-batch, the order of the JAX ``accumulate_grads`` over a
sharded batch; the model ranks of one data row take the same slice. Each
rank's losses divide by the whole micro-batch's counts (``utils/losses.py``),
so summing the gradients over the data ranks gives the gradient of the
global loss. Logged losses are summed over the data ranks, and per-sample
outputs gathered in batch order, so every rank returns what one process
would. Each data rank draws its own dropout stream, and the model ranks of
a data row draw the same one. At ``model`` > 1 the trainer shards the model
(``parallel/tensor_parallel.py``) after rank 0's parameters are broadcast;
the optimizer (``training/state.py``'s ``FlatAdam``) holds the parameters
and gradients in flat buffers and applies ZeRO-1 at ``data`` > 1.
"""
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from transformertts_torch.parallel.mesh import (ProcessMesh, all_reduce_sum,
                                                broadcast_module, gather_rows,
                                                pad_batch_to_multiple, shard_batch)
from transformertts_torch.parallel.tensor_parallel import shard_model
from transformertts_torch.training.state import make_optimizer, set_learning_rate

_MASK64 = 2 ** 64 - 1


def rank_seed(seed: int, rank: int) -> int:
    """Rank 0's ``seed`` itself; another rank's, ``seed`` and the rank mixed
    by splitmix64 into 64 bits that all differ, the low 32 too (a CPU
    generator seeds from those alone)."""
    if rank == 0:
        return seed
    x = (seed + rank * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def split_batch(batch: dict, n: int) -> List[dict]:
    """``n`` micro-batches of consecutive rows; the batch must divide by n."""
    b = next(iter(batch.values())).shape[0]
    if b % n != 0:
        raise ValueError(f'batch size {b} not divisible by grad_accumulation={n}')
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def merge_aux(auxes: List[dict]) -> dict:
    """Scalars: the mean over micro-batches; per-sample tensors: concatenated
    along the batch; dicts of them (attention maps by layer): merged alike."""
    merged = {}
    for k, first in auxes[0].items():
        items = [a[k] for a in auxes]
        if isinstance(first, dict):
            merged[k] = merge_aux(items)
        elif first.dim() == 0:
            merged[k] = torch.stack(items).mean()
        else:
            merged[k] = torch.cat(items)
    return merged


def detach_aux(aux: dict) -> dict:
    """``aux`` with every tensor, also inside nested dicts, detached."""
    return {k: detach_aux(v) if isinstance(v, dict) else v.detach() for k, v in aux.items()}


def _flat_items(aux: dict, prefix=()):
    for k, v in aux.items():
        if isinstance(v, dict):
            yield from _flat_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def global_aux(aux: dict, n_rows: int, mesh: ProcessMesh) -> dict:
    """One micro-batch's ``aux`` over the whole mesh: the scalars (losses,
    each this rank's part of the global loss) summed over the data ranks in
    one all-reduce, the per-sample tensors gathered in data rank order with the
    padding rows of the slicing dropped (``n_rows``: the micro-batch's rows
    before it)."""
    items = list(_flat_items(aux))
    scalars = [v for _, v in items if v.dim() == 0]
    summed = iter(all_reduce_sum(torch.stack(scalars), mesh).unbind() if scalars else ())
    out = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = next(summed) if v.dim() == 0 else gather_rows(v, mesh)[:n_rows]
    return out


class BaseTrainer:
    """Owns the optimizer, the step count, the dropout generators and the
    mesh (by default the process group's data axis, or one process without
    one). It broadcasts rank 0's parameters, shards the model over the
    mesh's ``model`` axis, then moves the parameters into the optimizer's
    flat buffers. Subclasses define ``loss(batch, training, generator, **options) ->
    (loss, aux)`` with their losses over ``self.mesh``; ``train_step`` and
    ``val_step`` pass their keyword options on to it."""

    def __init__(self, model: torch.nn.Module,
                 learning_rate_schedule: Sequence[Tuple[float, float]],
                 base_rng_seed: int = 42, grad_accumulation: int = 1,
                 mesh: ProcessMesh = None):
        self.model = model
        self.mesh = mesh if mesh is not None else ProcessMesh.current()
        broadcast_module(model, self.mesh)
        shard_model(model, self.mesh)
        self.schedule = learning_rate_schedule
        self.optimizer = make_optimizer(model, self.mesh)
        self.base_rng_seed = int(base_rng_seed)
        self.grad_accumulation = int(grad_accumulation)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def step_generator(self, step: int) -> torch.Generator:
        """The dropout generator of ``step``, seeded from (base seed, step,
        data rank): a step is reproducible, resuming does not replay earlier
        masks, no two data ranks draw the same masks, and the model ranks of
        one data row draw the same ones (their replicated activations must
        stay equal). Rank 0's stream is that of one process."""
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(rank_seed(self.base_rng_seed * 2 ** 32 + int(step),
                                         self.mesh.data_rank))

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
             generator: torch.Generator, **options) -> Tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def shard(self, batch: Dict[str, np.ndarray], n: int) -> List[Tuple[dict, int]]:
        """The global ``batch`` padded to a multiple of the mesh's data size,
        cut into ``n`` micro-batches, and this data rank's slice of each on
        the device, with the micro-batch's rows before slicing."""
        batch = {k: np.asarray(v) for k, v in batch.items()
                 if np.asarray(v).dtype.kind not in 'US'}
        data = self.mesh.data_size
        micro = split_batch(pad_batch_to_multiple(batch, data), n)
        return [(self.to_device(shard_batch(mb, self.mesh.data_rank, data)),
                 next(iter(mb.values())).shape[0]) for mb in micro]

    def _global_aux(self, aux: dict, n_rows: int) -> dict:
        return global_aux(aux, n_rows, self.mesh) if self.mesh.grouped else aux

    def reduce_gradients(self):
        """Sum the gradients over the mesh's data ranks. Every parameter's
        ``.grad`` is a view into the optimizer's flat gradient buffer, which
        the collective takes whole: one reduce-scatter into this rank's
        ZeRO-1 share at ``data`` > 1, one all-reduce at ``data`` 1 in a
        group; no copy in or out. The model ranks need no sum: the sharded
        parameters' gradients are their own, the replicated ones' equal."""
        self.optimizer.reduce_gradients()

    def train_step(self, batch: Dict[str, np.ndarray], **options) -> dict:
        """One Adam update on the mean of the micro-batch gradients (one
        micro-batch unless ``grad_accumulation`` > 1), summed over the mesh's
        data ranks. Returns the detached losses and per-sample outputs of the
        whole batch."""
        micro = self.shard(batch, self.grad_accumulation)
        set_learning_rate(self.optimizer, self.schedule, self.step)
        generator = self.step_generator(self.step)
        self.optimizer.zero_grad()
        auxes = []
        for mb, n_rows in micro:
            loss, aux = self.loss(mb, True, generator, **options)
            (loss / len(micro)).backward()
            auxes.append(self._global_aux(detach_aux(aux), n_rows))
        self.reduce_gradients()
        self.optimizer.step()
        self.step += 1
        return merge_aux(auxes)

    @torch.no_grad()
    def val_step(self, batch: Dict[str, np.ndarray], **options) -> dict:
        """Losses and predictions of the whole batch without dropout and
        without gradients."""
        [(mb, n_rows)] = self.shard(batch, 1)
        _, aux = self.loss(mb, False, None, **options)
        return self._global_aux(aux, n_rows)
