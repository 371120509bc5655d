"""Optimizer of the training state, the counterpart of
``transformertts_tpu/training/state.py``.

Adam with β (0.9, 0.98) and ε 1e-9, ε added outside the square root as optax
adds it (``torch.optim.Adam`` does the same). The learning rate is the
piecewise-linear schedule of the config, evaluated at the number of updates
already taken and set before every update, which is the step optax's
schedule sees. The training state is the model's parameters, this
optimizer's moments and the step count; ``training/checkpointing.py`` stores
it in the JAX package's layout.

``FlatAdam`` keeps the model's parameters, and their gradients, as views
into one flat buffer per dtype, so the mesh's collectives take each buffer
whole and no gradient is copied in or out. ZeRO-1, the JAX package's
``zero1_specs``: at ``data`` > 1 each data rank owns the contiguous share
``parallel.mesh.zero1_partition`` gives it, keeps the Adam moments of that
share only, reduce-scatters the gradients into it, updates it and
all-gathers the updated parameters; at ``data`` 1 the buffer is reduced
whole (in a group) and updated whole. The arithmetic of every element is
``torch.optim.Adam``'s either way.
"""
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

from transformertts_torch.parallel.mesh import ProcessMesh, zero1_partition
from transformertts_torch.utils.scheduling import piecewise_linear_schedule


class _FlatGroup:
    """The parameters of one dtype: ``flat`` and ``grad`` hold them end to
    end, padded to ``data_size`` equal shares; ``shard`` is this data
    rank's share of ``flat`` (what Adam updates), its ``.grad`` the same
    share of ``grad``."""

    def __init__(self, named: Sequence[Tuple[str, torch.nn.Parameter]], mesh: ProcessMesh):
        n = sum(p.numel() for _, p in named)
        self.start, self.stop = zero1_partition(n, mesh.data_size, mesh.data_rank)
        first = named[0][1]
        self.flat = torch.zeros(mesh.data_size * (self.stop - self.start), dtype=first.dtype,
                                device=first.device)
        self.grad = torch.zeros_like(self.flat)
        self.offsets = {}
        offset = 0
        with torch.no_grad():
            for name, p in named:
                k = p.numel()
                self.flat[offset:offset + k].copy_(p.reshape(-1))
                p.data = self.flat[offset:offset + k].view_as(p)
                p.grad = self.grad[offset:offset + k].view_as(p)
                self.offsets[name] = (offset, p.shape)
                offset += k
        self.shard = self.flat[self.start:self.stop]
        self.shard.grad = self.grad[self.start:self.stop]

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``flat`` (laid out as ``self.flat``) cut into one view a parameter."""
        return {name: flat[o:o + shape.numel()].view(shape)
                for name, (o, shape) in self.offsets.items()}

    def share(self, by_name: Dict[str, torch.Tensor]) -> torch.Tensor:
        """This data rank's share of the flat layout of ``by_name`` (one
        tensor a parameter, shaped as it)."""
        flat = torch.zeros_like(self.flat)
        for name, view in self.views(flat).items():
            view.copy_(by_name[name])
        return flat[self.start:self.stop].clone()


class FlatAdam:
    """Adam over ``model``'s parameters held in flat buffers, ZeRO-1 over
    ``mesh``'s data axis (see the module docstring). Construct it after the
    model is on its device and sharded: it re-points every parameter's data
    and ``.grad`` into its buffers. ``param_groups`` are Adam's, where
    ``set_learning_rate`` writes the rate."""

    def __init__(self, model: torch.nn.Module, mesh: ProcessMesh = None,
                 beta_1: float = 0.9, beta_2: float = 0.98, eps: float = 1e-9):
        self.mesh = mesh if mesh is not None else ProcessMesh()
        named = list(model.named_parameters())
        self.groups = [_FlatGroup([(n, p) for n, p in named if p.dtype == dtype], self.mesh)
                       for dtype in dict.fromkeys(p.dtype for _, p in named)]
        self.adam = torch.optim.Adam([g.shard for g in self.groups], lr=0.0,
                                     betas=(beta_1, beta_2), eps=eps)
        self.param_groups = self.adam.param_groups

    def zero_grad(self):
        """Zero the flat gradients in place: the parameters' ``.grad`` stay
        views into them, which backward accumulates into."""
        for g in self.groups:
            g.grad.zero_()

    def reduce_gradients(self):
        """Sum each flat gradient buffer over the mesh's data group in one
        collective: at ``data`` > 1 reduce-scattered into this rank's share
        (the rest of the buffer keeps this rank's own gradients), at
        ``data`` 1 all-reduced whole. Nothing without a process group."""
        if not self.mesh.grouped:
            return
        for g in self.groups:
            if self.mesh.data_size > 1:
                dist.reduce_scatter_tensor(g.shard.grad, g.grad, group=self.mesh.data_group)
            else:
                dist.all_reduce(g.grad, group=self.mesh.data_group)

    def step(self):
        """Adam on this rank's share of each buffer; at ``data`` > 1 the
        updated shares are then all-gathered, so every rank holds the whole
        updated parameters."""
        self.adam.step()
        if self.mesh.grouped and self.mesh.data_size > 1:
            for g in self.groups:
                dist.all_gather_into_tensor(g.flat, g.shard, group=self.mesh.data_group)

    def moments(self) -> Tuple[int, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(update count, first moments, second moments), one tensor a
        parameter shaped as this rank's parameter (zeros before the first
        update). At ``data`` > 1 each share is all-gathered over the data
        group: every rank calls it."""
        count, mu, nu = 0, {}, {}
        for g in self.groups:
            state = self.adam.state.get(g.shard, {})
            if state:
                count = int(state['step'])
            for key, out in (('exp_avg', mu), ('exp_avg_sq', nu)):
                share = state.get(key, torch.zeros_like(g.shard))
                if self.mesh.grouped and self.mesh.data_size > 1:
                    flat = torch.empty_like(g.flat)
                    dist.all_gather_into_tensor(flat, share, group=self.mesh.data_group)
                else:
                    flat = share
                out.update(g.views(flat))
        return count, mu, nu

    def load_moments(self, count: int, mu: Dict[str, torch.Tensor],
                     nu: Dict[str, torch.Tensor]):
        """Take the update count and this rank's share of the moments ``mu``
        and ``nu`` (one tensor a parameter, shaped as this rank's
        parameter); ``count`` 0 clears them."""
        self.adam.state.clear()
        if count == 0:
            return
        for g in self.groups:
            self.adam.state[g.shard] = {
                'step': torch.tensor(float(count), dtype=torch.float32),
                'exp_avg': g.share(mu).to(g.flat.device),
                'exp_avg_sq': g.share(nu).to(g.flat.device)}


def make_optimizer(model: torch.nn.Module, mesh: ProcessMesh = None, beta_1: float = 0.9,
                   beta_2: float = 0.98, eps: float = 1e-9) -> FlatAdam:
    """Adam over ``model``'s parameters; ``set_learning_rate`` sets its rate
    each step."""
    return FlatAdam(model, mesh, beta_1, beta_2, eps)


def set_learning_rate(optimizer, schedule: Sequence[Tuple[float, float]], step: int) -> float:
    """Set and return the schedule's rate at ``step`` updates taken."""
    lr = piecewise_linear_schedule(step, schedule)
    for group in optimizer.param_groups:
        group['lr'] = lr
    return lr
