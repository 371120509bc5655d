"""Tensor parallelism over the mesh's ``model`` axis: the port's
counterpart of the JAX package's ``tp_param_specs`` shardings, which jit
partitions for it.

``shard_model`` keeps this model rank's part of each Megatron pair that
``parallel.mesh.tp_rules`` names (``conv.conv_0`` + ``conv.conv_1`` in
``CNNResNorm``, ``ffn.d1`` + ``ffn.d2`` in ``FFNResNorm``). Only the inner
activation stands between the two modules of a pair, so:

- the column module (output features sharded, bias with them) takes its
  input through ``copy_to_model_group``: the identity forward, and in
  backward the sum over the model group of each rank's part of the input's
  gradient;
- the row module (input features sharded) sums its partial products over
  the model group with ``reduce_from_model_group`` (identity backward) and
  only then adds its bias, which every rank holds whole.

Everything else (attention, LayerNorms, embeddings, predictors, the
dropout after the row module) runs replicated on the model ranks of a data
row, on the same rows with the same dropout masks, so their gradients agree
without a collective. Each sharded parameter carries ``tp_dim``, the
dimension it was cut along; ``full_state_dict`` and ``unsharded`` gather
them back for checkpoints and model dirs.
"""
import functools
from typing import Dict

import torch
import torch.distributed as dist

from transformertts_torch.nn import core
from transformertts_torch.parallel.mesh import (COLUMN, ROW, ProcessMesh, all_reduce_sum,
                                                tp_rules)

# each column module's row partner, by the last part of the module path
_PARTNERS = {'conv_0': 'conv_1', 'd1': 'd2'}


class _CopyToModelGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.mesh, 'model'), None


class _ReduceFromModelGroup(torch.autograd.Function):
    """The partial products summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x.contiguous().clone(), mesh, 'model')

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, mesh)


def reduce_from_model_group(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    return _ReduceFromModelGroup.apply(x, mesh)


def is_sharded(model: torch.nn.Module) -> bool:
    return any(hasattr(p, 'tp_dim') for p in model.parameters())


def shard_model(model: torch.nn.Module, mesh: ProcessMesh) -> torch.nn.Module:
    """Cut every parameter ``tp_rules`` shards down to this model rank's
    contiguous part, in place, and wire the two collectives into the pairs'
    modules. Call it after every rank holds the same full parameters
    (``broadcast_module``). Inert at ``model_size`` 1; raises on a model
    already sharded, or on a column module whose row partner stays whole
    (its output would be a partial product)."""
    if mesh.model_size == 1:
        return model
    if is_sharded(model):
        raise ValueError('shard_model: the model is already sharded')
    rules = tp_rules(model.named_parameters(), mesh.model_size)
    modules = dict(model.named_modules())
    sharded = {}
    for name, (mode, dim) in rules.items():
        if mode in (COLUMN, ROW) and name.endswith('.weight'):
            sharded[name[:-len('.weight')]] = mode
    for path, mode in sharded.items():
        if mode == COLUMN:
            parent, _, leaf = path.rpartition('.')
            partner = f'{parent}.{_PARTNERS[leaf]}'
            if sharded.get(partner) != ROW:
                raise ValueError(f'shard_model: {path} is column-parallel but {partner} '
                                 f'is not row-parallel')
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, (mode, dim) in rules.items():
            if dim is None:
                continue
            p = params[name]
            size = p.shape[dim] // mesh.model_size
            p.data = p.data.narrow(dim, mesh.model_rank * size, size).contiguous()
            p.tp_dim = dim
    for path, mode in sharded.items():
        module = modules[path]
        if not isinstance(module, (core.Dense, core.Conv1D)):
            raise ValueError(f'shard_model: {path} is a {type(module).__name__}, not a '
                             f'Dense or Conv1D')
        if mode == COLUMN:
            module.tp_input = functools.partial(copy_to_model_group, mesh=mesh)
        else:
            module.tp_partial_sum = functools.partial(reduce_from_model_group, mesh=mesh)
    return model


def gather_model_dim(tensor: torch.Tensor, dim: int, mesh: ProcessMesh) -> torch.Tensor:
    """The model ranks' parts of a tensor cut along ``dim``, joined in
    model-rank order (a collective over the model group)."""
    parts = [torch.empty_like(tensor) for _ in range(mesh.model_size)]
    dist.all_gather(parts, tensor.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def full_tensors(model: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                 mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """``tensors`` (keyed by the model's parameter names and shaped as its
    local parameters: the parameters themselves, or Adam moments) with every
    sharded one gathered to full width. A collective over the model group:
    every rank calls it."""
    params = dict(model.named_parameters())
    out = {}
    for name, t in tensors.items():
        dim = getattr(params.get(name), 'tp_dim', None)
        out[name] = t if dim is None else gather_model_dim(t, dim, mesh)
    return out


def full_state_dict(model: torch.nn.Module, mesh: ProcessMesh) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` at full width (every rank calls it)."""
    if not is_sharded(model):
        return model.state_dict()
    return full_tensors(model, model.state_dict(), mesh)


def local_part(param: torch.Tensor, full: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """This model rank's part of ``full``, a full-width tensor of the
    parameter ``param``: ``full`` itself for a replicated one."""
    dim = getattr(param, 'tp_dim', None)
    if dim is None:
        return full
    size = full.shape[dim] // mesh.model_size
    return full.narrow(dim, mesh.model_rank * size, size)


def unsharded(model: torch.nn.Module, mesh: ProcessMesh) -> torch.nn.Module:
    """``model`` itself when it is not sharded; else a copy on the CPU at
    full width, with its step (every rank calls it: it gathers)."""
    if not is_sharded(model):
        return model
    state = {k: v.cpu() for k, v in full_state_dict(model, mesh).items()}
    full = type(model)(**model.config)
    full.load_state_dict(state, strict=True)
    full.step = model.step
    return full
