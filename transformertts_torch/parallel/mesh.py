"""The ``('data', 'model')`` mesh, the counterpart of
``transformertts_tpu/parallel/mesh.py`` in PyTorch's idiom.

The JAX package names a mesh of devices and lets jit partition each step
over it. Here the mesh is processes, one device each, joined by a
``torch.distributed`` process group (NCCL on cards, gloo on CPU processes
or on ranks that share a card):

- training runs one process a device under ``torchrun``. The world of
  ``data × model`` ranks is laid out row-major, as the JAX package reshapes
  its devices: rank ``r`` is data index ``r // model`` and model index
  ``r % model`` (``ProcessMesh``). ``maybe_initialize_distributed`` brings
  the group and its two kinds of subgroups up from the environment torchrun
  sets. Every rank runs the same seeded data loader; the ranks of one data
  index take the same contiguous slice of each global batch
  (``shard_batch``) and draw the same dropout masks, and the trainer sums
  the gradients over the data group;
- the ``model`` axis is Megatron-style tensor parallelism over the pairs
  ``tp_param_specs`` names (``tp_rules``; ``parallel/tensor_parallel.py``
  shards the modules);
- ZeRO-1 (``zero1_specs``): at ``data`` > 1 each data rank owns a
  contiguous ``zero1_partition`` of the flat optimizer state
  (``training/state.py``);
- in serving, a list of devices (``make_mesh``) over which one process
  spreads each chunk's rows, each device holding a copy of the model
  (``replicate``), as ``shard_params`` replicates the JAX parameters.

No call quietly runs on fewer processes than the config asks for: a mesh
that does not tile the world raises.
"""
import copy
import os
import warnings
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# Megatron pairs, by module path (the JAX package's TP_COLUMN_MODULES and
# TP_ROW_MODULES with '.' for '/'): the column module's output dimension
# shards over 'model', the row module's input dimension, and the partial
# sums are all-reduced before the row module's bias.
TP_COLUMN_MODULES = ('conv.conv_0', 'ffn.d1')
TP_ROW_MODULES = ('conv.conv_1', 'ffn.d2')
COLUMN, ROW = 'column', 'row'


@dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: every device, or every process of the group, over ``model``
    model: int = 1


def _tiling_error(data: int, model: int, n: int, what: str) -> ValueError:
    return ValueError(f'mesh {data}x{model} does not tile {n} {what}')


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Sequence = None) -> List[torch.device]:
    """The devices a serving call spreads each chunk over. The mesh is
    ``devices`` (for example ``['cpu'] * 4``), or by default the first
    ``data × model`` cards (all of them at ``data`` -1), laid out
    ``(data, model)`` row-major. Serving replicates the parameters and
    spreads rows over ``data`` only, as the JAX package's ``_prepare_mesh``
    does, so the devices of one data row would compute the same rows: the
    mesh returned is each data row's first device, one share of the rows
    each. Raises when ``data × model`` does not tile the given devices, or
    when fewer cards are present than it asks for."""
    config = config or MeshConfig()
    model = max(1, config.model)
    if devices is None:
        cards = torch.cuda.device_count()
        data = config.data if config.data > 0 else cards // model
        if data < 1 or data * model > cards:
            raise _tiling_error(data, model, cards, 'CUDA devices')
        devices = [f'cuda:{i}' for i in range(data * model)]
    devices = [torch.device(d) for d in devices]
    data = config.data if config.data > 0 else len(devices) // model
    if data < 1 or data * model != len(devices):
        raise _tiling_error(data, model, len(devices), 'devices')
    return devices[::model]


@dataclass(frozen=True)
class ProcessMesh:
    """This process's place on the training mesh: its ``rank`` of ``size``
    processes, one device each, ``model_size`` of them a data row.
    ``grouped``: a process group is up, and the trainer's collectives run
    through it, also at size 1. ``data_group`` and ``model_group`` are this
    rank's subgroups (None: the whole world)."""
    rank: int = 0
    size: int = 1
    grouped: bool = False
    model_size: int = 1
    data_group: object = field(default=None, compare=False, repr=False)
    model_group: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.model_size < 1 or self.size % self.model_size:
            raise _tiling_error(self.size // max(self.model_size, 1), self.model_size,
                                self.size, 'processes')

    @classmethod
    def current(cls, model: int = 1) -> 'ProcessMesh':
        """The process group's mesh with ``model`` ranks a data row and its
        subgroups (made collectively: every rank calls this alike), or one
        ungrouped process without a group."""
        if not (dist.is_available() and dist.is_initialized()):
            return cls(model_size=model)
        rank, world = dist.get_rank(), dist.get_world_size()
        data_group = model_group = None   # None: the whole world
        if model > 1:
            # every rank makes every subgroup, in one order, and keeps its own
            for m in range(model):
                group = dist.new_group(list(range(m, world, model)))
                data_group = group if rank % model == m else data_group
            for d in range(world // model):
                group = dist.new_group(list(range(d * model, (d + 1) * model)))
                model_group = group if rank // model == d else model_group
        return cls(rank, world, True, model, data_group, model_group)

    @property
    def data_size(self) -> int:
        return self.size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def is_main(self) -> bool:
        """Rank 0: the process that writes logs, audio and checkpoints."""
        return self.rank == 0

    def barrier(self):
        if self.grouped:
            dist.barrier()


def local_device(device) -> torch.device:
    """``device``, with a bare ``cuda`` taken to mean ``cuda:LOCAL_RANK``
    under torchrun."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None and 'LOCAL_RANK' in os.environ:
        return torch.device('cuda', int(os.environ['LOCAL_RANK']))
    return device


def maybe_initialize_distributed(config: dict, device='cuda') -> ProcessMesh:
    """Bring up ``torch.distributed`` from the environment torchrun sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``),
    NCCL for a CUDA ``device`` (the default; without a card it raises) and
    gloo for ``device='cpu'``, and return this rank's place on the config's
    ``mesh: {data, model}``: ``data × model`` must be the world size
    (``data`` -1 takes ``world // model``); any other shape raises. Without
    that environment the process is one rank of one, with no group.
    ``multihost: true`` needs nothing more: torchrun's group spans hosts the
    same way. Safe to call again; every rank calls it alike, since the
    subgroups are made collectively."""
    block = config.get('mesh') or {}
    spec = MeshConfig(data=int(block.get('data', -1)), model=int(block.get('model', 1)))
    launched = 'WORLD_SIZE' in os.environ and 'RANK' in os.environ
    world = int(os.environ['WORLD_SIZE']) if launched else 1
    model = max(1, spec.model)
    data = spec.data if spec.data > 0 else world // model
    if data * model != world:
        raise _tiling_error(data, model, world, f'devices (world size {world})')
    if launched and not dist.is_initialized():
        device = local_device(device)
        if device.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError('maybe_initialize_distributed: no CUDA device for an '
                                   "NCCL group; pass device='cpu' for a gloo group")
            torch.cuda.set_device(device)
        dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                                rank=int(os.environ['RANK']), world_size=world)
    return ProcessMesh.current(model)


def destroy_distributed():
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def pad_batch_to_multiple(batch: Dict[str, np.ndarray], multiple: int) -> dict:
    """Pad the batch axis with all-zero rows up to a multiple of
    ``multiple``. Every masked loss of ``utils/losses.py`` treats such a row
    as padding: it adds nothing to a numerator or a count."""
    def pad(x):
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        return np.concatenate([x, np.zeros((rem,) + x.shape[1:], x.dtype)])
    return {k: pad(v) for k, v in batch.items()}


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Data rank ``rank``'s contiguous slice of the global batch, padded
    first to a multiple of ``world`` data ranks: the part
    ``make_array_from_process_local_data`` places on this process in the
    JAX package."""
    batch = pad_batch_to_multiple(batch, world)
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def all_reduce_sum(tensor: torch.Tensor, mesh: ProcessMesh, group: str = 'data'
                   ) -> torch.Tensor:
    """``tensor`` summed (in place) over the mesh's ``group``: the ``'data'``
    ranks of this model index, or the ``'model'`` ranks of this data row;
    as it is without a process group."""
    if mesh.grouped:
        dist.all_reduce(tensor, group=getattr(mesh, f'{group}_group'))
    return tensor


def gather_rows(tensor: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The data ranks' equal-sized slices of a batch, concatenated in data
    rank order along dim 0; ``tensor`` itself without a group."""
    if not mesh.grouped:
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(mesh.data_size)]
    dist.all_gather(parts, tensor.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def broadcast_module(module: torch.nn.Module, mesh: ProcessMesh):
    """Every rank of the world takes rank 0's parameters and buffers (before
    any tensor-parallel sharding)."""
    if mesh.grouped:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def tp_rules(named_params: Iterable[Tuple[str, torch.Tensor]], model_size: int
             ) -> Dict[str, Tuple[str, Optional[int]]]:
    """The counterpart of ``tp_param_specs``: for each named parameter (a
    PyTorch name, ``encoder.conv_0.conv.conv_0.weight``), its mode and the
    dimension sharded over ``model``: ``('column', 0)``, ``('row', 1)`` or
    ``('replicated', None)``. A parameter is matched by the last two parts
    of its module path, never by its shape. PyTorch stores a Dense weight
    (out, in) and a Conv1D's (out, in, width), so a column module shards the
    weight's dim 0 (JAX: its kernel's last) and its bias with it; a row
    module its weight's dim 1 (JAX: second to last), its bias replicated. A
    matched dimension that does not divide ``model_size`` stays replicated,
    with a warning."""
    rules = {}
    for name, p in named_params:
        *module, leaf = name.split('.')
        module = '.'.join(module[-2:])
        mode = (COLUMN if module in TP_COLUMN_MODULES else
                ROW if module in TP_ROW_MODULES else None)
        dim = {COLUMN: 0, ROW: 1}.get(mode)
        if model_size <= 1 or mode is None or p.dim() <= dim:   # p.dim() 1: a row bias
            rules[name] = ('replicated', None)
        elif p.shape[dim] % model_size:
            if leaf == 'weight':
                warnings.warn(f'TP: {name} dim {p.shape[dim]} does not divide model '
                              f'axis {model_size}; replicating')
            rules[name] = ('replicated', None)
        else:
            rules[name] = (mode, dim)
    return rules


def zero1_partition(n: int, data_size: int, data_rank: int) -> Tuple[int, int]:
    """ZeRO-1's share of a flat state of ``n`` elements: data rank
    ``data_rank`` owns ``[start, stop)``, ``ceil(n / data_size)`` elements of
    the state padded to ``data_size`` such shares (the last may own padding
    only). The counterpart of ``zero1_specs``, over one flat buffer in place
    of each moment's first divisible axis."""
    chunk = -(-n // data_size)
    return data_rank * chunk, (data_rank + 1) * chunk


def replicate(module: torch.nn.Module, devices: Sequence[torch.device]) -> list:
    """One copy of ``module`` a device for serving: the module itself where it
    already lies, a deep copy moved there elsewhere. ``module`` is never
    moved."""
    home = next(module.parameters()).device
    copies = {}
    for device in devices:
        if device not in copies:
            copies[device] = (module if device == home
                              else copy.deepcopy(module).to(device))
    return [copies[d] for d in devices]
