"""Data parallelism over the ``data`` axis, the counterpart of
``transformertts_tpu/parallel/mesh.py`` in PyTorch's idiom.

The JAX package names a ``('data', 'model')`` mesh of devices and lets jit
partition each step over it. Here the ``data`` axis is two things:

- in training, one process a device under ``torchrun``, joined by a
  ``torch.distributed`` process group (NCCL on cards, gloo on CPU
  processes). Every process runs the same seeded data loader and takes its
  contiguous slice of each global batch (``shard_batch``); the trainer sums
  the gradients over the group. ``ProcessMesh`` is this process's place in
  it, and ``maybe_initialize_distributed`` brings it up from the
  environment torchrun sets;
- in serving, a list of devices (``make_mesh``) over which one process
  spreads each chunk's rows, each device holding a copy of the model
  (``replicate``), as ``shard_params`` replicates the JAX parameters.

The ``model`` axis (tensor parallelism, ``tp_param_specs``) and ZeRO-1
(``zero1_specs``) are not ported yet: a config that asks for ``model`` > 1
raises. No call quietly runs on fewer devices or processes than the config
asks for.
"""
import copy
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: every device, or every process of the group
    model: int = 1

    def __post_init__(self):
        if self.model > 1:
            raise NotImplementedError(
                f'mesh model={self.model}: tensor parallelism (the model axis, '
                f'tp_param_specs) and ZeRO-1 are not ported to PyTorch yet; '
                f'use model: 1')


def _tiling_error(data: int, model: int, n: int, what: str) -> ValueError:
    return ValueError(f'mesh {data}x{model} does not tile {n} {what}')


def make_mesh(config: Optional[MeshConfig] = None,
              devices: Sequence = None) -> List[torch.device]:
    """The devices a serving call spreads each chunk over: ``devices``
    (for example ``['cpu', 'cpu']``), or by default the first ``data`` cards
    (all of them at ``data`` -1). Raises when ``data`` does not tile the
    given devices, or when fewer cards are present than it asks for."""
    config = config or MeshConfig()
    if devices is None:
        cards = torch.cuda.device_count()
        data = config.data if config.data > 0 else cards
        if data < 1 or data > cards:
            raise _tiling_error(max(data, 1), config.model, cards, 'CUDA devices')
        devices = [f'cuda:{i}' for i in range(data)]
    devices = [torch.device(d) for d in devices]
    data = config.data if config.data > 0 else len(devices)
    if data != len(devices) or not devices:
        raise _tiling_error(data, config.model, len(devices), 'devices')
    return devices


@dataclass(frozen=True)
class ProcessMesh:
    """This process's place on the data axis of training: its ``rank`` of
    ``size`` processes, one device each. ``grouped``: a process group is up,
    and the trainer's collectives run through it, also at size 1."""
    rank: int = 0
    size: int = 1
    grouped: bool = False

    @classmethod
    def current(cls) -> 'ProcessMesh':
        """The process group's mesh, or one ungrouped process without one."""
        if dist.is_available() and dist.is_initialized():
            return cls(dist.get_rank(), dist.get_world_size(), True)
        return cls()

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
    gloo for ``device='cpu'``, and check the config's
    ``mesh.data`` against the world size (-1 takes the world size; any
    other mismatch raises). Without that environment the process is one
    rank of one, with no group. ``multihost: true`` needs nothing more:
    torchrun's group spans hosts the same way. Safe to call again."""
    block = config.get('mesh') or {}
    spec = MeshConfig(data=int(block.get('data', -1)), model=int(block.get('model', 1)))
    launched = 'WORLD_SIZE' in os.environ and 'RANK' in os.environ
    world = int(os.environ['WORLD_SIZE']) if launched else 1
    if spec.data > 0 and spec.data != world:
        raise _tiling_error(spec.data, spec.model, world,
                            f'devices (world size {world})')
    if launched and not dist.is_initialized():
        device = local_device(device)
        if device.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError('maybe_initialize_distributed: no CUDA device for an '
                                   "NCCL group; pass device='cpu' for a gloo group")
            torch.cuda.set_device(device)
        dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo',
                                rank=int(os.environ['RANK']), world_size=world)
    return ProcessMesh.current()


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
    """This rank's contiguous slice of the global batch, padded first to a
    multiple of ``world``: the part ``make_array_from_process_local_data``
    places on this process in the JAX package."""
    batch = pad_batch_to_multiple(batch, world)
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def all_reduce_sum(tensor: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """``tensor`` summed over the mesh's processes (in place), or as it is
    without a group."""
    if mesh.grouped:
        dist.all_reduce(tensor)
    return tensor


def gather_rows(tensor: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The ranks' equal-sized slices of a batch, concatenated in rank order
    along dim 0; ``tensor`` itself without a group."""
    if not mesh.grouped:
        return tensor
    parts = [torch.empty_like(tensor) for _ in range(mesh.size)]
    dist.all_gather(parts, tensor.contiguous())
    return torch.cat(parts)


def broadcast_module(module: torch.nn.Module, mesh: ProcessMesh):
    """Every rank takes rank 0's parameters and buffers."""
    if mesh.grouped:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


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
