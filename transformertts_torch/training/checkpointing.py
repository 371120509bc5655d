"""Training-state checkpoints, the counterpart of
``transformertts_tpu/training/checkpointing.py``, in its file layout.

``ckpt_{step}.npz`` holds the leaves of the JAX package's ``TrainState``
pytree as ``leaf_%05d``, in its order: the step (int32), the parameters,
then optax's Adam state (count, first moments, second moments) and the
schedule's count, each parameter group in the sorted order of the JAX
parameter paths and in the JAX (Keras) layouts of ``models/persistence.py``.
So a checkpoint written by either package resumes in the other. Files are
written under a temporary name and renamed, so a crash never leaves a torn
checkpoint that looks complete; ``keep_n`` prunes older ones. Over a mesh
(``mesh=``) every rank first gathers the full state with the optimizer's
mesh (parameters over the model group, ZeRO-1's moment shares over the data
group, then the moments over the model group), rank 0 alone writes and
every rank waits at a barrier for it; every rank restores the same file and
keeps its own parts. So a checkpoint moves between any two meshes and
either package.
"""
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from transformertts_torch.models.persistence import params_from_jax, params_to_jax
from transformertts_torch.parallel.tensor_parallel import (full_state_dict, full_tensors,
                                                           local_part)

# fullmatch-anchored: '.tmp_ckpt_<n>.npz', a torn write, is never a checkpoint
_CKPT_RE = re.compile(r'ckpt_(\d+)\.npz')


def _jax_order(flat: Dict[str, np.ndarray]) -> List[str]:
    """The JAX pytree order of parameter paths: dict keys sorted level by level."""
    return sorted(flat, key=lambda path: path.split('/'))


def flatten_state(model, optimizer, step: int) -> Dict[str, np.ndarray]:
    """The leaves of ``ckpt_{step}.npz`` at full width: ``optimizer`` (a
    ``training.state.FlatAdam``) gathers over its mesh, so every rank of a
    mesh calls this alike."""
    mesh = optimizer.mesh
    params = params_to_jax(full_state_dict(model, mesh))
    order = _jax_order(params)
    count, mu, nu = optimizer.moments()
    mu = params_to_jax(full_tensors(model, mu, mesh))
    nu = params_to_jax(full_tensors(model, nu, mesh))
    leaves = ([np.asarray(step, np.int32)] + [params[p] for p in order]
              + [np.asarray(count, np.int32)] + [mu[p] for p in order]
              + [nu[p] for p in order] + [np.asarray(count, np.int32)])
    return {f'leaf_{i:05d}': x for i, x in enumerate(leaves)}


def load_state(flat: Dict[str, np.ndarray], model, optimizer) -> int:
    """Fill ``model`` and ``optimizer`` from flattened leaves (full width);
    returns the step. A tensor-parallel model keeps its model rank's part of
    each sharded parameter and moment, and the optimizer its ZeRO-1 share
    of the moments. With ``optimizer`` None (inference, an unsharded model)
    the Adam moments are read past and dropped."""
    order = _jax_order(params_to_jax(model.state_dict()))
    n = len(order)
    leaves = [flat[f'leaf_{i:05d}'] for i in range(len(flat))]
    if len(leaves) != 3 * n + 3:
        raise ValueError(f'checkpoint has {len(leaves)} leaves; a TrainState of this '
                         f'model with Adam has {3 * n + 3}')
    step, count = int(leaves[0]), int(leaves[n + 1])
    mesh = optimizer.mesh if optimizer is not None else None
    params = dict(model.named_parameters())

    def group(start):   # n leaves from ``start`` as this rank's state dict
        full = params_from_jax(dict(zip(order, leaves[start:start + n])))
        if mesh is None:
            return full
        return {k: local_part(params[k], v, mesh) if k in params else v
                for k, v in full.items()}

    model.load_state_dict(group(1), strict=True)
    if optimizer is None:
        return step
    optimizer.load_moments(count, group(n + 2), group(2 * n + 2))
    return step


def list_checkpoints(directory) -> list:
    directory = Path(directory)
    if not directory.exists():
        return []
    found = [(int(m.group(1)), f) for f in directory.iterdir()
             if (m := _CKPT_RE.fullmatch(f.name))]
    return sorted(found)


def latest_checkpoint(directory) -> Optional[Path]:
    ckpts = list_checkpoints(directory)
    return ckpts[-1][1] if ckpts else None


def save_checkpoint(directory, model, optimizer, step: int, keep_n: int = None,
                    keep_every: int = None, mesh=None) -> Path:
    """Write ckpt_{step}.npz atomically; prune to the ``keep_n`` newest,
    always keeping steps divisible by ``keep_every``. With ``mesh`` (a
    ``parallel.ProcessMesh``) every rank gathers the state, only its rank 0
    writes, and every rank returns once the file is complete."""
    directory = Path(directory)
    path = directory / f'ckpt_{step}.npz'
    leaves = flatten_state(model, optimizer, step)
    if mesh is not None and not mesh.is_main:
        mesh.barrier()
        return path
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f'.tmp_ckpt_{step}.npz'
    for stale in directory.glob('.tmp_ckpt_*.npz'):
        stale.unlink(missing_ok=True)
    with open(tmp, 'wb') as f:
        np.savez(f, **leaves)
    os.replace(tmp, path)
    if keep_n is not None:
        ckpts = list_checkpoints(directory)
        for s, f in (ckpts[:-keep_n] if keep_n > 0 else []):
            if keep_every and s > 0 and s % keep_every == 0:
                continue
            f.unlink(missing_ok=True)
    if mesh is not None:
        mesh.barrier()
    return path


def restore_checkpoint(path, model, optimizer=None) -> int:
    """Load ``path`` into ``model`` and ``optimizer`` (None: the weights
    only); returns its step."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return load_state(flat, model, optimizer)


def restore_latest(directory, model, optimizer=None) -> Optional[int]:
    """Restore the newest checkpoint and return its step, or None if there
    is none."""
    path = latest_checkpoint(directory)
    return None if path is None else restore_checkpoint(path, model, optimizer)
