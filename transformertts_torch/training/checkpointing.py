"""Training-state checkpoints, the counterpart of
``transformertts_tpu/training/checkpointing.py``, in its file layout.

``ckpt_{step}.npz`` holds the leaves of the JAX package's ``TrainState``
pytree as ``leaf_%05d``, in its order: the step (int32), the parameters,
then optax's Adam state (count, first moments, second moments) and the
schedule's count, each parameter group in the sorted order of the JAX
parameter paths and in the JAX (Keras) layouts of ``models/persistence.py``.
So a checkpoint written by either package resumes in the other. Files are
written under a temporary name and renamed, so a crash never leaves a torn
checkpoint that looks complete; ``keep_n`` prunes older ones. Under data
parallelism (``mesh=``) rank 0 alone writes and every rank waits at a
barrier for it; every rank restores the same file.
"""
import os
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from transformertts_torch.models.persistence import params_from_jax, params_to_jax

# fullmatch-anchored: '.tmp_ckpt_<n>.npz', a torn write, is never a checkpoint
_CKPT_RE = re.compile(r'ckpt_(\d+)\.npz')


def _jax_order(flat: Dict[str, np.ndarray]) -> List[str]:
    """The JAX pytree order of parameter paths: dict keys sorted level by level."""
    return sorted(flat, key=lambda path: path.split('/'))


def _adam_moments(model, optimizer):
    """(count, exp_avg state dict, exp_avg_sq state dict); zeros before the
    first update."""
    count, mu, nu = 0, {}, {}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        if state:
            count = int(state['step'])
        mu[name] = state.get('exp_avg', torch.zeros_like(p))
        nu[name] = state.get('exp_avg_sq', torch.zeros_like(p))
    return count, mu, nu


def flatten_state(model, optimizer, step: int) -> Dict[str, np.ndarray]:
    params = params_to_jax(model.state_dict())
    order = _jax_order(params)
    count, mu, nu = _adam_moments(model, optimizer)
    mu, nu = params_to_jax(mu), params_to_jax(nu)
    leaves = ([np.asarray(step, np.int32)] + [params[p] for p in order]
              + [np.asarray(count, np.int32)] + [mu[p] for p in order]
              + [nu[p] for p in order] + [np.asarray(count, np.int32)])
    return {f'leaf_{i:05d}': x for i, x in enumerate(leaves)}


def load_state(flat: Dict[str, np.ndarray], model, optimizer) -> int:
    """Fill ``model`` and ``optimizer`` from flattened leaves; returns the step.
    With ``optimizer`` None (inference) the Adam moments are read past and
    dropped."""
    order = _jax_order(params_to_jax(model.state_dict()))
    n = len(order)
    leaves = [flat[f'leaf_{i:05d}'] for i in range(len(flat))]
    if len(leaves) != 3 * n + 3:
        raise ValueError(f'checkpoint has {len(leaves)} leaves; a TrainState of this '
                         f'model with Adam has {3 * n + 3}')
    step, count = int(leaves[0]), int(leaves[n + 1])

    def group(start):   # n leaves from ``start`` as a state dict
        return params_from_jax(dict(zip(order, leaves[start:start + n])))

    model.load_state_dict(group(1), strict=True)
    if optimizer is None:
        return step
    mu, nu = group(n + 2), group(2 * n + 2)
    optimizer.state.clear()
    if count > 0:
        for name, p in model.named_parameters():
            optimizer.state[p] = {
                'step': torch.tensor(float(count), dtype=torch.float32),
                'exp_avg': mu[name].to(p.device, p.dtype),
                'exp_avg_sq': nu[name].to(p.device, p.dtype)}
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
    ``parallel.ProcessMesh``) only its rank 0 writes, and every rank returns
    once the file is complete."""
    path = Path(directory) / f'ckpt_{step}.npz'
    if mesh is not None:
        if mesh.is_main:
            save_checkpoint(directory, model, optimizer, step, keep_n, keep_every)
        mesh.barrier()
        return path
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f'.tmp_ckpt_{step}.npz'
    for stale in directory.glob('.tmp_ckpt_*.npz'):
        stale.unlink(missing_ok=True)
    with open(tmp, 'wb') as f:
        np.savez(f, **flatten_state(model, optimizer, step))
    os.replace(tmp, path)
    if keep_n is not None:
        ckpts = list_checkpoints(directory)
        for s, f in (ckpts[:-keep_n] if keep_n > 0 else []):
            if keep_every and s > 0 and s % keep_every == 0:
                continue
            f.unlink(missing_ok=True)
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
