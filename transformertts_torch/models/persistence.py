"""Self-describing model dirs shared with the JAX package, and the weight bridge.

A model dir is ``config.yaml`` (the constructor config, alphabet and step)
plus ``model_weights.npz`` keyed by the JAX package's ``flatten_params``
paths (``encoder/conv_0/sarn/mha/wq/kernel``, ...), and/or
``model_weights.hdf5`` in the legacy Keras-2 layout the reference TF code
loads. Either package loads a dir the other wrote, a ForwardTransformer's or
an Aligner's, in either format. The hdf5 side goes through
``models/convert.py`` and needs h5py, imported only there: an npz dir is
written and read without it.

Layouts, JAX (Keras) → PyTorch, by leaf:

- Dense ``kernel`` (in, out) → ``weight`` (out, in); ``bias`` → ``bias``
- Conv1D ``kernel`` (width, in, out) → ``weight`` (out, in, width)
- LayerNorm ``gamma`` / ``beta`` → ``weight`` / ``bias``
- Embedding ``table`` (vocab, dim) → ``weight`` (vocab, dim)
- ``pos_encoding_scalar`` (0-d) → ``pos_encoding_scalar``

Transposes are exact, so npz → PyTorch → npz round-trips bit for bit.
"""
import subprocess
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import yaml


def make_config(locals_: dict, kwargs: dict) -> dict:
    """Constructor args are the schema, as in the JAX package."""
    config = {}
    for k, v in locals_.items():
        if k in kwargs or k in ('self', '__class__', 'kwargs'):
            continue
        if isinstance(v, dict):
            config.update(v)
        else:
            config[k] = v
    config.update(kwargs)
    return config


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX ``flatten_params`` dict → PyTorch state dict."""
    state = {}
    for path, value in flat.items():
        *mod, leaf = path.split('/')
        value = np.asarray(value)
        if leaf == 'kernel' and value.ndim == 2:
            leaf, value = 'weight', value.T
        elif leaf == 'kernel' and value.ndim == 3:
            leaf, value = 'weight', value.transpose(2, 1, 0)
        elif leaf in ('gamma', 'table'):
            leaf = 'weight'
        elif leaf == 'beta':
            leaf = 'bias'
        elif leaf not in ('bias', 'pos_encoding_scalar'):
            raise KeyError(f'unknown JAX parameter leaf {path!r}')
        state['.'.join(mod + [leaf])] = torch.from_numpy(value.copy(order='C'))
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """PyTorch state dict → JAX ``flatten_params`` dict (inverse of
    ``params_from_jax``). A module is told apart by its ``weight``: 1-d is a
    LayerNorm, 3-d a Conv1D, 2-d with a bias a Dense, 2-d alone an Embedding."""
    weights = {k[:-len('.weight')]: v for k, v in state.items() if k.endswith('.weight')}
    flat = {}
    for key, value in state.items():
        *mod, leaf = key.split('.')
        prefix = '.'.join(mod)
        value = value.detach().cpu().numpy()
        w = weights.get(prefix)
        if leaf == 'weight':
            if value.ndim == 1:
                leaf = 'gamma'
            elif value.ndim == 3:
                leaf, value = 'kernel', value.transpose(2, 1, 0)
            elif f'{prefix}.bias' in state:
                leaf, value = 'kernel', value.T
            else:
                leaf = 'table'
        elif leaf == 'bias' and w is not None and w.ndim == 1:
            leaf = 'beta'
        flat['/'.join(mod + [leaf])] = value.copy(order='C')
    return flat


WEIGHTS_FORMATS = ('npz', 'hdf5', 'both')


def save_model_dir(model, path, weights_format: str = 'npz') -> Path:
    """Write ``config.yaml`` and the weights under ``path``; the config
    carries ``git describe --always`` as ``git_hash`` where git can tell it,
    as the JAX package's does.

    weights_format: 'npz' (``model_weights.npz``), 'hdf5' (the legacy
    Keras-2 ``model_weights.hdf5`` the reference TF code and the JAX package
    load; needs h5py), or 'both'.
    """
    if weights_format not in WEIGHTS_FORMATS:
        raise ValueError(f'unknown weights_format {weights_format!r}: one of '
                         f'{", ".join(WEIGHTS_FORMATS)}')
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    config = dict(model.config)
    config['alphabet'] = ''.join(model.symbols)
    config['step'] = int(model.step)
    try:
        config['git_hash'] = subprocess.check_output(
            ['git', 'describe', '--always'], stderr=subprocess.DEVNULL).strip().decode()
    except (OSError, subprocess.CalledProcessError):
        pass
    with open(path / 'config.yaml', 'w') as f:
        yaml.safe_dump(config, f, allow_unicode=True)
    if weights_format in ('npz', 'both'):
        np.savez(path / 'model_weights.npz', **params_to_jax(model.state_dict()))
    if weights_format in ('hdf5', 'both'):
        from transformertts_torch.models.convert import write_legacy_h5
        write_legacy_h5(model, path / 'model_weights.hdf5')
    return path


def hdf5_weights(path: Path) -> Path:
    """``model_weights.hdf5``, else the first ``*.hdf5`` then ``*.h5`` in
    sorted order, as the JAX package picks them."""
    path = Path(path)
    canonical = path / 'model_weights.hdf5'
    if canonical.exists():
        return canonical
    candidates = sorted(path.glob('*.hdf5')) + sorted(path.glob('*.h5'))
    if not candidates:
        raise FileNotFoundError(f'no model weights under {path}: neither '
                                f'model_weights.npz nor an hdf5 file')
    return candidates[0]


def read_weights(model, weights) -> Dict[str, np.ndarray]:
    """A weights file of ``model`` → its JAX ``flatten_params`` dict: an
    ``.npz``, or hdf5 weights (legacy Keras-2 or Keras-3 layout, read with
    h5py)."""
    weights = Path(weights)
    if weights.suffix == '.npz':
        with np.load(weights) as data:
            return {k: data[k] for k in data.files}
    try:
        import h5py  # noqa: F401  (the readers of models/convert.py use it)
    except ImportError as e:
        raise ImportError(f'{weights} holds hdf5 weights: reading them needs h5py') from e
    from transformertts_torch.models.convert import read_reference_weights
    return read_reference_weights(model, weights)


def load_model_dir(cls, path, device='cuda'):
    """Rebuild a model of type ``cls`` on ``device`` (the card unless the
    caller names another) from a model dir: ``model_weights.npz`` where it
    is, else its hdf5 weights (``read_weights``). Every weight must fill a
    parameter and every parameter be filled."""
    path = Path(path)
    with open(path / 'config.yaml') as f:
        config = yaml.safe_load(f)
    model = cls(**config)
    npz = path / 'model_weights.npz'
    flat = read_weights(model, npz if npz.exists() else hdf5_weights(path))
    model.load_state_dict(params_from_jax(flat), strict=True)
    model.to(device)
    model.step = int(config.get('step', 0))
    return model
