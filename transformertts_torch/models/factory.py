"""Published and custom model loading, the counterpart of
``transformertts_tpu/models/factory.py``.

``tts_ljspeech(step)`` finds the published LJSpeech ForwardTransformer:

1. ``$TRANSFORMERTTS_MODELS_DIR/<name>`` where that variable is set;
2. ``~/.cache/transformertts_tpu/models/<name>``, the JAX package's own
   cache, so one dir placed once serves both packages;
3. else it downloads the reference's release archive into the first of
   those dirs and reads its hdf5 weights (``models/convert.py``, h5py).

A model dir holds ``config.yaml`` and ``model_weights.npz`` or hdf5
weights.
"""
import os
import urllib.request
import zipfile
from pathlib import Path

import yaml

from transformertts_torch.models import persistence
from transformertts_torch.models.forward_tts import ForwardTransformer

_REMOTE_DIR = ('https://public-asai-dl-models.s3.eu-central-1.amazonaws.com/'
               'TransformerTTS/api_weights/bdf06b9_ljspeech/')


def _cache_dirs() -> list:
    """Lookup order: $TRANSFORMERTTS_MODELS_DIR (if set), then the home
    cache. A download lands in the first entry."""
    dirs = []
    env = os.environ.get('TRANSFORMERTTS_MODELS_DIR')
    if env:
        dirs.append(Path(env))
    dirs.append(Path.home() / '.cache' / 'transformertts_tpu' / 'models')
    return dirs


def tts_ljspeech(step: str = '95000', device='cuda') -> ForwardTransformer:
    """The published LJSpeech ForwardTransformer at ``step`` on ``device``
    (the card unless the caller names another)."""
    name = f'bdf06b9_ljspeech_step_{step}'
    for cache in _cache_dirs():
        if (cache / name).exists():
            return ForwardTransformer.load_model(cache / name, device)
    cache = _cache_dirs()[0]
    cache.mkdir(parents=True, exist_ok=True)
    zip_path = cache / f'{name}.zip'
    url = _REMOTE_DIR + f'{name}.zip'
    try:
        urllib.request.urlretrieve(url, zip_path)
    except OSError as e:  # URLError and HTTPError are OSErrors
        raise RuntimeError(
            f'pretrained model {name} is not cached at {cache / name} and the download from '
            f'{url} failed ({e}). Place the model dir under $TRANSFORMERTTS_MODELS_DIR to '
            f'use it offline.') from e
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(cache)
    return ForwardTransformer.load_model(cache / name, device)


# the JAX factory's name for loading a ForwardTransformer model dir (npz or
# hdf5 weights) onto a device
load_model_dir = ForwardTransformer.load_model


def _custom(model_cls, config_path, weights_path, device):
    with open(config_path) as f:
        config = yaml.safe_load(f)
    model = model_cls(**config)
    flat = persistence.read_weights(model, weights_path)
    model.load_state_dict(persistence.params_from_jax(flat), strict=True)
    return model.to(device), config


def tts_custom(config_path, weights_path, device='cuda'):
    """(ForwardTransformer, config) from a config YAML and a weights file
    (``.npz`` of either package, or hdf5), on ``device``."""
    return _custom(ForwardTransformer, config_path, weights_path, device)


def aligner_custom(config_path, weights_path, device='cuda'):
    """(Aligner, config) from a config YAML and a weights file (``.npz`` of
    either package, or hdf5), on ``device``."""
    from transformertts_torch.models.aligner import Aligner
    return _custom(Aligner, config_path, weights_path, device)
