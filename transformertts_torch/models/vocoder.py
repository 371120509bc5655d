"""Vocoder checkpoint loading, the counterpart of ``transformertts_tpu/models/vocoder.py``.

``load_vocoder`` takes a checkpoint of either family the reference's
models are advertised for, ``seungwonpark/melgan`` or ``jik876/hifi-gan``,
and returns the matching generator (``models/melgan.py`` or
``models/hifigan.py``). A HiFi-GAN topology is read from the
``config.json`` beside the checkpoint where there is one (the jik876
release layout), else ``V1_CONFIG`` applies.
"""
import json
import pickle
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from transformertts_torch.models.hifigan import HiFiGANVocoder
from transformertts_torch.models.melgan import MelGANVocoder


def unwrap_torch_checkpoint(path, allow_pickle: bool = False) -> Dict[str, np.ndarray]:
    """A torch checkpoint file → its generator's state dict as numpy arrays.

    Takes a bare state dict, a MelGAN training checkpoint (``{'model_g':
    sd}``) and a HiFi-GAN one (``{'generator': sd}``). It loads with
    ``weights_only=True``, which runs no code from the file: the published
    checkpoints are plain tensor dicts. A file that needs full unpickling (a
    whole pickled ``nn.Module``) is refused unless ``allow_pickle=True``,
    which executes code from the file. A missing or corrupt file raises as
    ``torch.load`` does.
    """
    try:
        blob = torch.load(path, map_location='cpu', weights_only=True)
    except pickle.UnpicklingError as exc:
        if not allow_pickle:
            raise ValueError(
                f'{path} is not a plain tensor checkpoint (weights_only load failed: {exc}). '
                f'If you trust this file, pass allow_pickle=True to load it with full '
                f'unpickling (this executes code from the file).') from exc
        blob = torch.load(path, map_location='cpu', weights_only=False)
    if hasattr(blob, 'state_dict'):
        blob = blob.state_dict()
    if isinstance(blob, dict) and 'model_g' in blob:
        blob = blob['model_g']
    if isinstance(blob, dict) and hasattr(blob.get('generator'), 'keys'):
        blob = blob['generator']
    return {k: v.detach().cpu().numpy() for k, v in blob.items()}


def load_vocoder(path, mel_channels: int = 80, allow_pickle: bool = False, device='cuda'):
    """A MelGAN or HiFi-GAN checkpoint → its generator on ``device`` (the
    card unless the caller names another). A ``conv_pre.`` key marks
    HiFi-GAN."""
    sd = unwrap_torch_checkpoint(path, allow_pickle=allow_pickle)
    if any(k.startswith('conv_pre.') for k in sd):
        cfg_path = Path(path).parent / 'config.json'
        config = json.loads(cfg_path.read_text()) if cfg_path.exists() else None
        return HiFiGANVocoder.from_torch_state_dict(sd, config, mel_channels, device)
    return MelGANVocoder.from_torch_state_dict(sd, mel_channels, device)
