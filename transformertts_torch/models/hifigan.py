"""HiFi-GAN vocoder in PyTorch, the counterpart of ``transformertts_tpu/models/hifigan.py``.

The ``jik876/hifi-gan`` generator with that repo's module names: conv_pre →
for each stage [LeakyReLU(0.1) → ConvTranspose1d upsample → the average of
the stage's resblocks] → LeakyReLU(0.01) → conv_post → tanh. The slope
before conv_post is torch's ``F.leaky_relu`` default, as in the original
code. Resblock "1" runs a dilated conv then a unit conv for each dilation
(``convs1``, ``convs2``), resblock "2" one dilated conv (``convs``). Every
conv is zero-padded. The topology comes from the checkpoint's
``config.json`` (``V1_CONFIG`` where there is none); weight-norm pairs are
folded at load time, so a checkpoint loads by name, shape-checked against
the config.
"""
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from transformertts_torch.models.melgan import (conv_transpose_weight_from_jax,
                                                conv_weight_from_jax, fold_weight_norm,
                                                init_convs, load_arrays, mel_batch)

LRELU_SLOPE = 0.1

V1_CONFIG = {
    'resblock': '1',
    'upsample_rates': [8, 8, 2, 2],
    'upsample_kernel_sizes': [16, 16, 4, 4],
    'upsample_initial_channel': 512,
    'resblock_kernel_sizes': [3, 7, 11],
    'resblock_dilation_sizes': [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}


def _padding(k: int, dilation: int = 1) -> int:
    return (k * dilation - dilation) // 2


class ResBlock1(nn.Module):

    def __init__(self, channels: int, kernel: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(channels, channels, kernel, dilation=d,
                                              padding=_padding(kernel, d)) for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(channels, channels, kernel,
                                              padding=_padding(kernel)) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):

    def __init__(self, channels: int, kernel: int, dilations: Sequence[int]):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv1d(channels, channels, kernel, dilation=d,
                                             padding=_padding(kernel, d)) for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANVocoder(nn.Module):

    def __init__(self, mel_channels: int = 80, config: dict = None):
        super().__init__()
        cfg = {**V1_CONFIG, **(config or {})}
        self.mel_channels = mel_channels
        self.resblock_type = str(cfg['resblock'])
        if self.resblock_type not in ('1', '2'):
            raise ValueError(f'resblock must be "1" or "2", got {cfg["resblock"]!r}')
        self.upsample_rates = list(cfg['upsample_rates'])
        self.upsample_kernel_sizes = list(cfg['upsample_kernel_sizes'])
        self.initial_channel = int(cfg['upsample_initial_channel'])
        self.resblock_kernel_sizes = list(cfg['resblock_kernel_sizes'])
        self.resblock_dilation_sizes = [list(d) for d in cfg['resblock_dilation_sizes']]
        self.hop_length = int(np.prod(self.upsample_rates))
        block = ResBlock1 if self.resblock_type == '1' else ResBlock2
        ch = self.initial_channel
        self.conv_pre = nn.Conv1d(mel_channels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(self.upsample_rates, self.upsample_kernel_sizes):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u, padding=(k - u) // 2))
            ch //= 2
            for rk, dilations in zip(self.resblock_kernel_sizes, self.resblock_dilation_sizes):
                self.resblocks.append(block(ch, rk, dilations))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    @property
    def device(self) -> torch.device:
        return self.conv_pre.weight.device

    def init_params(self, generator: torch.Generator) -> 'HiFiGANVocoder':
        """Random weights with the JAX package's initializer (a CPU generator;
        move the module afterwards)."""
        init_convs(self, generator)
        return self

    def forward(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """(B, T, mel_channels) normalized log-mel, any float dtype → float32
        (B, T·hop) waveform in [-1, 1]."""
        x = self.conv_pre(mel_btc.float().transpose(1, 2))
        n = len(self.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            xs = self.resblocks[i * n](x)
            for j in range(1, n):
                xs = xs + self.resblocks[i * n + j](x)
            x = xs / n
        x = F.leaky_relu(x)  # slope 0.01, torch's default, as the original generator
        return torch.tanh(self.conv_post(x))[:, 0]

    @torch.inference_mode()
    def inference(self, mel) -> np.ndarray:
        """(C, T) or (B, C, T) normalized log-mel (numpy) → float32 waveform
        (T·hop,) or (B, T·hop), computed on the module's device."""
        mel, squeeze = mel_batch(mel, self.mel_channels)
        wav = self(torch.as_tensor(mel.transpose(0, 2, 1), device=self.device)).cpu().numpy()
        return wav[0] if squeeze else wav

    # ------------------------------------------------------------ conversion

    @classmethod
    def from_torch_state_dict(cls, state_dict, config: dict = None, mel_channels: int = 80,
                              device='cuda') -> 'HiFiGANVocoder':
        """A ``jik876/hifi-gan`` generator state dict → the module on
        ``device`` (the card unless the caller names another). ``config``:
        the checkpoint's config.json as a dict, ``V1_CONFIG`` where None;
        every tensor is checked by name and shape against it."""
        model = cls(mel_channels, config)
        load_arrays(model, fold_weight_norm(state_dict))
        return model.to(device)

    @classmethod
    def from_torch_checkpoint(cls, path, config: dict = None, mel_channels: int = 80,
                              device='cuda') -> 'HiFiGANVocoder':
        """A checkpoint file (``{'generator': sd}`` training checkpoints or a
        bare state dict) → the module on ``device``."""
        from transformertts_torch.models.vocoder import unwrap_torch_checkpoint
        return cls.from_torch_state_dict(unwrap_torch_checkpoint(path), config, mel_channels,
                                         device)

    @classmethod
    def from_jax_params(cls, params: dict, config: dict = None,
                        device='cuda') -> 'HiFiGANVocoder':
        """The JAX package's ``HiFiGANVocoder.params`` (numpy or JAX leaves)
        of the topology ``config`` → the module on ``device``."""
        model = cls(np.shape(params['conv_pre']['w'])[1], config)
        sd = {}
        for name in ('conv_pre', 'conv_post'):
            sd[f'{name}.weight'] = conv_weight_from_jax(params[name]['w'])
            sd[f'{name}.bias'] = np.asarray(params[name]['b'])
        for i, p in enumerate(params['ups']):
            sd[f'ups.{i}.weight'] = conv_transpose_weight_from_jax(p['w'])
            sd[f'ups.{i}.bias'] = np.asarray(p['b'])
        # the JAX package keeps a type-2 block's convs as its convs1
        names = (('convs1', 'convs1'), ('convs2', 'convs2')) if model.resblock_type == '1' \
            else (('convs', 'convs1'),)
        for i, blk in enumerate(params['resblocks']):
            for name, key in names:
                for j, p in enumerate(blk[key]):
                    sd[f'resblocks.{i}.{name}.{j}.weight'] = conv_weight_from_jax(p['w'])
                    sd[f'resblocks.{i}.{name}.{j}.bias'] = np.asarray(p['b'])
        load_arrays(model, sd)
        return model.to(device)
