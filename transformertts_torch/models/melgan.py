"""MelGAN vocoder in PyTorch, the counterpart of ``transformertts_tpu/models/melgan.py``.

The generator of the ``seungwonpark/melgan`` LJSpeech checkpoint, with that
repo's module tree (``generator``, one ``nn.Sequential``):
ReflectionPad(3) → Conv1d(mel_channels → base, k7) → for each upsample
rate r: LeakyReLU(0.2) → ConvTranspose1d(k 2r, stride r, pad r//2) →
ResStack (dilations 1/3/9, each block with a 1×1 shortcut) → LeakyReLU →
ReflectionPad(3) → Conv1d(→ 1, k7) → tanh, on ``(mel + 5) / 5``. The
checkpoint's weight-norm ``weight_g``/``weight_v`` pairs are folded into
plain weights at load time (weight norm is a training-time
reparameterization), so the module holds plain ``Conv1d`` and
``ConvTranspose1d`` weights and a checkpoint loads by name.

``forward`` takes the ForwardTransformer's (B, T, mel_channels) normalized
log-mel; ``inference`` takes the reference notebook's (mel_channels, T) or
(B, mel_channels, T), appends 10 frames of silence and trims their
``10·hop`` samples, which cuts the generator's edge artifact.

``nn.ReflectionPad1d`` refuses a pad as long as its input, where the JAX
package's ``jnp.pad(mode='reflect')`` does not: the first pad (3) needs at
least 4 frames. ``inference``'s 10 appended frames and the serving path's
128-frame buckets keep every call above that.
"""
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

LRELU_SLOPE = 0.2
LOG_MEL_SILENCE = float(np.log(1e-5))  # -11.5129..., a silent bin's log-mel
SILENCE_FRAMES = 10  # appended by ``inference``, and their samples trimmed


def fold_weight_norm(state_dict) -> Dict[str, np.ndarray]:
    """A torch state dict (tensors or arrays) → float32 arrays, each
    weight-norm (``weight_g``, ``weight_v``) pair folded into ``weight`` =
    g·v/‖v‖, the norm over every axis but the first (``weight_norm``'s dim 0)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    out = {}
    for key, value in sd.items():
        if key.endswith('.weight_g'):
            continue
        if key.endswith('.weight_v'):
            prefix = key[:-len('.weight_v')]
            norm = np.sqrt((value ** 2).sum(axis=tuple(range(1, value.ndim)), keepdims=True))
            out[f'{prefix}.weight'] = (sd[f'{prefix}.weight_g'] * value
                                       / np.maximum(norm, 1e-12)).astype(np.float32)
        else:
            out[key] = value.astype(np.float32)
    return out


def conv_weight_from_jax(w) -> np.ndarray:
    """JAX Conv1D kernel (k, in, out) → torch ``Conv1d.weight`` (out, in, k)."""
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(2, 1, 0))


def conv_transpose_weight_from_jax(w) -> np.ndarray:
    """JAX transposed-conv kernel, stored time-flipped as (k, in, out) (a
    conv over the stride-dilated input) → torch ``ConvTranspose1d.weight``
    (in, out, k)."""
    return np.ascontiguousarray(np.asarray(w, np.float32)[::-1].transpose(1, 2, 0))


def load_arrays(module: nn.Module, arrays: Dict[str, np.ndarray]):
    """Load {name: array} into ``module``: every name must be a parameter of
    the module's shape and every parameter must be given (raises otherwise)."""
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in arrays.items()}, strict=True)


def init_convs(module: nn.Module, generator: torch.Generator):
    """The JAX package's initializer for every conv: weights uniform in
    ±1/sqrt(in_channels·k), biases zero, drawn from ``generator`` (CPU)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
                scale = 1.0 / np.sqrt(m.in_channels * m.kernel_size[0])
                w = torch.rand(m.weight.shape, generator=generator) * (2 * scale) - scale
                m.weight.copy_(w)
                m.bias.zero_()


def mel_batch(mel, mel_channels: int):
    """(C, T) or (B, C, T) normalized log-mel → float32 (B, C, T) and whether
    the input had no batch axis."""
    mel = np.asarray(mel, np.float32)
    squeeze = mel.ndim == 2
    if squeeze:
        mel = mel[None]
    if mel.ndim != 3 or mel.shape[1] != mel_channels:
        raise ValueError(f'expected a ({mel_channels}, T) or (B, {mel_channels}, T) mel, '
                         f'got {mel.shape}')
    return mel, squeeze


class ResStack(nn.Module):
    """Residual blocks, x ← shortcut(x) + block(x), one for each dilation."""

    def __init__(self, channels: int, dilations: Sequence[int]):
        super().__init__()
        self.blocks = nn.ModuleList(nn.Sequential(
            nn.LeakyReLU(LRELU_SLOPE),
            nn.ReflectionPad1d(d),
            nn.Conv1d(channels, channels, kernel_size=3, dilation=d),
            nn.LeakyReLU(LRELU_SLOPE),
            nn.Conv1d(channels, channels, kernel_size=1)) for d in dilations)
        self.shortcuts = nn.ModuleList(nn.Conv1d(channels, channels, kernel_size=1)
                                       for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block, shortcut in zip(self.blocks, self.shortcuts):
            x = shortcut(x) + block(x)
        return x


class MelGANVocoder(nn.Module):

    def __init__(self, mel_channels: int = 80, base_channels: int = 512,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 res_dilations: Sequence[int] = (1, 3, 9)):
        super().__init__()
        self.mel_channels = mel_channels
        self.base_channels = base_channels
        self.upsample_rates = tuple(upsample_rates)
        self.res_dilations = tuple(res_dilations)
        self.hop_length = int(np.prod(self.upsample_rates))
        layers = [nn.ReflectionPad1d(3), nn.Conv1d(mel_channels, base_channels, kernel_size=7)]
        ch = base_channels
        for r in self.upsample_rates:
            layers += [nn.LeakyReLU(LRELU_SLOPE),
                       nn.ConvTranspose1d(ch, ch // 2, kernel_size=2 * r, stride=r,
                                          padding=r // 2),
                       ResStack(ch // 2, self.res_dilations)]
            ch //= 2
        layers += [nn.LeakyReLU(LRELU_SLOPE), nn.ReflectionPad1d(3),
                   nn.Conv1d(ch, 1, kernel_size=7), nn.Tanh()]
        self.generator = nn.Sequential(*layers)

    @property
    def device(self) -> torch.device:
        return self.generator[1].weight.device

    def init_params(self, generator: torch.Generator) -> 'MelGANVocoder':
        """Random weights with the JAX package's initializer (a CPU generator;
        move the module afterwards)."""
        init_convs(self, generator)
        return self

    def forward(self, mel_btc: torch.Tensor) -> torch.Tensor:
        """(B, T, mel_channels) normalized log-mel, any float dtype, at least
        4 frames → float32 (B, T·hop) waveform in [-1, 1]."""
        x = (mel_btc.float().transpose(1, 2) + 5.0) / 5.0
        return self.generator(x)[:, 0]

    @torch.inference_mode()
    def inference(self, mel) -> np.ndarray:
        """(C, T) or (B, C, T) normalized log-mel (numpy) → float32 waveform
        (T·hop,) or (B, T·hop), computed on the module's device, the edge
        artifact trimmed."""
        mel, squeeze = mel_batch(mel, self.mel_channels)
        pad = np.full((mel.shape[0], self.mel_channels, SILENCE_FRAMES), LOG_MEL_SILENCE,
                      np.float32)
        mel = np.concatenate([mel, pad], axis=2).transpose(0, 2, 1)
        wav = self(torch.as_tensor(mel, device=self.device)).cpu().numpy()
        wav = wav[:, :-(self.hop_length * SILENCE_FRAMES)]
        return wav[0] if squeeze else wav

    # ------------------------------------------------------------ conversion

    @classmethod
    def from_torch_state_dict(cls, state_dict, mel_channels: int = 80,
                              device='cuda') -> 'MelGANVocoder':
        """A ``seungwonpark/melgan`` generator state dict (the hub module's,
        the ``model_g`` entry of a training checkpoint, with or without the
        ``generator.`` prefix) → the module on ``device`` (the card unless the
        caller names another). The upsample rates come from the
        ConvTranspose widths (k = 2r); every tensor is checked by name and
        shape."""
        sd = fold_weight_norm(state_dict)
        if {k.split('.', 1)[0] for k in sd} == {'generator'}:
            sd = {k.split('.', 1)[1]: v for k, v in sd.items()}
        indices = sorted({int(k.split('.', 1)[0]) for k in sd if k.split('.', 1)[0].isdigit()})
        if len(indices) < 2:
            raise ValueError('not a MelGAN generator state dict: no numbered layers')
        # res stacks carry blocks.* and shortcuts.*, the convs a plain weight
        rates = [sd[f'{i}.weight'].shape[2] // 2 for i in indices[1:-1] if f'{i}.weight' in sd]
        model = cls(mel_channels=mel_channels, base_channels=sd[f'{indices[0]}.weight'].shape[0],
                    upsample_rates=rates)
        load_arrays(model.generator, sd)
        return model.to(device)

    @classmethod
    def from_torch_checkpoint(cls, path, mel_channels: int = 80,
                              device='cuda') -> 'MelGANVocoder':
        """A checkpoint file (hub weights or a training checkpoint with a
        ``model_g`` entry) → the module on ``device``."""
        from transformertts_torch.models.vocoder import unwrap_torch_checkpoint
        return cls.from_torch_state_dict(unwrap_torch_checkpoint(path), mel_channels, device)

    @classmethod
    def from_jax_params(cls, params, res_dilations: Sequence[int] = (1, 3, 9),
                        device='cuda') -> 'MelGANVocoder':
        """The JAX package's ``MelGANVocoder.params`` (a list aligned with its
        layer spec, numpy or JAX leaves) → the module on ``device``."""
        params = list(params)
        _, mel_channels, base_channels = np.shape(params[0]['w'])
        rates = [np.shape(p['w'])[0] // 2 for p in params[1:-1] if 'w' in p]
        model = cls(mel_channels, base_channels, rates, res_dilations)
        layers = [(i, m) for i, m in enumerate(model.generator)
                  if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, ResStack))]
        if len(layers) != len(params):
            raise ValueError(f'{len(params)} parameter entries for {len(layers)} layers')
        sd = {}
        for (i, layer), p in zip(layers, params):
            if isinstance(layer, ResStack):
                for b, blk in enumerate(p['blocks']):
                    for name, key in ((f'blocks.{b}.2', 'dilated'), (f'blocks.{b}.4', 'pointwise'),
                                      (f'shortcuts.{b}', 'shortcut')):
                        sd[f'{i}.{name}.weight'] = conv_weight_from_jax(blk[key]['w'])
                        sd[f'{i}.{name}.bias'] = np.asarray(blk[key]['b'])
                continue
            to_torch = (conv_transpose_weight_from_jax if isinstance(layer, nn.ConvTranspose1d)
                        else conv_weight_from_jax)
            sd[f'{i}.weight'] = to_torch(p['w'])
            sd[f'{i}.bias'] = np.asarray(p['b'])
        load_arrays(model.generator, sd)
        return model.to(device)
