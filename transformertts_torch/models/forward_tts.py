"""ForwardTransformer in PyTorch, the counterpart of
``transformertts_tpu/models/forward_tts.py``.

embedding → self-attention encoder → duration and pitch predictors → pitch
embedding added to the encoder output → length regulator → self-attention
decoder → Dense(mel). Inference is two phases, as in the JAX package:
``encode`` runs on the device, the durations come to the host to size the
frame budget (rounded up to ``FRAME_BUCKET``), then ``decode`` runs at that
budget. Serving calls (``predict``, ``predict_wav``, the synthesis path)
take the fused attention kernel; ``need_weights=True`` takes the eager
attention and returns the weights. Training calls ``apply`` teacher-forced
(target durations and pitch) with ``training=True``, which turns on the
model's dropouts, drawn from an explicit ``torch.Generator``; its attention
takes the differentiable fused kernels.

Parameters live in float32; ``compute_dtype='bfloat16'`` runs the network in
bfloat16 with float32 LayerNorm statistics and softmax.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from transformertts_torch.models.melgan import LOG_MEL_SILENCE
from transformertts_torch.models.persistence import (load_model_dir, make_config,
                                                     save_model_dir)
from transformertts_torch.nn import blocks, core, masks
from transformertts_torch.nn.length_regulator import regulate_length
from transformertts_torch.text import TextToTokens

FRAME_BUCKET = 128  # decode frame budgets are rounded up to multiples of this
TOKEN_BUCKET = 32   # token rows are padded to multiples of this


def pad_tokens(tokens: np.ndarray) -> np.ndarray:
    """(B, N) → (B, max(32, N rounded up to 32)), zero (padding) filled."""
    n = tokens.shape[1]
    n_pad = max(TOKEN_BUCKET, -(-n // TOKEN_BUCKET) * TOKEN_BUCKET)
    return np.pad(tokens, ((0, 0), (0, n_pad - n)))


class ForwardTransformer(nn.Module):

    def __init__(self,
                 encoder_model_dimension: int,
                 decoder_model_dimension: int,
                 dropout_rate: float,
                 decoder_num_heads: list,
                 encoder_num_heads: list,
                 encoder_max_position_encoding: int,
                 decoder_max_position_encoding: int,
                 encoder_dense_blocks: int,
                 decoder_dense_blocks: int,
                 duration_conv_filters: list,
                 pitch_conv_filters: list,
                 duration_kernel_size: int,
                 pitch_kernel_size: int,
                 predictors_dropout: float,
                 mel_channels: int,
                 phoneme_language: str,
                 with_stress: bool,
                 model_breathing: bool,
                 transposed_attn_convs: bool = True,
                 encoder_attention_conv_filters: list = None,
                 decoder_attention_conv_filters: list = None,
                 encoder_attention_conv_kernel: int = None,
                 decoder_attention_conv_kernel: int = None,
                 encoder_feed_forward_dimension: int = None,
                 decoder_feed_forward_dimension: int = None,
                 compute_dtype: str = 'float32',
                 debug: bool = False,
                 **kwargs):
        config = make_config(locals(), kwargs)
        super().__init__()
        self.config = config
        self.text_pipeline = TextToTokens.default(
            phoneme_language, add_start_end=False, with_stress=with_stress,
            model_breathing=model_breathing)
        self.symbols = self.text_pipeline.tokenizer.alphabet
        self.mel_channels = mel_channels
        self.compute_dtype = torch.bfloat16 if compute_dtype == 'bfloat16' else torch.float32
        self.step = 0
        dim = encoder_model_dimension

        self.encoder_prenet = core.Embedding(self.text_pipeline.tokenizer.vocab_size, dim)
        self.encoder = blocks.SelfAttentionBlocks(
            model_dim=dim, feed_forward_dimension=encoder_feed_forward_dimension,
            num_heads=encoder_num_heads,
            maximum_position_encoding=encoder_max_position_encoding,
            conv_filters=encoder_attention_conv_filters,
            dense_blocks=encoder_dense_blocks,
            kernel_size=encoder_attention_conv_kernel, conv_activation='relu',
            name='Encoder', dropout_rate=dropout_rate)
        self.dur_pred = blocks.StatPredictor(
            dim, duration_conv_filters, duration_kernel_size,
            conv_activation='relu', dense_activation='relu',
            dropout_rate=predictors_dropout)
        self.pitch_pred = blocks.StatPredictor(
            dim, pitch_conv_filters, pitch_kernel_size,
            conv_activation='relu', dense_activation='linear',
            dropout_rate=predictors_dropout)
        self.pitch_embed = core.Dense(1, dim, activation='relu')
        self.decoder = blocks.SelfAttentionBlocks(
            model_dim=decoder_model_dimension,
            feed_forward_dimension=decoder_feed_forward_dimension,
            num_heads=decoder_num_heads,
            maximum_position_encoding=decoder_max_position_encoding,
            conv_filters=decoder_attention_conv_filters,
            dense_blocks=decoder_dense_blocks,
            kernel_size=decoder_attention_conv_kernel, conv_activation='relu',
            name='Decoder', dropout_rate=dropout_rate)
        self.out = core.Dense(decoder_model_dimension, mel_channels)

    @property
    def device(self) -> torch.device:
        return self.out.weight.device

    def init_params(self, generator: torch.Generator) -> 'ForwardTransformer':
        """Random weights with the JAX package's initializers, drawn from
        ``generator`` (a CPU generator; move the model afterwards)."""
        core.reset_parameters(self, generator)
        with torch.no_grad():
            for stack in (self.encoder, self.decoder):
                stack.pos_encoding_scalar.fill_(1.0)
        return self

    # --------------------------------------------------------------- compute

    def encode(self, tokens: torch.Tensor, need_weights: bool = False,
               training: bool = False, generator: Optional[torch.Generator] = None
               ) -> dict:
        """tokens (B, N) → encoder features, durations and pitch (B, N, 1)."""
        enc_pad_mask = masks.encoder_padding_mask(tokens)
        x = self.encoder_prenet(tokens).to(self.compute_dtype)
        x, encoder_attention = self.encoder(x, enc_pad_mask, need_weights, training,
                                            generator)
        keep = (1.0 - enc_pad_mask[:, 0, 0, :])[:, :, None].to(x.dtype)
        return {'features': x, 'durations': self.dur_pred(x, keep, training, generator),
                'pitch': self.pitch_pred(x, keep, training, generator), 'keep_mask': keep,
                'encoder_attention': encoder_attention}

    def decode(self, features: torch.Tensor, use_durations: torch.Tensor,
               max_frames: int, need_weights: bool = False, training: bool = False,
               generator: Optional[torch.Generator] = None) -> dict:
        """Expand by durations (B, N) and decode to a float32 mel (B, T, mels)."""
        mels, frame_valid = regulate_length(features, use_durations, max_frames)
        expanded_mask = (1.0 - frame_valid)[:, None, None, :]
        mels, decoder_attention = self.decoder(mels, expanded_mask, need_weights, training,
                                               generator)
        mels = self.out(mels) * frame_valid[:, :, None]
        return {'mel': mels.float(), 'expanded_mask': expanded_mask,
                'decoder_attention': decoder_attention}

    def apply(self, tokens: torch.Tensor, max_frames: int,
              target_durations: Optional[torch.Tensor] = None,
              target_pitch: Optional[torch.Tensor] = None,
              durations_scalar: float = 1.0,
              max_durations_mask: Optional[torch.Tensor] = None,
              min_durations_mask: Optional[torch.Tensor] = None,
              need_weights: bool = False, training: bool = False,
              generator: Optional[torch.Generator] = None) -> dict:
        """Full forward pass at a static ``max_frames``.

        target_durations / target_pitch: (B, N, 1), or None to use the
        predictions. ``training`` applies the dropouts, drawn from
        ``generator`` (a generator on the model's device).
        """
        enc = self.encode(tokens, need_weights, training, generator)
        x, durations, pitch = enc['features'], enc['durations'], enc['pitch']
        if target_pitch is not None:
            pitch_in = target_pitch.to(x.dtype)
        else:
            pitch_in = pitch
        x = x + self.pitch_embed(pitch_in)
        if target_durations is not None:
            use_durations = target_durations
        else:
            use_durations = durations * durations_scalar
        if max_durations_mask is not None:
            use_durations = torch.minimum(use_durations, max_durations_mask[:, :, None])
        if min_durations_mask is not None:
            use_durations = torch.maximum(use_durations, min_durations_mask[:, :, None])
        # padded phonemes must not emit frames
        use_durations = use_durations[:, :, 0] * enc['keep_mask'][:, :, 0]
        dec = self.decode(x, use_durations, max_frames, need_weights, training, generator)
        return {'mel': dec['mel'],
                'duration': durations.float(),
                'pitch': pitch.float(),
                'expanded_mask': dec['expanded_mask'],
                'encoder_attention': enc['encoder_attention'],
                'decoder_attention': dec['decoder_attention']}

    @staticmethod
    def scaled_durations(enc: dict, durations_scalar: float) -> torch.Tensor:
        """(B, N) float32 durations to expand by: the predictions times the
        scalar, zero on padding tokens. The host sizes frame budgets from
        this same tensor, so host and device round the same values."""
        return (enc['durations'][:, :, 0].float() * durations_scalar
                * enc['keep_mask'][:, :, 0].float())

    def decode_features(self, features, pitch, durations, max_frames: int) -> dict:
        """Serving decode: pitch embedding, then the kernel-path decode."""
        return self.decode(features + self.pitch_embed(pitch), durations, max_frames)

    @staticmethod
    def mask_mel_to_silence(dec: dict, silence: float) -> torch.Tensor:
        """Padding frames take the normalizer's silence level before any
        waveform stage: 0.0 in log-mel space is amplitude 1.0, which would
        bleed noise into clip tails and dominate peak normalization."""
        valid = (1.0 - dec['expanded_mask'][:, 0, 0, :].float())[:, :, None]
        return dec['mel'] * valid + silence * (1.0 - valid)

    def vocoder_mel(self, features, pitch, durations, max_frames: int) -> torch.Tensor:
        """The mel a neural vocoder (``models/melgan.py`` or
        ``models/hifigan.py``) is fed: the kernel-path decode in float32,
        padding frames at the vocoders' silence (``LOG_MEL_SILENCE``, not the
        normalizer's). The vocoders take MelGAN-normalized mels only."""
        norm = self.config.get('normalizer', 'MelGAN')
        if norm != 'MelGAN':
            raise ValueError(f'neural vocoders expect MelGAN-normalized mels, but this model '
                             f'was trained with normalizer={norm!r}; use the Griffin-Lim path '
                             f'instead')
        dec = self.decode_features(features, pitch, durations, max_frames)
        return self.mask_mel_to_silence(dec, LOG_MEL_SILENCE).float()

    def decode_vocoder(self, vocoder, features, pitch, durations, max_frames: int
                       ) -> torch.Tensor:
        """Serving decode through a neural vocoder: ``vocoder_mel`` through
        ``vocoder`` → peak-normalized (B, frames·hop) waveforms."""
        return self.peak_normalize(vocoder(self.vocoder_mel(features, pitch, durations,
                                                            max_frames)))

    @staticmethod
    def peak_normalize(wav: torch.Tensor) -> torch.Tensor:
        """(B, T) → rescaled where a row's |peak| exceeds 1 (the float form
        of the JAX package's PCM16 shipping and ``wav_io.save_wav``)."""
        peak = wav.abs().amax(dim=-1, keepdim=True)
        return wav / torch.clamp_min(peak, 1.0)

    # ------------------------------------------------------------- inference

    def encode_text(self, text: str):
        return self.text_pipeline(text)

    def _tokens(self, inp, encode: bool) -> np.ndarray:
        if encode:
            inp = self.encode_text(inp)
        tokens = np.asarray(inp, np.int64)
        return tokens[None, :] if tokens.ndim < 2 else tokens

    @torch.inference_mode()
    def predict_wav(self, inp, audio, encode: bool = True,
                    speed_regulator: float = 1.0, max_frames: int = 384,
                    n_iter: int = None):
        """Text → waveform in one pass at the static ``max_frames`` budget,
        trimmed on the host. Returns (wav, mel) as numpy arrays."""
        tokens = torch.as_tensor(pad_tokens(self._tokens(inp, encode)), device=self.device)
        n_iter = n_iter if n_iter is not None else audio.griffin_lim_iters
        enc = self.encode(tokens)
        use = self.scaled_durations(enc, 1.0 / speed_regulator)
        dec = self.decode_features(enc['features'], enc['pitch'], use, max_frames)
        n = int(torch.round(use).sum()) + 1
        mel = self.mask_mel_to_silence(dec, audio.silence_level())
        wav = audio.mels_to_waveforms(mel, n_iter)
        return (wav[0, :n * audio.hop_length].cpu().numpy(), mel[0, :n].cpu().numpy())

    @torch.inference_mode()
    def predict(self, inp, encode: bool = True, speed_regulator: float = 1.0,
                phoneme_max_duration: dict = None, phoneme_min_duration: dict = None,
                phoneme_durations=None, phoneme_pitch=None, max_frames: int = None
                ) -> dict:
        """Text (or token ids) → mel, duration and pitch as numpy arrays."""
        tokens = self._tokens(inp, encode)
        n_orig = tokens.shape[1]
        tokens = pad_tokens(tokens)
        n_pad = tokens.shape[1]
        duration_scalar = np.float32(1.0 / speed_regulator)
        max_mask = self._make_duration_mask(tokens, phoneme_max_duration, 1e9)
        min_mask = self._make_duration_mask(tokens, phoneme_min_duration, 0.0)

        enc = self.encode(torch.as_tensor(tokens, device=self.device))
        durations_h = enc['durations'].float().cpu().numpy()
        keep_h = enc['keep_mask'].float().cpu().numpy()
        pitch = enc['pitch']
        if phoneme_pitch is not None:
            p = np.zeros((1, n_pad, 1), np.float32)
            p[0, :n_orig, 0] = np.asarray(phoneme_pitch, np.float32).reshape(-1)[:n_orig]
            pitch = torch.as_tensor(p, device=self.device).to(pitch.dtype)
        if phoneme_durations is not None:
            durations_used = np.zeros((1, n_pad, 1), np.float32)
            durations_used[0, :n_orig, 0] = np.asarray(
                phoneme_durations, np.float32).reshape(-1)[:n_orig]
            duration_scalar = np.float32(1.0)  # explicit durations bypass speed
        else:
            durations_used = durations_h
        # frame budget, sized on the host and rounded up to a bucket
        clamped = np.minimum(durations_used[:, :, 0] * float(duration_scalar), max_mask)
        clamped = np.maximum(clamped, min_mask) * keep_h[:, :, 0]
        total = int(np.round(clamped).sum(axis=1).max()) + 1
        if max_frames is None:
            max_frames = max(FRAME_BUCKET, int(np.ceil(total / FRAME_BUCKET)) * FRAME_BUCKET)
        # the decoder expands by the float32 durations the host just sized
        dec = self.decode_features(enc['features'], pitch,
                                   torch.as_tensor(clamped, device=self.device), max_frames)
        # keep at least one frame: an untrained model can predict zero total
        # duration, and an empty mel breaks the waveform stage
        n_valid = max(1, int(np.round(clamped).sum(axis=1).max()))
        return {'mel': dec['mel'][0, :n_valid].cpu().numpy(),
                'duration': np.asarray(durations_used)[:, :n_orig],
                'pitch': pitch[:, :n_orig].float().cpu().numpy()}

    def _make_duration_mask(self, tokens: np.ndarray, phoneme_duration, fill: float):
        mask = np.full(tokens.shape, np.float32(fill))
        for symbol, value in (phoneme_duration or {}).items():
            mask[tokens == self.text_pipeline.tokenizer(symbol)[0]] = value
        return mask.astype(np.float32)

    # ----------------------------------------------------------- persistence

    def save_model(self, path, weights_format: str = 'npz'):
        """Self-describing dir: config.yaml + weights, readable by the JAX
        package's ``load_model``. weights_format: 'npz', 'hdf5' (the legacy
        Keras-2 layout the reference TF code loads; needs h5py) or 'both'."""
        save_model_dir(self, path, weights_format)

    @classmethod
    def load_model(cls, path, device='cuda') -> 'ForwardTransformer':
        """Load a dir written by either package onto ``device`` (the card
        unless the caller names another)."""
        return load_model_dir(cls, path, device)

    @classmethod
    def from_config(cls, config: dict, device='cuda') -> 'ForwardTransformer':
        """A model of this config on ``device`` (the card unless the caller
        names another), parameters uninitialized (``init_params`` or
        ``load_state_dict`` fill them)."""
        return cls(**config).to(device)
