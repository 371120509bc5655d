"""The Aligner in PyTorch, the counterpart of ``transformertts_tpu/models/aligner.py``.

text embedding → self-attention encoder; mel → DecoderPrenet → causal
cross-attention decoder → Dense(mel · max_r), sliced to r frames a decoder
step → Postnet (mel and 3-way stop logits). The decoder input is the mel
strided by the reduction factor r. ``apply`` is the teacher-forced forward;
``align`` returns the last block's cross-attention map, the input of
duration extraction; ``predict`` decodes autoregressively with a static K/V
cache per decoder block and stops at the stop token.

Attention routes: with ``need_weights=False`` (the default, and
``predict``'s) every attention whose map nobody reads runs on the fused
kernel (K1 without a gradient): the encoder's self-attention, the decoder's
causal self-attention and every cross-attention but the last block's. That
one takes the eager path, because its map is the product.
``need_weights=True`` takes the eager path everywhere and returns every map
the JAX package returns.

Parameters live in float32; ``compute_dtype='bfloat16'`` runs the network in
bfloat16 with float32 LayerNorm statistics, softmax and postnet.
"""
from typing import Optional

import numpy as np
import torch
from torch import nn

from transformertts_torch.models.persistence import (load_model_dir, make_config,
                                                     save_model_dir)
from transformertts_torch.nn import blocks, core, masks
from transformertts_torch.text import TextToTokens

TOKEN_BUCKET = 32  # predict pads tokens to a multiple of this, at least one


class Aligner(nn.Module):

    def __init__(self,
                 encoder_model_dimension: int,
                 decoder_model_dimension: int,
                 encoder_num_heads: list,
                 decoder_num_heads: list,
                 encoder_max_position_encoding: int,
                 decoder_max_position_encoding: int,
                 encoder_prenet_dimension: int,
                 decoder_prenet_dimension: int,
                 dropout_rate: float,
                 mel_start_value: float,
                 mel_end_value: float,
                 mel_channels: int,
                 phoneme_language: str,
                 with_stress: bool,
                 decoder_prenet_dropout: float,
                 model_breathing: bool,
                 encoder_feed_forward_dimension: int = None,
                 decoder_feed_forward_dimension: int = None,
                 max_r: int = 10,
                 compute_dtype: str = 'float32',
                 debug: bool = False,
                 **kwargs):
        config = make_config(locals(), kwargs)
        super().__init__()
        self.config = config
        self.text_pipeline = TextToTokens.default(
            phoneme_language, add_start_end=True, with_stress=with_stress,
            model_breathing=model_breathing)
        self.symbols = self.text_pipeline.tokenizer.alphabet
        self.mel_channels = mel_channels
        self.max_r = max_r
        self.r = max_r
        self.stop_prob_index = 2
        self.compute_dtype = torch.bfloat16 if compute_dtype == 'bfloat16' else torch.float32
        self.start_vec = np.full((1, mel_channels), mel_start_value, np.float32)
        self.end_vec = np.full((1, mel_channels), mel_end_value, np.float32)
        self.step = 0

        self.encoder_prenet = core.Embedding(self.text_pipeline.tokenizer.vocab_size,
                                             encoder_prenet_dimension)
        self.encoder = blocks.SelfAttentionBlocks(
            model_dim=encoder_model_dimension,
            feed_forward_dimension=encoder_feed_forward_dimension,
            num_heads=encoder_num_heads,
            maximum_position_encoding=encoder_max_position_encoding,
            conv_filters=None, dense_blocks=len(encoder_num_heads), kernel_size=None,
            conv_activation=None, name='Encoder', dropout_rate=dropout_rate)
        self.decoder_prenet = blocks.DecoderPrenet(
            mel_channels, decoder_model_dimension, decoder_prenet_dimension,
            dropout_rate=decoder_prenet_dropout)
        self.decoder = blocks.CrossAttentionBlocks(
            model_dim=decoder_model_dimension,
            feed_forward_dimension=decoder_feed_forward_dimension,
            num_heads=decoder_num_heads,
            maximum_position_encoding=decoder_max_position_encoding,
            dropout_rate=dropout_rate, name='Decoder')
        self.final_proj_mel = core.Dense(decoder_model_dimension, mel_channels * max_r)
        self.decoder_postnet = blocks.Postnet(mel_channels, mel_channels)

    @property
    def device(self) -> torch.device:
        return self.final_proj_mel.weight.device

    def init_params(self, generator: torch.Generator) -> 'Aligner':
        """Random weights with the JAX package's initializers, drawn from
        ``generator`` (a CPU generator; move the model afterwards)."""
        core.reset_parameters(self, generator)
        with torch.no_grad():
            for stack in (self.encoder, self.decoder):
                stack.pos_encoding_scalar.fill_(1.0)
        return self

    # --------------------------------------------------------------- compute

    def encode(self, tokens: torch.Tensor, need_weights: bool = False,
               training: bool = False, generator: Optional[torch.Generator] = None):
        """tokens (B, N) → (encoder output, its (B, 1, 1, N) padding mask,
        {name: self-attention weights}, empty unless ``need_weights``)."""
        enc_pad_mask = masks.encoder_padding_mask(tokens)
        x = self.encoder_prenet(tokens).to(self.compute_dtype)
        enc_out, enc_attn = self.encoder(x, enc_pad_mask, need_weights, training, generator)
        return enc_out, enc_pad_mask, enc_attn

    def _mel_frames(self, proj: torch.Tensor, r: int) -> torch.Tensor:
        """(B, T, mel · max_r) projection → (B, T · r, mel) float32."""
        proj = proj[:, :, :r * self.mel_channels]
        b, t = proj.shape[0], proj.shape[1]
        return proj.reshape(b, t * r, self.mel_channels).float()

    def decode(self, enc_out: torch.Tensor, mel_inp: torch.Tensor,
               enc_pad_mask: torch.Tensor, r: int, need_weights: bool = False,
               training: bool = False, generator: Optional[torch.Generator] = None
               ) -> dict:
        """mel_inp: (B, T_r, C), the r-strided teacher-forced decoder input."""
        dec_pad_mask = masks.mel_padding_mask(mel_inp)
        dec_in = self.decoder_prenet(mel_inp.to(self.compute_dtype), training, generator)
        dec_out, dec_attn = self.decoder(dec_in, enc_out, dec_pad_mask, enc_pad_mask,
                                         need_weights, training, generator,
                                         reduction_factor=r)
        mel = self._mel_frames(self.final_proj_mel(dec_out), r)
        post = self.decoder_postnet(mel)
        return {'mel': post['mel'], 'stop_prob': post['stop_prob'], 'linear': mel,
                'decoder_attention': dec_attn, 'mel_mask': dec_pad_mask}

    def apply(self, tokens: torch.Tensor, mel_inp: torch.Tensor, r: int,
              need_weights: bool = False, training: bool = False,
              generator: Optional[torch.Generator] = None) -> dict:
        """Teacher-forced forward; ``mel_inp`` is already r-strided. The
        decoder's attention dict holds the last block's map, and every
        cross-attention map with ``need_weights`` (the encoder's then too)."""
        enc_out, enc_pad_mask, enc_attn = self.encode(tokens, need_weights, training,
                                                      generator)
        out = self.decode(enc_out, mel_inp, enc_pad_mask, r, need_weights, training,
                          generator)
        out['encoder_attention'] = enc_attn
        out['text_mask'] = enc_pad_mask
        return out

    # ------------------------------------------------------------------ align

    @torch.inference_mode()
    def align(self, text, mel, mels_have_start_end_vectors: bool = False,
              phonemize: bool = False, encode_phonemes: bool = False):
        """Teacher-forced pass at the model's r on the eager path. Returns the
        last block's cross-attention map (B, H, T_r, N) as a numpy array and
        the whole output dict (every map, as the JAX package's)."""
        if phonemize:
            text = self.text_pipeline.phonemizer(text)
        if encode_phonemes:
            text = self.text_pipeline.tokenizer(text)
        tokens = np.asarray(text, np.int64)
        if tokens.ndim < 2:
            tokens = tokens[None, :]
        mel = np.asarray(mel, np.float32)
        if mel.ndim < 3:
            mel = mel[None, ...]
        if mels_have_start_end_vectors:
            tar_inp = mel[:, :-1]
        else:
            start = np.tile(self.start_vec[None, ...], (mel.shape[0], 1, 1))
            tar_inp = np.concatenate([start, mel], axis=1)
        strided = np.ascontiguousarray(tar_inp[:, ::self.r, :])
        out = self.apply(torch.as_tensor(tokens, device=self.device),
                         torch.as_tensor(strided, device=self.device), self.r,
                         need_weights=True)
        attn = out['decoder_attention'][self.decoder.weights_key(len(self.decoder.blocks) - 1)]
        return attn.cpu().numpy(), out

    # ---------------------------------------------------------------- predict

    def _decode_step_cached(self, x_pos, pos_idx: int, k_caches, v_caches, cross_kv,
                            self_mask, enc_pad_mask, r: int):
        """One decoder position through every block: x_pos (B, 1, mel) →
        (mel (B, r, mel), stop logits (B, r, 3), the last block's
        cross-attention weights (B, H, 1, N)). Writes the position's K/V into
        each block's cache."""
        dec = self.decoder
        y = dec.embed(self.decoder_prenet(x_pos.to(self.compute_dtype)), r, pos_idx)
        last = len(dec.blocks) - 1
        cross_w = None
        for i, block in enumerate(dec.blocks):
            attn1, _ = block.sarn.mha.apply_cached(y, k_caches[i], v_caches[i], y, pos_idx,
                                                   self_mask, need_weights=False)
            attn1 = block.sarn.ln(attn1 + y)
            attn2, w = block.carn.mha.apply_kv(attn1, *cross_kv[i], enc_pad_mask,
                                               need_weights=i == last)
            attn2 = block.carn.ln(attn2 + attn1)
            y = block.ffn(attn2)
            if w is not None:
                cross_w = w
        linear = self._mel_frames(self.final_proj_mel(y), r)
        post = self.decoder_postnet(linear)
        return post['mel'], post['stop_prob'], cross_w

    @torch.inference_mode()
    def predict(self, inp, max_length: int = 1000, encode: bool = True,
                verbose: bool = False) -> dict:
        """Autoregressive text → mel for one sample, at most
        ``max_length // r + 1`` decoder steps, stopping after the step whose
        last frame's stop logits peak at the stop class (one host sync a
        step). Returns the mel (n·r, mel), the last block's cross-attention
        (1, H, n, N) over the tokens padded to a multiple of 32 and
        ``n_steps`` n, as numpy arrays and an int."""
        if encode:
            inp = self.encode_text(inp)
        tokens = np.asarray(inp, np.int64)
        if tokens.ndim < 2:
            tokens = tokens[None, :]
        if tokens.shape[0] != 1:
            raise ValueError('Aligner.predict is single-sample; '
                             f'got batch of {tokens.shape[0]}')
        n_pad = max(TOKEN_BUCKET, -(-tokens.shape[1] // TOKEN_BUCKET) * TOKEN_BUCKET)
        tokens = np.pad(tokens, ((0, 0), (0, n_pad - tokens.shape[1])))
        r = self.r
        max_steps = int(max_length // r) + 1
        device, dtype = self.device, self.compute_dtype

        enc_out, enc_pad_mask, _ = self.encode(torch.as_tensor(tokens, device=device))
        cross_kv = [block.carn.mha.project_kv(enc_out) for block in self.decoder.blocks]
        # head counts differ per block (the published [4, 4, 4, 4, 1]), so
        # each block has a cache of its own (H_i, D_i)
        k_caches = [torch.zeros(1, b.sarn.mha.num_heads, max_steps, b.sarn.mha.depth,
                                device=device, dtype=dtype) for b in self.decoder.blocks]
        v_caches = [torch.zeros_like(k) for k in k_caches]
        last_heads = self.decoder.blocks[-1].carn.mha.num_heads
        mel_buf = torch.zeros(1, max_steps * r, self.mel_channels, device=device)
        attn_buf = torch.zeros(1, last_heads, max_steps, n_pad, device=device)
        steps = torch.arange(max_steps, device=device)
        x = torch.as_tensor(self.start_vec, device=device)[None]
        n = 0
        while n < max_steps:
            # the cache positions after this step's are masked
            self_mask = (steps > n).float()[None, None, None, :]
            mel_r, stop, cross_w = self._decode_step_cached(
                x, n, k_caches, v_caches, cross_kv, self_mask, enc_pad_mask, r)
            mel_buf[:, n * r:(n + 1) * r] = mel_r
            attn_buf[:, :, n] = cross_w[:, :, 0].float()
            x = mel_r[:, -1:, :]
            n += 1
            if int(torch.argmax(stop[0, -1])) == self.stop_prob_index:
                break
        if verbose:
            print(f'stopped after {n} steps')
        return {'mel': mel_buf[0, :n * r].cpu().numpy(),
                'decoder_attention': attn_buf[:, :, :n].cpu().numpy(),
                'n_steps': n}

    # ------------------------------------------------------------- constants

    def set_constants(self, reduction_factor: int = None, **kwargs):
        """r, the only constant that may change after construction. Unknown
        constants raise, as in the JAX package (the dropout rates are
        constructor constants there too)."""
        if kwargs:
            raise TypeError(
                f'set_constants got unsupported constants {sorted(kwargs)}; '
                'only reduction_factor is runtime-settable')
        if reduction_factor is not None:
            self.r = int(reduction_factor)

    def encode_text(self, text):
        return self.text_pipeline(text)

    # ----------------------------------------------------------- persistence

    def save_model(self, path, weights_format: str = 'npz'):
        """Self-describing dir: config.yaml + weights, readable by the JAX
        package's ``Aligner.load_model``. weights_format: 'npz', 'hdf5' (the
        legacy Keras-2 layout; needs h5py) or 'both'."""
        save_model_dir(self, path, weights_format)

    @classmethod
    def load_model(cls, path, device='cuda') -> 'Aligner':
        """Load a dir written by either package onto ``device`` (the card
        unless the caller names another)."""
        return load_model_dir(cls, path, device)

    @classmethod
    def from_config(cls, config: dict, max_r: int = None, device='cuda') -> 'Aligner':
        """An Aligner of this config on ``device`` (the card unless the caller
        names another), parameters uninitialized."""
        config = dict(config)
        if max_r is not None:
            config['max_r'] = max_r
        return cls(**config).to(device)
