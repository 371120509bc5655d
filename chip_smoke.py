"""On-card smoke test of the PyTorch port (transformertts_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result):

1. device: a CUDA card is required; prints its name and power limit and
   switches TF32 off for the float32 comparisons;
2. build: compiles the attention kernels from transformertts_torch/csrc
   with nvcc into build/ (listed in .gitignore), one nvcc a source, in
   parallel;
3. kernel vs plain: the forward kernel (K1) against ``attention_plain`` on
   the card, in float32 and in bfloat16 (padded keys, a fully masked row,
   causal on and off, head widths 24 and 192, the synthesis shapes), and in
   both at the edges of its design (``EDGE_CASES``), what its bfloat16
   kernel uses on the card for each head-width template, then both timed in
   bfloat16 at the synthesis shapes;
4. training kernels vs plain: K2 (output and logsumexp), K3 (dQ) and K4
   (dK, dV) against ``attention_fwd_lse_plain``/``attention_bwd_plain`` in
   float32 and bfloat16, at dropout 0 and 0.1 with one (seed, offset), on
   the same kinds of cases, ``EDGE_CASES`` in bfloat16 and the training
   shapes (bfloat16 dQ, dK and dV also within a relative L2 error of 1e-2
   of the plain version in float32), what K2, K3 and K4 use on the card
   (registers, spill bytes, shared memory and blocks an SM, for each
   head-width template), then forward+backward timed against the plain
   versions at the training shapes;
5. serving slice: the published LJSpeech configuration (d=384, 6+6 blocks,
   2 heads, bfloat16) with weights drawn from a seed, saved as a model dir
   and loaded back; ``synthesize_lines`` over config/test_sentences.txt with
   the launch count of K1; the bfloat16 kernel-path mel against a float32
   eager-attention mel under forced durations; the bench workload
   (B64 x 128 tokens -> 768 frames) in mel frames/s; the predict_tts CLI;
   then the same model dir served through both neural vocoders at their
   published widths (MelGAN: seungwonpark/melgan's LJSpeech generator;
   HiFi-GAN: jik876/hifi-gan's V1), each written from a seed as an
   upstream-layout checkpoint (weight-norm pairs; ``{'model_g': sd}``, and
   ``{'generator': sd}`` beside a config.json) and loaded by ``load_vocoder``:
   ``synthesize_lines(..., vocoder=)`` over the test sentences with the
   launch count of K1, wav lengths of max(1, totals - 1) hops, in
   sentences/s and seconds of audio a second, then over a full 32-line
   chunk (the sentences repeated; median of 3, peak memory), beside
   Griffin-Lim on the same chunk; the generator alone on the sentences'
   chunk mel and on a 32 x 768-frame one in device ms beside its FLOPs and
   bound, and in peak memory; the card against the same module on the CPU
   on one 32-frame masked mel (``VOCODER_CPU_ATOL``), and the same with
   cuDNN's TF32 on as a reading of the bar's reach; and the predict_tts CLI
   with ``--vocoder``; then the serving warm start: the same model dir in
   fresh processes (``python -c``, ``serving_child``), for Griffin-Lim and
   for HiFi-GAN V1 one cold (two ``synthesize_lines`` of the test
   sentences) and one warmed (``warmup_serving``, which must return 72 and
   launch K1 576 times, then the same two), the warmed wavs equal to the
   cold ones; cold and warmed first-request ms, steady ms and the warm-up's
   seconds printed, not gated;
6. training slice: config/training_config.yaml's published TTS settings
   (bfloat16, dropout 0.1, Adam, the config's learning rate) on a synthetic
   featurized data dir drawn from a seed: ``transformertts_torch.train_tts``
   (its ``main``, the entry ``python -m`` runs) for 8 steps with validation
   (whose loss must be finite) and a save at step 8, with the K2/K3/K4
   launch counts, then again to step
   10, resuming from 8; ``model_step_8`` loaded and synthesizing a line; a
   timed step at B32 x 128 tokens x 512 frames with the launches a step;
   30 steps on one batch, whose loss must fall; and a float32 model at
   dropout 0 whose kernel-path gradients must match the eager path's;
7. featurization kernel: the fused log-mel frontend (K5) against
   ``fused_log_mel_plain`` in float32 (the JAX test's settings, the
   published ones, a window shorter than n_fft, a hop that does not divide
   n_fft, frame counts that are not a multiple of 64, the WaveRNN config's
   n_fft 2048 at hop 275, and n_fft 256), what it uses on the card for each
   n_fft (registers, spill bytes, shared memory, blocks an SM), then timed
   with the plain version and ``torch.stft`` (cuFFT) at B16 x 262,144 and
   131,072 samples;
8. featurization slice: the native VAD mask against the NumPy path on
   each of 64 seeded synthetic LJSpeech-like clips of 1-10 s (element for
   element), and ``trim_long_silences`` ms a clip, native and NumPy; then
   ``transformertts_torch.create_training_data`` (its ``main``, whose
   workers trim with the native VAD) over the same clips, with
   the K5 launch count, the files it writes, one clip's mel against the
   plain version, the voiced share and the split, in clips/s and seconds of
   audio per second;
9. Aligner kernel cases: K1 against ``attention_plain`` in float32 (its
   3xTF32 tensor-core kernel, the Aligner's compute dtype) and bfloat16 at
   the published Aligner's shapes (``ALIGNER_CASES``: the decoder's causal
   self-attention with padded keys, cross-attention with Tq >> Tk, the last
   block's causal self-attention at D 256, decode steps of Tq 1 against a
   masked cache), what the float32 kernel's K1 and K2 instances use on the
   card for each head-width template (it fails if D 64 or 256 spills), then
   K1 float32 timed at the decoder's self-attention shape beside its plain
   version, ``scaled_dot_product_attention`` in float32 and two bounds
   (causal: only the products the mask leaves; on the CUDA cores, and as
   3xTF32's three TF32 products on the tensor cores), K1 float32 timed at
   one decode step, and K2 float32 checked and timed there at dropout 0.1
   beside the library call with the same dropout;
10. Aligner training kernels: K2, K3 and K4 in float32 against their plain
   versions at the Aligner's training shapes (``ALIGNER_BWD_CASES``: the
   decoder's causal self-attention at D 64 and at D 256, the
   cross-attention, the encoder's self-attention; B16 x 896 frames x 160
   tokens) at dropout 0 and 0.1, what K3's and K4's float32 kernels use on
   the card (it fails if D 64 or 256 spills or fits no block), then K3 and
   K4 timed at the decoder's self-attention (beside the plain backward
   too), at its last block's (D 256) and at the cross-attention, with
   dropout 0.1 beside ``scaled_dot_product_attention``'s float32 backward
   and two bounds (on the CUDA cores, and as 3xTF32), each K3 and K4 time
   beside the SIMT kernel's that the 3xTF32 one replaced;
11. Aligner slice: config/training_config.yaml's published ``aligner_settings``
   (d 256, encoder heads [4, 4, 4, 4], decoder heads [4, 4, 4, 4, 1], float32)
   with weights drawn from a seed, saved as a model dir and loaded back,
   written as a JAX-layout checkpoint at a step where the reduction schedule
   gives r = 1; ``transformertts_torch.extract_durations`` (its ``main``)
   over the featurization slice's clips, which fails unless every clip's
   durations sum to its mel frame count, its phoneme-wise pitch has their
   length and K1 ran 13 times a batch; the kernel-path last-block maps of one
   batch against the all-eager path's (``ALIGN_MAP_TOL``); the time split in
   clips/s; one ``predict`` at max_length 400 in decode steps/s with its K1
   launches a step; and the share of one bfloat16 batch's durations equal to
   the float32 ones (printed, not gated: random weights give near-uniform
   maps), and that batch's kernel path against its all-eager path in
   bfloat16 (gated in phase 13);
12. Aligner training: the published ``aligner_settings`` (f32, dropout 0.1)
   from the seeded weights of ``train_aligner``, on the featurization
   slice's data dir through ``transformertts_torch.train_aligner`` (its
   ``main``): steps 0-1 at r = 10 with both diagonals forced, steps 2-5 at
   r = 1 with neither (step 3 a plotting step), a checkpoint at 3 and 6,
   validation and predictions at 6, then resumed from 6 to 8; it fails
   unless every loss is finite and K2/K3/K4 launch 13 times a micro-batch on
   a step that neither forces nor plots and 0 times on one that does. Then
   ms a step (median of steps 4-13 of 30 on one batch) at the config's three
   buckets at r = 1 and the largest at r = 10, 30 steps on one batch whose
   loss must fall, and the synthetic language of tests/convergence_check.py
   trained 2,500 steps at d 48 on the kernels, whose extracted durations
   must come within 1.5 frames of the known ones;
13. the Aligner at bfloat16 (``aligner_bf16_phase``): what K1-K4 use on the
   card in bfloat16 at each head width (D 64 must not spill, D 64 and 256
   must fit a block an SM); K2, K3 and K4 against their plain versions at
   ``ALIGNER_BWD_CASES`` (dropout 0 and 0.1), K1 at the decode steps of
   ``ALIGNER_CASES``, each timed beside its plain version,
   ``scaled_dot_product_attention`` in bfloat16 and its bound; the
   published ``aligner_settings`` at ``compute_dtype: bfloat16`` through
   ``train_aligner.main`` as in phase 12 (13 K2/K3/K4 launches a plain
   step, finite losses, a resume whose checkpoint holds float32 leaves) and
   ms a step at the same buckets beside phase 12's; the synthetic language
   trained 2,500 steps at bfloat16 (MAE < 1.5 frames); phase 12's
   float32-trained language weights in a bfloat16 forward, whose durations
   must equal the float32 forward's in ``BF16_SAME_WEIGHTS_SHARE`` of the
   tokens; phase 11's bfloat16 batch, kernel path against all-eager
   (``BF16_ROUTE_MAP_ATOL``, ``BF16_ROUTE_SAME``); ``predict`` at bfloat16
   to ``PREDICT_MAX_LENGTH`` (401 steps, K1 2 · blocks - 1 a step, a finite
   mel); then tests/convergence_check.py's ForwardTransformer half on the
   kernels (its model, seed and 700 steps; the mean mel loss of the last
   20 steps under a quarter of the first 20's);
14. data parallelism (``parallel/mesh.py``) at world size 1, the one
   card the machine has: ``python -m torch.distributed.run --standalone
   --nproc_per_node 1`` runs ``transformertts_torch.train_tts`` (its
   ``main``, in this script's ``--train-child`` mode, which counts the
   kernels' launches) on the published TTS settings at dropout 0 with
   ``mesh: {data: -1}``, so the trainer's losses, gradients and logged
   outputs go through an NCCL process group, for ``DP_TTS_STEPS`` steps
   with validation and a checkpoint at the end; the same session without
   torchrun, one process without a group; the two runs' per-step losses
   and final checkpoints compared leaf by leaf (bit for bit, or the
   largest difference printed) and their K2/K3/K4 launches (equal, 12 a
   step), both with deterministic algorithms on; the same for the Aligner
   at a reduced depth (``DP_ALIGNER``); then, in one process under
   torchrun, ms a step of both models' trainers with the group and without
   it, in turns on one fixed batch (deterministic algorithms off); ``mesh: {data: 2}`` refused under
   torchrun with the tiling message; ``synthesize_lines(mesh=make_mesh(MeshConfig(data=1)))``
   and ``predict_tts --data_parallel 1`` against the same calls without a
   mesh (the same wavs), with K1's launches and sentences/s on a full
   32-line chunk both ways; and K1-K4 at head width 100, which their
   wrappers pad to 104, against the plain versions in float32 and
   bfloat16, with a head of 384 taking ``MultiHeadAttention``'s eager path;
15. tensor parallelism (the mesh's ``model`` axis) and ZeRO-1 on the one
   card (``model_parallel_phase``): gloo groups of 2 and 4 ranks
   (``--mp-child``, started without torchrun's environment), every rank on
   the card, beside one process alone; the collectives the mesh runs on
   CUDA tensors checked first; the TTS at the published width (f32, dropout
   0, TF32 off, B8 x 128 x 512) and the Aligner at ``DP_ALIGNER``'s depth,
   3 steps at {1, 2}, {2, 1} and {2, 2}, each from one process's
   checkpoint of that step (restored into the sharded state), whose losses
   and gathered parameters and moments must be one process's within
   stated bars; bf16
   TTS steps at the published settings (dropout 0.1) on profile_train's
   batch at every layout, whose losses must be finite, with each rank's
   peak memory; K2/K3/K4 launched per rank as often as alone, the model
   ranks of a data row holding the same replicated parameters bit for bit,
   each data rank ⌈n/D⌉ of the Adam state; ``mesh: {data: 1, model: 2}``
   refused under torchrun; ``profile_train`` with an NCCL group of one
   (launches, kernel ms, peak memory);
16. the last three lines: the kernels' JSON record (each kernel's time, its
   plain version's, one PyTorch library call's that computes the same
   function, and its bound: the larger of the FLOPs the function needs
   (for K5 an FFT's) over the card's peak rate for their type and its
   bytes, each input read once and each output written once, over
   3.35 TB/s), the card's name and power limit, then the contract line.

The hdf5 writer and readers (h5py) and ``Audio.display_mel`` (matplotlib)
do not run here: the card's machine has neither package. The CPU tests hold
them to the JAX package (``tests/test_torch_interop.py``,
``tests/test_torch_audio_host.py``).
"""
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'chip_smoke'
SEED = 0
DEVICE = 'cuda'
F32_TOL = dict(atol=2e-5, rtol=1e-4)   # the JAX kernel's own float32 bar
BF16_TOL = dict(atol=3e-2, rtol=3e-2)  # the JAX kernel's bfloat16 bar
MEL_REL_MAE_BAR = 0.05  # bf16 vs f32 mel MAE over the f32 mel's std, forced durations
# A trained LJSpeech model predicts some 5-7 frames per phoneme; freshly
# drawn weights predict well under one, which would leave every sentence in
# the smallest frame bucket. This bias on the duration head puts the random
# model's durations, and so its decoder lengths, at a trained model's scale.
DURATION_BIAS = 5.0
ENCODER_SHAPE = (64, 2, 128, 128, 192)  # (B, H, Tq, Tk, D) of the slice
DECODER_SHAPE = (64, 2, 768, 768, 192)
TRAIN_ENCODER_SHAPE = (32, 2, 128, 128, 192)  # B32 x 128 tokens x 512 frames
TRAIN_DECODER_SHAPE = (32, 2, 512, 512, 192)
# the bf16 forward's design edges, (B, H, Tq, Tk, D) and causal, which the
# forward's and K2-K4's `cuda` tests take too: head widths 64, 128 and 256,
# and 24 (TMA zero-fills it to 64); Tq one row past a 128-row block; Tk 1;
# more key tiles than the ring has stages, causal with Tq != Tk; more blocks
# than one wave of the card
EDGE_CASES = [((2, 2, 150, 170, 64), False), ((2, 3, 200, 190, 128), True),
              ((2, 2, 140, 200, 256), False), ((3, 2, 129, 77, 24), False),
              ((2, 2, 129, 129, 192), True), ((2, 2, 70, 1, 192), False),
              ((2, 2, 300, 700, 192), True), ((1, 2, 100, 600, 256), True),
              ((2, 1, 64, 900, 64), True), ((12, 12, 160, 96, 64), False)]
BF16_GRAD_TOL = dict(atol=0.12, rtol=0.12)  # the JAX flash backward's bfloat16 bar
F32_GRAD_TOL = dict(atol=5e-5, rtol=1e-3)   # ... and its float32 bar
WIRING_REL_L2_BAR = 1e-3
GRAD_REL_L2_BAR = 1e-2  # bf16 dQ, dK, dV against the plain version in float32
LOG_MEL_TOL = dict(atol=2e-4, rtol=1e-3)  # the JAX fused log-mel kernel's bar
KERNELS = ('flash_attention_fwd', 'flash_attention_bwd', 'fused_log_mel')
# H100 SXM peaks (NVIDIA's data sheet, dense): bf16 and TF32 tensor cores,
# float32 outside them, and HBM3
PEAK_FLOPS = {'bf16': 989e12, 'tf32': 495e12, 'f32': 67e12}
HBM_BYTES_PER_S = 3.35e12
N_CLIPS = 64  # synthetic clips the featurization slice featurizes
# the published Aligner's attention shapes, (B, H, Tq, Tk, D), causal and, for
# a decode step, the cache position whose successors the bias masks: B6 is
# the config's validation batch, T up to its 1000-frame bucket, 150 tokens
ALIGNER_SELF_SHAPE = (6, 4, 1000, 1000, 64)
ALIGNER_CASES = [((6, 4, 777, 777, 64), True, None), (ALIGNER_SELF_SHAPE, True, None),
                 ((6, 4, 1000, 150, 64), False, None), ((6, 1, 1000, 1000, 256), True, None),
                 ((1, 4, 1, 1000, 64), False, 437), ((1, 1, 1, 1000, 256), False, 437)]
# extraction's kernel-path last-block maps against the all-eager path's: both
# float32, the kernels' summation order against cuBLAS's through 4 encoder and
# 5 decoder blocks
ALIGN_MAP_TOL = dict(atol=1e-4, rtol=0)
ALIGNER_R1_STEP = 130000   # the published reduction schedule's r = 1 from here
# the Aligner at bfloat16: the share of token durations that the float32-
# trained synthetic-language weights give in a bfloat16 forward equal to
# the float32 forward's (the JAX package measured 95.8 %), and the bars of
# the published-width extraction batch's kernel path against its all-eager
# path, both in bfloat16: about 3x the map difference and 5x the share of
# unequal durations measured (1.94e-3 and 0.9894; H100 80GB HBM3, 700 W;
# PERF.md)
BF16_SAME_WEIGHTS_SHARE = 0.90
BF16_ROUTE_MAP_ATOL = 6e-3
BF16_ROUTE_SAME = 0.95
PREDICT_MAX_LENGTH = 400
# the published Aligner's training attentions at the config's largest bucket,
# B16 x 896 frames x 160 tokens, (B, H, Tq, Tk, D) and causal: the decoder's
# self-attention at D 64 and its last block's at D 256, the cross-attention,
# the encoder's self-attention
ALIGNER_BWD_SHAPE = (16, 4, 896, 896, 64)
ALIGNER_BWD_LAST_SHAPE = (16, 1, 896, 896, 256)
ALIGNER_BWD_CROSS_SHAPE = (16, 4, 896, 160, 64)
ALIGNER_BWD_CASES = [(ALIGNER_BWD_SHAPE, True), (ALIGNER_BWD_LAST_SHAPE, True),
                     (ALIGNER_BWD_CROSS_SHAPE, False), ((16, 4, 160, 160, 64), False)]
# the float32 K3 and K4 that the 3xTF32 kernels replaced, SIMT on the CUDA
# cores, causal, dropout 0.1 (H100 80GB HBM3, 700 W; PERF.md): K4 and K3 at
# ALIGNER_BWD_SHAPE, K3 at ALIGNER_BWD_LAST_SHAPE
SIMT_K4_F32_MS = 2.1978
SIMT_K3_F32_MS = 0.8063
SIMT_K3_F32_D256_MS = 2.1808
# (B, frames, tokens, r): scripts/measure_train_step.py's three buckets at r = 1,
# and the largest at r = 10
ALIGNER_TRAIN_BUCKETS = [(64, 256, 48, 1), (32, 512, 96, 1), (16, 896, 160, 1),
                         (16, 896, 160, 10)]
# the vocoders' output on the card against the same module's on the CPU,
# float32 with TF32 off, one 32-frame mel across a line's end. Sound readings
# are 5-8e-7 and cuDNN's TF32 gives 2.4e-4 (HiFi-GAN) and 7.5e-4 (MelGAN)
# (H100 80GB HBM3, 700 W; PERF.md), so a bar of 1e-5 catches TF32 by 24x
VOCODER_CPU_ATOL = 1e-5
VOCODER_CHECK_FRAMES = 32
# a full serving chunk (synthesize_lines' max_batch), and the frame bucket
# its generator is also timed at
VOCODER_CHUNK_LINES = 32
VOCODER_FULL_FRAMES = 768
# weight-norm magnitudes, g = gain * |v|, that put freshly drawn weights'
# waveforms at speech level (peaks of some 0.1-0.6): at gain 1 (the JAX
# initializer) MelGAN's output peaks near 3e-6, which would make the
# card-vs-CPU bar and the written PCM16 wav vacuous
VOCODER_GAINS = {'MelGAN': 1.8, 'HiFi-GAN': 1.6}

PUBLISHED = dict(
    encoder_model_dimension=384, decoder_model_dimension=384, dropout_rate=0.1,
    decoder_num_heads=[2] * 6, encoder_num_heads=[2] * 6,
    encoder_max_position_encoding=2000, decoder_max_position_encoding=10000,
    encoder_dense_blocks=0, decoder_dense_blocks=0,
    duration_conv_filters=[256, 226], pitch_conv_filters=[256, 226],
    duration_kernel_size=3, pitch_kernel_size=3, predictors_dropout=0.1,
    mel_channels=80, phoneme_language='en-us', with_stress=False,
    model_breathing=True, transposed_attn_convs=True,
    encoder_attention_conv_filters=[1536, 384],
    decoder_attention_conv_filters=[1536, 384],
    encoder_attention_conv_kernel=3, decoder_attention_conv_kernel=3,
    compute_dtype='bfloat16',
    # audio settings of config/training_config.yaml
    sampling_rate=22050, n_fft=1024, hop_length=256, win_length=1024,
    f_min=0, f_max=8000, normalizer='MelGAN', data_name='ljspeech_random')

# warmup_serving's default menu: 6 batch buckets (32 and the powers of two
# below it) x 4 token buckets x 3 frame buckets; K1 runs once an encoder
# block at each (batch, token) and once a decoder block at each combination
WARM_COMBINATIONS = 6 * 4 * 3
WARM_LAUNCHES = (len(PUBLISHED['encoder_num_heads']) * 6 * 4
                 + len(PUBLISHED['decoder_num_heads']) * WARM_COMBINATIONS)
# the warmed process's wavs against the cold one's: the same kernels on the
# same shapes, so bit for bit is expected; the card-vs-CPU vocoder bar at most
WARM_WAV_ATOL = VOCODER_CPU_ATOL
WARM_CHILD_TIMEOUT_S = 300
# the data-parallel phase: steps of each training run, the Aligner's reduced
# depth (2 encoder and 2 decoder blocks, the last of one head of 256), and
# the head widths the attention wrappers pad or leave to the eager path
DP_TTS_STEPS = 10
DP_ALIGNER_STEPS = 6
DP_ALIGNER = dict(encoder_num_heads=[4, 4], decoder_num_heads=[4, 1])
DP_PADDED_CASES = [((4, 2, 300, 300, 100), False), ((4, 2, 300, 300, 100), True),
                   ((2, 3, 129, 77, 100), False)]
DP_WIDE_HEAD = 384
DP_CHILD_TIMEOUT_S = 400
# the data-parallel phase's timed steps: untimed steps of each trainer,
# then rounds of four timed steps (grouped, alone, alone, grouped)
DP_TIME_WARMUP = 5
DP_TIME_ROUNDS = 8
# model parallelism: gloo ranks sharing the one card
MP_STEPS = 3
MP_GATE_BATCH = (8, 128, 512)      # the TTS gates: B x tokens x frames, f32, dropout 0
MP_ALIGNER_BATCH = (8, 96, 512)    # the Aligner gates (DP_ALIGNER): B x tokens x frames, r 1
MP_MEMORY_BATCH = (32, 128, 512)   # bf16 readings: profile_train's batch
MP_LAYOUTS = ((1, 2), (2, 1), (2, 2))
MP_LOSS_RTOL = 1e-5
MP_CHILD_TIMEOUT_S = 400
MP_PROFILE_TIMEOUT_S = 300
GLOO_COLLECTIVES = ('all_reduce', 'broadcast', 'all_gather_into_tensor',
                    'reduce_scatter_tensor')


def log(*args):
    print(*args, flush=True)


def write_session(work: Path, tts_overrides: dict = None,
                  data_overrides: dict = None, aligner_overrides: dict = None) -> Path:
    """A session YAML: config/training_config.yaml (the published TTS and
    Aligner settings) with its paths under ``work`` and the given overrides."""
    with open(ROOT / 'config' / 'training_config.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg['paths'] = {'wav_directory': str(work / 'wavs'),
                    'metadata_path': str(work / 'metadata.csv'),
                    'log_directory': str(work / 'logs'),
                    'train_data_directory': str(work / 'ttsdata')}
    cfg['training_data_settings'].update(data_overrides or {})
    cfg['tts_settings'].update(tts_overrides or {})
    cfg['aligner_settings'].update(aligner_overrides or {})
    work.mkdir(parents=True, exist_ok=True)
    path = work / 'session.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def write_synthetic_data(cm, n_train: int, n_valid: int, frames=(400, 600),
                         seed: int = SEED):
    """Featurized samples in the layout TTSDataset reads, drawn from
    ``seed``: phoneme strings from the tokenizer's alphabet, durations of
    3-8 frames a token summing to a mel length in ``frames``, log-mels in
    the MelGAN range and per-token pitch. ``cm`` is the session's
    TrainingConfigManager."""
    c = cm.config
    tokenizer = cm.get_model('cpu').text_pipeline.tokenizer
    # no space (it adds a breathing token), no separator, no upsampled '?!'
    symbols = [s for s in tokenizer.alphabet if s not in ' |?!@/']
    rng = np.random.default_rng(seed)
    cm.create_remove_dirs(assume_yes=True)
    lines = []
    for i in range(n_train + n_valid):
        target = rng.integers(frames[0], frames[1] + 1)
        n_text = max(1, int(target) // 6)
        while True:
            text = ''.join(rng.choice(symbols, n_text))
            durations = rng.integers(3, 9, len(tokenizer(text))).astype(np.float32)
            if frames[0] <= durations.sum() <= frames[1]:
                break
            n_text += 1 if durations.sum() < frames[0] else -1
        t = int(durations.sum())
        mel = np.clip(rng.normal(-4.0, 1.5, (t, c['mel_channels'])), np.log(1e-5), 2.0)
        name = f'synth_{i:04d}'
        np.save(cm.mel_dir / f'{name}.npy', mel.astype(np.float32))
        np.save(cm.duration_dir / f'{name}.npy', durations)
        np.save(cm.pitch_per_char / f'{name}.npy',
                rng.standard_normal(len(durations)).astype(np.float32))
        lines.append(f'{name}|{text}')
    cm.train_metadata_path.write_text('\n'.join(lines[:n_train]) + '\n', encoding='utf-8')
    cm.valid_metadata_path.write_text('\n'.join(lines[n_train:]) + '\n', encoding='utf-8')


def tf32_off():
    """float32 products in float32 on the card (cuBLAS and cuDNN), as every
    comparison here assumes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available() '
                         'is false); the port is measured on the card only')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    tf32_off()
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    return card


def build_phase():
    from transformertts_torch.ops import build
    t0 = time.perf_counter()
    paths = build.build_all(KERNELS)
    for name in KERNELS:
        build.load(name)
    log(f'build: {[str(p.relative_to(ROOT)) for p in paths]} in '
        f'{time.perf_counter() - t0:.1f} s')


def _qkv(shape, dtype, gen, pad_keys=True):
    b, h, tq, tk, d = shape
    q, k, v = (torch.randn(b, h, t, d, device='cuda', generator=gen).to(dtype)
               for t in (tq, tk, tk))
    bias = torch.zeros(b, tk, device='cuda')
    if pad_keys:
        # ragged key lengths, and one row of the batch fully masked
        lengths = torch.randint(1, tk + 1, (b,), device='cuda', generator=gen)
        bias[torch.arange(tk, device='cuda')[None, :] >= lengths[:, None]] = -1e9
        bias[-1] = -1e9
    return q, k, v, bias


def _time_ms(fn, iters=20) -> float:
    """Device ms a call: CUDA events around ``iters`` calls, queued behind a
    spin of the card long enough for the host to queue them all, so that the
    calls run back to back and a small shape times the device, not the
    wrappers' Python (a call that waits on the card still times the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # at most 2 GHz: 2e9 cycles a second spin at least that long
    torch.cuda._sleep(int(2e9 * min(0.2, 2 * iters * host_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: str) -> dict:
    """The least time the card could take: the larger of the FLOPs over the
    peak rate of their type and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[peak], nbytes / HBM_BYTES_PER_S
    return {'bound_ms': max(t_ops, t_bytes) * 1e3,
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes'}


def _sdpa_backend(q, k, v, mask, dropout_p: float) -> str:
    """The backend PyTorch's dispatcher picks for these inputs."""
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, attn_mask=mask, dropout_p=dropout_p)
    return SDPBackend(choice).name


def _attention_bounds(shape, causal: bool, elem: int, peak: str) -> dict:
    """K1-K4's bounds at ``shape`` (B, H, Tq, Tk, D): the products the causal
    mask leaves (K1 and K2 two, S and P·V; K3 three, S, dP and dS·K; K4
    four, S, dP, dV and dK; each 2·kept·D FLOPs) over the ``peak`` rate, and
    the bytes, each input read once and each output written once: rows of
    ``elem`` bytes (q, k, v, dO, O and the gradients) and the float32
    bias, (m, log l) pairs and D rows."""
    b, h, tq, tk, d = shape
    kept = b * h * (sum(min(r + 1, tk) for r in range(tq)) if causal else tq * tk)
    q_row, k_row = elem * b * h * tq * d, elem * b * h * tk * d
    lse, dsum, bias = 8 * b * h * tq, 4 * b * h * tq, 4 * b * tk
    return {
        # in: q, k, v, bias; out: o
        'K1': bound(4 * kept * d, 2 * q_row + 2 * k_row + bias, peak),
        # in: q, k, v, bias; out: o, (m, log l)
        'K2': bound(4 * kept * d, 2 * q_row + 2 * k_row + lse + bias, peak),
        # in: q, k, v, dO, (m, log l), D, bias; out: dQ
        'K3': bound(6 * kept * d, 3 * q_row + 2 * k_row + lse + dsum + bias, peak),
        # in: q, k, v, dO, (m, log l), D, bias; out: dK, dV
        'K4': bound(8 * kept * d, 2 * q_row + 4 * k_row + lse + dsum + bias, peak)}


def _library_mask(q, bias, causal: bool):
    """The additive (B, 1, 1 or Tq, Tk) mask of ``scaled_dot_product_attention``
    in q's dtype: the key bias, plus the look-ahead when ``causal``."""
    mask = bias[:, None, None, :]
    if causal:
        tq, tk = q.shape[2], bias.shape[1]
        mask = mask + torch.triu(torch.full((tq, tk), -1e9, device=bias.device), diagonal=1)
    return mask.to(q.dtype)


def _resources(label: str, query, tile: str, dtype: str = 'bf16',
               gated=(192,), fit=()) -> dict:
    """Log what a kernel uses on the card at each head-width template
    (``query(d)``, one of ops.flash_attention's ``*_resources``); raise if a
    ``gated`` width (the bf16 kernels' training and serving width, D 192;
    the f32 forward's Aligner widths, D 64 and 256) spills or fits no
    block, or a ``fit`` width fits no block. Returns the first gated
    width's resources."""
    by_d = {d: query(d) for d in (64, 128, 192, 256)}
    for d, r in by_d.items():
        log(f'{label} {dtype} at D {d}: {r["registers"]} registers a thread, '
            f'{r["spill_bytes"]} spill (local) bytes, {r["static_smem_bytes"]} + '
            f'{r["dynamic_smem_bytes"]} B of shared memory a block, {r["blocks_per_sm"]} '
            f'block(s) of {r["threads"]} threads an SM, {tile.replace("_", " ")} {r[tile]}')
    # the designs keep their accumulators in registers at these widths
    for d in gated:
        if by_d[d]['spill_bytes'] != 0 or by_d[d]['blocks_per_sm'] < 1:
            raise AssertionError(f'{label} {dtype} at D {d} spills or does not fit: '
                                 f'{by_d[d]}')
    for d in fit:
        if by_d[d]['blocks_per_sm'] < 1:
            raise AssertionError(f'{label} {dtype} at D {d} does not fit: {by_d[d]}')
    return by_d[gated[0]]


def kernel_phase() -> dict:
    """Kernel vs plain in both dtypes (each has its own kernel: 3xTF32 on
    mma.sync for float32, wgmma for bfloat16) and ``EDGE_CASES``, what the
    bf16 kernel uses on the card, then both timed at the slice shapes."""
    from transformertts_torch.ops.flash_attention import (attention_plain, flash_attention,
                                                          fwd_resources)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [((2, 2, 37, 53, 24), False), ((2, 2, 41, 41, 24), True),
             ((3, 2, 130, 70, 192), False), ((2, 2, 100, 100, 192), True),
             (ENCODER_SHAPE, False), (DECODER_SHAPE, False)]
    errors = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape, causal in cases + EDGE_CASES:
            q, k, v, bias = _qkv(shape, dtype, gen)
            out = flash_attention(q, k, v, bias, causal)
            torch.cuda.synchronize()
            ref = attention_plain(q, k, v, bias, causal)
            if not torch.isfinite(out).all():
                raise AssertionError(f'kernel output not finite at {shape} {dtype}')
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            err = (out.float() - ref.float()).abs().max().item()
            errors[shape, dtype] = max(err, errors.get((shape, dtype), 0.0))
            log(f'{dtype} {shape} causal={causal}: max |kernel - plain| {err:.3g}')
    resources = _resources('K1', lambda d: fwd_resources(d, False), 'stages')
    record = {}
    for name, shape in (('encoder', ENCODER_SHAPE), ('decoder', DECODER_SHAPE)):
        q, k, v, bias = _qkv(shape, torch.bfloat16, gen)
        ms = _time_ms(lambda: flash_attention(q, k, v, bias))
        plain_ms = _time_ms(lambda: attention_plain(q, k, v, bias))
        # the library yardstick: PyTorch's fused attention with the additive mask
        mask = bias[:, None, None, :].to(q.dtype)
        backend = _sdpa_backend(q, k, v, mask, 0.0)
        library_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
        limit = _attention_bounds(shape, False, 2, 'bf16')['K1']
        log(f'bf16 {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
            f'scaled_dot_product_attention ({backend}) {library_ms:.4f} ms, bound '
            f'{limit["bound_ms"]:.4f} ms ({limit["bound_by"]})')
        record[name] = dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms, library_backend=backend, **limit)
    worst = max(e for (_, dtype), e in errors.items() if dtype == torch.bfloat16)
    return {'times': record, 'max_abs_err': worst, 'resources': resources}


def _trainable_ops():
    from transformertts_torch.ops import flash_attention as fa
    return fa, (fa.flash_attention_fwd_lse, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)


def _rel_l2(mine, want) -> float:
    return ((mine.float() - want.float()).norm() / want.float().norm()).item()


def _check_trainable_case(shape, causal: bool, dtype, rate: float, gen, label: str = ''):
    """K2 (output and logsumexp), K3 (dQ) and K4 (dK, dV) against their
    plain versions at one case, with one (seed, offset) at dropout
    ``rate``; in bfloat16 also dQ, dK and dV within ``GRAD_REL_L2_BAR``
    relative L2 of the plain version in float32 on the same inputs. Returns
    ({K2, K3, K4: max |kernel - plain|}, {dq, dk, dv: relative L2}, empty in
    float32)."""
    fa, _ = _trainable_ops()
    fwd_tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    grad_tol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
    # a softmax over one key has no gradient to its logit: dQ and dK are 0
    # at Tk 1, and only their absolute bar applies
    zero = ('dq', 'dk') if shape[3] == 1 else ()
    q, k, v, bias = _qkv(shape, dtype, gen)
    dout = torch.randn(q.shape, device='cuda', generator=gen).to(dtype)
    args = (causal, rate, 1234, 5678)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
    dq = fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.attention_fwd_lse_plain(q, k, v, bias, *args)
    ref = fa.attention_bwd_plain(q, k, v, bias, out, lse, dout, *args)
    checks = (('K2', 'out', out, ref_out, fwd_tol), ('K2', 'lse', lse, ref_lse, F32_TOL),
              ('K3', 'dq', dq, ref[0], grad_tol), ('K4', 'dk', dk, ref[1], grad_tol),
              ('K4', 'dv', dv, ref[2], grad_tol))
    errors = {'K2': 0.0, 'K3': 0.0, 'K4': 0.0}
    for name, what, mine, want, tol in checks:
        if not torch.isfinite(mine).all():
            raise AssertionError(f'{name} not finite at {shape} {dtype} {rate}')
        if what not in zero and not want.abs().max() > 0:
            raise AssertionError(f'{name}: the plain {what} is all zero')
        torch.testing.assert_close(mine.float(), want.float(), **tol)
        errors[name] = max(errors[name], (mine.float() - want.float()).abs().max().item())
    rels, rel = {}, ''
    if dtype == torch.bfloat16:
        # the plain K3 and K4 in float32 from the same bf16 inputs
        ref32 = fa.attention_bwd_plain(q.float(), k.float(), v.float(), bias, out.float(), lse,
                                       dout.float(), *args)
        rels = {n: _rel_l2(g, r) for n, g, r in zip(('dq', 'dk', 'dv'), (dq, dk, dv), ref32)
                if n not in zero}
        if not max(rels.values()) < GRAD_REL_L2_BAR:
            raise AssertionError(f'K3/K4 relative L2 error {rels} at {shape} dropout {rate}, '
                                 f'bar {GRAD_REL_L2_BAR}')
        rel = '; relative L2 vs float32 plain ' + ' '.join(f'{n} {x:.3g}'
                                                           for n, x in rels.items())
    log(f'{label}{dtype} {shape} causal={causal} dropout={rate}: max |kernel - plain| '
        f'out {(out.float() - ref_out.float()).abs().max().item():.3g} '
        f'dq {(dq.float() - ref[0].float()).abs().max().item():.3g} '
        f'dk {(dk.float() - ref[1].float()).abs().max().item():.3g} '
        f'dv {(dv.float() - ref[2].float()).abs().max().item():.3g} '
        f'(max |plain dq| {ref[0].float().abs().max().item():.3g}){rel}')
    return errors, rels


def trainable_kernel_phase() -> dict:
    """K2, K3 and K4 against the plain versions in both dtypes (and
    ``EDGE_CASES`` in bfloat16), at dropout 0 and 0.1 with one (seed,
    offset), what K2, K3 and K4 use on the card, then forward+backward timed
    in bfloat16 against the plain versions at the training shapes."""
    fa, _ = _trainable_ops()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 1)
    cases = [((2, 2, 37, 53, 24), False), ((2, 2, 41, 41, 24), True),
             ((3, 2, 130, 70, 192), False), ((2, 2, 100, 100, 192), True),
             (TRAIN_ENCODER_SHAPE, False), (TRAIN_DECODER_SHAPE, False)]
    errors = {'K2': 0.0, 'K3': 0.0, 'K4': 0.0}
    rel_l2 = {'dq': 0.0, 'dk': 0.0, 'dv': 0.0}   # bf16, the decoder's training shape
    for dtype in (torch.float32, torch.bfloat16):
        for shape, causal in cases + (EDGE_CASES if dtype == torch.bfloat16 else []):
            for rate in (0.0, 0.1):
                errs, rels = _check_trainable_case(shape, causal, dtype, rate, gen)
                errors = {n: max(errors[n], e) for n, e in errs.items()}
                if shape == TRAIN_DECODER_SHAPE and rels:
                    rel_l2 = {n: max(rel_l2[n], x) for n, x in rels.items()}
    resources = {label: _resources(label, query, tile) for label, query, tile in (
        ('K2', lambda d: fa.fwd_resources(d, True), 'stages'),
        ('K3', fa.dq_resources, 'key_tile'), ('K4', fa.dkv_resources, 'query_tile'))}
    record = {}
    for name, shape in (('encoder', TRAIN_ENCODER_SHAPE), ('decoder', TRAIN_DECODER_SHAPE)):
        q, k, v, bias = _qkv(shape, torch.bfloat16, gen)
        dout = torch.randn(q.shape, device='cuda', generator=gen).to(torch.bfloat16)
        args = (False, 0.1, 1234, 5678)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
        # the backward computes D = rowsum(dO∘O) once and hands it to K3 and K4
        dsum = fa.row_dot(dout, out)
        t = dict(
            K2=_time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, bias, *args)),
            K3=_time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout,
                                                          *args, dsum=dsum)),
            K4=_time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout,
                                                           *args, dsum=dsum)),
            row_dot=_time_ms(lambda: fa.row_dot(dout, out)),
            plain_fwd=_time_ms(lambda: fa.attention_fwd_lse_plain(q, k, v, bias, *args)),
            plain_bwd=_time_ms(lambda: fa.attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                                              *args)))
        # the plain versions without dropout, whose int64 mask hash costs them
        no_drop = (False, 0.0, 0, 0)
        plain0 = (_time_ms(lambda: fa.attention_fwd_lse_plain(q, k, v, bias, *no_drop))
                  + _time_ms(lambda: fa.attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                                            *no_drop)))
        log(f'bf16 dropout 0.1 {name} {shape}: K2 {t["K2"]:.4f} ms vs plain forward '
            f'{t["plain_fwd"]:.4f} ms; K3 {t["K3"]:.4f} ms + K4 {t["K4"]:.4f} ms vs plain '
            f'backward {t["plain_bwd"]:.4f} ms; forward+backward '
            f'{t["K2"] + t["K3"] + t["K4"]:.4f} ms vs {t["plain_fwd"] + t["plain_bwd"]:.4f} ms '
            f'(plain at dropout 0: {plain0:.4f} ms); row_dot {t["row_dot"]:.4f} ms once a '
            f'backward')
        t.update(_library_training_attention(q, k, v, _library_mask(q, bias, False), dout))
        t['bounds'] = _attention_bounds(shape, False, 2, 'bf16')
        log(f'  bounds: ' + ', '.join(f'{k} {v["bound_ms"]:.4f} ms ({v["bound_by"]})'
                                      for k, v in t['bounds'].items()))
        record[name] = dict(shape=list(shape), **t)
    return {'errors': errors, 'rel_l2': rel_l2, 'resources': resources, 'times': record}


def _library_training_attention(q, k, v, mask, dout) -> dict:
    """PyTorch's fused attention at dropout 0.1 with the additive ``mask``,
    forward alone and forward + backward through autograd: the yardstick of
    K2 and of K2 + K3 + K4."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    backend = _sdpa_backend(qg, kg, vg, mask, 0.1)

    def fwd_bwd():
        out = sdpa(qg, kg, vg, attn_mask=mask, dropout_p=0.1)
        torch.autograd.grad(out, (qg, kg, vg), dout)

    fwd = _time_ms(lambda: sdpa(qg, kg, vg, attn_mask=mask, dropout_p=0.1))
    both = _time_ms(fwd_bwd)
    log(f'  scaled_dot_product_attention ({backend}), dropout 0.1: forward {fwd:.4f} ms, '
        f'forward+backward {both:.4f} ms')
    return {'library_fwd': fwd, 'library_bwd': both - fwd, 'library_fwd_bwd': both,
            'library_backend': backend}


def _batch_like_serving(model, lines):
    """The single chunk synthesize_lines builds for a few lines: sorted by
    token count, tokens padded to 32, batch to a power of two."""
    toks = sorted((np.asarray(model.encode_text(l), np.int64) for l in lines), key=len)
    n_tok = -(-max(len(t) for t in toks) // 32) * 32
    batch = 1
    while batch < len(toks):
        batch *= 2
    tok = np.zeros((batch, n_tok), np.int64)
    for row, t in enumerate(toks):
        tok[row, :len(t)] = t
    return tok


def slice_phase() -> dict:
    from transformertts_torch.audio import Audio
    from transformertts_torch.models import ForwardTransformer
    from transformertts_torch.models.synthesis import synthesize_lines
    from transformertts_torch.ops.flash_attention import flash_attention

    gen = torch.Generator().manual_seed(SEED)
    model_dir = WORK / 'model'
    seeded = ForwardTransformer(**PUBLISHED).init_params(gen)
    with torch.no_grad():
        seeded.dur_pred.linear.bias.fill_(DURATION_BIAS)
    seeded.save_model(model_dir)
    model = ForwardTransformer.load_model(model_dir, device=DEVICE)
    audio = Audio.from_config(model.config)
    lines = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
             if l.strip()]

    synthesize_lines(model, audio, lines)   # warm-up: cuBLAS/cuDNN plans
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    wavs = synthesize_lines(model, audio, lines)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    if launches == 0:
        raise AssertionError('synthesize_lines never launched the attention kernel')

    with torch.inference_mode():
        tok = _batch_like_serving(model, lines)
        use = model.scaled_durations(model.encode(torch.as_tensor(tok, device=DEVICE)), 1.0)
        totals = torch.round(use).sum(dim=1).long().cpu().numpy() + 1
    # each wav keeps at least one frame
    expected = sorted(max(1, int(t - 1)) * audio.hop_length for t in totals[:len(lines)])
    lengths = [len(w) for w in wavs]
    for w in wavs:
        if not np.isfinite(w).all() or not np.abs(w).max() > 0:
            raise AssertionError('a synthesized wav is not finite or is silent')
    if sorted(lengths) != expected:
        raise AssertionError(f'wav lengths {lengths} != max(1, totals-1)*hop {expected}')
    log(f'synthesize_lines: {len(lines)} lines, wav samples {lengths}, kernel '
        f'launches {launches}, {wall:.4f} s, {len(lines) / wall:.3f} sentences/s')

    # bf16 kernel path vs f32 eager path, durations forced to the f32 model's
    model32 = ForwardTransformer.from_config({**model.config, 'compute_dtype': 'float32'},
                                             device=DEVICE)
    model32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        tokens = torch.as_tensor(tok, device=DEVICE)
        ref = model32.apply(tokens, max_frames=768, need_weights=True)
        forced = torch.round(ref['duration'])
        ref = model32.apply(tokens, max_frames=768, target_durations=forced,
                            need_weights=True)
        out = model.apply(tokens, max_frames=768, target_durations=forced)
        valid = (1.0 - ref['expanded_mask'][:, 0, 0, :]).bool()
        mae = (out['mel'] - ref['mel']).abs()[valid].mean().item()
        std = ref['mel'][valid].std().item()
    if not torch.isfinite(out['mel']).all() or mae > MEL_REL_MAE_BAR * std:
        raise AssertionError(f'bf16 vs f32 mel MAE {mae} over {MEL_REL_MAE_BAR} x '
                             f'the mel std {std}')
    log(f'bf16 kernel path vs f32 eager path, forced durations: mel MAE {mae:.4g}, '
        f'{mae / std:.4g} of the mel std {std:.4g} (bar {MEL_REL_MAE_BAR})')

    # bench workload: B64 x 128 tokens -> 768 frames, median of 3 windows
    rng = np.random.default_rng(SEED)
    bench_tok = torch.as_tensor(rng.integers(
        1, model.text_pipeline.tokenizer.vocab_size, size=(64, 128)), device=DEVICE)
    fps = []
    with torch.inference_mode():
        for _ in range(2):
            mel = model.apply(bench_tok, max_frames=768)['mel']
        if not torch.isfinite(mel).all() or mel.shape != (64, 768, 80):
            raise AssertionError(f'bench mel shape {tuple(mel.shape)} or not finite')
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                model.apply(bench_tok, max_frames=768)
            torch.cuda.synchronize()
            fps.append(64 * 768 * 4 / (time.perf_counter() - t0))
    log(f'bench B64x128t->768f: {statistics.median(fps):.1f} mel frames/s '
        f'(median of 3 windows of 4 batches: {[round(f, 1) for f in fps]})')

    from transformertts_torch import predict_tts
    predict_tts.main(['-p', str(model_dir), '-t', lines[0], '-o', str(WORK / 'out'),
                      '--device', DEVICE])
    from transformertts_torch.audio.wav_io import load_wav
    wav, sr = load_wav(next((WORK / 'out' / 'outputs' / 'custom_text').glob('*.wav')))
    if sr != 22050 or wav.size == 0 or not np.isfinite(wav).all():
        raise AssertionError('predict_tts wrote no readable 22050 Hz wav')
    log(f'predict_tts: wrote {wav.size} samples at {sr} Hz')
    return {'launches': launches, 'model_dir': model_dir,
            'sentences_per_s': len(lines) / wall}


def upstream_state_dict(vocoder, gain: float) -> dict:
    """``vocoder``'s weights in the upstream checkpoints' layout: each conv's
    weight as a weight-norm pair, v the weight and g = gain * |v| (the norm
    over every axis but the first), so the loader's fold gives gain times
    the weight."""
    sd = {}
    for key, value in vocoder.state_dict().items():
        if key.endswith('.weight'):
            prefix = key[:-len('.weight')]
            sd[f'{prefix}.weight_v'] = value.clone()
            sd[f'{prefix}.weight_g'] = gain * value.flatten(1).norm(dim=1).reshape(-1, 1, 1)
        else:
            sd[key] = value.clone()
    return sd


def generator_flops(vocoder, batch: int, frames: int) -> int:
    """The FLOPs of one generator call on (batch, frames) mels, from the
    shapes its convolutions meet (a copy run on the meta device): 2 * in * out
    * k for each output sample of a Conv1d and each input sample of a
    ConvTranspose1d. The elementwise passes are not counted."""
    nn = torch.nn
    meta = copy.deepcopy(vocoder).to('meta')
    total = 0

    def count(m, inputs, output):
        nonlocal total
        x = inputs[0] if isinstance(m, nn.ConvTranspose1d) else output
        total += (2 * m.in_channels * m.out_channels // m.groups * m.kernel_size[0]
                  * x.shape[0] * x.shape[2])

    hooks = [m.register_forward_hook(count) for m in meta.modules()
             if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))]
    meta(torch.empty(batch, frames, vocoder.mel_channels, device='meta'))
    for h in hooks:
        h.remove()
    return total


def _write_vocoder_checkpoints(work: Path) -> dict:
    """Seeded generators at their published widths, saved as the upstream
    training checkpoints: MelGAN's ``{'model_g': sd}``, HiFi-GAN's
    ``{'generator': sd}`` beside its config.json."""
    from transformertts_torch.models.hifigan import V1_CONFIG, HiFiGANVocoder
    from transformertts_torch.models.melgan import MelGANVocoder
    gen = torch.Generator().manual_seed(SEED)
    paths = {'MelGAN': work / 'melgan' / 'melgan.pt', 'HiFi-GAN': work / 'hifigan' / 'g_00000000'}
    for path in paths.values():
        path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({'model_g': upstream_state_dict(MelGANVocoder().init_params(gen),
                                               VOCODER_GAINS['MelGAN'])}, paths['MelGAN'])
    torch.save({'generator': upstream_state_dict(HiFiGANVocoder().init_params(gen),
                                                 VOCODER_GAINS['HiFi-GAN'])}, paths['HiFi-GAN'])
    (paths['HiFi-GAN'].parent / 'config.json').write_text(json.dumps(V1_CONFIG))
    return paths


def _timed_synthesis(model, audio, lines, vocoder=None, repeats: int = 1):
    """``synthesize_lines`` after one warm-up (cuDNN plans): the wavs of the
    last call, the median wall seconds over ``repeats`` calls, K1's launches
    in the last, and the device memory the calls peaked at beyond what was
    held before (GB)."""
    from transformertts_torch.models.synthesis import synthesize_lines
    from transformertts_torch.ops.flash_attention import flash_attention
    synthesize_lines(model, audio, lines, vocoder=vocoder)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(repeats):
        flash_attention.launches = 0
        t0 = time.perf_counter()
        wavs = synthesize_lines(model, audio, lines, vocoder=vocoder)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (wavs, statistics.median(walls), flash_attention.launches,
            (torch.cuda.max_memory_allocated() - held) / 1e9)


def _generator_reading(vocoder, mel, iters: int) -> dict:
    """One generator on ``mel`` (B, frames, C): device ms, FLOPs, the f32
    bound, and the memory one call peaks at beyond its input (GB)."""
    with torch.inference_mode():
        ms = _time_ms(lambda: vocoder(mel), iters=iters)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        vocoder(mel)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    flops = generator_flops(vocoder, *mel.shape[:2])
    n_params = sum(p.numel() for p in vocoder.parameters())
    limit = bound(flops, 4 * (mel.numel() + mel.shape[0] * mel.shape[1] * vocoder.hop_length
                              + n_params), 'f32')
    return dict(ms=ms, gflop=flops / 1e9, peak_gb=peak_gb, shape=list(mel.shape), **limit)


def vocoder_phase(model_dir: Path) -> dict:
    """The serving slice's model dir through both neural vocoders at their
    published widths: ``synthesize_lines(vocoder=)`` on the test sentences
    and on a full 32-line chunk (beside Griffin-Lim on the same chunk), the
    generator alone in device ms against its bound and in peak memory on
    the test sentences' chunk mel and on a 32 x 768-frame one, the card
    against the CPU (and, as a reading of the bar's reach, with cuDNN's
    TF32 on), the CLI."""
    from transformertts_torch import predict_tts
    from transformertts_torch.audio import Audio
    from transformertts_torch.audio.wav_io import load_wav
    from transformertts_torch.models import ForwardTransformer
    from transformertts_torch.models.synthesis import encode_chunk
    from transformertts_torch.models.vocoder import load_vocoder

    work = WORK / 'vocoders'
    paths = _write_vocoder_checkpoints(work)
    model = ForwardTransformer.load_model(model_dir, device=DEVICE)
    audio = Audio.from_config(model.config)
    lines = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
             if l.strip()]
    # a full serving chunk: the test sentences repeated to max_batch rows
    full = (lines * -(-VOCODER_CHUNK_LINES // len(lines)))[:VOCODER_CHUNK_LINES]
    # the chunks synthesize_lines builds, and the mels it feeds the vocoder:
    # the test sentences' at their frame bucket, the full chunk's at 768 frames
    with torch.inference_mode():
        enc, use, totals, frames = encode_chunk(
            model, _batch_like_serving(model, lines), len(lines))
        mel = model.vocoder_mel(enc['features'], enc['pitch'], use, frames)
        enc, use, full_totals, full_frames = encode_chunk(
            model, _batch_like_serving(model, full), len(full))
        full_mel = model.vocoder_mel(enc['features'], enc['pitch'], use,
                                     max(full_frames, VOCODER_FULL_FRAMES))
        del enc, use
    # 32 frames of the shortest line across its end: speech, then padding
    start = max(0, min(int(totals[0]) - 1 - VOCODER_CHECK_FRAMES // 2,
                       frames - VOCODER_CHECK_FRAMES))
    piece = mel[:1, start:start + VOCODER_CHECK_FRAMES]

    _, gl_wall, _, gl_gb = _timed_synthesis(model, audio, full, repeats=3)
    log(f'Griffin-Lim on the full chunk ({len(full)} lines): {gl_wall:.4f} s (median of 3), '
        f'{len(full) / gl_wall:.3f} sentences/s, peak {gl_gb:.3f} GB')
    record = {'Griffin-Lim': dict(chunk_sentences_per_s=len(full) / gl_wall,
                                  chunk_peak_gb=gl_gb)}
    for name, path in paths.items():
        vocoder = load_vocoder(path, mel_channels=model.config['mel_channels'], device=DEVICE)
        hop = vocoder.hop_length
        wavs, wall, launches, _ = _timed_synthesis(model, audio, lines, vocoder)
        if launches == 0:
            raise AssertionError(f'synthesize_lines with {name} never launched K1')
        lengths = [len(w) for w in wavs]
        expected = sorted(max(1, int(t) - 1) * hop for t in totals[:len(lines)])
        if sorted(lengths) != expected:
            raise AssertionError(f'{name} wav lengths {lengths} != max(1, totals-1)*hop '
                                 f'{expected}')
        for w in wavs:
            if not np.isfinite(w).all() or not 0 < np.abs(w).max() <= 1.0:
                raise AssertionError(f'a {name} wav is not finite, is silent or exceeds 1')
        audio_s = sum(lengths) / audio.sampling_rate
        chunk_wavs, chunk_wall, chunk_launches, chunk_gb = _timed_synthesis(
            model, audio, full, vocoder, repeats=3)
        chunk_lengths = sorted(len(w) for w in chunk_wavs)
        if chunk_launches == 0 or chunk_lengths != sorted(
                max(1, int(t) - 1) * hop for t in full_totals[:len(full)]):
            raise AssertionError(f'{name} on the full chunk: K1 launches {chunk_launches}, '
                                 f'wav lengths {chunk_lengths}')
        chunk_audio_s = sum(len(w) for w in chunk_wavs) / audio.sampling_rate

        small = _generator_reading(vocoder, mel, iters=10)
        big = _generator_reading(vocoder, full_mel, iters=3)
        with torch.inference_mode():
            card = vocoder(piece).cpu()
            cpu = copy.deepcopy(vocoder).cpu()(piece.cpu())
            torch.backends.cudnn.allow_tf32 = True
            try:
                card_tf32 = vocoder(piece).cpu()
            finally:
                torch.backends.cudnn.allow_tf32 = False
        err = (card - cpu).abs().max().item()
        err_tf32 = (card_tf32 - cpu).abs().max().item()
        peak = cpu.abs().max().item()
        if not err <= VOCODER_CPU_ATOL:
            raise AssertionError(f'{name} on the card vs the CPU: max |diff| {err} over '
                                 f'{VOCODER_CPU_ATOL} (CPU peak {peak})')

        out = work / f'out_{path.parent.name}'
        predict_tts.main(['-p', str(model_dir), '-t', lines[0], '-o', str(out), '--vocoder',
                          str(path), '--device', DEVICE])
        wav, sr = load_wav(next((out / 'outputs' / 'custom_text').glob('*.wav')))
        if sr != 22050 or wav.size == 0 or wav.size % hop or not np.isfinite(wav).all() \
                or not np.abs(wav).max() > 0:
            raise AssertionError(f'predict_tts --vocoder ({name}) wrote no readable 22050 Hz '
                                 f'wav')
        log(f'{name} ({type(vocoder).__name__}, hop {hop}): synthesize_lines {len(lines)} '
            f'lines (one call, host noise dominates), wav samples {lengths}, K1 launches '
            f'{launches}, {wall:.4f} s, {len(lines) / wall:.3f} sentences/s, '
            f'{audio_s / wall:.2f} s of audio/s; full chunk of {len(full)} lines: '
            f'{chunk_wall:.4f} s (median of 3), {len(full) / chunk_wall:.3f} sentences/s, '
            f'{chunk_audio_s / chunk_wall:.2f} s of audio/s, peak {chunk_gb:.3f} GB')
        for label, g in (('chunk mel', small), ('full-chunk mel', big)):
            log(f'  generator on the {label} {tuple(g["shape"])}: {g["ms"]:.4f} ms, '
                f'{g["gflop"]:.2f} GFLOP ({g["gflop"] * 1e3 / (g["shape"][0] * g["shape"][1]):.2f}'
                f' M a frame), bound {g["bound_ms"]:.4f} ms ({g["bound_by"]}, f32), '
                f'{g["gflop"] / g["ms"]:.2f} TFLOP/s, peak {g["peak_gb"]:.3f} GB')
        log(f'  card vs CPU on {tuple(piece.shape)}: max |diff| {err:.3g} (bar '
            f'{VOCODER_CPU_ATOL}; CPU peak {peak:.3g}); with cuDNN TF32 on {err_tf32:.3g}; '
            f'predict_tts wrote {wav.size} samples')
        record[name] = dict(launches=launches, sentences_per_s=len(lines) / wall,
                            audio_s_per_s=audio_s / wall,
                            chunk_sentences_per_s=len(full) / chunk_wall,
                            chunk_audio_s_per_s=chunk_audio_s / chunk_wall,
                            chunk_peak_gb=chunk_gb, generator_ms=small['ms'],
                            generator_gflop=small['gflop'], bound_ms=small['bound_ms'],
                            bound_by=small['bound_by'], full_generator=big,
                            cpu_max_abs_err=err, cpu_max_abs_err_tf32=err_tf32,
                            checkpoint=str(path))
    return record


def serving_child(model_dir: str, out: str, warm: bool, vocoder: str = None):
    """One fresh serving process (``python -c``, started by ``warm_start_phase``):
    load the model dir (and ``vocoder``) on the card, with ``warm`` run
    ``warmup_serving`` (timed, K1's launches counted), then time two
    ``synthesize_lines`` of the test sentences. Writes the first request's
    wavs to ``out``.npz and the readings to ``out``.json."""
    from transformertts_torch.audio import Audio
    from transformertts_torch.models import ForwardTransformer
    from transformertts_torch.models.synthesis import synthesize_lines, warmup_serving
    from transformertts_torch.models.vocoder import load_vocoder
    from transformertts_torch.ops.flash_attention import flash_attention
    tf32_off()
    model = ForwardTransformer.load_model(model_dir, device=DEVICE)
    audio = Audio.from_config(model.config)
    if vocoder is not None:
        vocoder = load_vocoder(vocoder, mel_channels=model.config['mel_channels'],
                               device=DEVICE)
    lines = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
             if l.strip()]
    record = {}
    if warm:
        flash_attention.launches = 0
        t0 = time.perf_counter()
        record['combinations'] = warmup_serving(model, audio, vocoder=vocoder)
        record['warmup_s'] = time.perf_counter() - t0
        record['warmup_launches'] = flash_attention.launches
    request_ms, requests = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        requests.append(synthesize_lines(model, audio, lines, vocoder=vocoder))
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
    record['request_ms'] = request_ms
    np.savez(f'{out}.npz', *requests[0])
    Path(f'{out}.json').write_text(json.dumps(record))


def _serving_child(model_dir: Path, out: Path, warm: bool, vocoder: str = None):
    """``serving_child`` in a fresh process; its wavs and its readings."""
    args = dict(model_dir=str(model_dir), out=str(out), warm=warm, vocoder=vocoder)
    code = (f'import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; '
            f'chip_smoke.serving_child(**{args!r})')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=WARM_CHILD_TIMEOUT_S)
    with np.load(f'{out}.npz') as data:
        wavs = [data[f'arr_{i}'] for i in range(len(data.files))]
    return wavs, json.loads(Path(f'{out}.json').read_text())


def warm_start_phase(model_dir: Path, hifigan: str, card: str) -> dict:
    """The serving slice's first request, cold and after ``warmup_serving``:
    fresh processes, so nothing earlier in this script has warmed them.
    Griffin-Lim and the seeded HiFi-GAN V1 each get a cold process (two
    ``synthesize_lines`` of the test sentences) and a warmed one
    (``warmup_serving``, then the same two). The warm-up must return 72 and
    launch K1 ``WARM_LAUNCHES`` times, and the warmed wavs must equal the
    cold ones."""
    work = WORK / 'warm_start'
    work.mkdir(parents=True, exist_ok=True)
    record = {}
    for name, vocoder in (('Griffin-Lim', None), ('HiFi-GAN', hifigan)):
        tag = name.lower().replace('-', '')
        cold_wavs, cold = _serving_child(model_dir, work / f'{tag}_cold', False, vocoder)
        warm_wavs, warm = _serving_child(model_dir, work / f'{tag}_warm', True, vocoder)
        if warm['combinations'] != WARM_COMBINATIONS or \
                warm['warmup_launches'] != WARM_LAUNCHES:
            raise AssertionError(f'{name}: warmup_serving warmed {warm["combinations"]} '
                                 f'combinations with {warm["warmup_launches"]} K1 launches, '
                                 f'not {WARM_COMBINATIONS} and {WARM_LAUNCHES}')
        if [w.shape for w in warm_wavs] != [w.shape for w in cold_wavs]:
            raise AssertionError(f'{name}: warmed wav shapes differ from the cold ones')
        diff = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(warm_wavs, cold_wavs))
        bitwise = all(np.array_equal(a, b) for a, b in zip(warm_wavs, cold_wavs))
        if not diff <= WARM_WAV_ATOL:
            raise AssertionError(f'{name}: warmed wavs differ from the cold ones by {diff}')
        entry = dict(cold_first_ms=cold['request_ms'][0], warm_first_ms=warm['request_ms'][0],
                     steady_ms=cold['request_ms'][1], warm_second_ms=warm['request_ms'][1],
                     warmup_s=warm['warmup_s'], launches=warm['warmup_launches'],
                     combinations=warm['combinations'], bitwise=bitwise, max_abs_diff=diff)
        log(f'warm start, {name} ({card}): cold first request {entry["cold_first_ms"]:.1f} ms, '
            f'warmed first request {entry["warm_first_ms"]:.1f} ms, warm steady '
            f'{entry["steady_ms"]:.1f} ms (warmed second {entry["warm_second_ms"]:.1f}), '
            f'warm-up {entry["warmup_s"]:.2f} s for {entry["combinations"]} combinations, '
            f'K1 launches {entry["launches"]}; warmed wavs equal the cold ones '
            f'{"bit for bit" if bitwise else f"within {diff:.3g}"}')
        record[name] = entry
    return record


def _launch_counts(ops) -> list:
    return [f.launches for f in ops]


def training_phase() -> dict:
    from transformertts_torch import train_tts
    from transformertts_torch.audio import Audio
    from transformertts_torch.models import ForwardTransformer
    from transformertts_torch.models.synthesis import synthesize_lines
    from transformertts_torch.profile_train import synthetic_batch
    from transformertts_torch.training import checkpointing
    from transformertts_torch.training.forward_trainer import ForwardTrainer, forward_loss
    from transformertts_torch.utils.config import TrainingConfigManager
    _, ops = _trainable_ops()
    work = WORK / 'train'
    if work.exists():
        shutil.rmtree(work)
    schedule = dict(validation_frequency=8, checkpoint_frequency=8,
                    weights_save_frequency=8, weights_save_starting_step=8,
                    prediction_start_step=10 ** 9)
    cfg = write_session(work, {**schedule, 'max_steps': 8})
    cm = TrainingConfigManager(cfg)
    write_synthetic_data(cm, n_train=90, n_valid=6)
    log(f'training data: 96 synthetic samples under {cm.data_dir.relative_to(ROOT)}')

    # the training main path: 8 steps, validation and a save at step 8
    for f in ops:
        f.launches = 0
    t0 = time.perf_counter()
    validation = train_tts.main(['--config', str(cfg), '--yes', '--device', DEVICE])
    torch.cuda.synchronize()
    launches = _launch_counts(ops)
    log(f'train_tts to step 8: {time.perf_counter() - t0:.1f} s, launches K2/K3/K4 '
        f'{launches} (12 attention layers x 8 steps = 96 each)')
    if launches != [96, 96, 96]:
        raise AssertionError(f'8 training steps launched K2/K3/K4 {launches} times, not 96')
    steps = [s for s, _ in checkpointing.list_checkpoints(cm.weights_dir)]
    if steps != [8] or not (cm.base_dir / 'model_step_8').exists():
        raise AssertionError(f'checkpoints {steps}, model dir missing or extra')
    # train_tts prints a failed validation and trains on, as the JAX CLI does
    if list(validation) != [8] or not np.isfinite(validation[8]):
        raise AssertionError(f'validation at step 8 gave no finite loss: {validation}')
    log(f'validation loss at step 8: {validation[8]:.4f}')

    # resume: the same session to step 10 takes exactly the two missing steps
    cfg = write_session(work, {**schedule, 'max_steps': 10})
    counts = _launch_counts(ops)
    train_tts.main(['--config', str(cfg), '--yes', '--device', DEVICE])
    torch.cuda.synchronize()
    resumed = [a - b for a, b in zip(_launch_counts(ops), counts)]
    steps = [s for s, _ in checkpointing.list_checkpoints(cm.weights_dir)]
    if resumed != [24, 24, 24] or steps != [8, 10]:
        raise AssertionError(f'resume to 10 launched {resumed} (24 each for steps 9-10), '
                             f'checkpoints {steps}')
    log(f'resumed from step 8 to 10: launches {resumed}, checkpoints {steps}')

    # serve the trained model dir
    model = ForwardTransformer.load_model(cm.base_dir / 'model_step_8', device=DEVICE)
    if model.step != 8:
        raise AssertionError(f'model_step_8 holds step {model.step}')
    wavs = synthesize_lines(model, Audio.from_config(model.config),
                            ['Please, say something.'])
    if len(wavs) != 1 or wavs[0].size == 0 or not np.isfinite(wavs[0]).all():
        raise AssertionError('model_step_8 synthesized no finite wav')
    log(f'model_step_8 synthesized {wavs[0].size} samples')

    # a timed step at B32 x 128 tokens x 512 frames, then on to 30 steps on
    # the same batch: the loss must fall
    model = ForwardTransformer.from_config(cm.config, 'cpu').init_params(
        torch.Generator().manual_seed(SEED)).to(DEVICE)
    trainer = ForwardTrainer(model, cm.config['learning_rate_schedule'])
    batch = synthetic_batch(model, seed=SEED)
    losses, times = [], []
    for i in range(30):
        counts = _launch_counts(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(aux['loss'].item())
        per_step = [a - b for a, b in zip(_launch_counts(ops), counts)]
        if per_step != [12, 12, 12]:
            raise AssertionError(f'a training step launched K2/K3/K4 {per_step} times')
    ms = statistics.median(times[3:13]) * 1e3
    frames_per_s = 32 * 512 / (ms / 1e3)
    log(f'train step B32 x 128 tokens x 512 frames, bf16, dropout 0.1: median {ms:.2f} ms '
        f'(steps 4-13: {[round(t * 1e3, 2) for t in times[3:13]]}), {frames_per_s:.1f} '
        f'trained mel frames/s, K2/K3/K4 launches a step 12/12/12')
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f'30 steps on one batch: loss {losses}')
    log(f'30 steps on one batch: mean loss of steps 1-5 {first:.4f}, of steps 26-30 {last:.4f}')
    del trainer, model

    # wiring: f32 at dropout 0, kernel-path grads against eager-path grads
    model32 = ForwardTransformer.from_config(
        {**cm.config, 'compute_dtype': 'float32', 'dropout_rate': 0.0,
         'predictors_dropout': 0.0}, 'cpu').init_params(
        torch.Generator().manual_seed(SEED + 2)).to(DEVICE)
    small = ForwardTrainer(model32, [(0, 0.0)]).to_device(
        synthetic_batch(model32, b=4, n_tok=64, n_frames=256, seed=SEED + 3))
    grads = {}
    for eager in (False, True):
        loss, _ = forward_loss(model32, small, True, None, need_weights=eager)
        grads[eager] = torch.autograd.grad(loss, list(model32.parameters()))
    # a softmax is invariant to a shift of its keys: the wk biases have a zero
    # gradient in exact arithmetic and both paths return rounding noise there,
    # so each leaf's denominator is floored at 1e-4 of the largest leaf norm
    floor = 1e-4 * max(g.norm().item() for g in grads[True])
    rel = {name: ((gk - ge).norm() / max(ge.norm().item(), floor)).item()
           for (name, _), gk, ge in zip(model32.named_parameters(), grads[False], grads[True])}
    worst = max(rel, key=rel.get)
    log(f'wiring, f32 dropout 0, B4 x 64 x 256: kernel vs eager grads, max per-leaf '
        f'relative L2 {rel[worst]:.3g} ({worst}) over {len(rel)} leaves')
    if not rel[worst] < WIRING_REL_L2_BAR:
        raise AssertionError(f'kernel-path grads differ from eager: {rel[worst]} at {worst}')
    return {'launches': launches, 'ms_per_step': ms, 'frames_per_s': frames_per_s}


def _log_mel_case(gen, b: int, n: int, n_fft: int):
    """(b, n + n_fft) reflect-centred noise clips on the device."""
    wav = torch.randn(b, n, device=DEVICE, generator=gen) * 0.3
    return torch.nn.functional.pad(wav[:, None], (n_fft // 2, n_fft // 2),
                                   mode='reflect')[:, 0].contiguous()


def _log_mel_library(wav, sr, n_fft, hop, win, n_mels, f_min, f_max, clip_min=1e-5):
    """One PyTorch stft (cuFFT) call, the magnitude, the mel product and the
    clipped log: the same function as K5, as (B, n_mels, F)."""
    from transformertts_torch.audio.spectral import mel_filterbank
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, f_min, f_max),
                         dtype=torch.float32, device=wav.device)
    window = torch.hann_window(win, periodic=True, device=wav.device)

    def run():
        spec = torch.stft(wav, n_fft, hop, win_length=win, window=window, center=False,
                          return_complex=True).abs()
        return (fb @ spec).clamp_min(clip_min).log()
    return run


def log_mel_kernel_phase() -> dict:
    """K5 against its plain version in float32, what it uses on the card for
    each FFT size, then timed with the plain version and the library call at
    featurization's bucket shapes."""
    from transformertts_torch.ops.fused_log_mel import (fused_log_mel, fused_log_mel_plain,
                                                        kernel_layout, kernel_resources)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    sr = 22050
    # (b, samples, n_fft, hop, win, mels, f_min, f_max): the JAX test's
    # settings, the published ones, win < n_fft, a hop that does not divide
    # n_fft, frame counts off a multiple of 64, a featurization bucket,
    # config/data_config_wavernn.yaml's (f_max None: the Nyquist frequency)
    # and the kernel's smallest FFT
    cases = [(1, sr // 2, 512, 128, 512, 20, 0, 8000), (3, sr // 4, 512, 128, 512, 20, 0, 8000),
             (2, sr, 1024, 256, 1024, 80, 0, 8000), (3, 30000, 1024, 256, 800, 80, 0, 8000),
             (2, 40000, 1024, 300, 1024, 80, 0, 8000), (4, 777, 1024, 256, 1024, 80, 0, 8000),
             (16, 262144 - 1024, 1024, 256, 1024, 80, 0, 8000),
             (4, 60000, 2048, 275, 1100, 80, 40, None), (3, sr // 2, 256, 64, 256, 40, 0, 8000)]
    worst = 0.0
    resources = {}
    for b, n, n_fft, hop, win, mels, f_min, f_max in cases:
        wav = _log_mel_case(gen, b, n, n_fft)
        args = (sr, n_fft, hop, win, mels, f_min, f_max)
        out = fused_log_mel(wav, *args)
        torch.cuda.synchronize()
        ref = fused_log_mel_plain(wav, *args)
        if out.shape != (b, 1 + n // hop, mels) or not torch.isfinite(out).all():
            raise AssertionError(f'K5 output {tuple(out.shape)} or not finite at {args}')
        torch.testing.assert_close(out, ref, **LOG_MEL_TOL)
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        log(f'K5 B{b} x {n} samples, n_fft {n_fft} hop {hop} win {win} mels {mels} f_min '
            f'{f_min} f_max {f_max}: {out.shape[1]} frames, max |kernel - plain| {err:.3g}')
        if (n_fft, hop) not in resources:
            layout = kernel_layout(str(wav.device), *args[:2], win, mels, f_min, f_max)
            r = kernel_resources(n_fft, hop, layout.k_hi - layout.k_lo)
            log(f'K5 at n_fft {n_fft} hop {hop} ({layout.k_hi - layout.k_lo} bins): '
                f'{r["registers"]} registers a thread, {r["spill_bytes"]} spill (local) bytes, '
                f'{r["static_smem_bytes"]} + {r["dynamic_smem_bytes"]} B of shared memory a '
                f'block, {r["blocks_per_sm"]} block(s) of {r["threads"]} threads an SM')
            # the configs' settings keep the kernel in registers; every
            # size fits a block on an SM
            spills = r['spill_bytes'] != 0 and (n_fft, hop) in ((1024, 256), (2048, 275))
            if spills or r['blocks_per_sm'] < 1:
                raise AssertionError(f'K5 at n_fft {n_fft} hop {hop} spills or does not fit: {r}')
            resources[n_fft, hop] = r
    times = {}
    for t in (262144, 131072):
        wav = torch.randn(16, t, device=DEVICE, generator=gen) * 0.3
        args = (sr, 1024, 256, 1024, 80, 0, 8000)
        library = _log_mel_library(wav, *args)
        lib_err = (library().transpose(1, 2) - fused_log_mel_plain(wav, *args)).abs().max()
        ms = _time_ms(lambda: fused_log_mel(wav, *args))
        plain_ms = _time_ms(lambda: fused_log_mel_plain(wav, *args))
        library_ms = _time_ms(library)
        layout = kernel_layout(str(wav.device), sr, 1024, 1024, 80, 0, 8000)
        n_frames = 1 + (t - 1024) // 256
        nnz = int((layout.fb != 0).sum())
        # the work the function needs: a real FFT a frame (2.5·n·log2 n) and
        # the sparse mel product over the filterbank's nonzero weights, in
        # float32; the wav, those weights and the log-mel, in float32
        limit = bound(16 * n_frames * (2.5 * 1024 * math.log2(1024) + 2 * nnz),
                      4 * (16 * t + nnz + 16 * n_frames * 80), 'f32')
        log(f'K5 B16 x {t} samples ({n_frames} frames): kernel {ms:.4f} ms, plain '
            f'{plain_ms:.4f} ms, torch.stft+mel {library_ms:.4f} ms (max |library - plain| '
            f'{lib_err:.3g}), bound {limit["bound_ms"]:.4f} ms ({limit["bound_by"]})')
        times[t] = dict(shape=[16, t], ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        **limit)
    return {'max_abs_err': worst, 'times': times, 'resources': resources[1024, 256]}


def _synthetic_corpus(work: Path, n_clips: int, seed: int = SEED):
    """LJSpeech-like clips at 22,050 Hz drawn from ``seed``: 1-10 s each,
    harmonics of a 90-260 Hz voice with vibrato and syllabic loudness, over
    faint noise; clips over 4 s get one or two gaps of 0.6-1.0 s of near
    silence, which the VAD trims. Writes wavs/ and an LJSpeech metadata.csv;
    returns the clip lengths in samples."""
    from scipy.io import wavfile
    sr = 22050
    rng = np.random.default_rng(seed)
    words = (ROOT / 'config' / 'test_sentences.txt').read_text().lower().split()
    (work / 'wavs').mkdir(parents=True)
    lines, lengths = [], []
    for i in range(n_clips):
        n = int(sr * rng.uniform(1.0, 10.0))
        t = np.arange(n) / sr
        f0 = rng.uniform(90, 260) * (1 + 0.03 * np.sin(2 * np.pi * rng.uniform(4, 6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        voice = sum(rng.uniform(0.1, 0.3) / k * np.sin(k * phase) for k in range(1, 9))
        loud = 0.35 + 0.65 * (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t))
        y = voice * loud + 0.005 * rng.standard_normal(n)
        if n > 4 * sr:
            for _ in range(rng.integers(1, 3)):
                gap = int(sr * rng.uniform(0.6, 1.0))
                start = int(rng.integers(sr, n - sr - gap))
                y[start:start + gap] = 1e-4 * rng.standard_normal(gap)
        wavfile.write(work / 'wavs' / f'LJ{i:03d}-0001.wav', sr,
                      (np.clip(y, -1, 1) * 32767).astype(np.int16))
        text = ' '.join(rng.choice(words, int(rng.integers(3, 15))))
        lines.append(f'LJ{i:03d}-0001|{text}|{text}')
        lengths.append(n)
    (work / 'metadata.csv').write_text('\n'.join(lines) + '\n', encoding='utf-8')
    return lengths


def native_vad_check(cm, card: str) -> dict:
    """The native VAD against the NumPy path on every clip of the corpus,
    as featurization's workers see it before trimming (volume-normalized,
    cut to whole windows): the masks must agree element for element. Then
    ``trim_long_silences`` (native) and the NumPy path, ms a clip on the
    host (the card's machine: ``card``) over the same clips."""
    from transformertts_torch import native
    from transformertts_torch.audio import Audio, vad
    if not native.available():
        raise AssertionError('the native host library did not build (g++)')
    audio = Audio.from_config(cm.config)
    args = (audio.sampling_rate, audio.vad_window_length, audio.vad_moving_average_width,
            audio.vad_max_silence_length)
    window = audio.vad_window_length * audio.sampling_rate // 1000
    wavs = []
    for path in sorted(cm.wav_directory.glob('*.wav')):
        y, _ = audio.load_wav(path, preprocess=False)
        if audio.norm_wav:
            y = audio.normalize_volume(y, increase_only=True)
        wavs.append(y[:len(y) - len(y) % window])
    differ = [i for i, y in enumerate(wavs) if not np.array_equal(
        native.vad_long_silence_mask(y, *args), vad.long_silence_mask(y, *args))]
    if differ:
        raise AssertionError(f'native VAD mask differs from the NumPy path on clips {differ}')
    t0 = time.perf_counter()
    kept = sum(len(vad.trim_long_silences(y, *args)) for y in wavs)
    native_ms = (time.perf_counter() - t0) * 1e3 / len(wavs)
    t0 = time.perf_counter()
    kept_numpy = sum(len(y[vad.long_silence_mask(y, *args)]) for y in wavs)
    numpy_ms = (time.perf_counter() - t0) * 1e3 / len(wavs)
    if kept != kept_numpy or not 0 < kept < sum(map(len, wavs)):
        raise AssertionError(f'trimmed clips keep {kept} samples native, {kept_numpy} NumPy, '
                             f'of {sum(map(len, wavs))}')
    log(f'native VAD: masks equal the NumPy path on all {len(wavs)} clips; '
        f'trim_long_silences {native_ms:.3f} ms a clip native, {numpy_ms:.3f} ms NumPy '
        f'(host of {card}), keeping {kept} of {sum(map(len, wavs))} samples')
    return {'clips': len(wavs), 'native_ms': native_ms, 'numpy_ms': numpy_ms}


def featurization_phase(card: str) -> dict:
    """Stage 1 on the card: the native VAD against the NumPy path, then
    create_training_data over the synthetic corpus."""
    from transformertts_torch import create_training_data
    from transformertts_torch.audio import Audio
    from transformertts_torch.ops.fused_log_mel import fused_log_mel, fused_log_mel_plain
    from transformertts_torch.utils.config import TrainingConfigManager
    work = WORK / 'featurize'
    if work.exists():
        shutil.rmtree(work)
    lengths = _synthetic_corpus(work, N_CLIPS)
    n_test = 8
    cfg = write_session(work, data_overrides={'n_test': n_test})
    cm = TrainingConfigManager(cfg, aligner=True)
    vad_record = native_vad_check(cm, card)

    fused_log_mel.launches = 0
    t0 = time.perf_counter()
    stats = create_training_data.main(['--config', str(cfg), '--device', DEVICE,
                                       '--workers', '4'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_log_mel.launches

    mels = sorted(cm.mel_dir.glob('*.npy'))
    kept = len(mels)
    buckets = math.ceil(kept / create_training_data.BATCH)
    if kept != N_CLIPS or launches != buckets:
        raise AssertionError(f'kept {kept} of {N_CLIPS} clips with {launches} K5 launches, '
                             f'not {buckets}')
    audio = Audio.from_config(cm.config)
    frames, voiced = 0, 0
    for path in mels:
        mel, pitch = np.load(path), np.load(cm.pitch_dir / path.name)
        if mel.ndim != 2 or mel.shape[1] != 80 or pitch.shape != (mel.shape[0],) \
                or not np.isfinite(mel).all() or not np.isfinite(pitch).all():
            raise AssertionError(f'{path.name}: mel {mel.shape}, pitch {pitch.shape}')
        frames += mel.shape[0]
        voiced += int((pitch != 0).sum())
    raw_frames = sum(1 + n // audio.hop_length for n in lengths)
    if not 0 < voiced < frames or not frames < raw_frames:
        raise AssertionError(f'voiced {voiced} of {frames} frames; {raw_frames} before '
                             f'trimming')
    # the longest clip's mel against the plain version of its padded wav
    name = max(mels, key=lambda p: np.load(p).shape[0]).stem
    y, _ = audio.load_wav(cm.wav_directory / f'{name}.wav')
    centered = np.pad(y, audio.n_fft // 2, mode='reflect')[None]
    ref = fused_log_mel_plain(torch.as_tensor(centered, device=DEVICE), audio.sampling_rate,
                              audio.n_fft, audio.hop_length, audio.win_length,
                              audio.mel_channels, audio.f_min, audio.f_max)[0]
    torch.testing.assert_close(torch.as_tensor(np.load(cm.mel_dir / f'{name}.npy'),
                                               device=DEVICE), ref, **LOG_MEL_TOL)
    train = cm.train_metadata_path.read_text(encoding='utf-8').splitlines()
    valid = cm.valid_metadata_path.read_text(encoding='utf-8').splitlines()
    phonemized = cm.phonemized_metadata_path.read_text(encoding='utf-8').splitlines()
    if (len(train), len(valid), len(phonemized)) != (kept - n_test, n_test, kept) \
            or not (cm.data_dir / 'pitch_stats.pkl').exists():
        raise AssertionError(f'split {len(train)} train / {len(valid)} valid / '
                             f'{len(phonemized)} phonemized of {kept}')
    seconds = sum(lengths) / audio.sampling_rate
    log(f'create_training_data: {kept} of {N_CLIPS} clips kept, {seconds:.1f} s of audio, '
        f'{frames} mel frames ({raw_frames} before trimming), voiced share '
        f'{voiced / frames:.3f}, split {len(train)}/{len(valid)}; K5 launches {launches}; '
        f'{name} mel matches the plain version; {wall:.2f} s, {kept / wall:.2f} clips/s, '
        f'{seconds / wall:.2f} s of audio/s; the mel and pitch pass {stats["mel_pitch_s"]:.2f} '
        f's, of it {stats["featurize_batch_s"]:.2f} s in featurize_batch (padding, K5, '
        f'YIN, saving) and the rest waiting on the host workers')
    return {'launches': launches, 'clips_per_s': kept / wall,
            'audio_s_per_s': seconds / wall, 'config': cfg, 'vad': vad_record}


def _aligner_qkv(shape, dtype, gen, step):
    """_qkv's inputs, or for a decode step a bias masking the cache
    positions after ``step``."""
    if step is None:
        return _qkv(shape, dtype, gen)
    q, k, v, bias = _qkv(shape, dtype, gen, pad_keys=False)
    bias[:, step + 1:] = -1e9
    return q, k, v, bias


def aligner_kernel_phase() -> dict:
    """K1 against its plain version at the Aligner's shapes in both dtypes,
    what the float32 kernel uses on the card, then ``aligner_f32_times``."""
    from transformertts_torch.ops.flash_attention import (attention_plain, flash_attention,
                                                          fwd_resources)
    gen = torch.Generator(device='cuda').manual_seed(SEED + 5)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape, causal, step in ALIGNER_CASES:
            q, k, v, bias = _aligner_qkv(shape, dtype, gen, step)
            out = flash_attention(q, k, v, bias, causal)
            torch.cuda.synchronize()
            ref = attention_plain(q, k, v, bias, causal)
            if not torch.isfinite(out).all():
                raise AssertionError(f'K1 output not finite at {shape} {dtype}')
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            err = (out.float() - ref.float()).abs().max().item()
            worst[dtype] = max(worst[dtype], err)
            log(f'Aligner {dtype} {shape} causal={causal} cache step={step}: max |kernel - '
                f'plain| {err:.3g}')
    resources = {label: _resources(label, lambda d: fwd_resources(d, train, torch.float32),
                                   'key_tile', 'f32', gated=(64, 256))
                 for label, train in (('K1', False), ('K2', True))}
    times = aligner_f32_times(gen)
    return {'f32_max_abs_err': worst[torch.float32],
            'aligner_bf16_max_abs_err': worst[torch.bfloat16],
            'f32_resources': resources, **times}


def aligner_f32_times(gen) -> dict:
    """The float32 forward where the Aligner runs it, each time beside its
    plain version, ``scaled_dot_product_attention`` on the same inputs and
    its bounds: K1 at the decoder's causal self-attention and at one decode
    step (Tq 1 against a 1000-position cache), then K2 at the
    self-attention shape at dropout 0.1, checked against its plain version
    first. It calls only the wrappers, so a parent tree's kernels take the
    same calls (a parent/change comparison in one run)."""
    from transformertts_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, h, t, _, d = ALIGNER_SELF_SHAPE
    q, k, v, bias = _qkv(ALIGNER_SELF_SHAPE, torch.float32, gen)
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, bias, True))
    plain_ms = _time_ms(lambda: fa.attention_plain(q, k, v, bias, True))
    mask = _library_mask(q, bias, True)
    backend = _sdpa_backend(q, k, v, mask, 0.0)
    library_ms = _time_ms(lambda: sdpa(q, k, v, attn_mask=mask))
    # the products the causal mask leaves: row i takes keys 0..i; on the
    # tensor cores 3xTF32 makes each of them three TF32 products
    kept = b * h * t * (t + 1) // 2
    nbytes = 4 * (4 * b * h * t * d) + 4 * b * t
    limit = bound(4 * kept * d, nbytes, 'f32')
    tf32 = bound(3 * 4 * kept * d, nbytes, 'tf32')
    log(f'f32 Aligner decoder self-attention {ALIGNER_SELF_SHAPE} causal: kernel {ms:.4f} ms, '
        f'plain {plain_ms:.4f} ms, scaled_dot_product_attention ({backend}, f32, TF32 off) '
        f'{library_ms:.4f} ms, bound {limit["bound_ms"]:.4f} ms on the CUDA cores '
        f'({limit["bound_by"]}, {4 * kept * d / 1e9:.2f} GFLOP), 3xTF32 bound '
        f'{tf32["bound_ms"]:.4f} ms ({tf32["bound_by"]}, {12 * kept * d / 1e9:.2f} GFLOP)')

    # one decode step of predict: Tq 1, the cache positions after it masked
    dshape, _, step = ALIGNER_CASES[4]
    dq_, dk_, dv_, dbias = _aligner_qkv(dshape, torch.float32, gen, step)
    decode_ms = _time_ms(lambda: fa.flash_attention(dq_, dk_, dv_, dbias))
    decode_plain_ms = _time_ms(lambda: fa.attention_plain(dq_, dk_, dv_, dbias))
    decode_library_ms = _time_ms(lambda: sdpa(dq_, dk_, dv_,
                                              attn_mask=dbias[:, None, None, :]))
    db, dh, dtq, dtk, dd = dshape
    decode_limit = bound(4 * db * dh * dtq * dtk * dd,
                         4 * (2 * db * dh * dtq * dd + 2 * db * dh * dtk * dd) + 4 * db * dtk,
                         'f32')
    log(f'f32 Aligner decode step {dshape}, cache step {step}: kernel {decode_ms:.4f} ms, '
        f'plain {decode_plain_ms:.4f} ms, scaled_dot_product_attention '
        f'{decode_library_ms:.4f} ms, bound {decode_limit["bound_ms"]:.4f} ms '
        f'({decode_limit["bound_by"]})')

    # K2 at the self-attention shape, dropout 0.1
    args = (True, 0.1, 1234, 5678)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.attention_fwd_lse_plain(q, k, v, bias, *args)
    torch.testing.assert_close(out, ref_out, **F32_TOL)
    torch.testing.assert_close(lse, ref_lse, **F32_TOL)
    k2_err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
    del out, lse, ref_out, ref_lse
    k2_ms = _time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, bias, *args))
    k2_plain_ms = _time_ms(lambda: fa.attention_fwd_lse_plain(q, k, v, bias, *args))
    k2_backend = _sdpa_backend(q, k, v, mask, 0.1)
    k2_library_ms = _time_ms(lambda: sdpa(q, k, v, attn_mask=mask, dropout_p=0.1))
    k2_bytes = nbytes + 8 * b * h * t   # and the (m, log l) pairs
    k2_limit = bound(4 * kept * d, k2_bytes, 'f32')
    k2_tf32 = bound(3 * 4 * kept * d, k2_bytes, 'tf32')
    log(f'f32 K2 {ALIGNER_SELF_SHAPE} causal, dropout 0.1: max |kernel - plain| {k2_err:.3g} '
        f'(out, lse); kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, '
        f'scaled_dot_product_attention ({k2_backend}, dropout 0.1) {k2_library_ms:.4f} ms, '
        f'bound {k2_limit["bound_ms"]:.4f} ms, 3xTF32 bound {k2_tf32["bound_ms"]:.4f} ms')
    return {'f32_shape': list(ALIGNER_SELF_SHAPE), 'f32_ms': ms, 'f32_plain_ms': plain_ms,
            'f32_library_ms': library_ms, 'f32_library_backend': backend,
            'f32_bound_ms': limit['bound_ms'], 'f32_bound_by': limit['bound_by'],
            'f32_tf32x3_bound_ms': tf32['bound_ms'], 'f32_tf32x3_bound_by': tf32['bound_by'],
            'f32_decode_shape': list(dshape), 'f32_decode_ms': decode_ms,
            'f32_decode_plain_ms': decode_plain_ms,
            'f32_decode_library_ms': decode_library_ms,
            'f32_decode_bound_ms': decode_limit['bound_ms'],
            'k2': {'f32_shape': list(ALIGNER_SELF_SHAPE), 'f32_dropout': 0.1,
                   'f32_max_abs_err': k2_err, 'f32_ms': k2_ms, 'f32_plain_ms': k2_plain_ms,
                   'f32_library_ms': k2_library_ms, 'f32_library_backend': k2_backend,
                   'f32_bound_ms': k2_limit['bound_ms'],
                   'f32_tf32x3_bound_ms': k2_tf32['bound_ms']}}


def _durations_of_batch(model, batch):
    """The extraction CLI's forward and durations for one batch, on the
    kernel path (``need_weights`` False) and the all-eager path."""
    from transformertts_torch.extract_durations import LAST_LAYER_KEY
    from transformertts_torch.ops.duration_extraction import get_durations_from_alignment
    tokens = torch.as_tensor(batch['tokens'], device=DEVICE)
    mel = torch.as_tensor(batch['mel'], device=DEVICE)
    n = int((batch['fname'] != '').sum())
    maps, durations = {}, {}
    with torch.inference_mode():
        for eager in (False, True):
            out = model.apply(tokens, mel[:, :-1], 1, need_weights=eager)
            maps[eager] = out['decoder_attention'][LAST_LAYER_KEY][:n]
            durations[eager] = get_durations_from_alignment(
                maps[eager], batch['mel'][:n], batch['tokens'][:n], weighted=True)[0]
    return maps, durations


def _same_share(ours, theirs) -> float:
    """The share of token durations equal between two lists of per-sample
    duration arrays."""
    return float(np.mean(np.concatenate([a == b for a, b in zip(ours, theirs)])))


def aligner_phase(cfg) -> dict:
    """Stage 3 on the card: the published Aligner in float32 through
    extract_durations over the featurization slice's data dir, then predict
    and a bfloat16 batch."""
    from transformertts_torch import extract_durations
    from transformertts_torch.data.datasets import AlignerDataset, AlignerPreprocessor
    from transformertts_torch.models.aligner import Aligner
    from transformertts_torch.ops.flash_attention import flash_attention
    from transformertts_torch.training import checkpointing
    from transformertts_torch.training.state import make_optimizer
    from transformertts_torch.utils.config import TrainingConfigManager
    cm = TrainingConfigManager(cfg, aligner=True)
    seeded = cm.get_model('cpu').init_params(torch.Generator().manual_seed(SEED))
    model_dir = WORK / 'aligner_model'
    seeded.save_model(model_dir)
    model = Aligner.load_model(model_dir, device=DEVICE)
    for key, value in seeded.state_dict().items():
        if not torch.equal(model.state_dict()[key].cpu(), value):
            raise AssertionError(f'the Aligner model dir did not load back: {key}')
    ckpt = checkpointing.save_checkpoint(cm.weights_dir, seeded, make_optimizer(seeded),
                                         ALIGNER_R1_STEP)
    c = model.config
    log(f'Aligner: d {c["decoder_model_dimension"]}, encoder heads {c["encoder_num_heads"]}, '
        f'decoder heads {c["decoder_num_heads"]}, feed-forward '
        f'{c["decoder_feed_forward_dimension"]}, {c["compute_dtype"]}, '
        f'{sum(p.numel() for p in model.parameters())} parameters; checkpoint '
        f'{ckpt.name}')

    flash_attention.launches = 0
    t0 = time.perf_counter()
    stats = extract_durations.main(['--config', str(cfg), '--autoregressive_weights',
                                    str(ckpt), '--device', DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    if launches == 0 or launches != 13 * stats['batches']:
        raise AssertionError(f'extraction launched K1 {launches} times in {stats["batches"]} '
                             f'batches, not 13 a batch')
    mels = {p.stem: np.load(p).shape[0] for p in cm.mel_dir.glob('*.npy')}
    for name, frames in mels.items():
        dur_path = cm.duration_dir / f'{name}.npy'
        pitch_path = cm.pitch_per_char / f'{name}.npy'
        if not dur_path.exists() or not pitch_path.exists():
            raise AssertionError(f'{name}: no durations or phoneme-wise pitch written')
        dur, pitch = np.load(dur_path), np.load(pitch_path)
        if dur.sum() != frames or pitch.shape != dur.shape or not np.isfinite(pitch).all():
            raise AssertionError(f'{name}: durations sum to {dur.sum()}, not its {frames} '
                                 f'frames, or pitch {pitch.shape} vs durations {dur.shape}')
    clips_per_s = len(mels) / wall
    log(f'extract_durations: {stats["clips"]} clips in {stats["batches"]} batches, durations '
        f'sum to each clip\'s mel frames; K1 launches {launches} (13 a batch); DP backend '
        f'{stats["backend"]}; {wall:.2f} s, {clips_per_s:.2f} clips/s; forward '
        f'{stats["forward_s"]:.2f} s, DP {stats["dp_s"]:.2f} s, host {stats["host_s"]:.2f} s, '
        f'char pitch {stats["char_pitch_s"]:.2f} s')

    model = cm.load_model(ckpt, device=DEVICE, verbose=False)
    prep = AlignerPreprocessor.from_config(cm, model.text_pipeline.tokenizer)
    batch = next(iter(AlignerDataset.from_config(cm, prep, kind='phonemized').get_dataset(
        bucket_batch_sizes=cm.config['val_bucket_batch_size'],
        bucket_boundaries=cm.config['bucket_boundaries'], shuffle=False).all_batches()))
    maps, durations = _durations_of_batch(model, batch)
    map_err = (maps[False] - maps[True]).abs().max().item()
    torch.testing.assert_close(maps[False], maps[True], **ALIGN_MAP_TOL)
    same = _same_share(durations[False], durations[True])
    log(f'one batch {tuple(batch["mel"].shape)}: kernel-path last-block maps vs all-eager, max '
        f'|diff| {map_err:.3g} (bar {ALIGN_MAP_TOL["atol"]}); durations equal {same:.4f}')

    # the same weights in bfloat16, one batch, on both routes
    model16 = bf16_copy(model)
    maps16, durations16 = _durations_of_batch(model16, batch)
    share16 = _same_share(durations16[False], durations[False])
    route16_err = (maps16[False] - maps16[True]).abs().max().item()
    route16_same = _same_share(durations16[False], durations16[True])
    log(f'bfloat16 batch: share of token durations equal to the float32 ones {share16:.4f}; '
        f'kernel-path last-block maps vs all-eager, max |diff| {route16_err:.3g}, durations '
        f'equal {route16_same:.4f}')

    # predict: random weights say nothing about when to stop, so the stop
    # class's bias is pushed down and the decode runs to max_length
    with torch.no_grad():
        model.decoder_postnet.stop_linear.bias[2] = -1e4
    sentence = (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()[0]
    model.predict(sentence, max_length=8)   # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    out = model.predict(sentence, max_length=PREDICT_MAX_LENGTH)
    decode_s = time.perf_counter() - t0
    steps = out['n_steps']
    # the encoder once, then a step's self-attentions and all but the last
    # block's cross-attentions
    n_enc, n_dec = len(model.encoder.dense_layers), len(model.decoder.blocks)
    per_step = (flash_attention.launches - n_enc) / steps
    if steps != PREDICT_MAX_LENGTH + 1 or per_step != 2 * n_dec - 1 \
            or not np.isfinite(out['mel']).all():
        raise AssertionError(f'predict: {steps} steps, {flash_attention.launches} K1 launches')
    log(f'predict "{sentence[:40]}...": {steps} decode steps in {decode_s:.3f} s, '
        f'{steps / decode_s:.1f} steps/s, K1 launches {n_enc} for the encoder and '
        f'{per_step:.0f} a step ({n_dec} self, {n_dec - 1} cross)')
    return {'launches': launches, 'clips_per_s': clips_per_s, 'steps_per_s': steps / decode_s,
            'bf16_same_share': share16, 'map_err': map_err, 'bf16_route_map_err': route16_err,
            'bf16_route_same': route16_same, 'checkpoint': ckpt, **stats}


def bf16_copy(model):
    """An Aligner of ``model``'s config and weights at compute dtype
    bfloat16, on the card, at ``model``'s r."""
    from transformertts_torch.models.aligner import Aligner
    model16 = Aligner.from_config({**model.config, 'compute_dtype': 'bfloat16'}, device=DEVICE)
    model16.load_state_dict(model.state_dict())
    model16.set_constants(reduction_factor=model.r)
    return model16


def aligner_backward_phase() -> dict:
    """K2, K3 and K4 in float32 against their plain versions at the Aligner's
    training shapes (``ALIGNER_BWD_CASES``) at dropout 0 and 0.1, what K3's
    and K4's float32 kernels use on the card (it fails if D 64 or 256
    spills or fits no block), then K3 and K4 timed at the decoder's causal
    self-attention (beside the plain backward too), its last block's at
    D 256 and the cross-attention, each with dropout 0.1 beside
    ``scaled_dot_product_attention``'s float32 backward and two bounds."""
    fa, _ = _trainable_ops()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    errors = {'K2': 0.0, 'K3': 0.0, 'K4': 0.0}
    for shape, causal in ALIGNER_BWD_CASES:
        for rate in (0.0, 0.1):
            q, k, v, bias = _qkv(shape, torch.float32, gen)
            dout = torch.randn(q.shape, device='cuda', generator=gen)
            args = (causal, rate, 1234, 5678)
            out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
            dq = fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.attention_fwd_lse_plain(q, k, v, bias, *args)
            ref = fa.attention_bwd_plain(q, k, v, bias, out, lse, dout, *args)
            for name, mine, want, tol in (('K2', out, ref_out, F32_TOL),
                                          ('K2', lse, ref_lse, F32_TOL),
                                          ('K3', dq, ref[0], F32_GRAD_TOL),
                                          ('K4', dk, ref[1], F32_GRAD_TOL),
                                          ('K4', dv, ref[2], F32_GRAD_TOL)):
                if not torch.isfinite(mine).all() or not want.abs().max() > 0:
                    raise AssertionError(f'{name} not finite, or its plain version all zero, '
                                         f'at {shape} dropout {rate}')
                torch.testing.assert_close(mine, want, **tol)
                errors[name] = max(errors[name], (mine - want).abs().max().item())
            log(f'f32 Aligner training {shape} causal={causal} dropout={rate}: max |kernel - '
                f'plain| out {(out - ref_out).abs().max().item():.3g} dq '
                f'{(dq - ref[0]).abs().max().item():.3g} dk {(dk - ref[1]).abs().max().item():.3g} '
                f'dv {(dv - ref[2]).abs().max().item():.3g}')
            del q, k, v, dout, out, lse, dq, dk, dv, ref_out, ref_lse, ref
    resources = {
        'K3': _resources('K3', lambda d: fa.dq_resources(d, torch.float32), 'query_block',
                         'f32', gated=(64, 256)),
        'K4': _resources('K4', lambda d: fa.dkv_resources(d, torch.float32), 'query_tile',
                         'f32', gated=(64, 256))}
    resources['K3_d256'] = fa.dq_resources(256, torch.float32)
    resources['K4_d256'] = fa.dkv_resources(256, torch.float32)

    decoder = _f32_backward_times(ALIGNER_BWD_SHAPE, True, gen, plain=True)
    last = _f32_backward_times(ALIGNER_BWD_LAST_SHAPE, True, gen)
    cross = _f32_backward_times(ALIGNER_BWD_CROSS_SHAPE, False, gen)
    simt = {('K3', 'decoder'): SIMT_K3_F32_MS, ('K3', 'last block'): SIMT_K3_F32_D256_MS,
            ('K4', 'decoder'): SIMT_K4_F32_MS}
    for name in ('K3', 'K4'):
        for label, run in (('decoder', decoder), ('last block', last), ('cross', cross)):
            before = (f'the SIMT kernel it replaced: {simt[name, label]} ms'
                      if (name, label) in simt else 'the SIMT kernel was not timed here')
            log(f'f32 {name} {label} {run["shape"]}: {run[name]:.4f} ms ({before}), '
                f'{run["bounds"][name]["tf32x3"]["bound_ms"] / run[name]:.1%} of its 3xTF32 '
                f'bound; {run["library_backend"]} f32 backward {run["library_bwd"]:.4f} ms')
    return {'errors': errors, 'resources': resources, **decoder, 'd256': last, 'cross': cross}


def _f32_backward_times(shape, causal: bool, gen, names=('K3', 'K4'), plain=False) -> dict:
    """K3 and K4 (``names``) in float32 at ``shape`` with dropout 0.1,
    timed beside ``scaled_dot_product_attention``'s float32 backward (and,
    with ``plain``, the plain backward) and two bounds: on the CUDA cores,
    and as 3xTF32."""
    fa, _ = _trainable_ops()
    b, h, tq, tk, d = shape
    q, k, v, bias = _qkv(shape, torch.float32, gen)
    dout = torch.randn(q.shape, device='cuda', generator=gen)
    args = (causal, 0.1, 1234, 5678)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
    dsum = fa.row_dot(dout, out)
    calls = {'K3': lambda: fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args,
                                                     dsum=dsum),
             'K4': lambda: fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args,
                                                      dsum=dsum)}
    result = {'shape': list(shape), 'causal': causal}
    result.update({name: _time_ms(calls[name]) for name in names})
    if plain:
        result['plain_bwd'] = _time_ms(
            lambda: fa.attention_bwd_plain(q, k, v, bias, out, lse, dout, *args), iters=5)
    result.update(_library_training_attention(q, k, v, _library_mask(q, bias, causal), dout))
    # the products the causal mask leaves: K3 three (S, dP, dS·K), K4 four
    # (S, dP, dV, dK), each 2·kept·D; float32 inputs q, k, v, dO, (m, log l),
    # D and bias read once, dQ or dK and dV written once
    kept = b * h * (sum(min(r + 1, tk) for r in range(tq)) if causal else tq * tk)
    inputs = 8 * b * h * (tq + tk) * d + 12 * b * h * tq + 4 * b * tk
    result['bounds'] = {}
    for name in names:
        products, written = (3, 4 * b * h * tq * d) if name == 'K3' else (4, 8 * b * h * tk * d)
        flops, nbytes = 2 * products * kept * d, inputs + written
        limit = result['bounds'][name] = {
            'f32': bound(flops, nbytes, 'f32'), 'tf32x3': bound(3 * flops, nbytes, 'tf32'),
            'gflop': flops / 1e9, 'mbytes': nbytes / 1e6}
        log(f'f32 {name} {shape} causal={causal}, dropout 0.1: kernel {result[name]:.4f} ms; '
            f'bound {limit["f32"]["bound_ms"]:.4f} ms on the CUDA cores '
            f'({limit["f32"]["bound_by"]}, {flops / 1e9:.2f} GFLOP that the mask leaves; its '
            f'{nbytes / 1e6:.1f} MB take {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), 3xTF32 bound '
            f'{limit["tf32x3"]["bound_ms"]:.4f} ms')
    log(f'f32 backward {shape} causal={causal}, dropout 0.1: '
        + ' + '.join(f'{name} {result[name]:.4f}' for name in names)
        + (f' ms; plain backward {result["plain_bwd"]:.4f}' if plain else ' ms')
        + f'; scaled_dot_product_attention ({result["library_backend"]}, f32, TF32 off) '
        f'backward {result["library_bwd"]:.4f} ms (forward {result["library_fwd"]:.4f})')
    return result


def _aligner_session(cfg, work: Path, overrides: dict) -> Path:
    """The featurization slice's session (its data dir) with the logs and
    weights under ``work`` and ``overrides`` in ``aligner_settings``."""
    session = yaml.safe_load(Path(cfg).read_text())
    session['paths']['log_directory'] = str(work / 'logs')
    session['aligner_settings'].update(overrides)
    work.mkdir(parents=True, exist_ok=True)
    path = work / 'session.yaml'
    path.write_text(yaml.safe_dump(session))
    return path


def _train_aligner_runs(cfg, work: Path, overrides: dict = None):
    """The published Aligner (``overrides`` in its settings) through
    ``train_aligner.main`` on the featurization slice's data dir, at r = 10
    with both diagonals forced, then at r = 1 with neither, covering a
    plotting step, a checkpoint, validation, predictions and a resume; it
    fails unless every loss is finite and K2/K3/K4 launch 13 times a
    micro-batch on a step that neither forces nor plots and 0 times on one
    that does. Returns the first run (its steps, launches, validation) and
    the session's config manager."""
    from transformertts_torch import train_aligner
    from transformertts_torch.training import checkpointing
    from transformertts_torch.training.aligner_trainer import AlignerTrainer
    from transformertts_torch.utils.config import TrainingConfigManager
    _, ops = _trainable_ops()
    if work.exists():
        shutil.rmtree(work)
    schedule = dict(reduction_factor_schedule=[[0, 10], [2, 1]],
                    force_encoder_diagonal_steps=2, force_decoder_diagonal_steps=2,
                    train_images_plotting_frequency=4, checkpoint_frequency=3,
                    validation_frequency=6, prediction_frequency=6, prediction_start_step=6,
                    prediction_max_length=40,
                    test_sentences_file=str(ROOT / 'config' / 'aligner_test_sentences.txt'))
    steps = []
    train_step = AlignerTrainer.train_step

    def counted(self, batch, r=None, force_encoder_diagonal=False,
                force_decoder_diagonal=False, return_attention=False):
        """The trainer's step, recording its flags, launches and loss."""
        before, step = _launch_counts(ops), self.step
        aux = train_step(self, batch, r, force_encoder_diagonal, force_decoder_diagonal,
                         return_attention)
        steps.append(dict(step=step, r=r, forced=force_encoder_diagonal and
                          force_decoder_diagonal, plot=return_attention,
                          micro=self.grad_accumulation, loss=aux['loss'].item(),
                          launches=[a - b for a, b in zip(_launch_counts(ops), before)]))
        return aux

    AlignerTrainer.train_step = counted
    try:
        runs = []
        for max_steps in (6, 8):
            session = _aligner_session(cfg, work, {**schedule, **(overrides or {}),
                                                   'max_steps': max_steps})
            for f in ops:
                f.launches = 0
            del steps[:]
            t0 = time.perf_counter()
            validation = train_aligner.main(['--config', str(session), '--yes',
                                             '--device', DEVICE])
            torch.cuda.synchronize()
            runs.append(dict(steps=list(steps), launches=_launch_counts(ops),
                             validation=validation, seconds=time.perf_counter() - t0))
    finally:
        AlignerTrainer.train_step = train_step
    cm = TrainingConfigManager(session, aligner=True)
    first, resumed = runs
    for run in runs:
        for st in run['steps']:
            expect = 0 if st['forced'] or st['plot'] else 13 * st['micro']
            if st['launches'] != [expect] * 3 or not np.isfinite(st['loss']):
                raise AssertionError(f'Aligner step {st}: K2/K3/K4 launches not {expect} '
                                     f'each, or the loss not finite')
            if st['r'] != (10 if st['step'] < 2 else 1) or st['forced'] != (st['step'] < 2):
                raise AssertionError(f'Aligner step {st}: r or forcing off the schedule')
    if [st['step'] for st in first['steps']] != list(range(6)) \
            or [st['step'] for st in resumed['steps']] != [6, 7]:
        raise AssertionError(f'train_aligner ran steps {[st["step"] for st in first["steps"]]} '
                             f'then {[st["step"] for st in resumed["steps"]]}, not 0-5 and 6-7')
    if list(first['validation']) != [6] or not np.isfinite(first['validation'][6]):
        raise AssertionError(f'validation at step 6 gave no finite loss: '
                             f'{first["validation"]}')
    ckpts = [s for s, _ in checkpointing.list_checkpoints(cm.weights_dir)]
    if ckpts != [6, 8]:
        raise AssertionError(f'checkpoints {ckpts}, not [6, 8]')
    for name, run in (('steps 0-5', first), ('resumed, steps 6-7', resumed)):
        log(f'train_aligner {name}: {run["seconds"]:.1f} s, K2/K3/K4 launches '
            f'{run["launches"]}; a step: ' + ', '.join(
                f'{st["step"]} r{st["r"]}{" forced" if st["forced"] else ""}'
                f'{" plot" if st["plot"] else ""} {st["launches"][0]} launches loss '
                f'{st["loss"]:.4f}' for st in run['steps']))
    log(f'validation loss at step 6: {first["validation"][6]:.4f}; checkpoints {ckpts}')
    return first, cm


def _aligner_step_ms(cm) -> dict:
    """ms a step of ``cm``'s Aligner (its compute dtype, dropout 0.1), the
    median of steps 4-13 of 30 on one batch, at the config's buckets (r = 1)
    and the largest at r = 10 (``ALIGNER_TRAIN_BUCKETS``); every step must
    launch K2/K3/K4 13 times and give a finite loss, and the middle bucket's
    loss must fall over its 30 steps."""
    from transformertts_torch.profile_train import aligner_batch
    from transformertts_torch.training.aligner_trainer import AlignerTrainer
    _, ops = _trainable_ops()
    dtype = cm.config['compute_dtype']
    times = {}
    for i, (b, frames, n_tok, r) in enumerate(ALIGNER_TRAIN_BUCKETS):
        model = cm.get_model('cpu').init_params(torch.Generator().manual_seed(SEED)).to(DEVICE)
        trainer = AlignerTrainer(model, cm.config['learning_rate_schedule'],
                                 stop_scaling=cm.stop_scaling)
        batch = aligner_batch(model, b, n_tok, frames, SEED)
        losses, step_s = [], []
        for _ in range(30):
            counts = _launch_counts(ops)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aux = trainer.train_step(batch, r=r)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(aux['loss'].item())
            per_step = [a - c for a, c in zip(_launch_counts(ops), counts)]
            if per_step != [13, 13, 13]:
                raise AssertionError(f'an Aligner step launched K2/K3/K4 {per_step} times')
        ms = statistics.median(step_s[3:13]) * 1e3
        head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        if not np.isfinite(losses).all():
            raise AssertionError(f'Aligner B{b} x {frames}f r {r}: loss {losses}')
        log(f'Aligner train step B{b} x {frames} frames x {n_tok} tokens, r {r}, {dtype}, '
            f'dropout 0.1: median {ms:.2f} ms (steps 4-13: {[round(x * 1e3, 2) for x in step_s[3:13]]}), '
            f'{b * frames / (ms / 1e3):.1f} mel frames/s; K2/K3/K4 13 a step; loss of steps '
            f'1-5 {head:.4f}, of steps 26-30 {tail:.4f}')
        times[f'B{b}x{frames}r{r}'] = ms
        # the overfit gate: the middle bucket
        if i == 1 and not tail < head:
            raise AssertionError(f'30 Aligner steps on one batch: loss {losses}')
        del model, trainer
    return times


def aligner_training_phase(cfg) -> dict:
    """Stage 2's training half on the card: the published Aligner (f32,
    dropout 0.1) through ``train_aligner.main`` (``_train_aligner_runs``);
    timed steps at the config's three buckets; the synthetic language's
    convergence on the kernels."""
    first, cm = _train_aligner_runs(cfg, WORK / 'align_train')
    times = _aligner_step_ms(cm)
    conv = synthetic_language_convergence(DEVICE)
    log(f'synthetic language, d 48, 2,500 steps on the kernels: extracted-duration MAE '
        f'{conv["duration_mae"]:.3f} frames (mean true duration {conv["mean_duration"]:.2f}; '
        f'bar 1.5), last loss {conv["final_loss"]:.4f}, {conv["seconds"]:.1f} s')
    if not conv['duration_mae'] < 1.5:
        raise AssertionError(f'the port\'s Aligner did not learn the synthetic language: {conv}')
    return {'launches': first['launches'], 'ms_per_step': times, 'convergence': conv}


def aligner_bf16_kernel_checks() -> dict:
    """The Aligner's kernels in bfloat16: what K1-K4 use on the card at each
    head width (D 64 must not spill; D 64 and 256 must fit a block an SM);
    K2, K3 and K4 against their plain versions at ``ALIGNER_BWD_CASES`` at
    dropout 0 and 0.1, K1 at the decode steps of ``ALIGNER_CASES``; then
    each timed at those shapes (dropout 0.1) beside its plain version,
    ``scaled_dot_product_attention`` in bfloat16 and its bound."""
    fa, _ = _trainable_ops()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 7)
    resources = {}
    for label, query, tile in (('K1', lambda d: fa.fwd_resources(d, False), 'stages'),
                               ('K2', lambda d: fa.fwd_resources(d, True), 'stages'),
                               ('K3', fa.dq_resources, 'key_tile'),
                               ('K4', fa.dkv_resources, 'query_tile')):
        resources[label] = {'d64': _resources(label, query, tile, gated=(64,), fit=(256,)),
                            'd256': query(256)}
    errors = {'K1': 0.0, 'K2': 0.0, 'K3': 0.0, 'K4': 0.0}
    rel_l2 = {'dq': 0.0, 'dk': 0.0, 'dv': 0.0}
    for shape, causal in ALIGNER_BWD_CASES:
        for rate in (0.0, 0.1):
            errs, rels = _check_trainable_case(shape, causal, torch.bfloat16, rate, gen,
                                               'Aligner ')
            errors.update({n: max(errors[n], e) for n, e in errs.items()})
            rel_l2 = {n: max(rel_l2[n], x) for n, x in rels.items()}
    decodes = [(shape, step) for shape, _, step in ALIGNER_CASES if step is not None]
    for shape, step in decodes:
        q, k, v, bias = _aligner_qkv(shape, torch.bfloat16, gen, step)
        out = fa.flash_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v, bias)
        if not torch.isfinite(out).all():
            raise AssertionError(f'K1 bf16 output not finite at {shape}')
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        err = (out.float() - ref.float()).abs().max().item()
        errors['K1'] = max(errors['K1'], err)
        log(f'Aligner bf16 decode step {shape}, cache step {step}: max |K1 - plain| {err:.3g}')

    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for shape, causal in ALIGNER_BWD_CASES:
        q, k, v, bias = _qkv(shape, torch.bfloat16, gen)
        dout = torch.randn(q.shape, device='cuda', generator=gen).to(torch.bfloat16)
        args = (causal, 0.1, 1234, 5678)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
        dsum = fa.row_dot(dout, out)
        t = dict(
            K2=_time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v, bias, *args)),
            K3=_time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout,
                                                          *args, dsum=dsum)),
            K4=_time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout,
                                                           *args, dsum=dsum)),
            plain_fwd=_time_ms(lambda: fa.attention_fwd_lse_plain(q, k, v, bias, *args),
                               iters=5),
            plain_bwd=_time_ms(lambda: fa.attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                                              *args), iters=5))
        t.update(_library_training_attention(q, k, v, _library_mask(q, bias, causal), dout))
        t['bounds'] = _attention_bounds(shape, causal, 2, 'bf16')
        log(f'bf16 Aligner {shape} causal={causal}, dropout 0.1: K2 {t["K2"]:.4f} ms (plain '
            f'{t["plain_fwd"]:.4f}, library {t["library_fwd"]:.4f}, bound '
            f'{t["bounds"]["K2"]["bound_ms"]:.4f}), K3 {t["K3"]:.4f} + K4 {t["K4"]:.4f} ms '
            f'(plain backward {t["plain_bwd"]:.4f}, library backward {t["library_bwd"]:.4f}, '
            f'bounds {t["bounds"]["K3"]["bound_ms"]:.4f} + {t["bounds"]["K4"]["bound_ms"]:.4f} '
            f'({t["bounds"]["K4"]["bound_by"]}))')
        times['x'.join(map(str, shape))] = dict(shape=list(shape), causal=causal, **t)
        del q, k, v, dout, out, lse, dsum
    for shape, step in decodes:
        q, k, v, bias = _aligner_qkv(shape, torch.bfloat16, gen, step)
        mask = bias[:, None, None, :].to(q.dtype)
        t = dict(K1=_time_ms(lambda: fa.flash_attention(q, k, v, bias)),
                 plain=_time_ms(lambda: fa.attention_plain(q, k, v, bias)),
                 library=_time_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
                 library_backend=_sdpa_backend(q, k, v, mask, 0.0),
                 bound=_attention_bounds(shape, False, 2, 'bf16')['K1'])
        log(f'bf16 Aligner decode step {shape}: K1 {t["K1"]:.4f} ms, plain {t["plain"]:.4f}, '
            f'scaled_dot_product_attention ({t["library_backend"]}) {t["library"]:.4f}, bound '
            f'{t["bound"]["bound_ms"]:.4f} ({t["bound"]["bound_by"]})')
        times['decode_' + 'x'.join(map(str, shape))] = dict(shape=list(shape), **t)
    return {'resources': resources, 'errors': errors, 'rel_l2': rel_l2, 'times': times}


def aligner_bf16_phase(cfg, extraction: dict, f32_train: dict) -> dict:
    """The Aligner at compute dtype bfloat16 on the card: its kernels
    (``aligner_bf16_kernel_checks``); ``train_aligner.main`` as the float32
    phase runs it, whose resumed checkpoint must hold float32 leaves; ms a
    step at the config's buckets beside the float32 phase's; the synthetic
    language trained at bfloat16 (duration MAE < 1.5 frames); the float32
    phase's trained language weights run in bfloat16 (durations equal to
    the float32 forward's in at least ``BF16_SAME_WEIGHTS_SHARE`` of the
    tokens) and the extraction phase's bfloat16 batch, kernel path against
    the all-eager path (``BF16_ROUTE_MAP_ATOL``, ``BF16_ROUTE_SAME``);
    ``predict`` at bfloat16 to ``PREDICT_MAX_LENGTH``; then the
    ForwardTransformer half of tests/convergence_check.py on the kernels."""
    from transformertts_torch.models.aligner import Aligner
    from transformertts_torch.ops.duration_extraction import get_durations_from_alignment
    from transformertts_torch.ops.flash_attention import flash_attention
    from transformertts_torch.training import checkpointing
    _, ops = _trainable_ops()
    t0 = time.perf_counter()
    kernels = aligner_bf16_kernel_checks()
    seconds = {'kernels': time.perf_counter() - t0}

    t0 = time.perf_counter()
    first, cm = _train_aligner_runs(cfg, WORK / 'align_train_bf16',
                                    {'compute_dtype': 'bfloat16'})
    resumed = cm.load_model(device=DEVICE, verbose=False)
    with np.load(checkpointing.list_checkpoints(cm.weights_dir)[-1][1]) as data:
        leaf_dtypes = {data[k].dtype for k in data.files if data[k].dtype.kind == 'f'}
    if (leaf_dtypes != {np.dtype(np.float32)} or resumed.compute_dtype != torch.bfloat16
            or any(p.dtype != torch.float32 for p in resumed.parameters())):
        raise AssertionError(f'the bf16 run\'s checkpoint leaves {leaf_dtypes}, or its model '
                             f'not bf16 on float32 parameters')
    ms = _aligner_step_ms(cm)
    seconds['train_aligner'] = time.perf_counter() - t0
    log('Aligner ms/step, bf16 beside f32 (f32 / bf16): ' + ', '.join(
        f'{k} {v:.2f} vs {f32_train["ms_per_step"][k]:.2f} '
        f'({f32_train["ms_per_step"][k] / v:.2f})' for k, v in ms.items()))

    t0 = time.perf_counter()
    for f in ops:
        f.launches = 0
    conv = synthetic_language_convergence(DEVICE, compute_dtype='bfloat16')
    conv_launches = _launch_counts(ops)
    seconds['language'] = time.perf_counter() - t0
    conv32 = f32_train['convergence']
    log(f'synthetic language at bf16, {conv["steps"]} steps on the kernels (K2/K3/K4 '
        f'{conv_launches}): extracted-duration MAE {conv["duration_mae"]:.3f} frames (f32 '
        f'{conv32["duration_mae"]:.3f}; bar 1.5), last loss {conv["final_loss"]:.4f}, '
        f'{conv["seconds"]:.1f} s')
    if not conv['duration_mae'] < 1.5 or min(conv_launches) == 0:
        raise AssertionError(f'the bf16 Aligner did not learn the synthetic language on the '
                             f'kernels: MAE {conv["duration_mae"]}, launches {conv_launches}')

    # the float32-trained language weights through a bfloat16 forward
    t0 = time.perf_counter()
    model32 = Aligner(**conv32['config'])
    model32.load_state_dict(conv32['weights'])
    model16 = bf16_copy(model32)
    batch = conv32['batch']
    with torch.inference_mode():
        out = model16.apply(torch.as_tensor(batch['tokens'], device=DEVICE),
                            torch.as_tensor(batch['mel'][:, :-1], device=DEVICE), 1,
                            need_weights=True)
    attn = out['decoder_attention']['Decoder_LastBlock_CrossAttention'][:8]
    if attn.dtype != torch.float32:
        raise AssertionError(f'the bf16 last-block map is {attn.dtype}, not float32')
    durations16 = get_durations_from_alignment(attn, batch['mel'][:8], batch['tokens'][:8],
                                               weighted=True)[0]
    same_weights = _same_share(durations16, conv32['durations'])
    log(f'f32-trained language weights in bf16: token durations equal to the f32 forward\'s '
        f'{same_weights:.4f} (bar {BF16_SAME_WEIGHTS_SHARE}); published-width extraction batch '
        f'in bf16, kernel path vs all-eager: last-block maps max |diff| '
        f'{extraction["bf16_route_map_err"]:.3g} (bar {BF16_ROUTE_MAP_ATOL}), durations equal '
        f'{extraction["bf16_route_same"]:.4f} (bar {BF16_ROUTE_SAME})')
    if (same_weights < BF16_SAME_WEIGHTS_SHARE
            or not extraction['bf16_route_map_err'] <= BF16_ROUTE_MAP_ATOL
            or extraction['bf16_route_same'] < BF16_ROUTE_SAME):
        raise AssertionError('bf16 extraction off its bars')

    # predict at bf16 to PREDICT_MAX_LENGTH, the stop class held off
    model16 = cm.load_model(extraction['checkpoint'], device=DEVICE, verbose=False)
    if model16.compute_dtype != torch.bfloat16 or model16.r != 1:
        raise AssertionError(f'the bf16 session built a {model16.compute_dtype} Aligner at r '
                             f'{model16.r}')
    with torch.no_grad():
        model16.decoder_postnet.stop_linear.bias[2] = -1e4
    sentence = (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()[0]
    model16.predict(sentence, max_length=8)   # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t1 = time.perf_counter()
    pred = model16.predict(sentence, max_length=PREDICT_MAX_LENGTH)
    decode_s = time.perf_counter() - t1
    steps = pred['n_steps']
    n_enc, n_dec = len(model16.encoder.dense_layers), len(model16.decoder.blocks)
    per_step = (flash_attention.launches - n_enc) / steps
    if steps != PREDICT_MAX_LENGTH + 1 or per_step != 2 * n_dec - 1 \
            or not np.isfinite(pred['mel']).all():
        raise AssertionError(f'bf16 predict: {steps} steps, {flash_attention.launches} K1 '
                             f'launches')
    predict_launches = flash_attention.launches
    log(f'bf16 predict "{sentence[:40]}...": {steps} decode steps in {decode_s:.3f} s, '
        f'{steps / decode_s:.1f} steps/s, K1 launches {n_enc} for the encoder and '
        f'{per_step:.0f} a step')
    seconds['extraction_predict'] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for f in ops:
        f.launches = 0
    tts = forward_language_convergence(DEVICE)
    tts_launches = _launch_counts(ops)
    seconds['tts_language'] = time.perf_counter() - t0
    log(f'ForwardTransformer synthetic language, {tts["steps"]} steps on the kernels (K2/K3/K4 '
        f'{tts_launches}): mean mel loss of the first 20 steps {tts["first"]:.4f}, of the last '
        f'20 {tts["last"]:.4f} (bar 0.25x), {tts["seconds"]:.1f} s')
    if not tts['last'] < 0.25 * tts['first'] or tts_launches != [2 * tts['steps']] * 3:
        raise AssertionError(f'the port\'s ForwardTransformer did not learn the synthetic '
                             f'language on the kernels: {tts}, launches {tts_launches}')
    log('aligner_bf16_phase parts: ' + ', '.join(f'{k} {v:.1f} s' for k, v in seconds.items()))
    return {'kernels': kernels, 'launches': first['launches'], 'ms_per_step': ms,
            'convergence_mae': conv['duration_mae'], 'same_weights': same_weights,
            'predict_launches': predict_launches, 'steps_per_s': steps / decode_s,
            'tts_convergence': tts}


LANG_MEL, LANG_VOCAB = 20, 20   # the synthetic language's mel channels and tokens


def make_language(rng, n_samples=64, n_tok=12, mel_channels=LANG_MEL):
    """A token → mel language whose durations are known (the numpy copy of
    tests/convergence_check.py's): each token id has a fixed mel signature
    and a fixed duration of 2-5 frames. Returns [(tokens int32, durations
    float32, mel (frames, mel_channels) float32)]."""
    signatures = rng.standard_normal((LANG_VOCAB + 1, mel_channels)) * 0.8
    durations_of = rng.integers(2, 6, LANG_VOCAB + 1)
    samples = []
    for _ in range(n_samples):
        toks = rng.integers(1, LANG_VOCAB + 1, n_tok)
        durs = np.asarray([durations_of[t] for t in toks], np.float32)
        frames = []
        for t, d in zip(toks, durs):
            block = np.tile(signatures[t], (int(d), 1))
            block += 0.01 * rng.standard_normal(block.shape)
            frames.append(block)
        mel = np.concatenate(frames, 0).astype(np.float32)
        samples.append((toks.astype(np.int32), durs, mel))
    return samples


def synthetic_language_convergence(device, steps: int = 2500,
                                   compute_dtype: str = 'float32') -> dict:
    """tests/convergence_check.py's Aligner half on the port: an Aligner at d
    48 (heads [2] / [2, 2], ``compute_dtype``, dropout 0.1, prenet dropout
    0.3, r 1) trained ``steps`` steps of B16 on the synthetic language at
    3e-4, the encoder's diagonal forced for 100 steps and the decoder's for
    800, then durations extracted from the last cross-attention of 8 samples
    (weighted heads) against their known durations. Returns the mean
    absolute error in frames, the last loss, the training wall time, and the
    trained weights (on the CPU), the 8-sample batch and its durations."""
    from transformertts_torch.models.aligner import Aligner
    from transformertts_torch.ops.duration_extraction import get_durations_from_alignment
    from transformertts_torch.training.aligner_trainer import AlignerTrainer
    rng = np.random.default_rng(1)
    samples = make_language(rng, n_samples=48)
    n_tok = 12 + 2   # start and end tokens
    t_max = max(s[2].shape[0] for s in samples) + 2
    t_pad = -(-t_max // 16) * 16
    model = Aligner(
        compute_dtype=compute_dtype, encoder_model_dimension=48, decoder_model_dimension=48,
        encoder_num_heads=[2], decoder_num_heads=[2, 2], encoder_max_position_encoding=128,
        decoder_max_position_encoding=256, encoder_prenet_dimension=48,
        decoder_prenet_dimension=48, dropout_rate=0.1, mel_start_value=0.5,
        mel_end_value=-0.5, mel_channels=LANG_MEL, phoneme_language='en-us',
        with_stress=False, decoder_prenet_dropout=0.3, model_breathing=False,
        encoder_feed_forward_dimension=96, decoder_feed_forward_dimension=96, max_r=1)
    model.init_params(torch.Generator().manual_seed(1)).to(device)
    trainer = AlignerTrainer(model, [(0, 3e-4), (10 ** 6, 3e-4)])
    tokenizer = model.text_pipeline.tokenizer

    def batch_of(idx):
        toks = np.zeros((len(idx), n_tok), np.int32)
        mel = np.zeros((len(idx), t_pad, LANG_MEL), np.float32)
        stop = np.zeros((len(idx), t_pad), np.int32)
        for row, i in enumerate(idx):
            t, _, m = samples[i]
            toks[row, 0] = tokenizer.start_token_index
            toks[row, 1:1 + len(t)] = t
            toks[row, 1 + len(t)] = tokenizer.end_token_index
            mel[row, 0] = 0.5
            mel[row, 1:1 + m.shape[0]] = m
            mel[row, 1 + m.shape[0]] = -0.5
            stop[row, :m.shape[0] + 1] = 1
            stop[row, m.shape[0] + 1] = 2
        return {'tokens': toks, 'mel': mel, 'stop_probs': stop}

    t0 = time.perf_counter()
    for step in range(steps):
        aux = trainer.train_step(batch_of(rng.integers(0, len(samples), 16)), r=1,
                                 force_encoder_diagonal=step < 100,
                                 force_decoder_diagonal=step < 800)
    loss = aux['loss'].item()
    seconds = time.perf_counter() - t0
    batch = batch_of(np.arange(8))
    attn = trainer.val_step(batch, r=1)['decoder_attention']['Decoder_LastBlock_CrossAttention']
    durations = get_durations_from_alignment(attn[:8], batch['mel'][:8], batch['tokens'][:8],
                                             weighted=True)[0]
    errors = [np.abs(durations[i].astype(np.float32)[:len(samples[i][1])]
                     - samples[i][1]).mean() for i in range(8)]
    return {'duration_mae': float(np.mean(errors)), 'final_loss': loss, 'seconds': seconds,
            'mean_duration': float(np.mean([s[1].mean() for s in samples])), 'steps': steps,
            'weights': {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            'config': dict(model.config), 'batch': batch, 'durations': durations}


def tts_language_batch(samples, idx) -> dict:
    """tests/convergence_check.py's ForwardTransformer batch of the samples
    ``idx``: tokens, their durations, the mels padded to a multiple of 16
    frames of the longest sample, zero pitch."""
    n_tok = len(samples[0][0])
    t_pad = -(-max(s[2].shape[0] for s in samples) // 16) * 16
    toks = np.zeros((len(idx), n_tok), np.int32)
    durs = np.zeros((len(idx), n_tok), np.float32)
    mel = np.zeros((len(idx), t_pad, LANG_MEL), np.float32)
    for row, i in enumerate(idx):
        t, d, m = samples[i]
        toks[row], durs[row] = t, d
        mel[row, :m.shape[0]] = m
    return {'tokens': toks, 'durations': durs, 'mel': mel,
            'pitch': np.zeros((len(idx), n_tok), np.float32)}


def forward_language_convergence(device, steps: int = 700) -> dict:
    """tests/convergence_check.py's ForwardTransformer half on the port: its
    model (d 64, one block of 2 heads each side, f32, dropout 0.1), its seed
    (0: the language, the batch draws and the weights) and its schedule
    (3e-4), ``steps`` steps of B16 with the target durations. Returns the
    mean mel loss of the first 20 and the last 20 steps and the wall time."""
    from transformertts_torch.models.forward_tts import ForwardTransformer
    from transformertts_torch.training.forward_trainer import ForwardTrainer
    rng = np.random.default_rng(0)
    samples = make_language(rng)
    model = ForwardTransformer(
        encoder_model_dimension=64, decoder_model_dimension=64, dropout_rate=0.1,
        decoder_num_heads=[2], encoder_num_heads=[2], encoder_max_position_encoding=128,
        decoder_max_position_encoding=256, encoder_dense_blocks=1, decoder_dense_blocks=1,
        duration_conv_filters=[32, 16], pitch_conv_filters=[32, 16], duration_kernel_size=3,
        pitch_kernel_size=3, predictors_dropout=0.1, mel_channels=LANG_MEL,
        phoneme_language='en-us', with_stress=False, model_breathing=False,
        encoder_feed_forward_dimension=64, decoder_feed_forward_dimension=64)
    model.init_params(torch.Generator().manual_seed(0)).to(device)
    trainer = ForwardTrainer(model, [(0, 3e-4), (10 ** 6, 3e-4)])
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        aux = trainer.train_step(tts_language_batch(samples, rng.integers(0, len(samples), 16)))
        losses.append(aux['mel'].item())
    return {'first': float(np.mean(losses[:20])), 'last': float(np.mean(losses[-20:])),
            'seconds': time.perf_counter() - t0, 'steps': steps}


def train_child(kind: str, cfg: str, out: str):
    """One training CLI run in this process, the ``main`` that ``python -m
    transformertts_torch.train_tts`` (``kind`` 'tts') or ``.train_aligner``
    runs (``chip_smoke.py --train-child``, started by
    ``data_parallel_phase`` under torchrun or alone): the K2/K3/K4 counts
    set to 0 just before ``main`` and read just after, the backend of any
    process group it brought up and each step's loss, written to ``out`` as
    JSON. PyTorch's deterministic algorithms are on (the length regulator's
    gather backward otherwise adds with atomics in any order, and cuDNN may
    pick such algorithms too), so two runs compare bit for bit."""
    import torch.distributed as dist
    from transformertts_torch import train_aligner, train_tts
    from transformertts_torch.training.base_trainer import BaseTrainer
    tf32_off()
    torch.use_deterministic_algorithms(True, warn_only=True)
    _, ops = _trainable_ops()
    backends, losses = [], []
    init, train_step = dist.init_process_group, BaseTrainer.train_step

    def recording_init(backend=None, **kwargs):
        backends.append(backend)
        return init(backend, **kwargs)

    def recording_step(self, batch, **options):
        aux = train_step(self, batch, **options)
        losses.append(aux['loss'])
        return aux

    dist.init_process_group = recording_init
    BaseTrainer.train_step = recording_step
    for f in ops:
        f.launches = 0
    t0 = time.perf_counter()
    validation = (train_tts if kind == 'tts' else train_aligner).main(
        ['--config', cfg, '--yes', '--device', DEVICE])
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps(dict(
        launches=_launch_counts(ops), seconds=time.perf_counter() - t0, backends=backends,
        losses=[float(x) for x in losses],
        validation={str(k): v for k, v in validation.items()})))


def time_child(cfg: str, out: str):
    """ms a training step with the process group and without it, in one
    process under torchrun (``chip_smoke.py --time-child``): the group of
    one brought up by ``maybe_initialize_distributed``, and for each of the
    session's two models (the TTS at its width, the Aligner at its reduced
    depth) two trainers from the same weights, one on the group's mesh and
    one on a mesh of one process without it, stepped on one fixed batch
    (the TTS B32 x 128 tokens x 512 frames, the Aligner B16 x 896 frames x
    160 tokens at r = 1) with deterministic algorithms off. After
    ``DP_TIME_WARMUP`` steps each, ``DP_TIME_ROUNDS`` rounds of single
    steps in the order grouped, alone, alone, grouped, each timed on the
    host clock between two ``torch.cuda.synchronize()``; written to ``out``
    as JSON: each trainer's step times in ms."""
    from transformertts_torch.parallel import ProcessMesh, maybe_initialize_distributed
    from transformertts_torch.parallel.mesh import destroy_distributed
    from transformertts_torch.profile_train import aligner_batch, synthetic_batch
    from transformertts_torch.training.aligner_trainer import AlignerTrainer
    from transformertts_torch.training.forward_trainer import ForwardTrainer
    from transformertts_torch.utils.config import TrainingConfigManager
    mesh = maybe_initialize_distributed({'mesh': {'data': -1}}, DEVICE)
    if not mesh.grouped:
        raise AssertionError('--time-child runs under torchrun, with a process group')
    result = {}
    try:
        for kind in ('tts', 'aligner'):
            cm = TrainingConfigManager(cfg, aligner=kind == 'aligner')
            schedule = cm.config['learning_rate_schedule']
            trainers = {}
            for label, on in (('grouped', mesh), ('single', ProcessMesh())):
                model = cm.get_model('cpu').init_params(
                    torch.Generator().manual_seed(SEED)).to(DEVICE)
                trainers[label] = (ForwardTrainer(model, schedule, mesh=on) if kind == 'tts'
                                   else AlignerTrainer(model, schedule, mesh=on,
                                                       stop_scaling=cm.stop_scaling))
            model = trainers['single'].model
            if kind == 'tts':
                batch, options = synthetic_batch(model, seed=SEED), {}
            else:
                batch, options = aligner_batch(model, 16, 160, 896, SEED), {'r': 1}
            times = {'grouped': [], 'single': []}
            for _ in range(DP_TIME_WARMUP):
                for trainer in trainers.values():
                    trainer.train_step(batch, **options)
            for _ in range(DP_TIME_ROUNDS):
                for label in ('grouped', 'single', 'single', 'grouped'):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    aux = trainers[label].train_step(batch, **options)
                    torch.cuda.synchronize()
                    times[label].append((time.perf_counter() - t0) * 1e3)
                    if not np.isfinite(aux['loss'].item()):
                        raise AssertionError(f'{kind} {label}: a timed step gave loss '
                                             f'{aux["loss"].item()}')
            result[kind] = times
            del trainers, model
    finally:
        destroy_distributed()
    Path(out).write_text(json.dumps(result))


def _torchrun(*argv) -> list:
    """The command that runs ``argv`` as the one process of a torchrun launch."""
    return [sys.executable, '-m', 'torch.distributed.run', '--standalone',
            '--nproc_per_node', '1', *argv]


def _session_variant(cfg: Path, name: str, section: str = None, overrides: dict = None):
    """``cfg`` with its logs under ``name`` beside it (the data dir shared)
    and ``overrides`` in ``section``."""
    session = yaml.safe_load(cfg.read_text())
    session['paths']['log_directory'] = str(cfg.parent / name)
    if section:
        session[section].update(overrides)
    path = cfg.parent / f'{name}.yaml'
    path.write_text(yaml.safe_dump(session))
    return path


def _start_train_run(kind: str, session: Path, grouped: bool, procs: list):
    """``train_child`` on ``session`` under torchrun (an NCCL group of one)
    or alone (no group), started and added to ``procs``; returns a function
    that waits for it and returns its JSON record, and whether the CLI said
    it ran on a group."""
    out = session.with_suffix('.json')
    argv = [str(ROOT / 'chip_smoke.py'), '--train-child', kind, str(session), str(out)]
    cmd = _torchrun(*argv) if grouped else [sys.executable, *argv]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, 'CUBLAS_WORKSPACE_CONFIG': ':4096:8'})
    procs.append(proc)

    def wait() -> dict:
        try:
            stdout, stderr = proc.communicate(timeout=DP_CHILD_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f'{kind} run {"under torchrun" if grouped else "alone"} '
                                 f'failed ({proc.returncode}): {stdout[-2000:]}\n'
                                 f'{stderr[-4000:]}')
        record = json.loads(out.read_text())
        record['data_parallel'] = 'rank 0 of 1 (data 0 of 1, model 0 of 1)' in stdout
        if record['backends'] != (['nccl'] if grouped else []) \
                or record['data_parallel'] != grouped:
            raise AssertionError(f'{kind}: process groups {record["backends"]} '
                                 f'{"under torchrun" if grouped else "alone"}, not '
                                 f'{"one NCCL group" if grouped else "none"}')
        return record

    return wait


def _start_train_pair(kind: str, cfg: Path, steps: int, procs: list):
    """``kind``'s CLI on ``cfg`` under torchrun and alone, both with
    deterministic algorithms and both started at once (a run's results do
    not depend on what else shares the card); returns a function that waits
    for them and returns the two runs' launches and per-step losses, and
    their final checkpoints compared leaf by leaf, which must agree bit for
    bit."""
    from transformertts_torch.utils.config import TrainingConfigManager
    waits, ckpts = {}, {}
    for label in ('grouped', 'single'):
        session = _session_variant(cfg, f'{kind}_{label}')
        waits[label] = _start_train_run(kind, session, label == 'grouped', procs)
        cm = TrainingConfigManager(session, aligner=kind == 'aligner')
        ckpts[label] = cm.weights_dir / f'ckpt_{steps}.npz'
    return lambda: _train_pair(kind, steps, waits, ckpts)


def _train_pair(kind: str, steps: int, waits: dict, ckpts: dict) -> dict:
    runs = {}
    for label, wait in waits.items():
        runs[label] = wait()
        runs[label]['ckpt'] = ckpts[label]
    grouped, single = runs['grouped'], runs['single']
    if len(grouped['losses']) != steps or len(single['losses']) != steps:
        raise AssertionError(f'{kind}: took {len(grouped["losses"])} and '
                             f'{len(single["losses"])} steps, not {steps}')
    with np.load(grouped['ckpt']) as a, np.load(single['ckpt']) as b:
        if sorted(a.files) != sorted(b.files):
            raise AssertionError(f'{kind}: the checkpoints hold different leaves')
        diffs = [float(np.abs(a[k].astype(np.float64) - b[k]).max(initial=0.0))
                 for k in a.files]
        bitwise = all(np.array_equal(a[k], b[k]) for k in a.files)
    loss_diff = max(abs(x - y) for x, y in zip(grouped['losses'], single['losses']))
    entry = dict(
        launches=grouped['launches'], single_launches=single['launches'],
        losses_bitwise=grouped['losses'] == single['losses'], max_loss_diff=loss_diff,
        ckpt_bitwise=bitwise, max_leaf_diff=max(diffs), leaves=len(diffs),
        seconds=grouped['seconds'], single_seconds=single['seconds'],
        validation=grouped['validation'], single_validation=single['validation'])
    if grouped['launches'] != single['launches']:
        raise AssertionError(f'{kind}: K2/K3/K4 launched {grouped["launches"]} times under '
                             f'torchrun, {single["launches"]} alone')
    if not np.isfinite(grouped['losses']).all() or not entry['losses_bitwise'] \
            or not bitwise:
        raise AssertionError(f'{kind}: torchrun and alone differ: losses by up to '
                             f'{loss_diff}, the final checkpoint by up to {max(diffs)} '
                             f'(losses {grouped["losses"]} and {single["losses"]})')
    return entry


def _step_times(cfg: Path) -> dict:
    """``time_child`` under torchrun on the session ``cfg``: for the TTS and
    the Aligner, ms a step with the group and without it (the medians of
    ``DP_TIME_ROUNDS`` * 2 steps each), and each label's spread (its
    quartiles)."""
    out = cfg.parent / 'step_times.json'
    proc = subprocess.run(_torchrun(str(ROOT / 'chip_smoke.py'), '--time-child', str(cfg),
                                    str(out)),
                          cwd=ROOT, capture_output=True, text=True, timeout=DP_CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f'the timed steps failed ({proc.returncode}): '
                             f'{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}')
    times = json.loads(out.read_text())
    return {kind: {label: dict(ms=statistics.median(t),
                               quartiles=[float(q) for q in np.percentile(t, [25, 75])],
                               steps=len(t))
                   for label, t in runs.items()}
            for kind, runs in times.items()}


def _refusal(cfg: Path) -> str:
    """``mesh: {data: 2}`` under torchrun on one card: train_tts must exit
    non-zero with the tiling message. Returns the message's line."""
    session = _session_variant(cfg, 'refused', 'tts_settings', {'mesh': {'data': 2}})
    proc = subprocess.run(_torchrun('-m', 'transformertts_torch.train_tts', '--config',
                                    str(session), '--yes', '--device', DEVICE),
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=DP_CHILD_TIMEOUT_S)
    said = [l for l in (proc.stdout + proc.stderr).splitlines() if 'does not tile' in l]
    if proc.returncode == 0 or not said:
        raise AssertionError(f'mesh data 2 on one card: exit {proc.returncode}, no tiling '
                             f'message: {proc.stderr[-3000:]}')
    return said[-1].strip()


def _dp_serving(model_dir: Path, card: str) -> dict:
    """``synthesize_lines`` over a one-card mesh against no mesh on a full
    32-line chunk (the same wavs, K1's launches, sentences/s each way,
    median of 3), and ``predict_tts --data_parallel 1`` against no flag."""
    from transformertts_torch import predict_tts
    from transformertts_torch.audio import Audio
    from transformertts_torch.audio.wav_io import load_wav
    from transformertts_torch.models import ForwardTransformer
    from transformertts_torch.models.synthesis import synthesize_lines
    from transformertts_torch.ops.flash_attention import flash_attention
    from transformertts_torch.parallel import MeshConfig, make_mesh
    model = ForwardTransformer.load_model(model_dir, device=DEVICE)
    audio = Audio.from_config(model.config)
    base = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
            if l.strip()]
    lines = (base * VOCODER_CHUNK_LINES)[:VOCODER_CHUNK_LINES]
    mesh = make_mesh(MeshConfig(data=1))
    synthesize_lines(model, audio, lines, mesh=mesh)   # warm
    flash_attention.launches = 0
    meshed = synthesize_lines(model, audio, lines, mesh=mesh)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    plain = synthesize_lines(model, audio, lines)
    diff = max(float(np.abs(a - b).max(initial=0.0)) for a, b in zip(meshed, plain))
    if [w.shape for w in meshed] != [w.shape for w in plain] or not diff <= WARM_WAV_ATOL:
        raise AssertionError(f'mesh serving differs from one device by {diff}')
    blocks = len(PUBLISHED['encoder_num_heads']) + len(PUBLISHED['decoder_num_heads'])
    if launches != blocks:
        raise AssertionError(f'a 32-line chunk over the mesh launched K1 {launches} times, '
                             f'not {blocks}')
    rates = {}
    for label, kwargs in (('mesh', dict(mesh=mesh)), ('one', {})):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synthesize_lines(model, audio, lines, **kwargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        rates[label] = len(lines) / statistics.median(times)
    work = WORK / 'data_parallel' / 'predict'
    work.mkdir(parents=True, exist_ok=True)
    text = work / 'lines.txt'
    text.write_text('\n'.join(base) + '\n')
    written = {}
    for label, flag in (('mesh', ['--data_parallel', '1']), ('one', [])):
        predict_tts.main(['-p', str(model_dir), '-f', str(text), '-o', str(work / label),
                          '--single', '--device', DEVICE, *flag])
        written[label] = {p.name: load_wav(p)[0] for p in sorted((work / label).rglob('*.wav'))}
    if written['mesh'].keys() != written['one'].keys() or len(written['one']) != len(base) + 1 \
            or not all(np.array_equal(written['mesh'][k], written['one'][k])
                       for k in written['one']):
        raise AssertionError('predict_tts --data_parallel 1 wrote other wavs than without it')
    log(f'data-parallel serving ({card}): a {len(lines)}-line chunk over make_mesh(data=1) '
        f'gives the one-device wavs (max |diff| {diff:.3g}), K1 launches {launches}; '
        f'{rates["mesh"]:.3f} sentences/s over the mesh, {rates["one"]:.3f} without '
        f'(median of 3); predict_tts --data_parallel 1 wrote the same {len(written["one"])} '
        f'wavs')
    return dict(launches=launches, sentences_per_s=rates['mesh'],
                one_device_sentences_per_s=rates['one'], max_wav_diff=diff)


def _padded_width_check() -> dict:
    """K1-K4 at head width 100 (their wrappers pad it to 104 and slice the
    outputs back) against the plain versions at D 100, in float32 and
    bfloat16; a head of ``DP_WIDE_HEAD`` through ``MultiHeadAttention``
    takes the eager path and launches no kernel."""
    from transformertts_torch.nn import attention
    fa, ops = _trainable_ops()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 16)
    errors = {'K1': 0.0, 'K2': 0.0, 'K3': 0.0, 'K4': 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        fwd_tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        grad_tol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
        for shape, causal in DP_PADDED_CASES:
            q, k, v, bias = _qkv(shape, dtype, gen)
            dout = torch.randn(q.shape, device='cuda', generator=gen).to(dtype)
            counts = [fa.flash_attention.launches] + _launch_counts(ops)
            out1 = fa.flash_attention(q, k, v, bias, causal)
            out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, causal)
            dq = fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, causal)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, causal)
            torch.cuda.synchronize()
            if [fa.flash_attention.launches] + _launch_counts(ops) != [c + 1 for c in counts]:
                raise AssertionError(f'D 100 at {shape}: a kernel did not launch once')
            ref_out, ref_lse = fa.attention_fwd_lse_plain(q, k, v, bias, causal)
            ref = fa.attention_bwd_plain(q, k, v, bias, out, lse, dout, causal)
            for name, mine, want, tol in (('K1', out1, ref_out, fwd_tol),
                                          ('K2', out, ref_out, fwd_tol),
                                          ('K2', lse, ref_lse, F32_TOL),
                                          ('K3', dq, ref[0], grad_tol),
                                          ('K4', dk, ref[1], grad_tol),
                                          ('K4', dv, ref[2], grad_tol)):
                if mine.shape != want.shape or not torch.isfinite(mine).all():
                    raise AssertionError(f'{name} at D 100 {shape}: shape {mine.shape} or '
                                         f'not finite')
                torch.testing.assert_close(mine.float(), want.float(), **tol)
                errors[name] = max(errors[name], (mine.float() - want.float()).abs().max().item())
    wide = attention.MultiHeadAttention(DP_WIDE_HEAD, 1)
    wgen = torch.Generator().manual_seed(SEED + 17)
    with torch.no_grad():
        for p in wide.parameters():
            p.copy_(torch.randn(p.shape, generator=wgen) * 0.05)
    wide = wide.to(DEVICE)
    x = torch.randn(2, 50, DP_WIDE_HEAD, device=DEVICE, generator=gen)
    before = [fa.flash_attention.launches] + _launch_counts(ops)
    with torch.no_grad():
        out, weights = wide(x, x, x, None, need_weights=False)
        eager, _ = wide(x, x, x, None, need_weights=True)
    torch.cuda.synchronize()
    if [fa.flash_attention.launches] + _launch_counts(ops) != before or weights is not None \
            or not torch.equal(out, eager):
        raise AssertionError(f'a head of {DP_WIDE_HEAD} did not take the eager path')
    log(f'head width 100, padded to 104: K1-K4 against the plain versions at D 100, '
        f'max |err| {", ".join(f"{k} {v:.3g}" for k, v in errors.items())}; a head of '
        f'{DP_WIDE_HEAD} takes the eager path, no kernel launched')
    return errors


def data_parallel_phase(model_dir: Path, card: str) -> dict:
    """Data parallelism on the one card: training under torchrun against
    training alone (TTS at the published width, the Aligner at a reduced
    depth), the tiling refusal, serving over a one-card mesh, and the
    attention at a padded and a too-wide head width."""
    from transformertts_torch.utils.config import TrainingConfigManager
    work = WORK / 'data_parallel'
    if work.exists():
        shutil.rmtree(work)
    mesh = {'data': -1, 'model': 1}
    tts = dict(dropout_rate=0.0, predictors_dropout=0.0, max_steps=DP_TTS_STEPS,
               validation_frequency=DP_TTS_STEPS, checkpoint_frequency=DP_TTS_STEPS,
               weights_save_frequency=10 ** 9, prediction_start_step=10 ** 9, mesh=mesh)
    aligner = dict(DP_ALIGNER, dropout_rate=0.0, decoder_prenet_dropout=0.0,
                   max_steps=DP_ALIGNER_STEPS, reduction_factor_schedule=[[0, 10], [2, 1]],
                   force_encoder_diagonal_steps=1, force_decoder_diagonal_steps=2,
                   train_images_plotting_frequency=4, validation_frequency=DP_ALIGNER_STEPS,
                   checkpoint_frequency=DP_ALIGNER_STEPS, prediction_start_step=10 ** 9,
                   mesh=mesh)
    cfg = write_session(work, tts, aligner_overrides=aligner)
    write_synthetic_data(TrainingConfigManager(cfg), n_train=90, n_valid=6)
    record, procs = {}, []
    try:
        pairs = {kind: _start_train_pair(kind, cfg, steps, procs)
                 for kind, steps in (('tts', DP_TTS_STEPS), ('aligner', DP_ALIGNER_STEPS))}
        entries = {kind: pair() for kind, pair in pairs.items()}
    finally:
        _stop(procs)
    for kind, steps in (('tts', DP_TTS_STEPS), ('aligner', DP_ALIGNER_STEPS)):
        entry = entries[kind]
        log(f'data-parallel {kind} training ({card}), {steps} steps: torchrun (NCCL, world '
            f'size 1) against one process without a group, deterministic algorithms in '
            f'both: losses and final checkpoint ({entry["leaves"]} leaves) bit for bit; '
            f'K2/K3/K4 launches {entry["launches"]} (alone {entry["single_launches"]}); '
            f'validation {entry["validation"]} (alone {entry["single_validation"]})')
        record[kind] = entry
    for kind, times in _step_times(cfg).items():
        record[kind].update(ms_per_step=times['grouped']['ms'],
                            single_ms_per_step=times['single']['ms'], step_times=times)
        log(f'data-parallel {kind} ms/step ({card}), one process, deterministic algorithms '
            f'off, one fixed batch, {times["grouped"]["steps"]} synchronized steps each in '
            f'turns (grouped, alone, alone, grouped): on the NCCL group of one '
            f'{times["grouped"]["ms"]:.3f} (quartiles '
            f'{", ".join(f"{q:.3f}" for q in times["grouped"]["quartiles"])}), without it '
            f'{times["single"]["ms"]:.3f} (quartiles '
            f'{", ".join(f"{q:.3f}" for q in times["single"]["quartiles"])})')
    blocks = len(PUBLISHED['encoder_num_heads']) + len(PUBLISHED['decoder_num_heads'])
    if record['tts']['launches'] != [blocks * DP_TTS_STEPS] * 3:
        raise AssertionError(f'data-parallel TTS: K2/K3/K4 launches {record["tts"]["launches"]}, '
                             f'not {blocks * DP_TTS_STEPS} each')
    # kernel steps: neither forced (steps 0-1) nor plotting (step 3); each
    # attention but the last cross-attention
    per_step = len(DP_ALIGNER['encoder_num_heads']) + 2 * len(DP_ALIGNER['decoder_num_heads']) - 1
    kernel_steps = [s for s in range(DP_ALIGNER_STEPS) if s >= 2 and (s + 1) % 4]
    if record['aligner']['launches'] != [per_step * len(kernel_steps)] * 3:
        raise AssertionError(f'data-parallel Aligner: K2/K3/K4 launches '
                             f'{record["aligner"]["launches"]}, not '
                             f'{per_step * len(kernel_steps)} each')
    record['refusal'] = _refusal(cfg)
    log(f'mesh data 2 on one card under torchrun: refused ("{record["refusal"]}")')
    record['serving'] = _dp_serving(model_dir, card)
    record['padded'] = _padded_width_check()
    return record


def _stop(procs: list):
    """Kill whichever of ``procs`` is still running, and reap it."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _free_ports(n: int) -> list:
    """``n`` distinct free local ports (all bound at once, then released)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(('127.0.0.1', 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def _gloo_collectives(world: int) -> dict:
    """Each collective the mesh runs, on CUDA tensors of this gloo group's
    card in float32 and bfloat16, against the values it must give; the
    optimizer's in-place forms too (a share of the flat buffer as the
    reduce-scatter's output and the all-gather's input)."""
    import torch.distributed as dist
    rank, ok = dist.get_rank(), {}
    total = world * (world + 1) / 2
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((8,), float(rank + 1), device=DEVICE, dtype=dtype)
        ranks = torch.arange(1, world + 1, device=DEVICE, dtype=dtype)[:, None]
        y = x.clone()
        dist.all_reduce(y)
        checks = {'all_reduce': (y == total).all()}
        y = x.clone()
        dist.broadcast(y, 0)
        checks['broadcast'] = (y == 1).all()
        g = torch.empty(8 * world, device=DEVICE, dtype=dtype)
        dist.all_gather_into_tensor(g, x)
        checks['all_gather_into_tensor'] = (g.view(world, 8) == ranks).all()
        out = torch.empty(8, device=DEVICE, dtype=dtype)
        dist.reduce_scatter_tensor(out, x.repeat(world))
        checks['reduce_scatter_tensor'] = (out == total).all()
        flat = x.repeat(world)
        share = flat[rank * 8:(rank + 1) * 8]
        dist.reduce_scatter_tensor(share, flat)
        checks['reduce_scatter_tensor in place'] = (share == total).all()
        flat = torch.zeros(8 * world, device=DEVICE, dtype=dtype)
        flat[rank * 8:(rank + 1) * 8] = rank + 1
        dist.all_gather_into_tensor(flat, flat[rank * 8:(rank + 1) * 8])
        checks['all_gather_into_tensor in place'] = (flat.view(world, 8) == ranks).all()
        for name, good in checks.items():
            ok[f'{name} {str(dtype)[6:]}'] = bool(good)
    return ok


def _mp_nudged_spread(trainer, batch, options, start: str, leaves: dict, out: str, ops):
    """The step from checkpoint ``start`` again, every parameter nudged one
    float32 unit up or down (a seeded sign each): for each moment leaf, the
    largest |difference| from the step's ``leaves``, written to ``out`` as
    JSON. Tensor parallelism and ZeRO-1 change sums in their last bits, so
    this is what a layout may move a moment by at the least. The kernels'
    launch counts are put back: the nudged step is not the path's."""
    from transformertts_torch.training import checkpointing
    counts = _launch_counts(ops)
    step = checkpointing.restore_checkpoint(start, trainer.model, trainer.optimizer)
    trainer.step = step
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + step)
    with torch.no_grad():
        for p in trainer.model.parameters():
            up = torch.rand(p.shape, generator=gen, device=p.device) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf)))
    trainer.train_step(batch, **options)
    nudged = checkpointing.flatten_state(trainer.model, trainer.optimizer, trainer.step)
    n = (len(leaves) - 3) // 3
    spread = {key: float(np.abs(nudged[key].astype(np.float64) - leaves[key]).max(initial=0.0))
              for key in (f'leaf_{i:05d}' for i in range(n + 2, 3 * n + 2))}
    Path(out).write_text(json.dumps(spread))
    for f, c in zip(ops, counts):
        f.launches = c


def _mp_job(job: dict) -> dict:
    """One job of an ``mp_child`` rank: the session's model (seed
    ``SEED``) through ``get_trainer`` on this rank's mesh, ``MP_STEPS``
    steps on one seeded batch: the losses, the K2/K3/K4 launches (counts set
    to 0 just before the steps), the peak memory of the last step, a digest
    of the replicated parameters and this rank's ZeRO-1 share. A
    ``reference`` job (one process) writes its full-width checkpoint before
    the first step and after each (``<states>_<step>.npz``); a ``follow``
    job restores the reference's checkpoint of each step before taking it
    (every rank keeps its parts) and holds the gathered state after it to
    the reference's next one (``_mp_leaf_ratios``, on rank 0), so each step
    is compared from the same start and no difference carries over. The
    reference also takes each step a second time from its parameters
    nudged by one float32 unit (``_mp_nudged_spread``): how far a rounding
    difference alone moves each moment."""
    import gc
    import hashlib
    import torch.distributed as dist
    from transformertts_torch.parallel import ProcessMesh
    from transformertts_torch.profile_train import aligner_batch, synthetic_batch
    from transformertts_torch.models.persistence import params_to_jax
    from transformertts_torch.training import checkpointing
    from transformertts_torch.training.checkpointing import _jax_order
    from transformertts_torch.utils.config import TrainingConfigManager
    aligner = job['kind'] == 'aligner'
    cm = TrainingConfigManager(job['session'], aligner=aligner)
    mesh = ProcessMesh.current(job['model']) if dist.is_initialized() else ProcessMesh()
    model = cm.get_model('cpu').init_params(torch.Generator().manual_seed(SEED)).to(DEVICE)
    trainer = cm.get_trainer(model, mesh=mesh)
    b, n_tok, frames = job['batch']
    if aligner:
        batch, options = aligner_batch(model, b, n_tok, frames, SEED), {'r': 1}
    else:
        batch, options = synthetic_batch(model, b, n_tok, frames, SEED), {}
    states, mode = job.get('states'), job.get('mode')
    names = _jax_order(params_to_jax(model.state_dict()))
    if mode == 'reference':
        np.savez(f'{states}_0.npz', **checkpointing.flatten_state(model, trainer.optimizer, 0))
    _, ops = _trainable_ops()
    for f in ops:
        f.launches = 0
    losses, ratios = [], []
    for i in range(MP_STEPS):
        if i == MP_STEPS - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if mode == 'follow':
            trainer.step = checkpointing.restore_checkpoint(f'{states}_{i}.npz', model,
                                                            trainer.optimizer)
        losses.append(trainer.train_step(batch, **options)['loss'].item())
        if mode is not None:
            leaves = checkpointing.flatten_state(model, trainer.optimizer, trainer.step)
            if mode == 'reference':
                np.savez(f'{states}_{i + 1}.npz', **leaves)
                _mp_nudged_spread(trainer, batch, options, f'{states}_{i}.npz', leaves,
                                  f'{states}_{i + 1}.spread.json', ops)
                trainer.step = checkpointing.restore_checkpoint(
                    f'{states}_{i + 1}.npz', model, trainer.optimizer)
            elif mesh.rank == 0:
                adam = dict(trainer.optimizer.adam.defaults,
                            lr=trainer.optimizer.param_groups[0]['lr'])
                ratios.append(_mp_leaf_ratios(leaves, names, Path(f'{states}_{i}.npz'),
                                              Path(f'{states}_{i + 1}.npz'), adam,
                                              Path(f'{states}_{i + 1}.spread.json')))
            del leaves
    torch.cuda.synchronize()
    record = dict(losses=losses, ratios=ratios, launches=_launch_counts(ops),
                  peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  mesh=[mesh.data_rank, mesh.data_size, mesh.model_rank, mesh.model_size])
    replicated = [p for p in model.parameters() if not hasattr(p, 'tp_dim')]
    record['replicated'] = hashlib.sha256(b''.join(
        p.detach().cpu().numpy().tobytes() for p in replicated)).hexdigest()
    record['sharded'] = sum(p.numel() for p in model.parameters() if hasattr(p, 'tp_dim'))
    group = trainer.optimizer.groups[0]
    record['share'] = [group.start, group.stop, sum(p.numel() for p in model.parameters()),
                       trainer.optimizer.adam.state[group.shard]['exp_avg'].numel()]
    del model, trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return record


def mp_child(rank: str, world: str, port: str, jobs: str, out: str):
    """One rank of ``model_parallel_phase`` (``chip_smoke.py --mp-child``):
    on the card, in a gloo group of ``world`` ranks (none at world 1)
    started without torchrun's environment, the collectives check, then
    each job of the JSON file ``jobs`` (``_mp_job``) with TF32 off and
    deterministic algorithms on; writes the records to ``out`` as JSON."""
    import torch.distributed as dist
    rank, world = int(rank), int(world)
    torch.cuda.set_device(0)
    tf32_off()
    torch.use_deterministic_algorithms(True, warn_only=True)
    if world > 1:
        dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}', rank=rank,
                                world_size=world)
    try:
        records = {'collectives': _gloo_collectives(world) if world > 1 else {}}
        for job in json.loads(Path(jobs).read_text()):
            records[job['name']] = _mp_job(job)
    finally:
        if world > 1:
            dist.destroy_process_group()
    Path(out).write_text(json.dumps(records))


def _mp_spawn(label: str, world: int, jobs: list, work: Path, procs: list, port: int):
    """``world`` ``mp_child`` ranks on ``jobs``, started at once and added
    to ``procs``; returns a function that waits for them (each within
    ``MP_CHILD_TIMEOUT_S``, killing any left) and returns each rank's
    records."""
    path = work / f'jobs_{label}.json'
    path.write_text(json.dumps(jobs))
    outs = [work / f'records_{label}.rank{r}.json' for r in range(world)]
    env = {**os.environ, 'CUBLAS_WORKSPACE_CONFIG': ':4096:8'}
    ranks = [subprocess.Popen([sys.executable, str(ROOT / 'chip_smoke.py'), '--mp-child',
                               str(r), str(world), str(port), str(path), str(outs[r])],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    procs += ranks

    def wait() -> list:
        try:
            for r, proc in enumerate(ranks):
                out, err = proc.communicate(timeout=MP_CHILD_TIMEOUT_S)
                if proc.returncode != 0:
                    raise AssertionError(f'model-parallel rank {r} of {world} failed '
                                         f'({proc.returncode}): {out[-1500:]}\n{err[-4000:]}')
        finally:
            _stop(ranks)
        return [json.loads(o.read_text()) for o in outs]

    return wait


def _mp_leaf_ratios(mine: dict, names: list, start: Path, want: Path, adam: dict,
                    spread: Path) -> dict:
    """A layout's gathered checkpoint leaves ``mine`` after one step against
    one process's (``want``) after the same step from the same checkpoint
    (``start``); ``names`` are the parameters' JAX paths in leaf order,
    ``adam`` the step's lr, betas and eps, ``spread`` the reference's
    nudged-step spread (``_mp_nudged_spread``). The step and counts must be
    equal. Bars, each a ratio (≤ 1 passes):

    - ``adam``: every parameter is the Adam step of its start taken with
      the layout's own gathered moments, to 1e-6·max|leaf| + 1e-3·lr
      (float32 rounding; a share missed by the all-gather is off by ≈ lr);
    - ``params``: every parameter within 2.05·lr of one process's. An
      element whose gradient sits at rounding size takes an Adam step of
      ≈ lr·sign(noise) (ε is 1e-9), so two summation orders may part by two
      steps; the first three are at most 1.0023·lr each at β 0.9/0.98;
    - ``moments``: each first and second moment within 1e-5 +
      3e-4·max|leaf| + 4·spread of one process's, the spread being how far
      one process's own moment moved when its parameters were nudged by one
      float32 unit (at initialization the predictors' LayerNorms over
      mostly-zero ReLU rows, and the key biases' gradient, which is only
      rounding noise since a softmax ignores a shift of its keys, amplify
      last-bit differences far past a fixed bar).

    Also returned: the largest absolute parameter difference and, for each
    bar, the leaf at its worst ratio."""
    lr, (beta1, beta2), eps = adam['lr'], adam['betas'], adam['eps']
    nudge = json.loads(spread.read_text())
    worst = {'adam': 0.0, 'params': 0.0, 'moments': 0.0, 'max_param_diff': 0.0}
    where = {}

    def note(key, ratio, leaf):
        if ratio > worst[key]:
            worst[key], where[key] = ratio, leaf

    with np.load(start) as first, np.load(want) as ref:
        n = len(names)
        if len(ref.files) != 3 * n + 3:
            raise AssertionError(f'{want.name}: {len(ref.files)} leaves, not {3 * n + 3}')
        for i in (0, n + 1, 3 * n + 2):
            if int(mine[f'leaf_{i:05d}']) != int(ref[f'leaf_{i:05d}']):
                raise AssertionError(f'{want.name}: leaf {i} (step or count) differs')
        t = int(ref[f'leaf_{n + 1:05d}'])
        for j, name in enumerate(names):
            keys = [f'leaf_{1 + j:05d}', f'leaf_{n + 2 + j:05d}', f'leaf_{2 * n + 2 + j:05d}']
            p, mu, nu = (mine[k].astype(np.float64) for k in keys)
            if p.shape != ref[keys[0]].shape:
                raise AssertionError(f'{name}: {p.shape}, not {ref[keys[0]].shape}')
            p0 = first[keys[0]].astype(np.float64)
            step = lr * (mu / (1 - beta1 ** t)) / (np.sqrt(nu / (1 - beta2 ** t)) + eps)
            note('adam', float((np.abs(p - (p0 - step)) / (
                1e-6 * np.abs(p0).max(initial=0.0) + 1e-3 * lr)).max(initial=0.0)), name)
            diff = np.abs(p - ref[keys[0]].astype(np.float64))
            note('params', float(diff.max(initial=0.0) / (2.05 * lr)), name)
            worst['max_param_diff'] = max(worst['max_param_diff'], float(diff.max(initial=0.0)))
            for k, label in zip(keys[1:], ('mu', 'nu')):
                b = ref[k].astype(np.float64)
                bar = 1e-5 + 3e-4 * np.abs(b).max(initial=0.0) + 4 * nudge[k]
                note('moments', float((np.abs(mine[k].astype(np.float64) - b) / bar).max(
                    initial=0.0)), f'{name} {label} (nudge spread {nudge[k]:.3g})')
    worst['where'] = where
    return worst


def _mp_profiles(work: Path) -> dict:
    """``profile_train`` on the published TTS step (bf16, B32 x 128 x 512)
    under ``torch.distributed.run --nproc_per_node 1``: an NCCL group of
    one, the flat buffer's all-reduce. Its readings."""
    readings = {}
    for label in ('grouped',):
        out = work / f'profile_{label}.json'
        argv = ['-m', 'transformertts_torch.profile_train', '--json', str(out)]
        cmd = _torchrun(*argv) if label == 'grouped' else [sys.executable, *argv]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=MP_PROFILE_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f'profile_train {label} failed ({proc.returncode}): '
                                 f'{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}')
        readings[label] = json.loads(out.read_text())
        if readings[label]['grouped'] != (label == 'grouped'):
            raise AssertionError(f'profile_train {label}: grouped is '
                                 f'{readings[label]["grouped"]}')
    return readings


def _mp_refusal(session: Path) -> str:
    """``mesh: {data: 1, model: 2}`` under torchrun with one process: train_tts
    must exit non-zero with the tiling message. Returns the message's line."""
    refused = _session_variant(session, 'refused_model', 'tts_settings',
                               {'mesh': {'data': 1, 'model': 2}})
    proc = subprocess.run(_torchrun('-m', 'transformertts_torch.train_tts', '--config',
                                    str(refused), '--yes', '--device', DEVICE),
                          cwd=ROOT, capture_output=True, text=True, timeout=DP_CHILD_TIMEOUT_S)
    said = [l for l in (proc.stdout + proc.stderr).splitlines() if 'does not tile' in l]
    if proc.returncode == 0 or not said:
        raise AssertionError(f'mesh 1x2 on one process: exit {proc.returncode}, no tiling '
                             f'message: {proc.stderr[-3000:]}')
    return said[-1].strip()


def model_parallel_phase(card: str) -> dict:
    """Tensor parallelism (the mesh's ``model`` axis) and ZeRO-1 on the one
    card: 1, 2 and 4 ranks (``mp_child``), the 2 and 4 in gloo groups with
    every rank on the card, started together. The collectives on CUDA
    tensors first; then the TTS at the published width (f32, dropout 0, TF32
    off, ``MP_GATE_BATCH``) and the Aligner at ``DP_ALIGNER``'s depth
    (``MP_ALIGNER_BATCH``, r 1), ``MP_STEPS`` steps each at {1, 2}, {2, 1}
    and {2, 2}, each step from one process's checkpoint of that step (at
    the published learning rate Adam's sign-like first steps move the TTS's
    loss from ~10 to ~23, so a free run would carry rounding differences
    forward and grow them), whose losses and gathered parameters and
    moments must be one process's within the bars of ``_mp_leaf_ratios``;
    bf16 TTS steps
    at the published settings (dropout 0.1) on ``MP_MEMORY_BATCH`` at {1,
    1}, {1, 2}, {2, 1} and {2, 2}, whose losses must be finite, with the
    peak memory of a rank's step; on every run K2/K3/K4 launched per rank as
    often as alone, the model ranks of a data row holding the same
    replicated parameters bit for bit, each data rank ⌈n/D⌉ of the Adam
    state. Then ``mesh: {data: 1, model: 2}`` refused under torchrun, and
    ``profile_train`` with an NCCL group of one."""
    work = WORK / 'model_parallel'
    if work.exists():
        shutil.rmtree(work)
    gates = write_session(work / 'gates', dict(compute_dtype='float32', dropout_rate=0.0,
                                               predictors_dropout=0.0),
                          aligner_overrides=dict(DP_ALIGNER, dropout_rate=0.0,
                                                 decoder_prenet_dropout=0.0))
    published = write_session(work / 'published')

    def job(name, kind, model, mode, session=gates):
        batch = (MP_MEMORY_BATCH if session == published
                 else MP_ALIGNER_BATCH if kind == 'aligner' else MP_GATE_BATCH)
        return dict(name=name, kind=kind, model=model, session=str(session), batch=batch,
                    mode=mode, states=str(work / kind))

    layouts = {f'{d}x{m}': (d, m) for d, m in MP_LAYOUTS}
    t0 = time.perf_counter()
    # the references and the bf16 step alone, then every layout at once,
    # each in its own group
    procs, ports = [], _free_ports(2 + len(layouts))
    try:
        firsts = [_mp_spawn('references', 1, [job('tts', 'tts', 1, 'reference'),
                                              job('aligner', 'aligner', 1, 'reference')],
                            work, procs, ports[0]),
                  _mp_spawn('bf16', 1, [job('bf16', 'tts', 1, None, published)], work, procs,
                            ports[1])]
        alone = {k: v for wait in firsts for k, v in wait()[0].items()}
        waits = {layout: _mp_spawn(layout, d * m, [
            job(f'tts-{layout}', 'tts', m, 'follow'),
            job(f'aligner-{layout}', 'aligner', m, 'follow'),
            job(f'bf16-{layout}', 'tts', m, None, published)], work, procs, port)
            for (layout, (d, m)), port in zip(layouts.items(), ports[2:])}
        records = {layout: wait() for layout, wait in waits.items()}
    finally:
        _stop(procs)
    seconds = time.perf_counter() - t0
    for layout, ranks in records.items():
        for rank, rec in enumerate(ranks):
            bad = [k for k, ok in rec['collectives'].items() if not ok]
            if bad or len(rec['collectives']) != 2 * (len(GLOO_COLLECTIVES) + 2):
                raise AssertionError(f'gloo on CUDA tensors, rank {rank} at {layout}: '
                                     f'wrong {bad} of {sorted(rec["collectives"])}')
    log(f'model parallelism ({card}): gloo (torch {torch.__version__}) takes '
        f'{", ".join(GLOO_COLLECTIVES)} on CUDA tensors in float32 and bfloat16, and the '
        f'in-place reduce-scatter and all-gather, right on every rank of 2 and 4')
    result = {'seconds': seconds, 'layouts': {}, 'memory_gib': {'1x1': alone['bf16']['peak_gib']}}
    for layout, (data, model) in layouts.items():
        ranks = records[layout]
        for kind in ('tts', 'aligner', 'bf16'):
            name = f'{kind}-{layout}'
            ref = alone[kind]
            for rank, rec in enumerate(ranks):
                mine = rec[name]
                if mine['mesh'] != [rank // model, data, rank % model, model]:
                    raise AssertionError(f'{name} rank {rank}: mesh {mine["mesh"]}')
                if mine['launches'] != ref['launches']:
                    raise AssertionError(f'{name} rank {rank}: K2/K3/K4 launched '
                                         f'{mine["launches"]}, alone {ref["launches"]}')
                partner = ranks[rank - rank % model][name]
                if mine['replicated'] != partner['replicated']:
                    raise AssertionError(f'{name}: model rank {rank % model} of data row '
                                         f'{rank // model} holds other replicated '
                                         f'parameters than model rank 0')
                start, stop, n, held = mine['share']
                if held != stop - start or held != -(-n // data) or (data > 1 and held >= n):
                    raise AssertionError(f'{name} rank {rank}: ZeRO-1 share {mine["share"]}')
                if not np.isfinite(mine['losses']).all():
                    raise AssertionError(f'{name} rank {rank}: losses {mine["losses"]}')
                if kind != 'bf16' and not np.allclose(mine['losses'], ref['losses'],
                                                      rtol=MP_LOSS_RTOL, atol=0):
                    raise AssertionError(f'{name} rank {rank}: losses {mine["losses"]}, '
                                         f'alone {ref["losses"]}')
            entry = dict(losses=ranks[0][name]['losses'], launches=ranks[0][name]['launches'],
                         peak_gib=[r[name]['peak_gib'] for r in ranks],
                         sharded=ranks[0][name]['sharded'], share=ranks[0][name]['share'])
            if kind == 'bf16':
                result['memory_gib'][layout] = max(entry['peak_gib'])
            else:
                steps = ranks[0][name]['ratios']
                entry.update({key: max(r[key] for r in steps)
                              for key in ('adam', 'params', 'moments', 'max_param_diff')})
                entry['by_step'] = steps
                if len(steps) != MP_STEPS or max(entry['adam'], entry['params'],
                                                 entry['moments']) > 1:
                    raise AssertionError(f'{name}: the gathered state is off its bars: by step '
                                         f'{steps}')
                entry['alone_losses'] = ref['losses']
            result['layouts'][name] = entry
            log(f'model parallelism {name} ({card}), {MP_STEPS} steps, {data * model} gloo '
                f'ranks on the card: losses {entry["losses"]}'
                + ('' if kind == 'bf16' else
                   f' (alone {ref["losses"]}); each step from one process\'s state: '
                   f'parameters at {entry["adam"]:.3g} of the Adam-step bar and '
                   f'{entry["params"]:.3g} of the 2.05 lr bar, moments at '
                   f'{entry["moments"]:.3g} of theirs (largest parameter difference '
                   f'{entry["max_param_diff"]:.3g}; worst leaves '
                   f'{[r["where"] for r in entry["by_step"]]})')
                + f'; K2/K3/K4 {entry["launches"]} a rank (alone {ref["launches"]}); '
                f'{entry["sharded"]} parameters sharded a rank; ZeRO-1 share '
                f'{entry["share"]}; peak memory a rank {entry["peak_gib"]} GiB')
    for path in work.glob('*.npz'):
        path.unlink()
    log(f'model parallelism peak memory of a bf16 TTS step at B{MP_MEMORY_BATCH[0]} x '
        f'{MP_MEMORY_BATCH[1]} x {MP_MEMORY_BATCH[2]}, largest rank ({card}): '
        + ', '.join(f'{k} {v:.3f} GiB' for k, v in result['memory_gib'].items())
        + f'; the runs took {seconds:.1f} s')
    result['refusal'] = _mp_refusal(gates)
    log(f'mesh data 1 x model 2 on one process under torchrun: refused '
        f'("{result["refusal"]}")')
    result['profiles'] = _mp_profiles(work)
    for label, r in result['profiles'].items():
        log(f'profile_train {label} ({card}, {r["device"]}): {r["launches"]:.0f} launches a '
            f'step, kernels {r["kernel_ms"]:.3f} ms (casts and copies '
            f'{r["kinds"].get("casts and copies", 0.0):.3f}, Adam '
            f'{r["kinds"].get("Adam (foreach)", 0.0):.3f}, elementwise '
            f'{r["kinds"].get("elementwise and other", 0.0):.3f}), '
            f'{r["step_ms"]:.2f} ms a step unprofiled, peak {r["peak_gib"]:.3f} GiB')
    return result


def _add_bf16_aligner_readings(kernels: list, aligner16: dict):
    """Add ``aligner_bf16_phase``'s readings to the K1-K4 entries of the
    kernels line: each shape's time, plain time, library time and bound,
    the resources at D 64 and 256, the errors and the launches."""
    k16 = aligner16['kernels']
    for key, run in k16['times'].items():
        if key.startswith('decode_'):
            kernels[0].setdefault('aligner_bf16_decode', {})[key[len('decode_'):]] = dict(
                ms=run['K1'], plain_ms=run['plain'], library_ms=run['library'],
                library=f'scaled_dot_product_attention ({run["library_backend"]})',
                **run['bound'])
            continue
        for i, label in enumerate(('K2', 'K3', 'K4')):
            plain, library = (('plain_fwd', 'library_fwd') if label == 'K2'
                              else ('plain_bwd', 'library_bwd'))
            kernels[1 + i].setdefault('aligner_bf16', {})[key] = dict(
                causal=run['causal'], dropout=0.1, ms=run[label], plain_ms=run[plain],
                library_ms=run[library], library=f'scaled_dot_product_attention '
                f'({run["library_backend"]}), bf16, dropout 0.1', **run['bounds'][label])
    kernels[0].update(aligner_bf16_decode_max_abs_err=k16['errors']['K1'],
                      aligner_bf16_predict_launches=aligner16['predict_launches'],
                      aligner_bf16_resources=k16['resources']['K1'])
    for i, label in enumerate(('K2', 'K3', 'K4')):
        kernels[1 + i].update(aligner_bf16_training_launches=aligner16['launches'][i],
                              aligner_bf16_max_abs_err=k16['errors'][label],
                              aligner_bf16_resources=k16['resources'][label])
    kernels[2].update(aligner_bf16_rel_l2_dq=k16['rel_l2']['dq'])
    kernels[3].update(aligner_bf16_rel_l2_dk=k16['rel_l2']['dk'],
                      aligner_bf16_rel_l2_dv=k16['rel_l2']['dv'])


def _timed(phase, *args):
    """``phase(*args)``, with its wall seconds logged."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f'{phase.__name__}: {time.perf_counter() - t0:.1f} s')
    return out


def main():
    card = device_phase()
    _timed(build_phase)
    serving = _timed(kernel_phase)
    trainable = _timed(trainable_kernel_phase)
    result = _timed(slice_phase)
    vocoders = _timed(vocoder_phase, result['model_dir'])
    gl = vocoders.pop('Griffin-Lim')
    warm_start = _timed(warm_start_phase, result['model_dir'],
                        vocoders['HiFi-GAN']['checkpoint'], card)
    train = _timed(training_phase)
    log_mel = _timed(log_mel_kernel_phase)
    featurize = _timed(featurization_phase, card)
    aligner_kernels = _timed(aligner_kernel_phase)
    k2_f32 = aligner_kernels.pop('k2')
    f32_resources = aligner_kernels.pop('f32_resources')
    aligner_bwd = _timed(aligner_backward_phase)
    aligner = _timed(aligner_phase, featurize['config'])
    aligner_train = _timed(aligner_training_phase, featurize['config'])
    aligner16 = _timed(aligner_bf16_phase, featurize['config'], aligner, aligner_train)
    data_parallel = _timed(data_parallel_phase, result['model_dir'], card)
    model_parallel = _timed(model_parallel_phase, card)
    times = serving['times']
    dec = times['decoder']
    kernels = [{
        'name': 'flash_attention_fwd', 'route': 'cuda',
        'source': 'transformertts_torch/csrc/flash_attention_fwd.cu',
        'replaces': 'transformertts_tpu/ops/flash_attention.py:48',
        'launches': result['launches'],
        'max_abs_err': serving['max_abs_err'],
        'ms': dec['ms'], 'plain_ms': dec['plain_ms'], 'bound_ms': dec['bound_ms'],
        'bound_by': dec['bound_by'], 'library_ms': dec['library_ms'],
        'library': f'scaled_dot_product_attention ({dec["library_backend"]})',
        'shape': dec['shape'],
        'encoder_ms': times['encoder']['ms'],
        'encoder_plain_ms': times['encoder']['plain_ms'],
        **serving['resources'],
        'vocoder_serving_launches': {k: v['launches'] for k, v in vocoders.items()},
        'warmup_serving_launches': {k: v['launches'] for k, v in warm_start.items()},
        'extraction_launches': aligner['launches'],
        'data_parallel_serving_launches': data_parallel['serving']['launches'],
        'd100_max_abs_err': data_parallel['padded']['K1'],
        **aligner_kernels, 'f32_resources': f32_resources['K1'],
    }]
    t_dec, t_enc = trainable['times']['decoder'], trainable['times']['encoder']
    for i, (name, label, source, line, plain, library) in enumerate((
            ('flash_attention_fwd_lse', 'K2', 'flash_attention_fwd.cu', 151, 'plain_fwd',
             'library_fwd'),
            ('flash_attention_bwd_dq', 'K3', 'flash_attention_bwd.cu', 176, 'plain_bwd',
             'library_bwd'),
            ('flash_attention_bwd_dkv', 'K4', 'flash_attention_bwd.cu', 204, 'plain_bwd',
             'library_bwd'))):
        kernels.append({
            'name': name, 'route': 'cuda', 'source': f'transformertts_torch/csrc/{source}',
            'replaces': f'transformertts_tpu/ops/flash_attention.py:{line}',
            'launches': train['launches'][i],
            'max_abs_err': trainable['errors'][label],
            'ms': t_dec[label], 'plain_ms': t_dec[plain], **t_dec['bounds'][label],
            'library_ms': t_dec[library],
            'library': (f'scaled_dot_product_attention ({t_dec["library_backend"]}), dropout '
                        f'0.1, {"forward" if label == "K2" else "backward (dQ, dK, dV)"}'),
            'shape': t_dec['shape'],
            'encoder_ms': t_enc[label], 'encoder_plain_ms': t_enc[plain],
            'encoder_bound_ms': t_enc['bounds'][label]['bound_ms'],
            'encoder_bound_by': t_enc['bounds'][label]['bound_by'],
            'encoder_library_ms': t_enc[library],
        })
    rel_l2 = trainable['rel_l2']
    kernels[1].update(trainable['resources']['K2'], **k2_f32,
                      f32_resources=f32_resources['K2'])
    kernels[-2].update(rel_l2_dq=rel_l2['dq'], **trainable['resources']['K3'])
    kernels[-1].update(rel_l2_dk=rel_l2['dk'], rel_l2_dv=rel_l2['dv'],
                       **trainable['resources']['K4'])
    # the float32 backward, the Aligner training path's
    for i, label in enumerate(('K2', 'K3', 'K4')):
        kernels[1 + i].update(
            aligner_training_launches=aligner_train['launches'][i],
            data_parallel_training_launches=data_parallel['tts']['launches'][i],
            data_parallel_aligner_launches=data_parallel['aligner']['launches'][i],
            d100_max_abs_err=data_parallel['padded'][label],
            model_parallel_launches={
                name: run['launches'][i] for name, run in model_parallel['layouts'].items()})
    for entry, label in ((kernels[-2], 'K3'), (kernels[-1], 'K4')):
        limit = aligner_bwd['bounds'][label]
        entry.update(
            f32_shape=aligner_bwd['shape'], f32_causal=True, f32_dropout=0.1,
            f32_max_abs_err=aligner_bwd['errors'][label], f32_ms=aligner_bwd[label],
            f32_plain_ms=aligner_bwd['plain_bwd'], f32_library_ms=aligner_bwd['library_bwd'],
            f32_library=(f'scaled_dot_product_attention ({aligner_bwd["library_backend"]}), '
                         f'f32, TF32 off, dropout 0.1, backward (dQ, dK, dV)'),
            f32_bound_ms=limit['f32']['bound_ms'], f32_bound_by=limit['f32']['bound_by'],
            f32_tf32x3_bound_ms=limit['tf32x3']['bound_ms'],
            f32_resources=aligner_bwd['resources'][label],
            f32_d256_resources=aligner_bwd['resources'][f'{label}_d256'])
        # the last decoder block's one head of 256, and the cross-attention
        for key, run in (('d256', aligner_bwd['d256']), ('cross', aligner_bwd['cross'])):
            entry.update({
                f'f32_{key}_shape': run['shape'], f'f32_{key}_causal': run['causal'],
                f'f32_{key}_ms': run[label],
                f'f32_{key}_tf32x3_bound_ms': run['bounds'][label]['tf32x3']['bound_ms'],
                f'f32_{key}_library_ms': run['library_bwd'],
                f'f32_{key}_library': f'scaled_dot_product_attention '
                                      f'({run["library_backend"]}), f32 backward'})
    _add_bf16_aligner_readings(kernels, aligner16)
    big, small = log_mel['times'][262144], log_mel['times'][131072]
    kernels.append({
        'name': 'fused_log_mel', 'route': 'cuda',
        'source': 'transformertts_torch/csrc/fused_log_mel.cu',
        'replaces': 'transformertts_tpu/ops/stft_pallas.py:41',
        'launches': featurize['launches'], 'max_abs_err': log_mel['max_abs_err'],
        'ms': big['ms'], 'plain_ms': big['plain_ms'], 'bound_ms': big['bound_ms'],
        'bound_by': big['bound_by'], 'library_ms': big['library_ms'],
        'library': 'torch.stft (cuFFT) + abs + mel matmul + clamp_min().log()',
        'shape': big['shape'],
        'half_ms': small['ms'], 'half_plain_ms': small['plain_ms'],
        'half_library_ms': small['library_ms'], 'half_bound_ms': small['bound_ms'],
        **log_mel['resources'],
    })
    log(f'training: {train["ms_per_step"]:.2f} ms/step, {train["frames_per_s"]:.1f} trained '
        f'mel frames/s at B32 x 512 frames')
    log('vocoder serving, 4 lines (one call): ' + ', '.join(
        f'{k} {v["sentences_per_s"]:.3f} sentences/s, {v["audio_s_per_s"]:.2f} s of audio/s'
        for k, v in vocoders.items()) + f'; Griffin-Lim {result["sentences_per_s"]:.3f} '
        f'sentences/s')
    log(f'vocoder serving, full {VOCODER_CHUNK_LINES}-line chunk (median of 3): ' + ', '.join(
        f'{k} {v["chunk_sentences_per_s"]:.3f} sentences/s, {v["chunk_audio_s_per_s"]:.2f} s '
        f'of audio/s, generator {v["full_generator"]["ms"]:.4f} ms at '
        f'{tuple(v["full_generator"]["shape"])} (bound {v["full_generator"]["bound_ms"]:.4f}, '
        f'peak {v["full_generator"]["peak_gb"]:.3f} GB)' for k, v in vocoders.items())
        + f'; Griffin-Lim {gl["chunk_sentences_per_s"]:.3f} sentences/s')
    log(f'serving warm start ({card}): ' + '; '.join(
        f'{k} first request {v["cold_first_ms"]:.1f} ms cold, {v["warm_first_ms"]:.1f} ms '
        f'warmed, {v["steady_ms"]:.1f} ms steady, warm-up {v["warmup_s"]:.2f} s'
        for k, v in warm_start.items()))
    log(f'featurization: {featurize["clips_per_s"]:.2f} clips/s, '
        f'{featurize["audio_s_per_s"]:.2f} s of audio/s; native VAD '
        f'{featurize["vad"]["native_ms"]:.3f} ms a clip, NumPy {featurize["vad"]["numpy_ms"]:.3f} '
        f'(host of {card})')
    log(f'duration extraction: {aligner["clips_per_s"]:.2f} clips/s; predict '
        f'{aligner["steps_per_s"]:.1f} decode steps/s')
    log('Aligner training: ' + ', '.join(f'{k} {v:.2f} ms/step' for k, v
                                         in aligner_train['ms_per_step'].items())
        + f'; synthetic-language duration MAE '
        f'{aligner_train["convergence"]["duration_mae"]:.3f} frames')
    log(f'Aligner at bf16 ({card}): ' + ', '.join(
        f'{k} {v:.2f} ms/step (f32 {aligner_train["ms_per_step"][k]:.2f})'
        for k, v in aligner16['ms_per_step'].items())
        + f'; synthetic-language duration MAE {aligner16["convergence_mae"]:.3f} frames; '
        f'same-weights durations {aligner16["same_weights"]:.4f}; predict '
        f'{aligner16["steps_per_s"]:.1f} decode steps/s; ForwardTransformer language mel loss '
        f'{aligner16["tts_convergence"]["first"]:.4f} -> {aligner16["tts_convergence"]["last"]:.4f}')
    dp_tts, dp_aligner = data_parallel['tts'], data_parallel['aligner']
    log(f'data parallelism at world size 1 ({card}), synchronized steps in turns on one '
        f'batch: TTS {dp_tts["ms_per_step"]:.3f} ms/step on an NCCL group of one, '
        f'{dp_tts["single_ms_per_step"]:.3f} without; Aligner (reduced depth) '
        f'{dp_aligner["ms_per_step"]:.3f} and {dp_aligner["single_ms_per_step"]:.3f}; '
        f'serving over a one-card mesh {data_parallel["serving"]["sentences_per_s"]:.3f} '
        f'sentences/s, {data_parallel["serving"]["one_device_sentences_per_s"]:.3f} without')
    mp = model_parallel
    log(f'model parallelism on one card ({card}), gloo ranks: TTS (f32, published width) and '
        f'Aligner (2 + 2 blocks) at ' + ', '.join(f'{d}x{m}' for d, m in MP_LAYOUTS)
        + f' match one process; bf16 TTS peak memory a rank '
        + ', '.join(f'{k} {v:.3f} GiB' for k, v in mp['memory_gib'].items())
        + '; profile_train ' + ', '.join(
            f'{k} {v["launches"]:.0f} launches, {v["kernel_ms"]:.3f} kernel ms'
            for k, v in mp['profiles'].items()))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--train-child']:
        sys.exit(train_child(*sys.argv[2:]))
    if sys.argv[1:2] == ['--time-child']:
        sys.exit(time_child(*sys.argv[2:]))
    if sys.argv[1:2] == ['--mp-child']:
        sys.exit(mp_child(*sys.argv[2:]))
    sys.exit(main())
