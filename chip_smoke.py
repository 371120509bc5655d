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
8. featurization slice: ``transformertts_torch.create_training_data`` (its
   ``main``) over 64 seeded synthetic LJSpeech-like clips of 1-10 s, with
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
   K4 timed at the decoder's self-attention with dropout 0.1 beside the
   plain backward, ``scaled_dot_product_attention``'s float32 backward and
   two bounds (on the CUDA cores, and as 3xTF32);
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
   maps);
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
13. the last three lines: the kernels' JSON record (each kernel's time, its
   plain version's, one PyTorch library call's that computes the same
   function, and its bound: the larger of the FLOPs the function needs
   (for K5 an FFT's) over the card's peak rate for their type and its
   bytes, each input read once and each output written once, over
   3.35 TB/s), the card's name and power limit, then the contract line.
"""
import json
import math
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
PREDICT_MAX_LENGTH = 400
# the published Aligner's training attentions at the config's largest bucket,
# B16 x 896 frames x 160 tokens, (B, H, Tq, Tk, D) and causal: the decoder's
# self-attention at D 64 and its last block's at D 256, the cross-attention,
# the encoder's self-attention
ALIGNER_BWD_SHAPE = (16, 4, 896, 896, 64)
ALIGNER_BWD_CASES = [(ALIGNER_BWD_SHAPE, True), ((16, 1, 896, 896, 256), True),
                     ((16, 4, 896, 160, 64), False), ((16, 4, 160, 160, 64), False)]
# (B, frames, tokens, r): scripts/measure_train_step.py's three buckets at r = 1,
# and the largest at r = 10
ALIGNER_TRAIN_BUCKETS = [(64, 256, 48, 1), (32, 512, 96, 1), (16, 896, 160, 1),
                         (16, 896, 160, 10)]

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


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available() '
                         'is false); the port is measured on the card only')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _resources(label: str, query, tile: str, dtype: str = 'bf16',
               gated=(192,)) -> dict:
    """Log what a kernel uses on the card at each head-width template
    (``query(d)``, one of ops.flash_attention's ``*_resources``); raise if a
    ``gated`` width (the bf16 kernels' training and serving width, D 192;
    the f32 forward's Aligner widths, D 64 and 256) spills or fits no
    block. Returns the first gated width's resources."""
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
        b, h, tq, tk, d = shape
        limit = bound(4 * b * h * tq * tk * d,
                      2 * (2 * b * h * tq * d + 2 * b * h * tk * d) + 4 * b * tk, 'bf16')
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
        fwd_tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        grad_tol = F32_GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL
        for shape, causal in cases + (EDGE_CASES if dtype == torch.bfloat16 else []):
            # a softmax over one key has no gradient to its logit: dQ and dK
            # are 0 at Tk 1, and only their absolute bar applies
            zero = ('dq', 'dk') if shape[3] == 1 else ()
            for rate in (0.0, 0.1):
                q, k, v, bias = _qkv(shape, dtype, gen)
                dout = torch.randn(q.shape, device='cuda', generator=gen).to(dtype)
                args = (causal, rate, 1234, 5678)
                out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
                dq = fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args)
                torch.cuda.synchronize()
                ref_out, ref_lse = fa.attention_fwd_lse_plain(q, k, v, bias, *args)
                ref = fa.attention_bwd_plain(q, k, v, bias, out, lse, dout, *args)
                checks = (('K2', 'out', out, ref_out, fwd_tol),
                          ('K2', 'lse', lse, ref_lse, F32_TOL),
                          ('K3', 'dq', dq, ref[0], grad_tol), ('K4', 'dk', dk, ref[1], grad_tol),
                          ('K4', 'dv', dv, ref[2], grad_tol))
                for name, what, mine, want, tol in checks:
                    if not torch.isfinite(mine).all():
                        raise AssertionError(f'{name} not finite at {shape} {dtype} {rate}')
                    if what not in zero and not want.abs().max() > 0:
                        raise AssertionError(f'{name}: the plain {what} is all zero')
                    torch.testing.assert_close(mine.float(), want.float(), **tol)
                    errors[name] = max(errors[name],
                                       (mine.float() - want.float()).abs().max().item())
                rel = ''
                if dtype == torch.bfloat16:
                    # the plain K3 and K4 in float32 from the same bf16 inputs
                    ref32 = fa.attention_bwd_plain(q.float(), k.float(), v.float(), bias,
                                                   out.float(), lse, dout.float(), *args)
                    rels = {n: _rel_l2(g, r) for n, g, r in zip(('dq', 'dk', 'dv'),
                                                                 (dq, dk, dv), ref32)
                            if n not in zero}
                    if not max(rels.values()) < GRAD_REL_L2_BAR:
                        raise AssertionError(f'K3/K4 relative L2 error {rels} at {shape} '
                                             f'dropout {rate}, bar {GRAD_REL_L2_BAR}')
                    if shape == TRAIN_DECODER_SHAPE:
                        rel_l2 = {n: max(rel_l2[n], x) for n, x in rels.items()}
                    rel = '; relative L2 vs float32 plain ' + ' '.join(
                        f'{n} {x:.3g}' for n, x in rels.items())
                    del ref32
                log(f'{dtype} {shape} causal={causal} dropout={rate}: max |kernel - plain| '
                    f'out {(out.float() - ref_out.float()).abs().max().item():.3g} '
                    f'dq {(dq.float() - ref[0].float()).abs().max().item():.3g} '
                    f'dk {(dk.float() - ref[1].float()).abs().max().item():.3g} '
                    f'dv {(dv.float() - ref[2].float()).abs().max().item():.3g} '
                    f'(max |plain dq| {ref[0].float().abs().max().item():.3g}){rel}')
                del q, k, v, dout, out, lse, dq, dk, dv, ref_out, ref_lse, ref
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
        t.update(_library_training_attention(q, k, v, bias[:, None, None, :].to(q.dtype),
                                             dout))
        b, h, tq, tk, d = shape
        # bf16 rows of q or o, dO or dQ (each b·h·tq·d) and of k, v, dK or dV
        # (each b·h·tk·d); float32 bias, (m, log l) pairs and D rows
        q_row, k_row = 2 * b * h * tq * d, 2 * b * h * tk * d
        lse_bytes, dsum_bytes, bias_bytes = 8 * b * h * tq, 4 * b * h * tq, 4 * b * tk
        t['bounds'] = {
            # in: q, k, v, bias; out: o, (m, log l)
            'K2': bound(4 * b * h * tq * tk * d,
                        2 * q_row + 2 * k_row + lse_bytes + bias_bytes, 'bf16'),
            # in: q, k, v, dO, (m, log l), D, bias; out: dQ
            'K3': bound(6 * b * h * tq * tk * d,
                        3 * q_row + 2 * k_row + lse_bytes + dsum_bytes + bias_bytes, 'bf16'),
            # in: q, k, v, dO, (m, log l), D, bias; out: dK, dV
            'K4': bound(8 * b * h * tq * tk * d,
                        2 * q_row + 4 * k_row + lse_bytes + dsum_bytes + bias_bytes, 'bf16')}
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
    return {'launches': launches}


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


def featurization_phase() -> dict:
    """Stage 1 on the card: create_training_data over the synthetic corpus."""
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
            'audio_s_per_s': seconds / wall, 'config': cfg}


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
    # the library's additive (B, 1, T, T) mask: key padding plus the look-ahead
    look_ahead = torch.triu(torch.full((t, t), -1e9, device='cuda'), diagonal=1)
    mask = bias[:, None, None, :] + look_ahead
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


def aligner_phase(cfg) -> dict:
    """Stage 3 on the card: the published Aligner in float32 through
    extract_durations over the featurization slice's data dir, then predict
    and a bfloat16 batch."""
    from transformertts_torch import extract_durations
    from transformertts_torch.data.datasets import AlignerDataset, AlignerPreprocessor
    from transformertts_torch.models.aligner import Aligner
    from transformertts_torch.ops.flash_attention import flash_attention
    from transformertts_torch.training import checkpointing
    from transformertts_torch.utils.config import TrainingConfigManager
    cm = TrainingConfigManager(cfg, aligner=True)
    seeded = cm.get_model('cpu').init_params(torch.Generator().manual_seed(SEED))
    model_dir = WORK / 'aligner_model'
    seeded.save_model(model_dir)
    model = Aligner.load_model(model_dir, device=DEVICE)
    for key, value in seeded.state_dict().items():
        if not torch.equal(model.state_dict()[key].cpu(), value):
            raise AssertionError(f'the Aligner model dir did not load back: {key}')
    ckpt = checkpointing.save_checkpoint(cm.weights_dir, seeded,
                                         torch.optim.Adam(seeded.parameters()), ALIGNER_R1_STEP)
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
    same = np.mean(np.concatenate([a == b for a, b in zip(durations[False], durations[True])]))
    log(f'one batch {tuple(batch["mel"].shape)}: kernel-path last-block maps vs all-eager, max '
        f'|diff| {map_err:.3g} (bar {ALIGN_MAP_TOL["atol"]}); durations equal {same:.4f}')

    # the same weights in bfloat16, one batch
    model16 = Aligner.from_config({**model.config, 'compute_dtype': 'bfloat16'}, device=DEVICE)
    model16.load_state_dict(model.state_dict())
    model16.set_constants(reduction_factor=1)
    _, durations16 = _durations_of_batch(model16, batch)
    share16 = np.mean(np.concatenate([a == b for a, b in zip(durations16[False],
                                                              durations[False])]))
    log(f'bfloat16 batch: share of token durations equal to the float32 ones {share16:.4f}')

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
            'bf16_same_share': share16, 'map_err': map_err, **stats}


def aligner_backward_phase() -> dict:
    """K2, K3 and K4 in float32 against their plain versions at the Aligner's
    training shapes (``ALIGNER_BWD_CASES``) at dropout 0 and 0.1, what K3's
    and K4's float32 kernels use on the card (it fails if D 64 or 256
    spills or fits no block), then K3 and K4 timed at the decoder's causal
    self-attention with dropout 0.1 beside the plain backward,
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
        'K3': _resources('K3', lambda d: fa.dq_resources(d, torch.float32), 'query_rows',
                         'f32', gated=(64, 256)),
        'K4': _resources('K4', lambda d: fa.dkv_resources(d, torch.float32), 'query_tile',
                         'f32', gated=(64, 256))}
    resources['K3_d256'] = fa.dq_resources(256, torch.float32)
    resources['K4_d256'] = fa.dkv_resources(256, torch.float32)

    b, h, t, _, d = ALIGNER_BWD_SHAPE
    q, k, v, bias = _qkv(ALIGNER_BWD_SHAPE, torch.float32, gen)
    dout = torch.randn(q.shape, device='cuda', generator=gen)
    args = (True, 0.1, 1234, 5678)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, bias, *args)
    dsum = fa.row_dot(dout, out)
    k3 = _time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args,
                                                    dsum=dsum))
    k4 = _time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args,
                                                     dsum=dsum))
    plain = _time_ms(lambda: fa.attention_bwd_plain(q, k, v, bias, out, lse, dout, *args),
                     iters=5)
    # the library's additive (B, 1, T, T) mask: key padding plus the look-ahead
    look_ahead = torch.triu(torch.full((t, t), -1e9, device='cuda'), diagonal=1)
    library = _library_training_attention(q, k, v, bias[:, None, None, :] + look_ahead, dout)
    # the products the causal mask leaves: K3 three (S, dP, dS·K), K4 four
    # (S, dP, dV, dK), each 2·kept·D; float32 inputs q, k, v, dO, (m, log l),
    # D and bias read once, dQ or dK and dV written once
    kept = b * h * t * (t + 1) // 2
    row = 4 * b * h * t * d
    small = 8 * b * h * t + 4 * b * h * t + 4 * b * t
    bounds = {}
    for name, products, outputs in (('K3', 3, 1), ('K4', 4, 2)):
        flops, nbytes = 2 * products * kept * d, (4 + outputs) * row + small
        bounds[name] = {'f32': bound(flops, nbytes, 'f32'),
                        'tf32x3': bound(3 * flops, nbytes, 'tf32'),
                        'gflop': flops / 1e9, 'mbytes': nbytes / 1e6}
        log(f'f32 {name} {ALIGNER_BWD_SHAPE} causal, dropout 0.1: kernel '
            f'{k3 if name == "K3" else k4:.4f} ms; bound {bounds[name]["f32"]["bound_ms"]:.4f} '
            f'ms on the CUDA cores ({bounds[name]["f32"]["bound_by"]}, {flops / 1e9:.2f} GFLOP '
            f'that the causal mask leaves; its {nbytes / 1e6:.1f} MB take '
            f'{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), 3xTF32 bound '
            f'{bounds[name]["tf32x3"]["bound_ms"]:.4f} ms')
    log(f'f32 backward {ALIGNER_BWD_SHAPE} causal, dropout 0.1: K3 {k3:.4f} + K4 {k4:.4f} = '
        f'{k3 + k4:.4f} ms; plain backward {plain:.4f} ms; scaled_dot_product_attention '
        f'({library["library_backend"]}, f32, TF32 off) backward {library["library_bwd"]:.4f} '
        f'ms (forward {library["library_fwd"]:.4f})')
    return {'errors': errors, 'resources': resources, 'shape': list(ALIGNER_BWD_SHAPE),
            'K3': k3, 'K4': k4, 'plain_bwd': plain, 'bounds': bounds, **library}


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


def aligner_training_phase(cfg) -> dict:
    """Stage 2's training half on the card: the published Aligner (f32,
    dropout 0.1) through ``train_aligner.main`` on the featurization slice's
    data dir, at r = 10 with both diagonals forced, then at r = 1 with
    neither, covering a plotting step, a checkpoint, validation, predictions
    and a resume; timed steps at the config's three buckets; the synthetic
    language's convergence on the kernels."""
    from transformertts_torch import train_aligner
    from transformertts_torch.profile_train import aligner_batch
    from transformertts_torch.training import checkpointing
    from transformertts_torch.training.aligner_trainer import AlignerTrainer
    from transformertts_torch.utils.config import TrainingConfigManager
    _, ops = _trainable_ops()
    work = WORK / 'align_train'
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
            session = _aligner_session(cfg, work, {**schedule, 'max_steps': max_steps})
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

    # timed steps at the config's buckets (r = 1) and the largest at r = 10
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
        log(f'Aligner train step B{b} x {frames} frames x {n_tok} tokens, r {r}, f32, dropout '
            f'0.1: median {ms:.2f} ms (steps 4-13: {[round(x * 1e3, 2) for x in step_s[3:13]]}), '
            f'{b * frames / (ms / 1e3):.1f} mel frames/s; K2/K3/K4 13 a step; loss of steps '
            f'1-5 {head:.4f}, of steps 26-30 {tail:.4f}')
        times[f'B{b}x{frames}r{r}'] = ms
        # the overfit gate: the middle bucket
        if i == 1 and not tail < head:
            raise AssertionError(f'30 Aligner steps on one batch: loss {losses}')
        del model, trainer

    conv = synthetic_language_convergence(DEVICE)
    log(f'synthetic language, d 48, 2,500 steps on the kernels: extracted-duration MAE '
        f'{conv["duration_mae"]:.3f} frames (mean true duration {conv["mean_duration"]:.2f}; '
        f'bar 1.5), last loss {conv["final_loss"]:.4f}, {conv["seconds"]:.1f} s')
    if not conv['duration_mae'] < 1.5:
        raise AssertionError(f'the port\'s Aligner did not learn the synthetic language: {conv}')
    return {'launches': first['launches'], 'ms_per_step': times, 'convergence': conv}


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


def synthetic_language_convergence(device, steps: int = 2500) -> dict:
    """tests/convergence_check.py's Aligner half on the port: an Aligner at d
    48 (heads [2] / [2, 2], f32, dropout 0.1, prenet dropout 0.3, r 1)
    trained ``steps`` steps of B16 on the synthetic language at 3e-4, the
    encoder's diagonal forced for 100 steps and the decoder's for 800, then
    durations extracted from the last cross-attention of 8 samples (weighted
    heads) against their known durations. Returns the mean absolute error in
    frames, the last loss and the training wall time."""
    from transformertts_torch.models.aligner import Aligner
    from transformertts_torch.ops.duration_extraction import get_durations_from_alignment
    from transformertts_torch.training.aligner_trainer import AlignerTrainer
    rng = np.random.default_rng(1)
    samples = make_language(rng, n_samples=48)
    n_tok = 12 + 2   # start and end tokens
    t_max = max(s[2].shape[0] for s in samples) + 2
    t_pad = -(-t_max // 16) * 16
    model = Aligner(
        compute_dtype='float32', encoder_model_dimension=48, decoder_model_dimension=48,
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
            'mean_duration': float(np.mean([s[1].mean() for s in samples]))}


def main():
    card = device_phase()
    build_phase()
    serving = kernel_phase()
    trainable = trainable_kernel_phase()
    result = slice_phase()
    train = training_phase()
    log_mel = log_mel_kernel_phase()
    featurize = featurization_phase()
    aligner_kernels = aligner_kernel_phase()
    k2_f32 = aligner_kernels.pop('k2')
    f32_resources = aligner_kernels.pop('f32_resources')
    aligner_bwd = aligner_backward_phase()
    aligner = aligner_phase(featurize['config'])
    aligner_train = aligner_training_phase(featurize['config'])
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
        'extraction_launches': aligner['launches'],
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
        })
    rel_l2 = trainable['rel_l2']
    kernels[1].update(trainable['resources']['K2'], **k2_f32,
                      f32_resources=f32_resources['K2'])
    kernels[-2].update(rel_l2_dq=rel_l2['dq'], **trainable['resources']['K3'])
    kernels[-1].update(rel_l2_dk=rel_l2['dk'], rel_l2_dv=rel_l2['dv'],
                       **trainable['resources']['K4'])
    # the float32 backward, the Aligner training path's
    for i in range(3):
        kernels[1 + i]['aligner_training_launches'] = aligner_train['launches'][i]
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
    log(f'featurization: {featurize["clips_per_s"]:.2f} clips/s, '
        f'{featurize["audio_s_per_s"]:.2f} s of audio/s')
    log(f'duration extraction: {aligner["clips_per_s"]:.2f} clips/s; predict '
        f'{aligner["steps_per_s"]:.1f} decode steps/s')
    log('Aligner training: ' + ', '.join(f'{k} {v:.2f} ms/step' for k, v
                                         in aligner_train['ms_per_step'].items())
        + f'; synthetic-language duration MAE '
        f'{aligner_train["convergence"]["duration_mae"]:.3f} frames')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
