"""On-card smoke test of the PyTorch port (transformertts_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero and
prints no result):

1. device: a CUDA card is required; prints its name and power limit and
   switches TF32 off for the float32 comparisons;
2. build: compiles the fused-attention kernel from transformertts_torch/csrc
   with nvcc into build/ (listed in .gitignore);
3. kernel vs plain: the kernel against ``attention_plain`` on the card, in
   float32 and in bfloat16 (padded keys, a fully masked row, causal on and
   off, head widths 24 and 192, the synthesis shapes), then both timed in
   bfloat16 at the synthesis shapes;
4. slice: the published LJSpeech configuration (d=384, 6+6 blocks, 2 heads,
   bfloat16) with weights drawn from a seed, saved as a model dir and loaded
   back; ``synthesize_lines`` over config/test_sentences.txt with the launch
   count of the kernel; the bfloat16 kernel-path mel against a float32
   eager-attention mel under forced durations; the bench workload
   (B64 x 128 tokens -> 768 frames) in mel frames/s; the predict_tts CLI;
5. the last two lines: the kernels' JSON record, then the contract line.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

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
    path = build.build('flash_attention_fwd')
    build.load('flash_attention_fwd')
    log(f'build: {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s')


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
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase() -> dict:
    """Kernel vs plain in both dtypes (each has its own kernel: SIMT for
    float32, tensor cores for bfloat16), then both timed at the slice shapes."""
    from transformertts_torch.ops.flash_attention import attention_plain, flash_attention
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    cases = [((2, 2, 37, 53, 24), False), ((2, 2, 41, 41, 24), True),
             ((3, 2, 130, 70, 192), False), ((2, 2, 100, 100, 192), True),
             (ENCODER_SHAPE, False), (DECODER_SHAPE, False)]
    errors = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for shape, causal in cases:
            q, k, v, bias = _qkv(shape, dtype, gen)
            out = flash_attention(q, k, v, bias, causal)
            torch.cuda.synchronize()
            ref = attention_plain(q, k, v, bias, causal)
            if not torch.isfinite(out).all():
                raise AssertionError(f'kernel output not finite at {shape} {dtype}')
            torch.testing.assert_close(out.float(), ref.float(), **tol)
            err = (out.float() - ref.float()).abs().max().item()
            errors[shape, dtype] = err
            log(f'{dtype} {shape} causal={causal}: max |kernel - plain| {err:.3g}')
    record = {}
    for name, shape in (('encoder', ENCODER_SHAPE), ('decoder', DECODER_SHAPE)):
        q, k, v, bias = _qkv(shape, torch.bfloat16, gen)
        ms = _time_ms(lambda: flash_attention(q, k, v, bias))
        plain_ms = _time_ms(lambda: attention_plain(q, k, v, bias))
        log(f'bf16 {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')
        record[name] = dict(shape=list(shape), max_abs_err=errors[shape, torch.bfloat16],
                            ms=ms, plain_ms=plain_ms)
    return record


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
    expected = sorted(int(t - 1) * audio.hop_length for t in totals[:len(lines)])
    lengths = [len(w) for w in wavs]
    for w in wavs:
        if not np.isfinite(w).all() or not np.abs(w).max() > 0:
            raise AssertionError('a synthesized wav is not finite or is silent')
    if sorted(lengths) != expected:
        raise AssertionError(f'wav lengths {lengths} != (totals-1)*hop {expected}')
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


def main():
    card = device_phase()
    build_phase()
    times = kernel_phase()
    result = slice_phase()
    dec = times['decoder']
    kernels = [{
        'name': 'flash_attention_fwd', 'route': 'cuda',
        'source': 'transformertts_torch/csrc/flash_attention_fwd.cu',
        'replaces': 'transformertts_tpu/ops/flash_attention.py:48',
        'launches': result['launches'],
        'max_abs_err': max(t['max_abs_err'] for t in times.values()),
        'ms': dec['ms'], 'plain_ms': dec['plain_ms'], 'shape': dec['shape'],
        'encoder_ms': times['encoder']['ms'],
        'encoder_plain_ms': times['encoder']['plain_ms'],
    }]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
