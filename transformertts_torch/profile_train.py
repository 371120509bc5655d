"""Where a training step's time goes on the card.

    python -m transformertts_torch.profile_train [--config config/training_config.yaml]
        [--aligner] [--json out.json]
    torchrun --nproc_per_node N -m transformertts_torch.profile_train --config <yaml>

Builds the config's ForwardTransformer (the published TTS settings: bf16,
dropout 0.1, Adam) with weights drawn from a seed, times 15 synchronized
``train_step`` calls on one synthetic batch of B32 x 128 tokens x 512
frames (the step chip_smoke.py times); with ``--aligner`` the config's
Aligner (f32, dropout 0.1) at r = 1 on B16 x 896 frames x 160 tokens, the
published buckets' largest, with no diagonal forced. Each model computes in
its settings' ``compute_dtype``: a session yaml with ``compute_dtype:
bfloat16`` in ``aligner_settings`` profiles the bf16 Aligner. Then it records 5
more under ``torch.profiler`` and prints, per step: the unprofiled ms
(median of the warm steps after the third), the kernel time by kind and
the busiest kernels, the kernel launches, the device time covered
by at least one kernel (a check on the sum: one stream runs one kernel at a
time), the device's idle share of an unprofiled step (1 - kernel ms / step
ms) and of a profiled one, and the peak device memory of this process.

Under torchrun the trainer runs on the config's ``mesh: {data, model}``,
one card a rank; every rank profiles its own step and prints its lines
after ``rank r:``, so the peak memory is a rank's. ``--json`` also writes
the readings (rank r > 0: to ``<path>.rank<r>``).
"""
import argparse
import json
import statistics
import time
from collections import defaultdict

import numpy as np
import torch

SHAPE = (32, 128, 512)   # batch, tokens, frames
ALIGNER_SHAPE = (16, 160, 896)
WARM, STEPS, TOP = 15, 5, 15

# kernel kinds, by a substring of the kernel's name; the first match wins
KINDS = (
    ('K2 attn forward', ('attn_fwd',)),
    ('K3 attn dQ', ('attn_dq',)),
    ('K4 attn dK/dV', ('attn_dkv',)),
    ('layout transposes', ('nchwToNhwc', 'nhwcToNchw', 'transpose')),
    ('cuDNN convolutions', ('conv', 'cudnn', 'implicit')),
    ('GEMMs', ('gemm', 'cutlass', 'cublas', 'xmma')),
    ('Adam (foreach)', ('multi_tensor_apply',)),
    ('casts and copies', ('copy', 'cast')),
    ('reductions', ('reduce', 'norm')),
)


def synthetic_batch(model, b: int = 32, n_tok: int = 128, n_frames: int = 512,
                    seed: int = 0) -> dict:
    """B x n_tok tokens x n_frames frames, every row full: durations of 2-6
    frames a token summing to n_frames, log-mels in the MelGAN range."""
    rng = np.random.default_rng(seed)
    durations = np.full((b, n_tok), n_frames // n_tok, np.float32)
    for row in durations:
        for _ in range(n_tok):   # move frames between random tokens, sum kept
            i, j = rng.integers(0, n_tok, 2)
            if row[i] > 2 and row[j] < 6:
                row[i] -= 1
                row[j] += 1
    tokens = rng.integers(1, model.text_pipeline.tokenizer.vocab_size, (b, n_tok))
    mel = np.clip(rng.normal(-4.0, 1.5, (b, n_frames, model.mel_channels)), np.log(1e-5), 2.0)
    return {'tokens': tokens, 'mel': mel.astype(np.float32), 'durations': durations,
            'pitch': rng.standard_normal((b, n_tok)).astype(np.float32)}


def aligner_batch(model, b: int = 16, n_tok: int = 160, n_frames: int = 896,
                  seed: int = 0) -> dict:
    """scripts/measure_train_step.py's Aligner batch: 90 % of each row's
    tokens real, a standard normal mel, stop classes 1 and 2 on the last
    frame."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, n_tok), np.int64)
    tokens[:, :int(n_tok * 0.9)] = rng.integers(
        1, model.text_pipeline.tokenizer.vocab_size, size=(b, int(n_tok * 0.9)))
    stop = np.ones((b, n_frames), np.int64)
    stop[:, -1] = 2
    mel = rng.standard_normal((b, n_frames, model.mel_channels)).astype(np.float32)
    return {'tokens': tokens, 'mel': mel, 'stop_probs': stop}


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return 'elementwise and other'


def kernel_table(prof) -> dict:
    """{kernel name: (device µs, launches)} over the profiled steps."""
    table = {}
    for e in prof.key_averages():
        # '#' marks annotation ranges (Optimizer.step#Adam.step), not kernels
        if e.device_type != torch.autograd.DeviceType.CUDA or '#' in e.key:
            continue
        us = getattr(e, 'device_time_total', None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            table[e.key] = (us, e.count)
    return table


def busy_ms(prof) -> float:
    """Device time covered by at least one kernel or copy, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and '#' not in e.name)
    total, end = 0.0, float('-inf')
    for start, stop in spans:
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--config', default='config/training_config.yaml')
    parser.add_argument('--aligner', action='store_true',
                        help="profile the config's Aligner at r = 1 instead")
    parser.add_argument('--json', help='also write the readings to this file')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profile_train: no CUDA device')
    from transformertts_torch.parallel.mesh import destroy_distributed, local_device
    from transformertts_torch.utils.config import TrainingConfigManager
    cm = TrainingConfigManager(args.config, aligner=args.aligner)
    device = local_device('cuda')
    mesh = cm.get_mesh(device)
    try:
        profile(cm, args, mesh, device)
    finally:
        destroy_distributed()


def profile(cm, args, mesh, device):
    """Time, then profile, ``STEPS`` steps on this rank, and print (and
    with ``--json`` write) the readings."""
    model = cm.get_model('cpu').init_params(torch.Generator().manual_seed(0)).to(device)
    trainer = cm.get_trainer(model, mesh)
    shape = ALIGNER_SHAPE if args.aligner else SHAPE
    batch = (aligner_batch if args.aligner else synthetic_batch)(model, *shape)
    options = {'r': 1} if args.aligner else {}

    times = []
    for _ in range(WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, **options)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[3:]) * 1e3
    torch.cuda.reset_peak_memory_stats()

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step(batch, **options)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    table = kernel_table(prof)
    if not table:
        raise SystemExit('profile_train: the profiler recorded no device time')
    n = STEPS
    kinds = defaultdict(float)
    for name, (us, _) in table.items():
        kinds[kind_of(name)] += us / 1e3 / n
    kernel_ms = sum(kinds.values())
    launches = sum(c for _, c in table.values()) / n
    busy = busy_ms(prof) / n

    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tag = f'rank {mesh.rank}: ' if mesh.grouped else ''
    print(f'{tag}{cm.model_kind} train step B{shape[0]} x {shape[1]} tokens x {shape[2]} '
          f'frames{", r 1" if args.aligner else ""}, {cm.config.get("compute_dtype")}, '
          f'dropout {cm.config["dropout_rate"]}, mesh data {mesh.data_size} x model '
          f'{mesh.model_size}')
    print(f'{tag}unprofiled: {step_ms:.2f} ms a step (median of warm steps 4-{WARM})')
    print(f'{tag}kernels: {kernel_ms:.2f} ms a step summed, {busy:.2f} ms covered, '
          f'{launches:.0f} launches a step; idle share of an unprofiled step '
          f'{1 - kernel_ms / step_ms:.3f}, of a profiled one ({profiled_ms:.2f} ms) '
          f'{1 - busy / profiled_ms:.3f}')
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f'{tag}  {kind:<24} {ms:8.3f} ms')
    print(f'{tag}busiest {TOP} kernels (ms a step, launches a step):')
    for name, (us, count) in sorted(table.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f'{tag}  {us / 1e3 / n:8.3f} {count / n:6.0f}  {name[:110]}')
    print(f'{tag}peak device memory {peak_gib:.2f} GiB')
    if args.json:
        path = args.json if mesh.rank == 0 else f'{args.json}.rank{mesh.rank}'
        with open(path, 'w') as f:
            json.dump(dict(step_ms=step_ms, profiled_ms=profiled_ms, kernel_ms=kernel_ms,
                           busy_ms=busy, launches=launches, kinds=dict(kinds),
                           peak_gib=peak_gib, rank=mesh.rank, size=mesh.size,
                           data=mesh.data_size, model=mesh.model_size,
                           grouped=mesh.grouped, device=torch.cuda.get_device_name(device)),
                      f)


if __name__ == '__main__':
    main()
