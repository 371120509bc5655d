"""What every cell of the benchmark shares: the cell's files found by name,
the device checks, weights drawn from the seed on the card, the guard
against the JAX package, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: its ``config``
names ``configs/<config>.yaml`` and its ``traffic`` names
``traffic/<traffic>.json``; the configuration's ``kind`` names the driver module
(``<kind>.py``) that runs it, which names the traffic kind it generates
(``TRAFFIC_KIND``). A serving configuration's ``model_family`` names its
family module (``families/<model_family>.py``).
"""
import importlib
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import yaml

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'transformertts_tpu', 'bench', 'chip_smoke',
                     'scripts')


class BenchmarkError(RuntimeError):
    """A fault of the run itself (bad arguments, no card, a forbidden
    module): the run prints no result."""


def process_start_time() -> float:
    """This process's start on the host's wall clock (``time.time()``)."""
    with open('/proc/self/stat') as f:
        fields = f.read().rsplit(')', 1)[1].split()
    ticks = os.sysconf('SC_CLK_TCK')
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + int(fields[19]) / ticks


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic read from their files; the traffic's ``kind`` must be the
    ``TRAFFIC_KIND`` of its configuration's driver module."""
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise BenchmarkError(f'no workload {name!r} in BENCHMARK.json '
                             f'(it has {sorted(cells)})')
    cell = dict(cells[name])
    cell['config_data'] = yaml.safe_load((BENCH_DIR / 'configs' / f"{cell['config']}.yaml")
                                         .read_text())
    cell['traffic_data'] = json.loads((BENCH_DIR / 'traffic' / f"{cell['traffic']}.json")
                                      .read_text())
    cell['benchmark'] = bench
    want = importlib.import_module(f"h100bench.{cell['config_data']['kind']}").TRAFFIC_KIND
    if cell['traffic_data']['kind'] != want:
        raise BenchmarkError(f"cell {name}: a {cell['config_data']['kind']} configuration "
                             f"takes {want} traffic, not {cell['traffic_data']['kind']}")
    return cell


def family_of(cfg: dict):
    """The model family module of a serving configuration."""
    return importlib.import_module(f"h100bench.families.{cfg['model_family']}")


def require_devices(n: int):
    """The card count this cell needs, or ``BenchmarkError``."""
    import torch
    if not torch.cuda.is_available():
        raise BenchmarkError('torch.cuda.is_available() is false: the benchmark runs on '
                             'an NVIDIA GPU only')
    if torch.cuda.device_count() < n:
        raise BenchmarkError(f'the cell needs {n} GPUs, torch sees '
                             f'{torch.cuda.device_count()}')


def device_info(count: int) -> dict:
    import torch
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': count,
            'memory_peak_bytes': int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def forbidden_loaded() -> list:
    """Modules in ``sys.modules`` whose top-level name is forbidden."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def seed_streams(seed: int, stream: int) -> np.random.Generator:
    """numpy generator of ``stream`` of ``seed`` (any non-negative int)."""
    return np.random.default_rng([int(seed), int(stream)])


SHARED_SEED = 0   # the seed of the weights that every seed shares (stream 8)


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from (seed, stream)."""
    return int(seed_streams(seed, stream).integers(0, 2 ** 63 - 1))


def uniform_weights(shapes: dict, limits: dict, constants: dict, seed: int,
                    device, shared: tuple = ()) -> dict:
    """Weights on ``device`` from the seed: every leaf named in ``limits``
    uniform in ±limit, drawn from one ``torch.rand`` call on a generator on
    the card; every leaf in ``constants`` filled with its value. Leaves whose
    names start with one of ``shared`` are drawn in a second call from one
    stream that is the same for every seed. Returns {name: float32 tensor}."""
    import torch
    out = {}
    drawn = [n for n in shapes if n in limits]
    for draw_seed, stream, names in (
            (seed, 7, [n for n in drawn if not n.startswith(tuple(shared))]),
            (SHARED_SEED, 8, [n for n in drawn if n.startswith(tuple(shared))])):
        if not names:
            continue
        total = sum(math.prod(shapes[n]) for n in names)
        gen = torch.Generator(device=device).manual_seed(torch_seed(draw_seed, stream))
        flat = torch.rand(total, generator=gen, device=device)
        offset = 0
        for n in names:
            k = math.prod(shapes[n])
            lim = limits[n]
            out[n] = (flat[offset:offset + k] * (2 * lim) - lim).reshape(shapes[n])
            offset += k
    for n, value in constants.items():
        out[n] = torch.full(shapes[n], float(value), device=device)
    missing = set(shapes) - set(out)
    if missing:
        raise BenchmarkError(f'no initializer for {sorted(missing)}')
    return {n: out[n] for n in shapes}


def keras_limits(shapes: dict, embeddings=()) -> tuple:
    """The published initializers as (limits, constants): glorot-uniform
    dense (out, in) and conv (out, in, k) kernels, uniform ±0.05 embeddings,
    zero biases, LayerNorm scales and position-encoding scalars of 1."""
    limits, constants = {}, {}
    for n, s in shapes.items():
        if n in embeddings:
            limits[n] = 0.05
        elif len(s) == 2:
            limits[n] = math.sqrt(6.0 / (s[0] + s[1]))
        elif len(s) == 3:
            limits[n] = math.sqrt(6.0 / ((s[0] + s[1]) * s[2]))
        elif len(s) == 0 or n.endswith('.weight'):
            constants[n] = 1.0
        else:
            constants[n] = 0.0
    return limits, constants


def emit(result: dict, checks: dict):
    """The run's last lines: each compared number beside its limit on
    standard error, then the result as the last line of standard output,
    with the compared numbers under ``checks``, its last key."""
    for name, (value, limit) in checks.items():
        print(f'check {name}: {value!r} (limit {limit!r})', file=sys.stderr)
    line = dict(result)
    line['checks'] = {k: {'value': v, 'limit': lim} for k, (v, lim) in checks.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def log_phase(t_start: float, phase: str):
    """A set-up phase's end on standard error, in seconds since the start."""
    print(f'set-up: {phase} at {time.time() - t_start:.2f} s', file=sys.stderr, flush=True)
