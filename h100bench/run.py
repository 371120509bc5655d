"""The port's benchmark: one run of one cell.

    python -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

Reads the cell from ``BENCHMARK.json``, its configuration from
``h100bench/configs/<config>.yaml`` and its traffic from
``h100bench/traffic/<traffic>.json``; the configuration's ``kind`` names the
driver module (``h100bench/<kind>.py``). Set-up, the window, then the
comparison that decides ``correct``; the last line of standard output is
the result. With ``--trace 0`` the metrics are the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones (``h100bench/metrics/<name>.py``).

Exits 2 without a result when the card is missing, the arguments or files
are wrong, or a module of the JAX package (or JAX) is loaded once the
window has closed; exits 1 without a result when set-up or the window
raises. Either way the last lines of standard error name the cell, the
seed and the cause.
"""
import argparse
import importlib
import os
import sys
import time
import traceback

# one process with one compute thread on the host: the card's host shares its
# cores with other machines, and idle worker threads spinning on them only
# widen the spread of host-paced windows; set before numpy or torch loads
os.environ.setdefault('OMP_NUM_THREADS', '1')
os.environ.setdefault('MKL_NUM_THREADS', '1')
os.environ.setdefault('OPENBLAS_NUM_THREADS', '1')
os.environ.setdefault('USE_FLAX', '0')
os.environ.setdefault('USE_JAX', '0')

from h100bench.common import (BenchmarkError, emit, forbidden_loaded,  # noqa: E402
                              load_cell, process_start_time)
from h100bench.readers import load_reader  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(prog='python -m h100bench.run')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell_metrics(cell: dict, traced: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` that this cell reports."""
    bench, name = cell['benchmark'], cell['name']
    e2e = [m for m in bench['end_to_end'] if name in m.get('workloads', [name])]
    if not traced:
        return e2e
    moved = {m['name'] for m in e2e}
    return [m for m in bench['per_layer']
            if name in m.get('workloads', [name] if m['moves'] in moved else [])]


def run(args, t_start: float, device_name: str = 'cuda') -> dict:
    cell = load_cell(args.workload)
    driver = importlib.import_module(f"h100bench.{cell['config_data']['kind']}")
    readings, (attempted, failed), device, records, weights, extra = driver.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), t_start, device_name)
    metrics, breakdown = {}, None
    for m in cell_metrics(cell, bool(args.trace)):
        if args.trace:
            value = load_reader(m['name'])(extra['ctx'])
        else:
            value = readings.get(m['name'])
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    if args.trace:
        a, b = extra['ctx']['a'], extra['ctx']['b']
        device.update(busy_s=a['busy_s'], window_s=a['window_s'])
        breakdown = {'device_ops': [[n, s] for n, s in b['device_ops']],
                     'idle_gaps': [[n, s] for n, s in b['idle_gaps']]}
        del extra
    checks, ok = driver.judge_cell(cell, records, weights)
    found = forbidden_loaded()
    if found:
        raise BenchmarkError(f'modules of the JAX package or JAX are loaded: {found}')
    result = {'correct': bool(ok and failed == 0), 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': device}
    if breakdown is not None:
        result['breakdown'] = breakdown
    return result, checks


def main(argv=None) -> int:
    t_start = process_start_time()
    args = parse(argv)
    try:
        result, checks = run(args, t_start)
    except BenchmarkError as exc:
        print(f'h100bench: cell {args.workload}, seed {args.seed}: {exc}', file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        print(f'h100bench: cell {args.workload}, seed {args.seed}: the run failed '
              f'(traceback above)', file=sys.stderr)
        return 1
    emit(result, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
