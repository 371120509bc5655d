"""The readings that a cell's limits are set from (not part of a run).

    python -m h100bench.control --workload <cell> --seeds 1 2 3 [--seconds 3]

For each seed, in one process: set-up and a short window of the cell as a
run makes them, then

- ``program``: the compared numbers of the program's own check (the lower
  readings);
- ``control``: the numbers when the reference, one precision below the
  configuration, takes the program's place. Serving: the model and the
  waveform stage with the operands the configuration's ``control`` names
  (float8 e4m3 for the bfloat16 model, TF32 for Griffin-Lim, bfloat16 for
  HiFi-GAN), over the sentences the program's check sampled. Training: the
  reference's three
  steps with TF32 on in cuBLAS and cuDNN.
- training also ``half_batch``: the reference's steps on the first half of
  each batch's rows, the mean taken over them (a fault the check must see),
  and ``unchanged`` reads 1 by the measure of the change (no run).

One JSON line a seed on standard output. ``--program-only`` reads the
program alone, for the dozen seeds a limit's lower reading needs.
"""
import argparse
import json
import sys
import time


from h100bench.common import load_cell


def serve_readings(cell, seed, seconds, program_only=False) -> dict:
    from h100bench import check_serve, serve
    cfg = cell['config_data']
    readings, _, _, records, (weights, vweights), _ = serve.run_cell(cell, seed, seconds, False,
                                                                    time.time())
    program = check_serve.judge(records, cfg, weights, vweights, 'cuda')
    program['audio_rate'] = readings['audio_rate']
    if program_only:
        return {'program': program}
    low = check_serve.control_records([r['sentence'] for r in records], cfg, weights,
                                      vweights, 'cuda')
    return {'program': program, 'control': check_serve.judge(low, cfg, weights, vweights,
                                                             'cuda')}


def train_readings(cell, seed, seconds, program_only=False) -> dict:
    from h100bench import train
    cfg = cell['config_data']
    _, _, _, check, weights, _ = train.run_cell(cell, seed, seconds, False, time.time())
    ref = train.reference_run(cfg, check['batches'], check['seeds'], weights)
    out = {'program': train.compare(check, ref, weights)}
    if program_only:
        out['program'].pop('left_out', None)
        return out
    out['control'] = train.compare(
        train.reference_run(cfg, check['batches'], check['seeds'], weights, tf32=True), ref,
        weights)
    halves = [{k: v[:max(1, len(v) // 2)] for k, v in b.items()} for b in check['batches']]
    out['half_batch'] = train.compare(
        train.reference_run(cfg, halves, check['seeds'], weights), ref, weights)
    for side in out.values():
        side.pop('left_out', None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python -m h100bench.control')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--program-only', action='store_true',
                    help='the program\'s readings alone, without a control')
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    read = serve_readings if cell['config_data']['kind'] == 'serve' else train_readings
    for seed in args.seeds:
        out = read(cell, seed, args.seconds, args.program_only)
        print(json.dumps({'workload': args.workload, 'seed': seed, **out}, default=str),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
