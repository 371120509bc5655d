"""The readings that a cell's limits are set from (not part of a run).

    python -m h100bench.control --workload <cell> --seeds 1 2 3 [--seconds 3]

For each seed, in one process: set-up and a short window of the cell as a
run makes them (its driver's ``control_readings``), then

- ``program``: the compared numbers of the program's own check (the lower
  readings);
- ``control``: the numbers when the reference, one precision below the
  configuration, takes the program's place. Serving: the model family's
  ``control_records`` over the sentences the program's check sampled (for
  ``forward_tts``, the model and the waveform stage with the operands the
  configuration's ``control`` names: float8 e4m3 for the bfloat16 model,
  TF32 for Griffin-Lim, bfloat16 for HiFi-GAN). Training: the
  reference's three steps with TF32 on in cuBLAS and cuDNN.
- training also ``half_batch``: the reference's steps on the first half of
  each batch's rows, the mean taken over them (a fault the check must see),
  and ``unchanged`` reads 1 by the measure of the change (no run).

One JSON line a seed on standard output. ``--program-only`` reads the
program alone, for the dozen seeds a limit's lower reading needs.
"""
import argparse
import importlib
import json
import sys

from h100bench.common import load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog='python -m h100bench.control')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--program-only', action='store_true',
                    help='the program\'s readings alone, without a control')
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    read = importlib.import_module(f"h100bench.{cell['config_data']['kind']}").control_readings
    for seed in args.seeds:
        out = read(cell, seed, args.seconds, args.program_only)
        print(json.dumps({'workload': args.workload, 'seed': seed, **out}, default=str),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
