#!/usr/bin/env bash
# Rehearse the driver's runs of one or more cells before they enter
# BENCHMARK.json, as the driver makes them: from a copy of the committed tree
# with no build/ (so the first run compiles the kernels), with a HOME,
# XDG_CACHE_HOME and TMPDIR of the rehearsal's own, every run a new process,
# the exact command of BENCHMARK.json.
#
#   h100bench/rehearse.sh pack OUT            # where git is: OUT/tree = the committed tree
#   h100bench/rehearse.sh run OUT CELL...     # on the GPU machine, from OUT/tree
#
# OUT lies in a directory that .gitignore lists (build/rehearse, say), so the
# tree is never committed; copy OUT/summary.tsv and OUT/runs back by hand.
#
# For each cell, in this order: two sets of six runs at --seconds run_seconds
# with --trace 0 on seeds 1000101-1000106, the same seeds in both sets (the
# sets a bound is set from; the first run of the first cell is the compiling
# one), seed 2147483629 at --seconds 10 with --trace 0, and seeds 1000033,
# 1000037 and 1000039 at --seconds run_seconds with --trace 1. Each run's
# output goes to OUT/runs/<cell>.<set>.<seed>.<trace>.{out,err}; OUT/summary.tsv
# gets one line a run: cell, set, seed, seconds, trace, exit code, wall
# seconds, correct, setup_s, the metrics. Then each set's median and spread
# (the quartile distance over the median, statistics.quantiles) of every
# end-to-end metric, to OUT/spreads.txt.
# Exits 1 if any run exited non-zero or printed no parsable last line.
set -u
mode=${1:?pack or run}; out=$(realpath -m "${2:?output directory}"); shift 2

if [ "$mode" = pack ]; then
  rm -rf "$out/tree"; mkdir -p "$out/tree"
  git add -A && git archive "$(git write-tree)" | tar -x -C "$out/tree"
  exit $?
fi

cd "$out/tree" || exit 2
rm -rf build
mkdir -p "$out/home" "$out/cache" "$out/tmp" "$out/runs"
export HOME="$out/home" XDG_CACHE_HOME="$out/cache" TMPDIR="$out/tmp"
run_seconds=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
mapfile -t cmd < <(python3 -c 'import json; print("\n".join(json.load(open("BENCHMARK.json"))["command"]))')
status=0
one() {  # cell set seed seconds trace
  local base="$out/runs/$1.$2.$3.$5"
  local t0=$(date +%s.%N)
  "${cmd[@]}" --workload "$1" --seed "$3" --seconds "$4" --trace "$5" > "$base.out" 2> "$base.err"
  local rc=$?
  local wall=$(python3 -c "import time; print(round(time.time() - $t0, 1))")
  local line
  line=$(python3 - "$base.out" <<'PY'
import json, sys
try:
    r = json.loads(open(sys.argv[1]).read().strip().splitlines()[-1])
    m = r['metrics']
    print(r['correct'], m.get('setup_s', {}).get('value', '-'),
          ' '.join(f'{k}={v["value"]!r}' for k, v in m.items()), sep='\t')
except Exception as exc:
    print('unparsed', '-', repr(exc), sep='\t')
PY
)
  printf '%s\t%s\t%s\t%s\t%s\t%s\t%s\t%s\n' "$1" "$2" "$3" "$4" "$5" "$rc" "$wall" "$line" \
    >> "$out/summary.tsv"
  tail -n 1 "$out/summary.tsv"
  if [ "$rc" != 0 ] || [[ "$line" == unparsed* ]]; then
    status=1; tail -n 15 "$base.err"
  fi
}
for cell in "$@"; do
  for set in 1 2; do
    for seed in 1000101 1000102 1000103 1000104 1000105 1000106; do
      one "$cell" "$set" "$seed" "$run_seconds" 0
    done
  done
  one "$cell" 0 2147483629 10 0
  for seed in 1000033 1000037 1000039; do one "$cell" 0 "$seed" "$run_seconds" 1; done
done
python3 - "$out/summary.tsv" > "$out/spreads.txt" <<'PY'
import collections, statistics, sys
sets = collections.defaultdict(list)
for line in open(sys.argv[1]):
    cell, set_, seed, seconds, trace, rc, wall, correct, setup, metrics = line.rstrip('\n').split('\t')
    if set_ in ('1', '2') and rc == '0' and correct != 'unparsed':
        for kv in metrics.split(' '):
            k, v = kv.split('=')
            sets[cell, k, set_].append(float(v))
for (cell, k, set_), vals in sorted(sets.items()):
    q = statistics.quantiles(vals, n=4)
    med = statistics.median(vals)
    print(cell, k, f'set {set_}', f'median {med!r}', f'spread {(q[2] - q[0]) / med!r}',
          f'runs {vals!r}')
PY
cat "$out/spreads.txt"
exit $status
