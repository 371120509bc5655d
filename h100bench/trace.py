"""The traced run's readings from ``torch.profiler``.

Two traced windows follow set-up in a ``--trace 1`` run:

- window A traces the device only (CUPTI: kernels, copies, fills, and the
  runtime calls that launched them). It gives the busy seconds (the union
  of the device's activity intervals), the window's length, each kernel's
  name and time, the launch count, and each device event's and launch
  event's time and correlation id on the trace's clock, which the
  program's spans share (``spans.py``). With no Python tracing the host
  runs at its measured pace, so the idle share is the window's.
- window B, a few requests or steps, also traces the host with Python
  stacks (``with_stack=True``). Each kernel is charged to the innermost
  ``transformertts_torch`` frame on the stack of the call that launched it,
  and each idle gap of the device to the innermost frame the host was in;
  that gives the breakdown and the device time of each of the program's
  modules.

The chrome traces are written under a temporary directory and deleted.
"""
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
PACKAGE = 'transformertts_torch'


def _profile(fn, with_stack: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if with_stack:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        with torch.profiler.profile(activities=acts, with_stack=with_stack) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [e for e in trace['traceEvents'] if e.get('ph') == 'X']
    return out, events, seconds, trace.get('baseTimeNanoseconds', 0)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in the unit given."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_window(fn):
    """Window A: (fn's result, readings) with readings {'busy_s', 'window_s',
    'kernels': [(name, seconds)], 'launches', 'device_events': [(ts µs,
    dur µs, correlation)], 'launch_events': [(ts µs, correlation)],
    'base_ns'} (the exported trace's ``baseTimeNanoseconds``: epoch ns =
    ts · 1e3 + base). The window is ``fn``'s call, waited for on the
    device."""
    out, events, window_s, base_ns = _profile(fn, with_stack=False)
    dev = [e for e in events if e.get('cat') in DEVICE_CATS]
    busy_us = union_seconds((e['ts'], e['ts'] + e['dur']) for e in dev)
    kernels = [(e['name'], e['dur'] * 1e-6) for e in dev if e.get('cat') == 'kernel']
    return out, {'busy_s': busy_us * 1e-6, 'window_s': window_s,
                 'kernels': kernels, 'launches': len(kernels), 'base_ns': base_ns,
                 'device_events': [(e['ts'], e['dur'], e.get('args', {}).get('correlation'))
                                   for e in dev],
                 'launch_events': [(e['ts'], e['args']['correlation']) for e in events
                                   if e.get('cat') in LAUNCH_CATS
                                   and 'correlation' in e.get('args', {})]}


def _frame_module(name: str) -> str:
    """'…/transformertts_torch/audio/griffinlim.py(93): istft_padded' →
    'audio/griffinlim.py:istft_padded'."""
    path, _, func = name.partition(': ')
    path = path.split(PACKAGE + '/', 1)[-1]
    return f"{path.split('(')[0]}:{func}"


def _stacks_at(frames, times):
    """For each time in ``times`` (sorted), the innermost of ``frames``
    ((start, end, label), properly nested) that holds it, or None."""
    frames = sorted(frames, key=lambda f: (f[0], -f[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(frames) and frames[i][0] <= t:
            while stack and stack[-1][1] < frames[i][0]:
                stack.pop()
            stack.append(frames[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def stack_window(fn):
    """Window B: (fn's result, readings) with readings {'by_module':
    {module: device seconds}, 'device_ops': [(name, seconds)], 'idle_gaps':
    [(name, seconds)], 'window_s'}."""
    out, events, window_s, _ = _profile(fn, with_stack=True)
    py = [e for e in events if e.get('cat') == 'python_function']
    launch = {e['args']['correlation']: e for e in events
              if e.get('cat') in LAUNCH_CATS and 'correlation' in e.get('args', {})}
    dev = [e for e in events if e.get('cat') in DEVICE_CATS]
    ours = [(e['ts'], e['ts'] + e['dur'], _frame_module(e['name'])) for e in py
            if PACKAGE + '/' in e['name']]
    any_frame = [(e['ts'], e['ts'] + e['dur'], e['name'].split('/')[-1]) for e in py]

    launched = []
    for e in dev:
        src = launch.get(e.get('args', {}).get('correlation'))
        launched.append((src['ts'] if src else e['ts'], e))
    launched.sort(key=lambda x: x[0])
    labels = _stacks_at(ours, [t for t, _ in launched])
    by_module, ops = defaultdict(float), defaultdict(float)
    for (t, e), label in zip(launched, labels):
        label = label or 'outside transformertts_torch'
        by_module[label.split(':')[0]] += e['dur'] * 1e-6
        ops[f"{label} {e['name'][:80]}"] += e['dur'] * 1e-6

    busy = sorted((e['ts'], e['ts'] + e['dur']) for e in dev)
    gaps, end = [], None
    for s, e in busy:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    gap_labels = _stacks_at(ours, [m for m, _ in mids])
    any_labels = _stacks_at(any_frame, [m for m, _ in mids])
    idle = defaultdict(float)
    for (m, length), mine, other in zip(mids, gap_labels, any_labels):
        idle[mine or other or 'host outside Python'] += length * 1e-6
    return out, {'by_module': dict(by_module),
                 'device_ops': sorted(ops.items(), key=lambda x: -x[1])[:10],
                 'idle_gaps': sorted(idle.items(), key=lambda x: -x[1])[:10],
                 'window_s': window_s}
