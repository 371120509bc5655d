"""A run of each kind of cell on the CPU at a tiny size, with the look for a
card skipped: the reference against the port, the controls and the faults
the check must see, failure reporting, the records and check of the
harness before its model families, the traced run's hand-over to the
readers, a cell, a model family and a driver added as files alone, and the
modules a run loads."""
import hashlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from conftest import (BENCH, ROOT, cell, tiny_serve_config, tiny_serve_mix,
                      tiny_train_config, tiny_train_mix)
from h100bench import serve, train
from h100bench.families import forward_tts
from h100bench.readers import load_reader

SERVE_LIMITS = {'mismatched_sentences': 0, 'duration_gap_frames': 0.05, 'mel_gap': 1e-3,
                'wave_gap': 0.1, 'wave_gap_outliers': 0}
TRAIN_LIMITS = {'loss_gap': 1e-4, 'grad_gap': 1e-3, 'update_gap': 1e-2}


def serve_run(cfg, seed=2 ** 31 + 5, seconds=1.0):
    cfg['limits'] = dict(SERVE_LIMITS)
    c = cell(cfg, tiny_serve_mix())
    out = serve.run_cell(c, seed, seconds, False, time.time(), 'cpu')
    return c, out


@pytest.mark.parametrize('config', ['forward-ljspeech', 'forward-hifigan-ljspeech'])
def test_serving_reference_agrees_with_the_port(on_cpu, config):
    c, (readings, (attempted, failed), _, records, weights, _) = serve_run(
        tiny_serve_config(config))
    assert attempted >= 1 and failed == 0 and readings['audio_rate'] > 0
    numbers = forward_tts.judge(records, c['config_data'], weights)
    assert numbers['checked_sentences'] >= 2 and numbers['mismatched_sentences'] == 0
    assert numbers['duration_gap_frames'] < 1e-3 and numbers['mel_gap'] < 1e-4
    _, ok = serve.judge_cell(c, records, weights)
    assert ok
    # the control: the model with float8 operands, the waveform stage in TF32
    low = forward_tts.control_records([r['sentence'] for r in records], c['config_data'],
                                      weights)
    control = forward_tts.judge(low, c['config_data'], weights)
    assert control['mel_gap'] > 10 * max(numbers['mel_gap'], 1e-4)


def test_a_token_altered_where_it_is_produced_fails_the_check(on_cpu, monkeypatch):
    from transformertts_torch.models.forward_tts import ForwardTransformer
    real = ForwardTransformer.encode_text

    def altered(self, text):
        ids = list(real(self, text))
        ids[len(ids) // 2] = ids[len(ids) // 2] % 100 + 1
        return ids

    monkeypatch.setattr(ForwardTransformer, 'encode_text', altered)
    c, (_, _, _, records, weights, _) = serve_run(tiny_serve_config())
    checks, ok = serve.judge_cell(c, records, weights)
    assert not ok and checks['mismatched_sentences'][0] > 0


def test_a_wave_altered_where_it_is_produced_fails_the_check(on_cpu, monkeypatch):
    from transformertts_torch.audio import griffinlim
    real = griffinlim.griffin_lim
    monkeypatch.setattr(griffinlim, 'griffin_lim', lambda *a, **k: -real(*a, **k))
    c, (_, _, _, records, weights, _) = serve_run(tiny_serve_config())
    checks, ok = serve.judge_cell(c, records, weights)
    assert not ok and checks['wave_gap'][0] > 0.3


def test_a_wave_wrong_in_one_row_of_each_chunk_fails_the_check(on_cpu, monkeypatch):
    from transformertts_torch.audio import griffinlim
    real = griffinlim.griffin_lim

    def first_row_negated(*a, **k):
        wav = real(*a, **k).clone()
        wav[0] = -wav[0]
        return wav

    monkeypatch.setattr(griffinlim, 'griffin_lim', first_row_negated)
    cfg = tiny_serve_config()
    c, (_, _, _, records, weights, _) = serve_run(cfg)
    numbers = forward_tts.judge(records, c['config_data'], weights)
    assert 1 <= numbers['wave_gap_outliers'] < numbers['checked_sentences']
    checks, ok = serve.judge_cell(c, records, weights)
    assert not ok and checks['wave_gap_outliers'][0] >= 1


def train_run(seed=2 ** 31 + 77):
    cfg = tiny_train_config()
    cfg['limits'] = dict(TRAIN_LIMITS)
    c = cell(cfg, tiny_train_mix())
    return c, train.run_cell(c, seed, 0.5, False, time.time(), 'cpu')


def test_training_reference_agrees_with_the_port(on_cpu):
    c, (readings, (attempted, failed), _, check, weights, _) = train_run()
    assert attempted >= 1 and failed == 0 and readings['train_frame_rate'] > 0
    n = train.judge_numbers(c['config_data'], check, weights)
    assert n['loss_gap'] < 1e-6 and n['grad_gap'] < 1e-5 and n['update_gap'] < 1e-4
    # the key biases get no gradient under softmax and leave the change by the rule
    assert n['left_out'] and all('wk.bias' in k for k in n['left_out'])
    assert train.judge_cell(c, check, weights)[1]


def test_a_step_that_leaves_the_state_unchanged_fails_the_check(on_cpu, monkeypatch):
    from transformertts_torch.training import state
    monkeypatch.setattr(state.FlatAdam, 'step', lambda self: None)
    c, (_, _, _, check, weights, _) = train_run()
    checks, ok = train.judge_cell(c, check, weights)
    assert not ok and checks['update_gap'][0] == pytest.approx(1.0)


def test_half_the_batch_left_out_fails_the_check(on_cpu, monkeypatch):
    from transformertts_torch.training.base_trainer import BaseTrainer
    real = BaseTrainer.shard

    def half(self, batch, n):
        return real(self, {k: np.asarray(v)[:max(1, len(v) // 2)] for k, v in batch.items()}, n)

    monkeypatch.setattr(BaseTrainer, 'shard', half)
    c, (_, _, _, check, weights, _) = train_run()
    checks, ok = train.judge_cell(c, check, weights)
    assert not ok and checks['loss_gap'][0] > 1e-3


def test_a_failed_request_counts_and_says_why(on_cpu, monkeypatch, capsys):
    from transformertts_torch.models import synthesis
    real, calls = synthesis.synthesize_lines, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 3:       # the warm-up takes the first two
            raise RuntimeError('planted fault')
        return real(*a, **k)

    monkeypatch.setattr(synthesis, 'synthesize_lines', flaky)
    _, (_, (attempted, failed), _, _, _, _) = serve_run(tiny_serve_config())
    assert failed == 1 and attempted > 1
    err = capsys.readouterr().err
    assert 'failed' in err and 'planted fault' in err and 'Traceback' in err


def records_digest(records) -> str:
    """sha256 over each record's sentence, tokens, token bucket, durations
    and the float32 bytes of its mel and wave."""
    h = hashlib.sha256()
    for r in records:
        h.update(json.dumps([r['sentence'], [int(x) for x in r['tokens']], int(r['n_pad']),
                             [int(x) for x in r['durations']]]).encode())
        h.update(np.ascontiguousarray(r['mel'], np.float32).tobytes())
        h.update(np.ascontiguousarray(r['wav'], np.float32).tobytes())
    return h.hexdigest()


# What the harness gave before its model families (commit 80bc6dd, where
# serve.py built the ForwardTransformer itself and check_serve.judge judged
# it), taken by this module's ``records_digest`` and that commit's
# ``check_serve.judge(records, cfg, weights, vocoder_weights, 'cpu')`` after
# ``serve.run_cell`` at --trace 0, on the CPU (x86-64, PyTorch 2.13 CPU
# build) with the test's settings: seed 2**31 + 5, one torch thread, a
# window of 10 ticks of a clock that advances a tick a read (3 requests).
PARENT = {
    'forward-ljspeech': {
        'counts': [3, 0],
        'sentences': ['Hot gave.', 'Some write has.', 'There no these wrong rain.',
                      'Picked get can.', 'Big, thought talk emotional his.'],
        'records_sha256': '1bb609bb0030c63c48e8d4754ae6d1696d13e113ccaf82fcf533e9d1e18a034e',
        'detail': {'checked_sentences': 5.0, 'mismatched_sentences': 0.0,
                   'duration_gap_frames': 0.0, 'mel_gap': 4.4561923573382956e-07,
                   'wave_gap': 0.06550486385822296, 'wave_gap_median': 0.02924509160220623,
                   'wave_gap_outliers': 0.0}},
    'forward-hifigan-ljspeech': {
        'counts': [3, 0],
        'sentences': ['Hot gave.', 'Some write has.', 'There no these wrong rain.',
                      'Picked get can.', 'Big, thought talk emotional his.'],
        'records_sha256': '43d0b561408fd31af2174df18a7e1230b26530942ec0bfa9338e482c4fbe85f7',
        'detail': {'checked_sentences': 5.0, 'mismatched_sentences': 0.0,
                   'duration_gap_frames': 0.0, 'mel_gap': 4.4561923573382956e-07,
                   'wave_gap': 3.2759456303210754e-07, 'wave_gap_median': 2.9823760883118666e-07,
                   'wave_gap_outliers': 0.0}},
}


@pytest.mark.parametrize('config', sorted(PARENT))
def test_records_and_check_equal_the_harness_before_its_families(on_cpu, monkeypatch,
                                                                 config):
    ticks = itertools.count()
    monkeypatch.setattr(time, 'perf_counter', lambda: float(next(ticks)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        c, (_, counts, _, records, weights, _) = serve_run(tiny_serve_config(config),
                                                           seconds=10.0)
        numbers = forward_tts.judge(records, c['config_data'], weights)
    finally:
        torch.set_num_threads(threads)
    want = PARENT[config]
    assert list(counts) == want['counts']
    assert [r['sentence'] for r in records] == want['sentences']
    assert records_digest(records) == want['records_sha256']
    assert {k: float(v) for k, v in numbers.items()} == want['detail']


def test_a_traced_run_hands_the_readers_the_programs_spans_and_counters(traced_on_cpu):
    from transformertts_torch.utils import tracing
    cfg = tiny_serve_config()
    cfg['limits'] = dict(SERVE_LIMITS)
    c = cell(cfg, tiny_serve_mix())
    _, (attempted, failed), _, records, weights, extra = serve.run_cell(
        c, 2 ** 31 + 21, 1.0, True, time.time(), 'cpu')
    assert failed == 0 and serve.judge_cell(c, records, weights)[1]
    ctx = extra['ctx']
    assert {'cell', 'a', 'b', 'a_work', 'b_work', 'spans', 'counters'} <= set(ctx)
    assert {'busy_s', 'window_s', 'kernels', 'launches', 'wave_stage_s', 'device_events',
            'launch_events', 'base_ns'} <= set(ctx['a'])
    assert ctx['a']['base_ns'] > 0
    # window A's requests alone: window B runs with the program's tracing off
    n_a = len(ctx['a_work'])
    assert 1 <= n_a < attempted
    assert sum(s['name'] == 'request' for s in ctx['spans']) == ctx['counters']['requests'] == n_a
    assert ctx['counters']['frame_slots'] >= ctx['counters']['frames_real'] > 0
    assert 0 <= load_reader('frame_pad_share.serve')(ctx) < 100
    # no device event on the CPU: every stretch of encode, decode and waveform is idle
    assert 0 < load_reader('launch_idle_share.serve')(ctx) < 100
    assert not tracing.enabled()


def test_an_untraced_run_leaves_the_programs_tracing_off(on_cpu, monkeypatch):
    from transformertts_torch.utils import tracing
    calls = []
    monkeypatch.setattr(tracing, 'enable', lambda: calls.append(1))
    _, (_, (attempted, failed), _, _, _, _) = serve_run(tiny_serve_config())
    assert attempted >= 1 and failed == 0 and calls == []


def _copy_with_tiny_cell(tmp_path):
    """The benchmark's files in a fresh directory, plus a cell added as
    files alone: a configuration, a traffic mix, a per-layer reader and
    their entries in BENCHMARK.json."""
    dst = tmp_path / 'checkout'
    shutil.copytree(BENCH, dst / 'h100bench', ignore=shutil.ignore_patterns('__pycache__'))
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    cfg = tiny_serve_config()
    cfg['limits'] = dict(SERVE_LIMITS)
    (dst / 'h100bench' / 'configs' / 'tiny-forward.yaml').write_text(yaml.safe_dump(cfg))
    (dst / 'h100bench' / 'traffic' / 'tiny-paragraphs.json').write_text(
        json.dumps(tiny_serve_mix()))
    (dst / 'h100bench' / 'metrics' / 'tiny_requests.serve.py').write_text(
        'def read(ctx):\n    return float(len(ctx["a_work"]))\n')
    bench['configs'].append({'name': 'tiny-forward', 'source': 'a test', 'reduced': [],
                             'file': 'h100bench/configs/tiny-forward.yaml', 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny.serve', 'config': 'tiny-forward',
                               'traffic': 'tiny-paragraphs', 'chips': 1, 'why': 'a test'})
    for m in bench['end_to_end']:
        if 'workloads' in m and 'tts.serve' in m['workloads']:
            m['workloads'].append('tiny.serve')
    bench['per_layer'].append({'name': 'tiny_requests.serve', 'unit': 'requests',
                               'better': 'higher', 'source': 'program_counter',
                               'layer': 'entry', 'moves': 'audio_rate',
                               'workloads': ['tiny.serve']})
    (dst / 'BENCHMARK.json').write_text(json.dumps(bench))
    return dst


FAMILY = '''"""A second model family: the ForwardTransformer's pieces, each sentence
of a request served by a call of its own."""
from h100bench.families import forward_tts
from h100bench.families.forward_tts import (Capture, build, chunk_work, control_records,
                                            flop_seconds, judge, records, stage)

attention_bound_s = None


def serve(built, sentences, mix):
    return [w for s in sentences for w in forward_tts.serve(built, [s], mix)]
'''

DRIVER = '''"""A serving driver of its own traffic kind."""
from h100bench import serve

TRAFFIC_KIND = 'tiny_paragraphs'
run_cell = serve.run_cell
judge_cell = serve.judge_cell
'''


def _add_family_and_driver(dst):
    """Into the copy: a model family, a serving driver that names its own
    traffic kind, their configuration and traffic, a per-layer reader of
    the program's counters, and their entries in BENCHMARK.json."""
    bench_dir = dst / 'h100bench'
    (bench_dir / 'families' / 'tiny_echo.py').write_text(FAMILY)
    (bench_dir / 'serve_each.py').write_text(DRIVER)
    cfg = tiny_serve_config()
    cfg.update(kind='serve_each', model_family='tiny_echo', limits=dict(SERVE_LIMITS))
    (bench_dir / 'configs' / 'tiny-echo.yaml').write_text(yaml.safe_dump(cfg))
    (bench_dir / 'traffic' / 'tiny-echo.json').write_text(
        json.dumps(tiny_serve_mix() | {'kind': 'tiny_paragraphs'}))
    (bench_dir / 'metrics' / 'calls_per_sentence.serve.py').write_text(
        'def read(ctx):\n'
        '    c = ctx["counters"]\n'
        '    return c["requests"] / c["sentences"] if c.get("sentences") else None\n')
    bench = json.loads((dst / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny-echo', 'source': 'a test', 'reduced': [],
                             'file': 'h100bench/configs/tiny-echo.yaml', 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny.echo', 'config': 'tiny-echo',
                               'traffic': 'tiny-echo', 'chips': 1, 'why': 'a test'})
    for m in bench['end_to_end']:
        if 'workloads' in m and 'tts.serve' in m['workloads']:
            m['workloads'].append('tiny.echo')
    bench['per_layer'].append({'name': 'calls_per_sentence.serve', 'unit': 'calls',
                               'better': 'lower', 'source': 'program_counter',
                               'layer': 'entry', 'moves': 'audio_rate',
                               'workloads': ['tiny.echo']})
    (dst / 'BENCHMARK.json').write_text(json.dumps(bench))


RUN_ON_CPU = '''
import sys, time, json
from h100bench import common, run
import torch
common.require_devices = lambda n: None
common.device_info = lambda n: {"platform": "cpu", "kind": "cpu", "count": 1,
                                "memory_peak_bytes": 0}
torch.cuda.synchronize = lambda *a, **k: None
args = run.parse(sys.argv[1:])
result, checks = run.run(args, time.time(), "cpu")
common.emit(result, checks)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})), file=sys.stderr)
'''

# a traced run on the CPU: the profiler and CUDA events on the host (conftest)
RUN_TRACED_ON_CPU = RUN_ON_CPU.replace('args = run.parse', '''sys.path.insert(0, "h100bench/tests")
import conftest
for obj, name, value in conftest.cpu_trace_patches():
    setattr(obj, name, value)
args = run.parse''')


def _tree(root) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob('*'))
            if p.is_file() and '__pycache__' not in p.parts}


def test_a_cell_added_as_files_runs_with_no_code_edit(tmp_path):
    dst = _copy_with_tiny_cell(tmp_path)
    env = dict(os.environ, PYTHONPATH=f'{dst}{os.pathsep}{ROOT}')
    proc = subprocess.run([sys.executable, '-c', RUN_ON_CPU, '--workload', 'tiny.serve',
                           '--seed', str(2 ** 31 + 3), '--seconds', '1', '--trace', '0'],
                          cwd=dst, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['failed'] == 0
    assert set(result['metrics']) == {'audio_rate', 'request_p95_ms', 'setup_s'}
    assert list(result)[-1] == 'checks'
    loaded = set(json.loads(proc.stderr.strip().splitlines()[-1]))
    assert 'transformertts_torch' in loaded
    assert not loaded & {'jax', 'jaxlib', 'flax', 'transformertts_tpu', 'bench', 'chip_smoke',
                         'scripts'}
    reader = subprocess.run(
        [sys.executable, '-c', 'from h100bench.readers import load_reader; '
         'print(load_reader("tiny_requests.serve")({"a_work": [1, 2]}))'],
        cwd=dst, env=env, capture_output=True, text=True, timeout=120)
    assert reader.stdout.strip() == '2.0', reader.stderr

    # a model family and a serving driver of its own traffic kind, as files
    # alone, run traced; their reader takes the program's counters
    _add_family_and_driver(dst)
    before = _tree(dst / 'h100bench')
    proc = subprocess.run([sys.executable, '-c', RUN_TRACED_ON_CPU, '--workload', 'tiny.echo',
                           '--seed', str(2 ** 31 + 9), '--seconds', '1', '--trace', '1'],
                          cwd=dst, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['failed'] == 0
    # one program call a sentence: the family's own serve call ran
    assert result['metrics'] == {'calls_per_sentence.serve': {'value': 1.0, 'unit': 'calls'}}
    assert {'busy_s', 'window_s'} <= set(result['device']) and 'breakdown' in result
    assert _tree(dst / 'h100bench') == before
    for path, data in _tree(BENCH).items():
        assert before[path] == data, path


def test_the_reference_imports_nothing_of_the_program():
    code = ('import sys, h100bench.reference.forward_tts, h100bench.reference.aligner, '
            'h100bench.reference.waveform, h100bench.reference.frontend, h100bench.check_serve, '
            'h100bench.families.forward_tts; '
            'print(sorted({m.split(".")[0] for m in sys.modules}))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    loaded = set(eval(proc.stdout))
    assert not loaded & {'transformertts_torch', 'transformertts_tpu', 'jax'}


def test_without_a_card_a_run_prints_no_result_and_says_why():
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    proc = subprocess.run([sys.executable, '-m', 'h100bench.run', '--workload', 'tts.serve',
                           '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ''
    assert 'tts.serve' in proc.stderr.splitlines()[-1]


def test_a_set_up_fault_ends_the_run_naming_cell_and_seed(tmp_path):
    dst = _copy_with_tiny_cell(tmp_path)
    cfg = yaml.safe_load((dst / 'h100bench' / 'configs' / 'tiny-forward.yaml').read_text())
    cfg['model']['encoder_num_heads'] = [3, 3]       # 32 channels do not split into 3 heads
    (dst / 'h100bench' / 'configs' / 'tiny-forward.yaml').write_text(yaml.safe_dump(cfg))
    code = RUN_ON_CPU.replace('result, checks = run.run(args, time.time(), "cpu")\n'
                              'common.emit(result, checks)',
                              'run.run = lambda a, t, d="cuda", f=run.run: f(a, t, "cpu")\n'
                              'sys.exit(run.main(sys.argv[1:]))')
    env = dict(os.environ, PYTHONPATH=f'{dst}{os.pathsep}{ROOT}')
    proc = subprocess.run([sys.executable, '-c', code, '--workload', 'tiny.serve', '--seed',
                           '42', '--seconds', '1', '--trace', '0'], cwd=dst, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout.strip() == ''
    last = proc.stderr.strip().splitlines()
    assert 'tiny.serve' in last[-1] and '42' in last[-1]
    assert any('Traceback' in line for line in last[-40:])


@pytest.mark.cuda
def test_the_controls_fail_on_the_card(card):
    """On the card at the cells' own sizes: the float8/TF32 control of each
    serving cell and the TF32 control of the training cell read above
    their limits (the readings PERF.md gives come from this module's
    command, ``python -m h100bench.control``)."""
    from h100bench.common import load_cell
    for name in ('tts.serve', 'tts.serve-hifigan'):
        c = load_cell(name)
        out = serve.control_readings(c, 2 ** 31 + 1, 2.0)
        limits = c['config_data']['limits']
        assert any(out['control'][k] > limits[k] for k in limits)
        assert all(out['program'][k] <= limits[k] for k in limits)
