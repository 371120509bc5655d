"""A run of each kind of cell on the CPU at a tiny size, with the look for a
card skipped: the reference against the port, the controls and the faults
the check must see, failure reporting, a cell added as files alone, and
the modules a run loads."""
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
from h100bench import check_serve, serve, train

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
    numbers = check_serve.judge(records, c['config_data'], *weights, 'cpu')
    assert numbers['checked_sentences'] >= 2 and numbers['mismatched_sentences'] == 0
    assert numbers['duration_gap_frames'] < 1e-3 and numbers['mel_gap'] < 1e-4
    _, ok = serve.judge_cell(c, records, weights)
    assert ok
    # the control: the model with float8 operands, the waveform stage in TF32
    low = check_serve.control_records([r['sentence'] for r in records], c['config_data'],
                                      *weights, 'cpu')
    control = check_serve.judge(low, c['config_data'], *weights, 'cpu')
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
    numbers = check_serve.judge(records, c['config_data'], *weights, 'cpu')
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


def test_the_reference_imports_nothing_of_the_program():
    code = ('import sys, h100bench.reference.forward_tts, h100bench.reference.aligner, '
            'h100bench.reference.waveform, h100bench.reference.frontend, h100bench.check_serve; '
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
    from h100bench import control
    from h100bench.common import load_cell
    for name in ('tts.serve', 'tts.serve-hifigan'):
        c = load_cell(name)
        out = control.serve_readings(c, 2 ** 31 + 1, 2.0)
        limits = c['config_data']['limits']
        assert any(out['control'][k] > limits[k] for k in limits)
        assert all(out['program'][k] <= limits[k] for k in limits)
