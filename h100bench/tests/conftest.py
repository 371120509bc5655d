"""Tiny cells for the harness's CPU tests, and the card marker.

``cuda``-marked tests need an NVIDIA GPU and skip inside the ``card``
fixture when there is none. The tiny cells keep every published structure
of their configuration (the blocks, the heads' layout, the buckets) at
small widths, so the program runs its CPU paths."""
import copy
import json
import sys
import time
from pathlib import Path

import pytest
import yaml

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CPU_DEVICE = {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': 0}


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs an NVIDIA GPU (skips without one)')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')


def tiny_serve_config(name: str = 'forward-ljspeech', dtype: str = 'float32') -> dict:
    cfg = yaml.safe_load((BENCH / 'configs' / f'{name}.yaml').read_text())
    cfg['model'].update(encoder_model_dimension=32, decoder_model_dimension=32,
                        encoder_attention_conv_filters=[64, 32],
                        decoder_attention_conv_filters=[64, 32],
                        duration_conv_filters=[16, 16], pitch_conv_filters=[16, 16],
                        encoder_num_heads=[2, 2], decoder_num_heads=[2, 2], compute_dtype=dtype)
    if cfg.get('vocoder'):
        cfg['vocoder']['upsample_initial_channel'] = 32
    return cfg


def tiny_serve_mix(name: str = 'paragraphs-16') -> dict:
    mix = json.loads((BENCH / 'traffic' / f'{name}.json').read_text())
    mix.update(sentences={'min': 1, 'max': 3}, words={'deck': [2, 3, 5]},
               warmup_requests=1, check_requests=2)
    return mix


def tiny_train_config() -> dict:
    cfg = yaml.safe_load((BENCH / 'configs' / 'aligner-ljspeech.yaml').read_text())
    cfg['model'].update(encoder_model_dimension=32, decoder_model_dimension=32,
                        encoder_prenet_dimension=32, decoder_prenet_dimension=32,
                        encoder_feed_forward_dimension=64, decoder_feed_forward_dimension=64,
                        encoder_num_heads=[2, 2], decoder_num_heads=[2, 2, 1])
    cfg['training'].update(bucket_boundaries=[40, 60], bucket_batch_sizes=[4, 3, 2])
    return cfg


def tiny_train_mix() -> dict:
    mix = json.loads((BENCH / 'traffic' / 'aligner-ljspeech-r1.json').read_text())
    mix.update(frames={'min': 20, 'max': 55, 'beta_a': 2.5, 'beta_b': 1.61}, pool_batches=4)
    return mix


def cell(cfg: dict, mix: dict) -> dict:
    return {'name': 'tiny', 'chips': 1, 'config_data': copy.deepcopy(cfg),
            'traffic_data': copy.deepcopy(mix)}


@pytest.fixture
def on_cpu(monkeypatch):
    """Skip the harness's look for a card; the rest of a run as it is."""
    import torch
    from h100bench import common
    monkeypatch.setattr(common, 'require_devices', lambda n: None)
    monkeypatch.setattr(common, 'device_info', lambda n: dict(CPU_DEVICE))
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda *a, **k: None)


class HostEvent:
    """``torch.cuda.Event``'s stand-in on the CPU: the host's clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def cpu_trace_patches() -> list:
    """(object, attribute, stand-in) that let a traced run go on the CPU:
    the profiler traces the host's operations in place of the card's (so
    the trace holds no device event), and a CUDA event reads the host's
    clock."""
    import torch
    real = torch.profiler.profile

    def profile(activities=None, **kwargs):
        return real(activities=[torch.profiler.ProfilerActivity.CPU], **kwargs)

    return [(torch.profiler, 'profile', profile), (torch.cuda, 'Event', HostEvent)]


@pytest.fixture
def traced_on_cpu(on_cpu, monkeypatch):
    """``on_cpu``, and a traced run's profiler and CUDA events on the host."""
    for obj, name, value in cpu_trace_patches():
        monkeypatch.setattr(obj, name, value)
