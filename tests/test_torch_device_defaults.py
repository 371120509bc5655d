"""The port's entry points run on the card unless the caller names another
device. Without a card, a call that names none raises: it never falls back
to the CPU. With ``device='cpu'`` each runs here, as the other CPU tests
call them.
"""
import json
import os
import socket
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_aligner import TINY_ALIGNER
from test_torch_duration_extraction import write_featurized
from test_torch_nn import TINY_CONFIG
from transformertts_torch import extract_durations
from transformertts_torch.audio import Audio
from transformertts_torch.audio.pitch import extract_pitch_np
from transformertts_torch.models.aligner import Aligner
from transformertts_torch.models import factory
from transformertts_torch.models.forward_tts import ForwardTransformer
from transformertts_torch.models.hifigan import HiFiGANVocoder
from transformertts_torch.models.melgan import MelGANVocoder
from transformertts_torch.models.persistence import load_model_dir
from transformertts_torch.models.vocoder import load_vocoder
from transformertts_torch.parallel import maybe_initialize_distributed
from transformertts_torch.parallel.mesh import destroy_distributed
from transformertts_torch.training import checkpointing
from transformertts_torch.training.state import make_optimizer
from transformertts_torch.utils.config import TrainingConfigManager

torch.set_num_threads(1)

AUDIO = Audio.from_config(TINY_CONFIG)
WAV = (0.1 * np.random.default_rng(0).standard_normal(4096)).astype(np.float32)
MEL = np.full((12, TINY_CONFIG['mel_channels']), -4.0, np.float32)
HIFIGAN = {'upsample_rates': [2, 2], 'upsample_kernel_sizes': [4, 4],
           'upsample_initial_channel': 16, 'resblock_kernel_sizes': [3],
           'resblock_dilation_sizes': [[1, 3]]}


def _extract_durations(d, device=None):
    argv = ['--config', str(d / 'stage3' / 'session.yaml'), '--skip_char_pitch']
    return extract_durations.main(argv + (['--device', device] if device else []))


# entry point -> call(dir, **device): the dir holds a ForwardTransformer
# model dir (also as the published model's cache dir under models/), an
# Aligner model dir under aligner/, a featurized session under stage3/ and
# vocoder checkpoints under vocoders/
ENTRY_POINTS = {
    'Aligner.from_config': lambda d, **dev: Aligner.from_config(TINY_ALIGNER, **dev),
    'Aligner.load_model': lambda d, **dev: Aligner.load_model(d / 'aligner', **dev),
    'TrainingConfigManager.load_model(aligner)': lambda d, **dev: TrainingConfigManager(
        d / 'stage3' / 'session.yaml', aligner=True).load_model(verbose=False, **dev),
    'extract_durations.main': _extract_durations,
    'persistence.load_model_dir(Aligner)': lambda d, **dev: load_model_dir(
        Aligner, d / 'aligner', **dev),
    'ForwardTransformer.load_model': lambda d, **dev: ForwardTransformer.load_model(d, **dev),
    'ForwardTransformer.from_config': lambda d, **dev: ForwardTransformer.from_config(
        TINY_CONFIG, **dev),
    'persistence.load_model_dir': lambda d, **dev: load_model_dir(ForwardTransformer, d,
                                                                  **dev),
    'Audio.mel_spectrogram': lambda d, **dev: AUDIO.mel_spectrogram(WAV, **dev),
    'Audio.extract_pitch': lambda d, **dev: AUDIO.extract_pitch(WAV, **dev),
    'Audio.reconstruct_waveform': lambda d, **dev: AUDIO.reconstruct_waveform(
        MEL, n_iter=1, **dev),
    'pitch.extract_pitch_np': lambda d, **dev: extract_pitch_np(
        WAV, AUDIO.sampling_rate, AUDIO.hop_length, **dev),
    'factory.tts_ljspeech': lambda d, **dev: factory.tts_ljspeech('1', **dev),
    'factory.tts_custom': lambda d, **dev: factory.tts_custom(
        d / 'config.yaml', d / 'model_weights.npz', **dev)[0],
    'vocoder.load_vocoder': lambda d, **dev: load_vocoder(d / 'vocoders' / 'g_1', **dev),
    'MelGANVocoder.from_torch_checkpoint': lambda d, **dev: MelGANVocoder.from_torch_checkpoint(
        d / 'vocoders' / 'melgan.pt', **dev),
    'HiFiGANVocoder.from_torch_checkpoint': lambda d, **dev:
        HiFiGANVocoder.from_torch_checkpoint(d / 'vocoders' / 'g_1', HIFIGAN, **dev),
}


@pytest.fixture
def model_dir(tmp_path, monkeypatch):
    model = ForwardTransformer(**TINY_CONFIG).init_params(torch.Generator().manual_seed(0))
    model.save_model(tmp_path)
    model.save_model(tmp_path / 'models' / 'bdf06b9_ljspeech_step_1')
    monkeypatch.setenv('TRANSFORMERTTS_MODELS_DIR', str(tmp_path / 'models'))
    (tmp_path / 'vocoders').mkdir()
    gen = torch.Generator().manual_seed(0)
    torch.save({'model_g': MelGANVocoder(base_channels=16, upsample_rates=(2, 2)).init_params(
        gen).state_dict()}, tmp_path / 'vocoders' / 'melgan.pt')
    torch.save({'generator': HiFiGANVocoder(config=HIFIGAN).init_params(gen).state_dict()},
               tmp_path / 'vocoders' / 'g_1')
    (tmp_path / 'vocoders' / 'config.json').write_text(json.dumps(HIFIGAN))
    Aligner(**TINY_ALIGNER).init_params(torch.Generator().manual_seed(0)).save_model(
        tmp_path / 'aligner')
    cm = TrainingConfigManager(write_featurized(tmp_path / 'stage3', n_clips=2), aligner=True)
    aligner = cm.get_model('cpu').init_params(torch.Generator().manual_seed(0))
    # step 7: the session's reduction schedule is at r = 1 there
    checkpointing.save_checkpoint(cm.weights_dir, aligner, make_optimizer(aligner), 7)
    return tmp_path


@pytest.mark.parametrize('entry', sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(entry, model_dir):
    call = ENTRY_POINTS[entry]
    if not torch.cuda.is_available():
        # a CPU-only torch raises AssertionError, a CUDA build without a card
        # RuntimeError; neither returns results computed on the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            call(model_dir)
        return
    out = call(model_dir)
    if isinstance(out, torch.nn.Module):
        assert out.device.type == 'cuda'


@pytest.mark.parametrize('entry', sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(entry, model_dir):
    out = ENTRY_POINTS[entry](model_dir, device='cpu')
    if isinstance(out, torch.nn.Module):
        assert out.device.type == 'cpu'
    elif entry == 'extract_durations.main':
        assert out['clips'] == 2
    else:
        assert isinstance(out, np.ndarray) and out.size > 0 and np.isfinite(out).all()


def _torchrun_env() -> dict:
    """The environment torchrun gives the one rank of a group of one."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    return {'RANK': '0', 'WORLD_SIZE': '1', 'LOCAL_RANK': '0',
            'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port)}


def test_process_group_defaults_to_the_card():
    """Under torchrun, ``maybe_initialize_distributed`` without a device
    brings up an NCCL group on the card, or raises without one: it never
    brings up a gloo group, whose collectives would run through the host."""
    try:
        with mock.patch.dict(os.environ, _torchrun_env()):
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match='no CUDA device'):
                    maybe_initialize_distributed({'mesh': {'data': -1}})
                assert not dist.is_initialized()
                return
            mesh = maybe_initialize_distributed({'mesh': {'data': -1}})
            assert mesh.grouped and dist.get_backend() == 'nccl'
    finally:
        destroy_distributed()


def test_process_group_runs_on_the_cpu_when_asked():
    try:
        with mock.patch.dict(os.environ, _torchrun_env()):
            mesh = maybe_initialize_distributed({'mesh': {'data': -1}}, device='cpu')
        assert (mesh.rank, mesh.size, mesh.grouped) == (0, 1, True)
        assert dist.get_backend() == 'gloo'
    finally:
        destroy_distributed()
