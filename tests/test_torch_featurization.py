"""Featurization (stage 1) of the port against the JAX package.

- The VAD and ``Audio.preprocess`` (volume normalization, long-silence and
  edge trimming) are NumPy in both packages: bit-identical.
- ``featurize_batch`` and the whole ``create_training_data`` CLI, run through
  both packages into separate data dirs on the CPU: the same kept clips,
  identical phonemized, train and valid metadata, mels within the fused
  kernel's bar (atol 2e-4, rtol 1e-3), pitch within the YIN bars (voicing
  agreeing on at least 99 % of frames, F0 within 1e-3 relative where both
  are voiced) and ``pitch_stats.pkl`` within 1e-3 relative.

The clip generator is ``tests/test_full_pipeline.py``'s, copied here.
"""
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from transformertts_torch import create_training_data as port_cli
from transformertts_torch.audio import Audio, vad
from transformertts_torch.utils.config import TrainingConfigManager

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
N_CLIPS = 10
SR = 22050
MEL_TOL = dict(atol=2e-4, rtol=1e-3)
VOICING_AGREEMENT = 0.99
F0_RTOL = 1e-3
STATS_RTOL = 1e-3


def _make_wavs(wav_dir: Path, meta_path: Path):
    wav_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    texts = ['hello world', 'a test', 'this is speech', 'more data now',
             'the quick fox', 'jumps over', 'sounds good', 'one two three',
             'testing audio', 'final clip']
    from scipy.io import wavfile
    for i in range(N_CLIPS):
        dur = rng.uniform(0.6, 1.2)
        t = np.arange(int(SR * dur)) / SR
        f0 = rng.uniform(120, 220)
        y = 0.4 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
        y += 0.01 * rng.standard_normal(len(t))
        wavfile.write(wav_dir / f'clip{i:02d}.wav', SR,
                      (y * 32767).astype(np.int16))
        lines.append(f'clip{i:02d}|raw|{texts[i]}')
    meta_path.write_text('\n'.join(lines) + '\n', encoding='utf-8')


def _session(tmp: Path, name: str) -> Path:
    """A session YAML of config/training_config.yaml with its paths under
    ``tmp``: the wavs are shared, the data dir is ``name``'s own."""
    with open(ROOT / 'config' / 'training_config.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg['paths'] = {'wav_directory': str(tmp / 'wavs'),
                    'metadata_path': str(tmp / 'metadata.csv'),
                    'log_directory': str(tmp / name / 'logs'),
                    'train_data_directory': str(tmp / name / 'ttsdata')}
    cfg['training_data_settings'].update({'n_test': 2, 'min_mel_len': 1,
                                          'max_mel_len': 2000})
    path = tmp / f'{name}.yaml'
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def _audio_config():
    with open(ROOT / 'config' / 'training_config.yaml') as f:
        return yaml.safe_load(f)['audio_settings']


def _speechlike(seed: int, seconds=2.0):
    """Harmonics with vibrato, separated by silent gaps, over faint noise."""
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    phase = 2 * np.pi * np.cumsum(150 + 8 * np.sin(2 * np.pi * 5 * t)) / SR
    y = sum(0.2 / k * np.sin(k * phase) for k in range(1, 5))
    y = y * ((t % 1.0) < 0.45)
    return (y + 1e-3 * rng.standard_normal(n)).astype(np.float32)


def _pitch_agrees(mine, ref):
    assert mine.shape == ref.shape
    voiced_m, voiced_r = mine > 0, ref > 0
    assert (voiced_m == voiced_r).mean() >= VOICING_AGREEMENT
    both = voiced_m & voiced_r
    np.testing.assert_allclose(mine[both], ref[both], rtol=F0_RTOL)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_vad_and_preprocess_bit_identical(seed):
    from transformertts_tpu.audio import Audio as JAudio
    from transformertts_tpu.audio import vad as jvad
    y = _speechlike(seed, seconds=3.0) * (0.2 + seed)
    for window_ms, width, max_silence in ((30, 8, 12), (20, 4, 2)):
        mine = vad.trim_long_silences(y, SR, window_ms, width, max_silence)
        ref = jvad.trim_long_silences(y, SR, window_ms, width, max_silence)
        assert mine.dtype == ref.dtype and np.array_equal(mine, ref)
    assert len(vad.trim_long_silences(y, SR, 30, 8, 2)) < len(y)
    np.testing.assert_array_equal(vad.trim_silence_top_db(y, 40), jvad.trim_silence_top_db(y, 40))
    config = {**_audio_config(), 'trim_silence': True, 'trim_silence_top_db': 40}
    mine, ref = Audio.from_config(config).preprocess(y), JAudio.from_config(config).preprocess(y)
    assert mine.dtype == ref.dtype and np.array_equal(mine, ref)


def test_featurize_batch_matches_jax(tmp_path):
    import create_training_data as jax_cli
    from transformertts_tpu.audio import Audio as JAudio
    config = _audio_config()
    wavs = [_speechlike(s, seconds=sec)[:n] for s, sec, n in
            ((3, 1.0, 22050), (4, 0.7, 15001), (5, 0.5, 9000))]
    names = ['a', 'b', 'c']
    dirs = {}
    for tag in ('jax', 'port'):
        dirs[tag] = tmp_path / tag / 'mels', tmp_path / tag / 'pitch'
        for d in dirs[tag]:
            d.mkdir(parents=True)
    kept_j, pitch_j = jax_cli.featurize_batch(JAudio.from_config(config), names, wavs,
                                              *dirs['jax'], 40, 2000)
    kept_p, pitch_p = port_cli.featurize_batch(Audio.from_config(config), names, wavs,
                                               *dirs['port'], 40, 2000, 'cpu')
    assert kept_p == kept_j == ['a', 'b']   # c has 36 frames, under the minimum
    for name in kept_p:
        mine = np.load(dirs['port'][0] / f'{name}.npy')
        frames = 1 + len(wavs[names.index(name)]) // 256
        assert mine.dtype == np.float32 and mine.shape == (frames, 80)
        np.testing.assert_allclose(mine, np.load(dirs['jax'][0] / f'{name}.npy'), **MEL_TOL)
        _pitch_agrees(pitch_p[name], pitch_j[name])
        np.testing.assert_array_equal(np.load(dirs['port'][1] / f'{name}.npy'), pitch_p[name])


@pytest.fixture(scope='module')
def both_clis(tmp_path_factory):
    """The stage-1 CLI of each package over the same 10 clips."""
    import create_training_data as jax_cli
    tmp = tmp_path_factory.mktemp('featurize')
    _make_wavs(tmp / 'wavs', tmp / 'metadata.csv')
    jax_cfg, port_cfg = _session(tmp, 'jax'), _session(tmp, 'port')
    jax_cli.main(['--config', str(jax_cfg), '--workers', '1'])
    port_cli.main(['--config', str(port_cfg), '--workers', '1', '--device', 'cpu'])
    return (TrainingConfigManager(jax_cfg, aligner=True),
            TrainingConfigManager(port_cfg, aligner=True))


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob('*') if p.is_file())


def test_cli_writes_the_jax_file_set_and_metadata(both_clis):
    jax_cm, port_cm = both_clis
    assert _files(port_cm.data_dir) == _files(jax_cm.data_dir)
    assert len(list(port_cm.mel_dir.glob('*.npy'))) == N_CLIPS
    for attr in ('phonemized_metadata_path', 'train_metadata_path', 'valid_metadata_path'):
        mine = getattr(port_cm, attr).read_text(encoding='utf-8')
        assert mine == getattr(jax_cm, attr).read_text(encoding='utf-8'), attr
    assert len(port_cm.train_metadata_path.read_text().splitlines()) == N_CLIPS - 2
    assert len(port_cm.valid_metadata_path.read_text().splitlines()) == 2


def test_cli_mels_pitch_and_stats_match_jax(both_clis):
    jax_cm, port_cm = both_clis
    stats = {}
    for tag, cm in (('jax', jax_cm), ('port', port_cm)):
        with open(cm.data_dir / 'pitch_stats.pkl', 'rb') as f:
            stats[tag] = pickle.load(f)
    for key in ('pitch_mean', 'pitch_std'):
        np.testing.assert_allclose(stats['port'][key], stats['jax'][key], rtol=STATS_RTOL)
    voiced = 0
    for path in sorted(port_cm.mel_dir.glob('*.npy')):
        mine, ref = np.load(path), np.load(jax_cm.mel_dir / path.name)
        assert mine.shape == ref.shape and mine.shape[1] == 80
        np.testing.assert_allclose(mine, ref, **MEL_TOL)
        # the files hold normalized pitch; compare F0 in Hz, zeros staying zeros
        hz = {}
        for tag, cm in (('jax', jax_cm), ('port', port_cm)):
            norm = np.load(cm.pitch_dir / path.name)
            assert norm.shape == (mine.shape[0],)
            hz[tag] = np.where(norm != 0, norm * stats[tag]['pitch_std']
                               + stats[tag]['pitch_mean'], 0.0)
        _pitch_agrees(hz['port'], hz['jax'])
        voiced += (hz['port'] > 0).sum()
    assert voiced > 0
