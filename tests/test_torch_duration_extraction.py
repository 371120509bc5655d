"""Parity of the port's duration extraction (stage 3) with the JAX package's, on the CPU.

- ``dist_table`` against JAX's within 1e-5, one map and a batch;
- durations identical to ``get_durations_from_alignment``'s for ``weighted``
  True and False, on both backends ('native' and 'device');
- ``attention_score`` to atol 1e-6 and ``batch_diagonal_mask`` to 1e-7;
- the port's native DP copy (built with g++ here) against
  ``transformertts_tpu.native``;
- the stage-3 CLI: on one synthetic featurized data dir and one JAX Aligner
  checkpoint (``narrow_pv: false``, so both compute the same function), the
  root ``extract_durations.main`` and the port's ``main(--device cpu)`` write
  identical ``durations/*.npy`` and ``char_pitch/*.npy`` within 1e-6.
"""
import pickle
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from transformertts_torch import extract_durations as t_cli
from transformertts_torch import native as t_native
from transformertts_torch.ops import duration_extraction as t_dur
from transformertts_torch.utils import metrics as t_metrics
from transformertts_torch.utils.spectrogram_ops import mel_lengths, phoneme_lengths
from transformertts_tpu import native as j_native
from transformertts_tpu.ops import duration_extraction as j_dur
from transformertts_tpu.utils import metrics as j_metrics

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

torch.set_num_threads(1)

MEL = 80


def attention_batch(b=4, h=3, m_pad=40, n_pad=16, seed=0):
    """(maps (B, H, M, N) softmax rows with a diagonal ridge, mels (B, M+1,
    80) with start and end vectors, tokens (B, N)); lengths differ by row and
    the last row is all padding."""
    rng = np.random.default_rng(seed)
    maps = np.zeros((b, h, m_pad, n_pad), np.float32)
    mels = np.zeros((b, m_pad + 1, MEL), np.float32)
    tokens = np.zeros((b, n_pad), np.int64)
    for i in range(b - 1):
        m, n = m_pad - 6 * i, n_pad - 3 * i
        rows = np.arange(m)[:, None] * n / m - np.arange(n)[None, :]
        logits = -rows ** 2 / 2.0 + rng.standard_normal((h, m, n)) * 1.5
        maps[i, :, :m, :n] = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        mels[i, 0], mels[i, m] = 0.5, -0.5
        mels[i, 1:m] = rng.standard_normal((m - 1, MEL))
        tokens[i, :n] = rng.integers(1, 40, n)
    return maps, mels, tokens


def test_lengths_match():
    _, mels, tokens = attention_batch()
    np.testing.assert_array_equal(mel_lengths(mels), mel_lengths(torch.from_numpy(mels)))
    from transformertts_tpu.utils.spectrogram_ops import mel_lengths as j_ml
    from transformertts_tpu.utils.spectrogram_ops import phoneme_lengths as j_pl
    np.testing.assert_array_equal(mel_lengths(mels), np.asarray(j_ml(jnp.asarray(mels))))
    np.testing.assert_array_equal(phoneme_lengths(torch.from_numpy(tokens)).numpy(),
                                  np.asarray(j_pl(jnp.asarray(tokens))))


def test_dist_table_matches_jax():
    rng = np.random.default_rng(1)
    cost = rng.random((23, 9)).astype(np.float32)
    np.testing.assert_allclose(t_dur.dist_table(torch.from_numpy(cost)).numpy(),
                               np.asarray(j_dur.dist_table(jnp.asarray(cost))),
                               atol=1e-5, rtol=0)
    costs = rng.random((3, 17, 11)).astype(np.float32)
    np.testing.assert_allclose(t_dur.dist_table(torch.from_numpy(costs)).numpy(),
                               np.asarray(j_dur.dist_table_batch(jnp.asarray(costs))),
                               atol=1e-5, rtol=0)
    attn = rng.random((31, 7)).astype(np.float32)
    np.testing.assert_array_equal(t_dur.extract_durations_with_dp(attn),
                                  j_dur.extract_durations_with_dp(attn))


def test_scores_and_diagonal_mask_match_jax():
    maps, mels, tokens = attention_batch(seed=2)
    mel_len = mel_lengths(mels) - 1
    phon_len = phoneme_lengths(tokens) - 1
    t_args = (torch.from_numpy(maps), torch.from_numpy(mel_len), torch.from_numpy(phon_len))
    j_args = (jnp.asarray(maps), jnp.asarray(mel_len), jnp.asarray(phon_len))
    for t, j in zip(t_metrics.attention_score(*t_args), j_metrics.attention_score(*j_args)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        t_metrics.batch_diagonal_mask(maps.shape, *t_args[1:]).numpy(),
        np.asarray(j_metrics.batch_diagonal_mask(maps.shape, *j_args[1:])), atol=1e-7, rtol=0)


@pytest.mark.parametrize('backend', ['native', 'device'])
@pytest.mark.parametrize('weighted', [False, True])
def test_durations_identical_to_jax(weighted, backend):
    maps, mels, tokens = attention_batch(seed=3)
    # the JAX function takes real rows only (its CLI drops the padding rows);
    # the port's also gives an all-padding row empty durations
    ref = j_dur.get_durations_from_alignment(maps[:3], mels[:3], tokens[:3].astype(np.int32),
                                             weighted=weighted, backend=backend)
    out = t_dur.get_durations_from_alignment(torch.from_numpy(maps), mels, tokens,
                                             weighted=weighted, backend=backend)
    assert len(out[0]) == 4 and len(ref[0]) == 3 and out[0][-1].size == 0
    for t, j in zip(out[0], ref[0]):
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, j)
    for t, j in zip(out[1], ref[1]):
        np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    for t, j in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(t[:3], np.asarray(j), atol=1e-6, rtol=0)


def test_native_copy_agrees_with_jax_package():
    assert t_native.available() and j_native.available()
    rng = np.random.default_rng(4)
    costs = rng.random((5, 30, 12)).astype(np.float32)
    ms, ns = np.array([30, 25, 1, 12, 7]), np.array([12, 9, 4, 1, 7])
    np.testing.assert_array_equal(t_native.duration_dp_batch(costs, ms, ns, max_workers=3),
                                  j_native.duration_dp_batch(costs, ms, ns))
    with pytest.raises(ValueError, match='dims'):
        t_native.duration_dp_batch(costs, ms, np.array([12, 9, 4, 1, 13]))


def test_pitch_per_char_matches_jax_cli():
    import extract_durations as j_cli
    rng = np.random.default_rng(5)
    pitch = rng.standard_normal(40).astype(np.float32)
    pitch[rng.random(40) < 0.3] = 0.0
    durations = np.array([3, 0, 10, 7, 20], np.int32)
    np.testing.assert_array_equal(t_cli.pitch_per_char(pitch, durations, 150.0, 120.0),
                                  j_cli.pitch_per_char(pitch, durations, 150.0, 120.0))


# --------------------------------------------------------------------- the CLI

ALIGNER = {'decoder_model_dimension': 32, 'encoder_model_dimension': 32,
           'decoder_num_heads': [2, 1], 'encoder_num_heads': [2],
           'encoder_feed_forward_dimension': 32, 'decoder_feed_forward_dimension': 32,
           'decoder_prenet_dimension': 32, 'encoder_prenet_dimension': 32,
           'reduction_factor_schedule': [[0, 10], [5, 1]], 'narrow_pv': False}


def write_featurized(work: Path, n_clips: int = 7, seed: int = 0) -> Path:
    """A session YAML with a tiny Aligner and a featurized data dir: random
    log-mels of 30-90 frames, voiced and unvoiced normalized pitch, phoneme
    strings and pitch stats, drawn from ``seed``."""
    from transformertts_torch.utils.config import TrainingConfigManager
    with open(Path(__file__).resolve().parent.parent / 'config' / 'training_config.yaml') as f:
        cfg = yaml.safe_load(f)
    cfg['paths'] = {'wav_directory': str(work / 'wavs'),
                    'metadata_path': str(work / 'metadata.csv'),
                    'log_directory': str(work / 'logs'),
                    'train_data_directory': str(work / 'data')}
    cfg['training_data_settings'].update({'bucket_boundaries': [64],
                                          'val_bucket_batch_size': [3, 2]})
    cfg['aligner_settings'].update(ALIGNER)
    path = work / 'session.yaml'
    work.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    cm = TrainingConfigManager(path, aligner=True)
    cm.create_remove_dirs(assume_yes=True)
    rng = np.random.default_rng(seed)
    alphabet = cm.get_model('cpu').text_pipeline.tokenizer.alphabet
    symbols = [s for s in alphabet if s not in ' |?!@/']
    lines = []
    for i in range(n_clips):
        t = int(rng.integers(30, 90))
        np.save(cm.mel_dir / f'clip{i}.npy',
                rng.normal(-4.0, 1.5, (t, MEL)).astype(np.float32))
        pitch = rng.normal(0.0, 1.5, t).astype(np.float32)
        pitch[rng.random(t) < 0.3] = 0.0
        np.save(cm.pitch_dir / f'clip{i}.npy', pitch)
        lines.append(f'clip{i}|' + ''.join(rng.choice(symbols, int(rng.integers(4, 14)))))
    cm.phonemized_metadata_path.write_text('\n'.join(lines) + '\n', encoding='utf-8')
    with open(cm.data_dir / 'pitch_stats.pkl', 'wb') as f:
        pickle.dump({'pitch_mean': 150.0, 'pitch_std': 120.0}, f)
    return path


def test_cli_writes_what_the_jax_cli_writes(tmp_path):
    import extract_durations as j_cli
    from transformertts_tpu.training import checkpointing as j_ckpt
    from transformertts_tpu.training.state import init_state, make_optimizer
    from transformertts_tpu.utils.config import TrainingConfigManager as JConfig
    cfg = write_featurized(tmp_path)
    cm = JConfig(cfg, aligner=True)
    model = cm.get_model()
    model.init_params(jax.random.PRNGKey(3))
    # step 7: the schedule's r is 1 there
    j_ckpt.save_checkpoint(cm.weights_dir, init_state(model.params, make_optimizer([(0, 1e-4)]),
                                                      step=7))
    j_cli.main(['--config', str(cfg)])
    outputs = (cm.duration_dir, cm.pitch_per_char)
    jax_out = {d: {f.name: np.load(f) for f in d.glob('*.npy')} for d in outputs}
    for d in outputs:
        shutil.rmtree(d)
    stats = t_cli.main(['--config', str(cfg), '--device', 'cpu', '--workers', '2'])
    assert stats['clips'] == 7 and stats['backend'] == 'native'
    for d in outputs:
        port = {f.name: np.load(f) for f in d.glob('*.npy')}
        assert sorted(port) == sorted(jax_out[d]) and len(port) == 7
        for name, value in port.items():
            assert value.dtype == jax_out[d][name].dtype
            np.testing.assert_allclose(value, jax_out[d][name], atol=1e-6, rtol=0)
    mels = {f.stem: np.load(f).shape[0] for f in cm.mel_dir.glob('*.npy')}
    for f in cm.duration_dir.glob('*.npy'):
        assert np.load(f).sum() == mels[f.stem]


def test_cli_refuses_an_aligner_at_r_above_1(tmp_path):
    from transformertts_torch.training import checkpointing as t_ckpt
    from transformertts_torch.utils.config import TrainingConfigManager
    cfg = write_featurized(tmp_path, n_clips=2)
    cm = TrainingConfigManager(cfg, aligner=True)
    model = cm.get_model('cpu').init_params(torch.Generator().manual_seed(0))
    from transformertts_torch.training.state import make_optimizer
    t_ckpt.save_checkpoint(cm.weights_dir, model, make_optimizer(model), 2)
    assert cm.load_model(device='cpu').r == 10
    with pytest.raises(ValueError, match='reduction factor must be 1'):
        t_cli.main(['--config', str(cfg), '--device', 'cpu', '--skip_char_pitch'])
