"""ForwardTransformer training in the port against the JAX package, on the
CPU at the tiny config, float32, dropout 0 where parity is held.

Bars: the one-step loss and per-leaf gradients against the JAX
``ForwardTrainer``'s to atol 1e-5 + 1e-4·max|g| (different summation
orders; the port's attention takes the fused kernels' plain versions, the
JAX model its eager attention); parameters after one Adam step on the
same gradients to 1e-6;
losses and the schedule to float32 rounding; checkpoints bit for bit both
ways.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_nn import TINY_CONFIG
from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
from transformertts_torch.models.persistence import params_from_jax, params_to_jax
from transformertts_torch.training import checkpointing as t_ckpt
from transformertts_torch.training.forward_trainer import ForwardTrainer as TTrainer
from transformertts_torch.training.forward_trainer import forward_loss as t_forward_loss
from transformertts_torch.training.state import set_learning_rate
from transformertts_torch.utils import losses as t_losses
from transformertts_torch.utils.scheduling import piecewise_linear_schedule as t_schedule
from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
from transformertts_tpu.parallel import MeshConfig, make_mesh
from transformertts_tpu.training import ForwardTrainer as JTrainer
from transformertts_tpu.training import checkpointing as j_ckpt
from transformertts_tpu.training import make_optimizer
from transformertts_tpu.training.forward_trainer import forward_loss as j_forward_loss
from transformertts_tpu.training.state import init_state
from transformertts_tpu.utils import losses as j_losses
from transformertts_tpu.utils.pytree import flatten_params
from transformertts_tpu.utils.scheduling import piecewise_linear_schedule as j_schedule

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCHEDULE = [(0, 1e-3), (10, 5e-4), (100, 1e-4)]
NO_DROPOUT = dict(dropout_rate=0.0, predictors_dropout=0.0)


def _batch(vocab, b=4, n_tok=16, n_frames=64, seed=0, uniform=False, zero_rows=1):
    """A padded batch like BucketedDataset's: real rows with ragged lengths
    (or, ``uniform``, all alike), then ``zero_rows`` all-zero samples."""
    rng = np.random.default_rng(seed)
    durations = np.zeros((b, n_tok), np.float32)
    tokens = np.zeros((b, n_tok), np.int64)
    pitch = np.zeros((b, n_tok), np.float32)
    mel = np.zeros((b, n_frames, 80), np.float32)
    for i in range(b - zero_rows):
        n = 12 if uniform else int(rng.integers(6, 13))
        durations[i, :n] = 4.0 if uniform else rng.integers(1, 5, n)
        tokens[i, :n] = rng.integers(1, vocab, n)
        pitch[i, :n] = rng.standard_normal(n)
        t = int(durations[i].sum())
        mel[i, :t] = rng.standard_normal((t, 80))
    return {'tokens': tokens, 'mel': mel, 'durations': durations, 'pitch': pitch}


def _models(seed=7, **overrides):
    """JAX and port ForwardTransformers holding the same weights."""
    jm = JFT(**{**TINY_CONFIG, **NO_DROPOUT, **overrides})
    jm.init_params(jax.random.PRNGKey(seed))
    tm = TFT(**{**TINY_CONFIG, **NO_DROPOUT, **overrides})
    tm.load_state_dict(params_from_jax(flatten_params(jm.params)), strict=True)
    return jm, tm


def _jax_trainer(jm):
    mesh = make_mesh(MeshConfig(data=1, model=1), devices=jax.devices('cpu')[:1])
    return JTrainer(jm, make_optimizer(SCHEDULE), mesh=mesh)


def _port_flat(tensors: dict) -> dict:
    """A state dict (or grads keyed alike) in the JAX flat layout."""
    return params_to_jax({k: v.detach() for k, v in tensors.items()})


def _grads_close(mine: dict, ref: dict):
    assert mine.keys() == ref.keys()
    for path in ref:
        g = np.asarray(ref[path])
        np.testing.assert_allclose(mine[path], g, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(g).max(), err_msg=path)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    t3 = rng.standard_normal((3, 7, 5)).astype(np.float32)
    t3[0, 4:] = 0.0                               # padded frames
    p3 = rng.standard_normal((3, 7, 5)).astype(np.float32)
    t2, p2 = t3[..., 0], p3[..., 0]
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    for name in ('masked_mean_absolute_error', 'masked_mean_squared_error'):
        tf, jf = getattr(t_losses, name), getattr(j_losses, name)
        for t, p in ((t3, p3), (t2, p2)):
            np.testing.assert_allclose(tf(torch.from_numpy(t), torch.from_numpy(p)).item(),
                                       float(jf(jnp.asarray(t), jnp.asarray(p))), rtol=1e-6)
            np.testing.assert_allclose(
                tf(torch.from_numpy(t), torch.from_numpy(p), torch.from_numpy(mask)).item(),
                float(jf(jnp.asarray(t), jnp.asarray(p), jnp.asarray(mask))), rtol=1e-6)
    total, parts = t_losses.weighted_sum_losses(
        [torch.from_numpy(t3)] * 2, [torch.from_numpy(p3)] * 2,
        [t_losses.masked_mean_absolute_error, t_losses.masked_mean_squared_error], [1.0, 3.0])
    j_total, j_parts = j_losses.weighted_sum_losses(
        [jnp.asarray(t3)] * 2, [jnp.asarray(p3)] * 2,
        [j_losses.masked_mean_absolute_error, j_losses.masked_mean_squared_error], [1.0, 3.0])
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-6)
    np.testing.assert_allclose([x.item() for x in parts], [float(x) for x in j_parts], rtol=1e-6)


def test_learning_rate_schedule_matches_jax():
    for step in (0, 1, 5, 10, 37, 100, 1000):
        # one float32 rounding apart at most: np.interp and jnp.interp
        # interpolate in different orders
        np.testing.assert_allclose(t_schedule(step, SCHEDULE),
                                   float(j_schedule(step, SCHEDULE)), rtol=2e-7)


@pytest.fixture(scope='module')
def one_step():
    """The JAX and the port's loss, grads and params after one Adam step,
    from the same weights on the same padded batch."""
    jm, tm = _models()
    batch = _batch(jm.text_pipeline.tokenizer.vocab_size)
    jbatch = {k: jnp.asarray(v.astype(np.int32) if k == 'tokens' else v)
              for k, v in batch.items()}
    (j_loss, (j_losses, _)), j_grads = jax.value_and_grad(
        lambda p: j_forward_loss(jm, p, jbatch, jax.random.PRNGKey(0), False),
        has_aux=True)(jm.params)
    tx = make_optimizer(SCHEDULE)
    updates, _ = tx.update(j_grads, tx.init(jm.params), jm.params)
    j_params = optax.apply_updates(jm.params, updates)

    t_trainer = TTrainer(tm, SCHEDULE)
    tb = t_trainer.to_device(batch)
    t_loss, (t_parts, _) = t_forward_loss(tm, tb, True, torch.Generator().manual_seed(0))
    t_grads = dict(zip((n for n, _ in tm.named_parameters()),
                       torch.autograd.grad(t_loss, list(tm.parameters()))))
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    aux = t_trainer.train_step(batch)
    # the port's Adam fed the JAX gradients: a softmax is invariant to a
    # shift of its keys, so wk.bias has a true gradient of 0 and both
    # packages compute rounding noise there, which Adam's first step
    # (≈ lr·sign(g)) would blow up to O(lr); the same gradients through
    # optax's Adam and the port's isolate the update
    tm.load_state_dict(start)
    adam_trainer = TTrainer(tm, SCHEDULE)
    set_learning_rate(adam_trainer.optimizer, SCHEDULE, 0)
    j_grad_state = params_from_jax(flatten_params(j_grads))
    for name, param in tm.named_parameters():
        param.grad.copy_(j_grad_state[name])   # .grad is a view into the flat buffer
    adam_trainer.optimizer.step()
    return dict(j_loss=float(j_loss), j_parts=j_losses, j_grads=flatten_params(j_grads),
                j_params=flatten_params(jax.device_get(j_params)),
                t_loss=t_loss.item(), t_parts=t_parts, t_grads=_port_flat(t_grads),
                t_params=_port_flat(tm.state_dict()), t_aux=aux, t_step=t_trainer.step)


def test_one_step_loss_matches_jax(one_step):
    np.testing.assert_allclose(one_step['t_loss'], one_step['j_loss'], rtol=1e-5)
    for k in ('mel', 'duration', 'pitch'):
        np.testing.assert_allclose(one_step['t_parts'][k].item(),
                                   float(one_step['j_parts'][k]), rtol=1e-5)
    np.testing.assert_allclose(one_step['t_aux']['loss'].item(), one_step['j_loss'], rtol=1e-5)


def test_one_step_grads_match_jax_per_leaf(one_step):
    _grads_close(one_step['t_grads'], one_step['j_grads'])


def test_params_after_one_adam_step_match_jax(one_step):
    assert one_step['t_step'] == 1
    for path, ref in one_step['j_params'].items():
        np.testing.assert_allclose(one_step['t_params'][path], ref, rtol=0, atol=1e-6,
                                   err_msg=path)


def test_grad_accumulation_equals_single_batch():
    _, tm = _models(seed=3)
    batch = _batch(tm.text_pipeline.tokenizer.vocab_size, b=8, seed=3, uniform=True,
                   zero_rows=0)
    start = {k: v.clone() for k, v in tm.state_dict().items()}

    def run(n):
        tm.load_state_dict(start)
        trainer = TTrainer(tm, SCHEDULE, grad_accumulation=n)
        aux = trainer.train_step(batch)
        return aux, {name: p.grad.clone() for name, p in tm.named_parameters()}

    aux1, g1 = run(1)
    aux2, g2 = run(2)
    np.testing.assert_allclose(aux1['loss'].item(), aux2['loss'].item(), rtol=1e-5)
    assert aux2['duration_pred'].shape == aux1['duration_pred'].shape == (8, 16)
    scale = max(g.abs().max().item() for g in g1.values())
    for name in g1:
        assert (g1[name] - g2[name]).abs().max().item() < 1e-4 * scale, name
    with pytest.raises(ValueError, match='divisible'):
        TTrainer(tm, SCHEDULE, grad_accumulation=3).train_step(batch)


def test_jax_checkpoint_resumes_in_port_and_back(tmp_path):
    jm, tm = _models(seed=5)
    vocab = jm.text_pipeline.tokenizer.vocab_size
    trainer = _jax_trainer(jm)
    state, _ = trainer.train_step(init_state(jm.params, trainer.tx), _batch(vocab, seed=1))
    j_path = j_ckpt.save_checkpoint(tmp_path / 'jax', state)

    # JAX → port: every leaf lands bit for bit
    _, fresh = _models(seed=9)
    t_trainer = TTrainer(fresh, SCHEDULE)
    assert t_ckpt.restore_latest(tmp_path / 'jax', fresh, t_trainer.optimizer) == 1
    with np.load(j_path) as data:
        j_leaves = {k: data[k] for k in data.files}
    port_leaves = t_ckpt.flatten_state(fresh, t_trainer.optimizer, 1)
    assert port_leaves.keys() == j_leaves.keys()
    for key in j_leaves:
        np.testing.assert_array_equal(port_leaves[key], j_leaves[key], err_msg=key)
        assert port_leaves[key].dtype == j_leaves[key].dtype, key

    # port → JAX: the port trains a step on, saves, and JAX restores it
    t_trainer.step = 1
    t_trainer.train_step(_batch(vocab, seed=2))
    t_path = t_ckpt.save_checkpoint(tmp_path / 'port', fresh, t_trainer.optimizer, 2)
    restored = j_ckpt.restore_checkpoint(t_path, init_state(jm.params, trainer.tx))
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    np.testing.assert_array_equal(flatten_params(jax.device_get(restored.params))[
        'encoder/conv_0/sarn/mha/wq/kernel'], fresh.encoder.conv_0.sarn.mha.wq.weight.detach().T)
    state2, aux = trainer.train_step(restored, _batch(vocab, seed=3))
    assert int(state2.step) == 3 and np.isfinite(float(aux['loss']))


def test_checkpoints_keep_n_and_ignore_torn_writes(tmp_path):
    _, tm = _models(seed=4)
    opt = TTrainer(tm, SCHEDULE).optimizer
    for step in (1, 2, 3):
        t_ckpt.save_checkpoint(tmp_path, tm, opt, step, keep_n=2)
    (tmp_path / '.tmp_ckpt_9.npz').write_bytes(b'torn')
    assert [s for s, _ in t_ckpt.list_checkpoints(tmp_path)] == [2, 3]
    assert t_ckpt.latest_checkpoint(tmp_path).name == 'ckpt_3.npz'


def _tiny_session(work, **schedule):
    """A session of the published config at the tiny widths, float32, over
    10 synthetic samples of 40-80 frames: (session yaml, config manager)."""
    import chip_smoke
    from transformertts_torch.utils.config import TrainingConfigManager
    cfg = chip_smoke.write_session(
        work,
        tts_overrides={**{k: TINY_CONFIG[k] for k in (
            'encoder_model_dimension', 'decoder_model_dimension', 'encoder_num_heads',
            'decoder_num_heads', 'encoder_attention_conv_filters',
            'decoder_attention_conv_filters', 'duration_conv_filters',
            'pitch_conv_filters')}, 'compute_dtype': 'float32', **schedule},
        data_overrides={'bucket_boundaries': [60, 90], 'bucket_batch_sizes': [4, 4, 2],
                        'val_bucket_batch_size': [4, 4, 2]})
    cm = TrainingConfigManager(cfg)
    chip_smoke.write_synthetic_data(cm, n_train=8, n_valid=2, frames=(40, 80))
    return cfg, cm


def test_train_tts_cli_three_steps_writes_what_jax_loads(tmp_path):
    cfg, cm = _tiny_session(tmp_path, max_steps=3, validation_frequency=3,
                            checkpoint_frequency=2, weights_save_frequency=3,
                            weights_save_starting_step=0, prediction_start_step=100)
    proc = subprocess.run(
        [sys.executable, '-m', 'transformertts_torch.train_tts', '--config', str(cfg),
         '--yes', '--device', 'cpu'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'done' in proc.stdout
    assert [s for s, _ in t_ckpt.list_checkpoints(cm.weights_dir)] == [2, 3]
    model_dir = cm.base_dir / 'model_step_3'
    jm = JFT.load_model(model_dir)
    assert jm.config['step'] == 3
    tm = TFT.load_model(model_dir, device='cpu')
    for path, value in flatten_params(jm.params).items():
        np.testing.assert_array_equal(_port_flat(tm.state_dict())[path], value)
    # the JAX package restores the port's checkpoint against its own template
    restored = j_ckpt.restore_checkpoint(
        cm.weights_dir / 'ckpt_3.npz', init_state(jm.params, make_optimizer(SCHEDULE)))
    assert int(restored.step) == 3
    assert np.isfinite(jm.predict('ab')['mel']).all()


def _summary_values(log_dir):
    """(tag, summary value) of every event file under ``log_dir``."""
    import struct
    from tensorboard.compat.proto.event_pb2 import Event
    values = []
    for path in sorted(log_dir.rglob('events.out.tfevents.*')):
        blob, off = path.read_bytes(), 0
        while off < len(blob):
            (length,) = struct.unpack('<Q', blob[off:off + 8])
            event = Event.FromString(blob[off + 12:off + 12 + length])
            values += [(v.tag, v) for v in event.summary.value]
            off += 16 + length
    return values


def test_train_tts_logs_validation_and_test_sentence_audio(tmp_path, monkeypatch):
    """The training CLI logs Griffin-Lim wavs of a validation target, its
    prediction and each test sentence, as the JAX CLI does."""
    from transformertts_torch import train_tts
    cfg, cm = _tiny_session(tmp_path, max_steps=2, validation_frequency=2,
                            checkpoint_frequency=2, weights_save_frequency=100,
                            prediction_frequency=2, prediction_start_step=0)
    monkeypatch.chdir(ROOT)   # the test sentences are config/test_sentences.txt
    validation = train_tts.main(['--config', str(cfg), '--yes', '--device', 'cpu'])
    assert list(validation) == [2] and np.isfinite(validation[2])
    audio = {tag: v.audio for tag, v in _summary_values(cm.log_dir) if v.HasField('audio')}
    sentences = [i for i, line in enumerate(
        (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()) if line.strip()]
    assert sorted(audio) == sorted(['Validation/target_wav', 'Validation/pred_wav']
                                   + [f'TestSentences/{i}_wav' for i in sentences])
    for clip in audio.values():
        assert clip.sample_rate == 22050 and clip.length_frames > 0
        assert clip.encoded_audio_string[:4] == b'RIFF'


def test_loss_falls_over_30_steps_with_dropout():
    torch.manual_seed(0)
    tm = TFT(**TINY_CONFIG).init_params(torch.Generator().manual_seed(1))
    assert tm.config['dropout_rate'] == 0.1
    trainer = TTrainer(tm, [(0, 1e-3)])
    batch = _batch(tm.text_pipeline.tokenizer.vocab_size, seed=6)
    losses = [trainer.train_step(batch)['loss'].item() for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_training_dropout_is_reproducible_per_step():
    _, tm = _models(seed=2, dropout_rate=0.1, predictors_dropout=0.1)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    batch = _batch(tm.text_pipeline.tokenizer.vocab_size, seed=4)

    def run():
        tm.load_state_dict(start)
        return TTrainer(tm, SCHEDULE).train_step(batch)['loss'].item()

    first = run()
    assert run() == first
    tm.load_state_dict(start)
    trainer = TTrainer(tm, SCHEDULE)
    trainer.step = 1                       # another step: another mask
    assert trainer.train_step(batch)['loss'].item() != first


def test_profile_train_batch_and_kernel_kinds():
    from transformertts_torch.profile_train import kind_of, synthetic_batch
    tm = TFT(**TINY_CONFIG)
    batch = synthetic_batch(tm, b=3, n_tok=16, n_frames=64, seed=1)
    assert batch['tokens'].shape == (3, 16) and (batch['tokens'] > 0).all()
    assert (batch['durations'].sum(axis=1) == 64).all()
    assert batch['durations'].min() >= 2 and batch['durations'].max() <= 6
    assert batch['mel'].shape == (3, 64, 80) and np.isfinite(batch['mel']).all()
    assert kind_of('void (anonymous namespace)::attn_dkv_mma_kernel<192>(...)') == 'K4 attn dK/dV'
    assert kind_of('void (anonymous namespace)::attn_fwd_mma_kernel<192, true>') == \
        'K2 attn forward'
    assert kind_of('cudnn::engines_precompiled::nchwToNhwcKernel<...>') == 'layout transposes'
    assert kind_of('at::native::vectorized_elementwise_kernel<4, add>') == \
        'elementwise and other'
