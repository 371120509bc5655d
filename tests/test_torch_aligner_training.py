"""Aligner training in the port against the JAX package, on the CPU at a
tiny config (d 32, encoder heads [2], decoder heads [2, 1]: the last block
has one head of d, as the published Aligner's), float32.

Bars: the stop-token losses to rtol 1e-6; the one-step loss and its parts
against the JAX ``AlignerTrainer(narrow_pv=False)`` at dropout 0 to rtol
1e-5, for r 1 and 3, with diagonal forcing off (the port's attentions then
take the fused kernels' plain versions, whose backward is the kernels'
formulas) and on (every attention eager); per-leaf gradients to atol
1e-5 + 1e-4·max|g| and parameters after one Adam step on the same gradients
to 1e-6, as ``test_torch_training.py`` holds the ForwardTransformer.
Dropout streams differ between the packages, so with dropout on the checks
are on losses and convergence.
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

from test_torch_aligner import MEL, TINY_ALIGNER
from test_torch_training import _grads_close, _port_flat, _summary_values
from transformertts_torch.models.aligner import Aligner as TAligner
from transformertts_torch.models.persistence import params_from_jax
from transformertts_torch.training import checkpointing as t_ckpt
from transformertts_torch.training.aligner_trainer import AlignerTrainer as TTrainer
from transformertts_torch.training.aligner_trainer import aligner_loss as t_aligner_loss
from transformertts_torch.training.state import set_learning_rate
from transformertts_torch.utils import losses as t_losses
from transformertts_tpu.models.aligner import Aligner as JAligner
from transformertts_tpu.parallel import MeshConfig, make_mesh
from transformertts_tpu.training import AlignerTrainer as JTrainer
from transformertts_tpu.training import checkpointing as j_ckpt
from transformertts_tpu.training import make_optimizer
from transformertts_tpu.training.aligner_trainer import aligner_loss as j_aligner_loss
from transformertts_tpu.training.state import init_state
from transformertts_tpu.utils import losses as j_losses
from transformertts_tpu.utils.pytree import flatten_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCHEDULE = [(0, 1e-3), (10, 5e-4), (100, 1e-4)]
LAST = 'Decoder_LastBlock_CrossAttention'
HEADS = dict(encoder_num_heads=[2], decoder_num_heads=[2, 1])
NO_DROPOUT = dict(dropout_rate=0.0, decoder_prenet_dropout=0.0)


def _models(seed=7, **overrides):
    """JAX and port Aligners (heads [2] / [2, 1]) holding the same weights."""
    jm = JAligner(**{**TINY_ALIGNER, **HEADS, **NO_DROPOUT, **overrides})
    jm.init_params(jax.random.PRNGKey(seed))
    tm = TAligner(**jm.config)
    tm.load_state_dict(params_from_jax(flatten_params(jm.params)), strict=True)
    return jm, tm


def _batch(vocab, b=4, n_tok=16, n_frames=48, seed=0, uniform=False, zero_rows=1):
    """An Aligner batch as BucketedDataset collates it: tokens; mels with the
    start (0.5) and end (-0.5) frames; stop classes 1 … 1, 2 at the end
    frame, 0 on padding. Real rows' lengths differ (or, ``uniform``, agree);
    then ``zero_rows`` all-zero samples."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, n_tok), np.int64)
    mel = np.zeros((b, n_frames, MEL), np.float32)
    stop = np.zeros((b, n_frames), np.int64)
    for i in range(b - zero_rows):
        n = n_tok - 2 if uniform else int(rng.integers(6, n_tok + 1))
        t = n_frames - 4 if uniform else int(rng.integers(n_frames // 2, n_frames - 1))
        tokens[i, :n] = rng.integers(1, vocab, n)
        mel[i, 0] = 0.5
        mel[i, 1:t - 1] = rng.standard_normal((t - 2, MEL))
        mel[i, t - 1] = -0.5
        stop[i, :t] = 1
        stop[i, t - 1] = 2
    return {'tokens': tokens, 'mel': mel, 'stop_probs': stop}


def _np32(batch):
    """The batch with integer fields as int32, as the JAX package takes it."""
    return {k: v.astype(np.int32) if v.dtype.kind in 'iu' else v for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in _np32(batch).items()}


def _jax_trainer(jm, data=1):
    mesh = make_mesh(MeshConfig(data=data, model=1), devices=jax.devices('cpu')[:data])
    return JTrainer(jm, make_optimizer(SCHEDULE), mesh=mesh, narrow_pv=False)


def test_stop_losses_match_jax():
    rng = np.random.default_rng(0)
    targets = rng.integers(0, 3, (3, 11))
    targets[0, 7:] = 0                      # padding
    logits = rng.standard_normal((3, 11, 3)).astype(np.float32) * 3
    tt, tl = torch.from_numpy(targets), torch.from_numpy(logits)
    jt, jl = jnp.asarray(targets.astype(np.int32)), jnp.asarray(logits)
    np.testing.assert_allclose(t_losses.masked_crossentropy(tt, tl).item(),
                               float(j_losses.masked_crossentropy(jt, jl)), rtol=1e-6)
    for index, scaling in ((2, 8.0), (1, 0.5), (2, 1.0)):
        np.testing.assert_allclose(
            t_losses.new_scaled_crossentropy(index, scaling)(tt, tl).item(),
            float(j_losses.new_scaled_crossentropy(index, scaling)(jt, jl)), rtol=1e-6)
    # all padding: the count is clamped at 1, the loss is 0
    zero = torch.zeros(2, 5, dtype=torch.long)
    assert t_losses.new_scaled_crossentropy(2, 8.0)(zero, tl[:2, :5]).item() == 0.0


def _one_step(r, forcing):
    """The JAX and the port's losses, grads and params after one Adam step,
    from the same weights on the same padded batch."""
    jm, tm = _models()
    batch = _batch(jm.text_pipeline.tokenizer.vocab_size)
    trainer = _jax_trainer(jm)
    with trainer._attention_scope():
        (j_loss, (j_parts, _)), j_grads = jax.value_and_grad(
            lambda p: j_aligner_loss(jm, p, _jax_batch(batch), r, trainer.stop_loss,
                                     forcing, forcing, jax.random.PRNGKey(0), False),
            has_aux=True)(jm.params)
    updates, _ = trainer.tx.update(j_grads, trainer.tx.init(jm.params), jm.params)
    j_params = optax.apply_updates(jm.params, updates)

    t_trainer = TTrainer(tm, SCHEDULE)
    tb = t_trainer.to_device(batch)
    t_loss, (t_parts, _) = t_aligner_loss(tm, tb, r, t_trainer.stop_loss, forcing, forcing,
                                          True, torch.Generator().manual_seed(0))
    t_grads = dict(zip((n for n, _ in tm.named_parameters()),
                       torch.autograd.grad(t_loss, list(tm.parameters()))))
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    aux = t_trainer.train_step(batch, r=r, force_encoder_diagonal=forcing,
                               force_decoder_diagonal=forcing)
    # the port's Adam fed the JAX gradients, as test_torch_training does: the
    # wk biases' true gradient is 0 and both packages return rounding noise
    # there, which Adam's first step would blow up to O(lr)
    tm.load_state_dict(start)
    adam = TTrainer(tm, SCHEDULE).optimizer
    set_learning_rate(adam, SCHEDULE, 0)
    j_grad_state = params_from_jax(flatten_params(j_grads))
    for name, param in tm.named_parameters():
        param.grad = j_grad_state[name].clone()
    adam.step()
    return dict(j_loss=float(j_loss), j_parts=j_parts, j_grads=flatten_params(j_grads),
                j_params=flatten_params(jax.device_get(j_params)),
                t_loss=t_loss.item(), t_parts=t_parts, t_grads=_port_flat(t_grads),
                t_params=_port_flat(tm.state_dict()), t_aux=aux, t_step=t_trainer.step)


@pytest.fixture(scope='module', params=[(1, False), (3, False), (1, True), (3, True)],
                ids=['r1', 'r3', 'r1-forced', 'r3-forced'])
def one_step(request):
    return _one_step(*request.param) | {'forced': request.param[1]}


def test_one_step_loss_matches_jax(one_step):
    np.testing.assert_allclose(one_step['t_loss'], one_step['j_loss'], rtol=1e-5)
    for k in ('mel', 'stop_prob', 'diag_loss'):
        np.testing.assert_allclose(one_step['t_parts'][k].item(),
                                   float(one_step['j_parts'][k]), rtol=1e-5, atol=0)
    assert (one_step['t_parts']['diag_loss'].item() > 0) == one_step['forced']
    np.testing.assert_allclose(one_step['t_aux']['loss'].item(), one_step['j_loss'],
                               rtol=1e-5)


def test_one_step_grads_match_jax_per_leaf(one_step):
    _grads_close(one_step['t_grads'], one_step['j_grads'])


def test_params_after_one_adam_step_match_jax(one_step):
    assert one_step['t_step'] == 1
    for path, ref in one_step['j_params'].items():
        np.testing.assert_allclose(one_step['t_params'][path], ref, rtol=0, atol=1e-6,
                                   err_msg=path)


def test_grad_accumulation_equals_single_batch_with_attention_aux():
    _, tm = _models(seed=3)
    batch = _batch(tm.text_pipeline.tokenizer.vocab_size, b=6, seed=3, uniform=True,
                   zero_rows=0)
    start = {k: v.clone() for k, v in tm.state_dict().items()}

    def run(n):
        tm.load_state_dict(start)
        trainer = TTrainer(tm, SCHEDULE, grad_accumulation=n)
        aux = trainer.train_step(batch, r=1, return_attention=True)
        return aux, {name: p.grad.clone() for name, p in tm.named_parameters()}

    aux1, g1 = run(1)
    aux2, g2 = run(2)
    np.testing.assert_allclose(aux1['loss'].item(), aux2['loss'].item(), rtol=1e-5)
    scale = max(g.abs().max().item() for g in g1.values())
    for name in g1:
        assert (g1[name] - g2[name]).abs().max().item() < 1e-4 * scale, name
    # the maps of the two micro-batches, concatenated along the batch
    for group in ('decoder_attention', 'encoder_attention'):
        assert aux2[group].keys() == aux1[group].keys()
        for key, ref in aux1[group].items():
            assert aux2[group][key].shape == ref.shape and ref.shape[0] == 6, key
            torch.testing.assert_close(aux2[group][key], ref, atol=1e-6, rtol=0)
    assert aux2['text_mask'].shape == aux1['text_mask'].shape == (6, 1, 1, 16)
    assert aux2['mel_mask'].shape == aux1['mel_mask'].shape == (6, 1, 1, 47)
    # without return_attention no map is kept
    tm.load_state_dict(start)
    assert 'decoder_attention' not in TTrainer(tm, SCHEDULE, grad_accumulation=2).train_step(
        batch, r=1, force_decoder_diagonal=True)
    with pytest.raises(ValueError, match='divisible'):
        TTrainer(tm, SCHEDULE, grad_accumulation=4).train_step(batch)


def test_val_step_returns_maps_and_predictions():
    jm, tm = _models(seed=6)
    batch = _batch(jm.text_pipeline.tokenizer.vocab_size, seed=6)
    aux = TTrainer(tm, SCHEDULE).val_step(batch, r=1)
    assert set(aux['decoder_attention']) == {'Decoder_DenseBlock1_CrossAttention', LAST}
    assert set(aux['encoder_attention']) == {'Encoder_DenseBlock1_SelfAttention'}
    assert aux['decoder_attention'][LAST].shape == (4, 1, 47, 16)
    assert aux['mel_pred'].shape == (4, 47, MEL)   # the decoder's r-frames of tar_inp
    j_trainer = _jax_trainer(jm)
    j_aux = j_trainer.val_step(j_trainer.init_state(params=jm.params), _np32(batch), r=1)
    np.testing.assert_allclose(aux['loss'].item(), float(j_aux['loss']), rtol=1e-5)
    np.testing.assert_allclose(aux['decoder_attention'][LAST].numpy(),
                               np.asarray(j_aux['decoder_attention'][LAST])[:4], atol=1e-6)


def _tiny_session(work, **schedule):
    """A session of the published config with the tiny Aligner, float32,
    over 10 synthetic samples of 40-80 frames: (session yaml, config
    manager)."""
    import chip_smoke
    from transformertts_torch.utils.config import TrainingConfigManager
    tiny = {k: v for k, v in TINY_ALIGNER.items()
            if k.endswith(('dimension', 'position_encoding'))}
    cfg = chip_smoke.write_session(
        work, aligner_overrides={**tiny, **HEADS, **schedule},
        data_overrides={'bucket_boundaries': [60, 90], 'bucket_batch_sizes': [4, 4, 2],
                        'val_bucket_batch_size': [4, 4, 2]})
    cm = TrainingConfigManager(cfg, aligner=True)
    chip_smoke.write_synthetic_data(cm, n_train=8, n_valid=2, frames=(40, 80))
    return cfg, cm


def test_get_trainer_returns_the_model_kinds_trainer(tmp_path):
    from transformertts_torch.training.forward_trainer import ForwardTrainer
    from transformertts_torch.utils.config import TrainingConfigManager
    cfg, cm = _tiny_session(tmp_path, grad_accumulation=2)
    trainer = cm.get_trainer(cm.get_model('cpu'))
    assert type(trainer) is TTrainer and trainer.grad_accumulation == 2
    tm = cm.get_model('cpu')
    targets = torch.tensor([[1, 1, 2, 0]])
    logits = torch.randn(1, 4, 3)
    np.testing.assert_allclose(
        cm.get_trainer(tm).stop_loss(targets, logits).item(),
        t_losses.new_scaled_crossentropy(2, 8.0)(targets, logits).item(), rtol=1e-7)
    tts = TrainingConfigManager(cfg)
    assert type(tts.get_trainer(tts.get_model('cpu'))) is ForwardTrainer


def test_jax_checkpoint_resumes_in_port_and_back(tmp_path):
    jm, _ = _models(seed=5)
    vocab = jm.text_pipeline.tokenizer.vocab_size
    trainer = _jax_trainer(jm)
    state, _ = trainer.train_step(init_state(jm.params, trainer.tx),
                                  _np32(_batch(vocab, seed=1)), r=1)
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
    t_trainer.train_step(_batch(vocab, seed=2), r=3, force_decoder_diagonal=True)
    t_path = t_ckpt.save_checkpoint(tmp_path / 'port', fresh, t_trainer.optimizer, 2)
    restored = j_ckpt.restore_checkpoint(t_path, init_state(jm.params, trainer.tx))
    assert int(restored.step) == 2 and int(restored.opt_state[0].count) == 2
    np.testing.assert_array_equal(
        flatten_params(jax.device_get(restored.params))['decoder/block_1/carn/mha/wq/kernel'],
        fresh.decoder.block_1.carn.mha.wq.weight.detach().T)
    state2, aux = trainer.train_step(restored, _np32(_batch(vocab, seed=3)), r=1)
    assert int(state2.step) == 3 and np.isfinite(float(aux['loss']))


def test_train_aligner_cli_three_steps_writes_what_jax_loads(tmp_path):
    from transformertts_tpu.utils.config import TrainingConfigManager as JConfig
    cfg, cm = _tiny_session(
        tmp_path, max_steps=3, reduction_factor_schedule=[[0, 3], [2, 1]],
        force_encoder_diagonal_steps=1, force_decoder_diagonal_steps=2,
        validation_frequency=3, checkpoint_frequency=2, weights_save_frequency=2,
        train_images_plotting_frequency=3, prediction_start_step=100)
    proc = subprocess.run(
        [sys.executable, '-m', 'transformertts_torch.train_aligner', '--config', str(cfg),
         '--yes', '--device', 'cpu'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'done' in proc.stdout and 'ignored exception' not in proc.stdout, proc.stdout[-3000:]
    assert [s for s, _ in t_ckpt.list_checkpoints(cm.weights_dir)] == [2, 3]
    tags = {tag: v for tag, v in _summary_values(cm.log_dir)}
    assert np.isfinite(tags['Validation/loss'].simple_value)
    assert tags['Meta/reduction_factor'].simple_value == 1.0
    assert f'AttentionDiagonality/{LAST}' in tags
    assert any(tag.startswith('ValidationSnippets/') for tag in tags)
    # the JAX package restores the port's checkpoint against its own template
    jcm = JConfig(cfg, aligner=True)
    jm = jcm.get_model()
    jm.init_params(jax.random.PRNGKey(0))
    restored = j_ckpt.restore_checkpoint(
        cm.weights_dir / 'ckpt_3.npz', init_state(jm.params, make_optimizer(SCHEDULE)))
    assert int(restored.step) == 3 and int(restored.opt_state[0].count) == 3


def test_loss_falls_over_30_steps_with_dropout():
    tm = TAligner(**{**TINY_ALIGNER, **HEADS}).init_params(torch.Generator().manual_seed(1))
    assert tm.config['dropout_rate'] == 0.1 and tm.config['decoder_prenet_dropout'] == 0.1
    trainer = TTrainer(tm, [(0, 1e-3)])
    batch = _batch(tm.text_pipeline.tokenizer.vocab_size, seed=6)
    losses = [trainer.train_step(batch, r=1)['loss'].item() for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_training_dropout_is_reproducible_per_step():
    _, tm = _models(seed=2, dropout_rate=0.1, decoder_prenet_dropout=0.1)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    batch = _batch(tm.text_pipeline.tokenizer.vocab_size, seed=4)

    def run(step=0):
        tm.load_state_dict(start)
        trainer = TTrainer(tm, SCHEDULE)
        trainer.step = step
        return trainer.train_step(batch, r=1)['loss'].item()

    first = run()
    assert run() == first
    assert run(step=1) != first           # another step: another mask


def test_chip_smoke_language_is_the_convergence_checks():
    """chip_smoke's numpy copy of the synthetic language draws the same
    samples as ``convergence_check.make_language`` from the same seed."""
    import chip_smoke
    from convergence_check import make_language
    ours = chip_smoke.make_language(np.random.default_rng(1), n_samples=5)
    theirs = make_language(np.random.default_rng(1), n_samples=5)
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype


@pytest.mark.slow
def test_synthetic_language_convergence():
    """The port's counterpart of ``convergence_check.aligner_convergence``
    (chip_smoke runs the same on the card): an Aligner at d 48 trained 2,500
    steps on a token → mel language whose durations are known must extract
    durations within 1.5 frames of them."""
    import chip_smoke
    result = chip_smoke.synthetic_language_convergence('cpu')
    assert result['duration_mae'] < 1.5, result
