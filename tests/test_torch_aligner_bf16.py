"""The port's Aligner at ``compute_dtype: bfloat16`` against the JAX package's,
on the CPU at tiny configs (d 32), the same weights on both sides. The port
runs its kernels' plain versions here (a CPU tensor); the JAX package runs
its own jnp attention, as its tests run it.

Bars, each beside what this file measured (about 3x the measurement, or
tighter where that would exceed the port's stated bf16 bar):

- ``Aligner.apply`` at r 1, 2 and 10, kernel and eager routes: mel, linear
  and stop logits to atol 5e-2 (measured up to 2.7e-2 against values up
  to 1.9), attention maps to atol 2e-2 (measured up to 9.2e-3); the maps
  float32 and their rows over real frames summing to 1 within 1e-5;
- one training step at dropout 0 against the JAX ``AlignerTrainer``
  (``narrow_pv=False``) at r 1 and 3, diagonal forcing off and on: the loss
  and its parts to rtol 2e-3 (measured up to 5.5e-4); per-leaf gradients
  to a relative L2 error of 5e-2 (measured up to 3.8e-2), except two kinds
  of leaf whose bf16 gradient no bf16 computation fixes to 5e-2: the key
  biases, whose true gradient is 0 (softmax ignores a shift along the
  keys), at most 3e-4 of the largest gradient in both packages (measured
  1.1e-4), and the two positional-encoding scalars, one number summed from
  B·T·d bf16 products that cancel (JAX's own bf16 gradient is up to 14 %
  from its float32 one; here each is 1.8e-2 to 4.1e-2 of the largest
  gradient): of JAX's sign, within 1e-2 of the largest gradient (measured
  3.2e-3) and within 0.5 of its own size (measured 0.17), so a zeroed or
  flipped gradient fails; every parameter and the optimizer's flat
  buffers float32 after the step, every ``.grad`` a view of the flat
  gradient buffer;
- ``val_step`` against JAX's: the loss to rtol 2e-3 (measured 2.9e-4),
  the predicted mel to atol 5e-2 (1.5e-2), the maps as for ``apply``
  (4.7e-3);
- gradient accumulation over 2 micro-batches against one batch, both in
  the port at bf16: the loss to rtol 2e-3 (measured equal), per-leaf
  gradients to a relative L2 error of 1e-2 (measured 2.6e-3; the key
  biases and scalars as above), the concatenated maps to atol 2e-2
  (measured equal);
- ``align`` + ``get_durations_from_alignment``: at least 0.9 of the token
  durations equal to JAX's (measured 1.0), the last map to atol 2e-2;
- ``predict`` (decoder heads [2, 1], r 1, 13 steps): the same step count as
  JAX, bf16 K/V caches, and every decoded frame within 5e-2 of what JAX's
  teacher-forced decoder makes of the port's decode (measured 1.5e-2). The
  two free-running decodes part by more (up to 9.1e-2 at the 12th step):
  each step feeds its bf16 rounding back, and JAX's own bf16 decode is
  1.2e-1 from the float32 one there, so only the first four steps, before
  the feedback compounds, are held to 5e-2 (measured 3.0e-2);
- ``train_aligner`` at bf16, 3 steps: the JAX package restores its
  checkpoint, whose leaves are float32;
- ``extract_durations`` at bf16, both CLIs on one checkpoint: durations
  summing to each clip's frames, at least 0.9 of them equal (measured 1.0);
- chip_smoke's numpy copy of the ForwardTransformer's synthetic language
  draws the samples of ``convergence_check.make_language`` (seed 0).

``slow``: the synthetic language at bf16 (duration MAE < 1.5 frames) and
the port of ``convergence_check.forward_convergence`` (mean mel loss of the
last 20 of 700 steps below 0.25 of the first 20's).
"""
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aligner import LAST, jax_and_port_aligners, ragged_batch
from test_torch_aligner_training import (SCHEDULE, _batch, _jax_batch, _jax_trainer, _models,
                                         _np32, _tiny_session)
from test_torch_training import _port_flat
from transformertts_torch.nn import attention as t_attention
from transformertts_torch.ops.duration_extraction import (
    get_durations_from_alignment as t_durations)
from transformertts_torch.training import checkpointing as t_ckpt
from transformertts_torch.training.aligner_trainer import AlignerTrainer as TTrainer
from transformertts_torch.training.aligner_trainer import aligner_loss as t_aligner_loss
from transformertts_tpu.ops.duration_extraction import (
    get_durations_from_alignment as j_durations)
from transformertts_tpu.training import checkpointing as j_ckpt
from transformertts_tpu.training import make_optimizer
from transformertts_tpu.training.aligner_trainer import aligner_loss as j_aligner_loss
from transformertts_tpu.training.state import init_state
from transformertts_tpu.utils.pytree import flatten_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BF16 = dict(compute_dtype='bfloat16')
OUT_ATOL = 5e-2
MAP_ATOL = 2e-2
ROW_SUM_ATOL = 1e-5
LOSS_RTOL = 2e-3
GRAD_REL_L2 = 5e-2
ACCUMULATION_REL_L2 = 1e-2
ZERO_GRAD_SHARE = 3e-4      # the key biases, of the largest gradient
SCALAR_GRAD_SHARE = 1e-2    # the positional-encoding scalars, likewise
SCALAR_GRAD_REL = 0.5       # and of their own size
SAME_DURATIONS = 0.9
PREDICT_FREE_STEPS = 4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_maps(maps: dict, row_mask: np.ndarray, ref: dict = None):
    """Every map float32, its rows over real query positions (``row_mask``
    (B, T), 1 = real) summing to 1, and, given ``ref``, near its maps."""
    for key, w in maps.items():
        assert w.dtype == torch.float32, key
        sums = _np(w).sum(-1)
        real = np.broadcast_to(row_mask[:, None, :], sums.shape) > 0
        np.testing.assert_allclose(sums[real], 1.0, atol=ROW_SUM_ATOL, rtol=0, err_msg=key)
        if ref is not None:
            np.testing.assert_allclose(_np(w), np.asarray(ref[key]), atol=MAP_ATOL, rtol=0,
                                       err_msg=key)


@pytest.fixture(scope='module')
def aligners16():
    return jax_and_port_aligners(**BF16)


@pytest.mark.parametrize('r', [1, 2, 10])
def test_bf16_apply_matches_jax_on_both_routes(aligners16, r):
    jm, tm = aligners16
    tokens, mel = ragged_batch(tm.text_pipeline.tokenizer.vocab_size)
    strided = np.ascontiguousarray(mel[:, :-1][:, ::r])
    ref = jax.jit(lambda p, t, m: jm.apply(p, t, m, r))(
        jm.params, jnp.asarray(tokens.astype(np.int32)), jnp.asarray(strided))
    with torch.no_grad():
        for need_weights in (False, True):
            out = tm.apply(torch.from_numpy(tokens), torch.from_numpy(strided), r,
                           need_weights=need_weights)
            for key in ('mel', 'linear', 'stop_prob'):
                assert out[key].dtype == torch.float32, key
                np.testing.assert_allclose(_np(out[key]), np.asarray(ref[key]), atol=OUT_ATOL,
                                           rtol=0, err_msg=key)
            frames = 1.0 - _np(out['mel_mask'])[:, 0, 0, :]
            toks = 1.0 - _np(out['text_mask'])[:, 0, 0, :]
            assert list(out['decoder_attention']) == (
                sorted(ref['decoder_attention']) if need_weights else [LAST])
            _assert_maps(out['decoder_attention'], frames, ref['decoder_attention'])
            _assert_maps(out['encoder_attention'], toks, ref['encoder_attention'])


def _grads(jm, tm, batch, r, forcing):
    """The JAX and the port's loss, parts and per-leaf gradients at one
    step's weights (dropout 0, so both see the same function)."""
    trainer = _jax_trainer(jm)
    with trainer._attention_scope():
        (j_loss, (j_parts, _)), j_grads = jax.jit(jax.value_and_grad(
            lambda p, b: j_aligner_loss(jm, p, b, r, trainer.stop_loss, forcing, forcing,
                                        jax.random.PRNGKey(0), False),
            has_aux=True))(jm.params, _jax_batch(batch))
    t_trainer = TTrainer(tm, SCHEDULE)
    t_loss, (t_parts, _) = t_aligner_loss(tm, t_trainer.to_device(batch), r,
                                          t_trainer.stop_loss, forcing, forcing, True,
                                          torch.Generator().manual_seed(0))
    t_grads = dict(zip((n for n, _ in tm.named_parameters()),
                       torch.autograd.grad(t_loss, list(tm.parameters()))))
    return (dict(loss=float(j_loss), parts={k: float(v) for k, v in j_parts.items()},
                 grads={k: np.asarray(v) for k, v in flatten_params(j_grads).items()}),
            dict(loss=t_loss.item(), parts={k: v.item() for k, v in t_parts.items()},
                 grads=_port_flat(t_grads)))


@pytest.fixture(scope='module', params=[(1, False), (3, False), (1, True), (3, True)],
                ids=['r1', 'r3', 'r1-forced', 'r3-forced'])
def step16(request):
    r, forcing = request.param
    jm, tm = _models(**BF16)
    batch = _batch(jm.text_pipeline.tokenizer.vocab_size)
    jax_side, port_side = _grads(jm, tm, batch, r, forcing)
    trainer = TTrainer(tm, SCHEDULE)
    aux = trainer.train_step(batch, r=r, force_encoder_diagonal=forcing,
                             force_decoder_diagonal=forcing)
    return dict(jax=jax_side, port=port_side, aux=aux, model=tm, trainer=trainer,
                forced=forcing)


def test_bf16_one_step_loss_matches_jax(step16):
    j, t = step16['jax'], step16['port']
    np.testing.assert_allclose(t['loss'], j['loss'], rtol=LOSS_RTOL)
    for k in ('mel', 'stop_prob', 'diag_loss'):
        np.testing.assert_allclose(t['parts'][k], j['parts'][k], rtol=LOSS_RTOL, atol=0,
                                   err_msg=k)
    assert (t['parts']['diag_loss'] > 0) == step16['forced']
    # train_step's own loss: the same function at the same weights
    np.testing.assert_allclose(step16['aux']['loss'].item(), t['loss'], rtol=1e-6)
    assert np.isfinite(step16['aux']['loss'].item())


def _assert_grads_close(mine: dict, ref: dict, rel_bar: float):
    """Per leaf (JAX layout paths): a relative L2 error of at most
    ``rel_bar``; the key biases (true gradient 0) and the positional-encoding
    scalars against the largest gradient instead (see the module docstring)."""
    assert mine.keys() == ref.keys()
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    scale = max(np.abs(g).max() for g in ref.values())
    for path, want in ref.items():
        got = np.asarray(mine[path], np.float64)
        if path.endswith('wk/bias'):
            assert np.abs(got).max() <= ZERO_GRAD_SHARE * scale, path
            assert np.abs(want).max() <= ZERO_GRAD_SHARE * scale, path
        elif path.endswith('pos_encoding_scalar'):
            assert np.abs(got - want).max() <= SCALAR_GRAD_SHARE * scale, (path, got, want)
            assert (np.abs(got - want) <= SCALAR_GRAD_REL * np.abs(want)).all(), (path, got, want)
            assert (np.sign(got) == np.sign(want)).all(), (path, got, want)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= rel_bar, (path, rel)


def test_bf16_one_step_grads_match_jax_per_leaf(step16):
    _assert_grads_close(step16['port']['grads'], step16['jax']['grads'], GRAD_REL_L2)


def test_bf16_step_keeps_float32_parameters_and_flat_gradients(step16):
    model, trainer = step16['model'], step16['trainer']
    assert trainer.step == 1 and model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    groups = trainer.optimizer.groups
    assert len(groups) == 1 and groups[0].flat.dtype == groups[0].grad.dtype == torch.float32
    lo = groups[0].grad.data_ptr()
    hi = lo + groups[0].grad.numel() * groups[0].grad.element_size()
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32 and lo <= p.grad.data_ptr() < hi, name
        assert torch.isfinite(p).all(), name


def test_bf16_val_step_matches_jax():
    jm, tm = _models(seed=6, **BF16)
    batch = _batch(jm.text_pipeline.tokenizer.vocab_size, seed=6)
    aux = TTrainer(tm, SCHEDULE).val_step(batch, r=1)
    j_trainer = _jax_trainer(jm)
    j_aux = j_trainer.val_step(j_trainer.init_state(params=jm.params), _np32(batch), r=1)
    np.testing.assert_allclose(aux['loss'].item(), float(j_aux['loss']), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(aux['mel_pred']), np.asarray(j_aux['mel_pred'])[:4],
                               atol=OUT_ATOL, rtol=0)
    frames = 1.0 - _np(aux['mel_mask'])[:, 0, 0, :]
    _assert_maps(aux['decoder_attention'], frames,
                 {k: np.asarray(v)[:4] for k, v in j_aux['decoder_attention'].items()})


def test_bf16_grad_accumulation_equals_single_batch():
    _, tm = _models(seed=3, **BF16)
    batch = _batch(tm.text_pipeline.tokenizer.vocab_size, b=6, seed=3, uniform=True,
                   zero_rows=0)
    start = {k: v.clone() for k, v in tm.state_dict().items()}

    def run(n):
        tm.load_state_dict(start)
        trainer = TTrainer(tm, SCHEDULE, grad_accumulation=n)
        aux = trainer.train_step(batch, r=1, return_attention=True)
        return aux, _port_flat({name: p.grad.clone() for name, p in tm.named_parameters()})

    (aux1, g1), (aux2, g2) = run(1), run(2)
    np.testing.assert_allclose(aux2['loss'].item(), aux1['loss'].item(), rtol=LOSS_RTOL)
    _assert_grads_close(g2, g1, ACCUMULATION_REL_L2)
    for group in ('decoder_attention', 'encoder_attention'):
        for key, ref in aux1[group].items():
            assert aux2[group][key].dtype == torch.float32 and ref.shape[0] == 6, key
            torch.testing.assert_close(aux2[group][key], ref, atol=MAP_ATOL, rtol=0)


def test_bf16_align_durations_match_jax(aligners16):
    jm, tm = aligners16
    tokens, mel = ragged_batch(tm.text_pipeline.tokenizer.vocab_size, seed=3)
    jm.set_constants(reduction_factor=1)
    tm.set_constants(reduction_factor=1)
    j_attn, _ = jm.align(tokens.astype(np.int32), mel, mels_have_start_end_vectors=True)
    t_attn, out = tm.align(tokens, mel, mels_have_start_end_vectors=True)
    assert t_attn.dtype == np.float32
    np.testing.assert_allclose(t_attn, np.asarray(j_attn), atol=MAP_ATOL, rtol=0)
    frames = 1.0 - _np(out['mel_mask'])[:, 0, 0, :]
    _assert_maps(out['decoder_attention'], frames)
    ours = t_durations(t_attn, mel, tokens, weighted=True)[0]
    theirs = j_durations(np.asarray(j_attn), mel, tokens.astype(np.int32), weighted=True)[0]
    same = np.mean(np.concatenate([a == b for a, b in zip(ours, theirs)]))
    assert same >= SAME_DURATIONS, same


def test_bf16_predict_matches_jax(monkeypatch):
    jm, tm = jax_and_port_aligners(seed=4, encoder_num_heads=[2], decoder_num_heads=[2, 1],
                                   **BF16)
    jm.set_constants(reduction_factor=1)
    tm.set_constants(reduction_factor=1)
    cache_dtypes = set()
    apply_cached = t_attention.MultiHeadAttention.apply_cached

    def recording(self, q_in, k_cache, v_cache, *args, **kwargs):
        cache_dtypes.update((k_cache.dtype, v_cache.dtype))
        return apply_cached(self, q_in, k_cache, v_cache, *args, **kwargs)

    monkeypatch.setattr(t_attention.MultiHeadAttention, 'apply_cached', recording)
    ref = jm.predict('ab', max_length=12)
    out = tm.predict('ab', max_length=12)
    assert cache_dtypes == {torch.bfloat16}
    assert out['n_steps'] == ref['n_steps'] == 13
    assert np.isfinite(out['mel']).all() and out['decoder_attention'].dtype == np.float32
    free = slice(0, PREDICT_FREE_STEPS)
    np.testing.assert_allclose(out['mel'][free], ref['mel'][free], atol=OUT_ATOL, rtol=0)
    # JAX's teacher-forced decoder on the port's own decode: each frame from
    # the frames before it, with no feedback of the differences
    tokens = np.asarray(tm.encode_text('ab'), np.int32)[None]
    tar = np.concatenate([tm.start_vec[None], out['mel'][None, :-1]], axis=1)
    forced = jax.jit(lambda p, t, m: jm.apply(p, t, m, 1))(
        jm.params, jnp.asarray(tokens), jnp.asarray(tar))
    np.testing.assert_allclose(out['mel'], np.asarray(forced['mel'])[0], atol=OUT_ATOL, rtol=0)


def test_bf16_train_aligner_cli_three_steps_writes_what_jax_loads(tmp_path):
    from transformertts_tpu.utils.config import TrainingConfigManager as JConfig
    cfg, cm = _tiny_session(
        tmp_path, max_steps=3, reduction_factor_schedule=[[0, 3], [2, 1]],
        force_encoder_diagonal_steps=1, force_decoder_diagonal_steps=2,
        validation_frequency=3, checkpoint_frequency=3, weights_save_frequency=3,
        train_images_plotting_frequency=3, prediction_start_step=100, **BF16)
    assert cm.get_model('cpu').compute_dtype == torch.bfloat16
    proc = subprocess.run(
        [sys.executable, '-m', 'transformertts_torch.train_aligner', '--config', str(cfg),
         '--yes', '--device', 'cpu'], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'done' in proc.stdout and 'ignored exception' not in proc.stdout, proc.stdout[-3000:]
    assert [s for s, _ in t_ckpt.list_checkpoints(cm.weights_dir)] == [3]
    with np.load(cm.weights_dir / 'ckpt_3.npz') as data:
        floats = {k: data[k].dtype for k in data.files if data[k].dtype.kind == 'f'}
    assert floats and set(floats.values()) == {np.dtype(np.float32)}, floats
    # the JAX package restores it into its own bf16 Aligner's state
    jcm = JConfig(cfg, aligner=True)
    jm = jcm.get_model()
    assert jm.compute_dtype == jnp.bfloat16
    jm.init_params(jax.random.PRNGKey(0))
    restored = j_ckpt.restore_checkpoint(
        cm.weights_dir / 'ckpt_3.npz', init_state(jm.params, make_optimizer(SCHEDULE)))
    assert int(restored.step) == 3
    leaves = jax.tree_util.tree_leaves(restored.params)
    assert leaves and all(x.dtype == jnp.float32 for x in leaves)
    # and the port resumes its own checkpoint in bf16
    model = cm.load_model(device='cpu', verbose=False)
    assert model.step == 3 and model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_extraction_cli_matches_the_jax_cli(tmp_path):
    """``extract_durations`` with ``compute_dtype: bfloat16`` in the config,
    both CLIs on one JAX checkpoint (r 1 at its step): every clip's
    durations sum to its frames and at least 0.9 of them equal JAX's."""
    import extract_durations as j_cli
    import yaml
    from test_torch_duration_extraction import write_featurized
    from transformertts_torch import extract_durations as t_cli
    from transformertts_tpu.utils.config import TrainingConfigManager as JConfig
    cfg = write_featurized(tmp_path)
    session = yaml.safe_load(cfg.read_text())
    session['aligner_settings'].update(BF16)
    cfg.write_text(yaml.safe_dump(session))
    cm = JConfig(cfg, aligner=True)
    model = cm.get_model()
    assert model.compute_dtype == jnp.bfloat16
    model.init_params(jax.random.PRNGKey(3))
    j_ckpt.save_checkpoint(cm.weights_dir, init_state(model.params,
                                                      make_optimizer([(0, 1e-4)]), step=7))
    j_cli.main(['--config', str(cfg), '--skip_char_pitch'])
    theirs = {f.stem: np.load(f) for f in cm.duration_dir.glob('*.npy')}
    shutil.rmtree(cm.duration_dir)
    stats = t_cli.main(['--config', str(cfg), '--device', 'cpu', '--skip_char_pitch'])
    ours = {f.stem: np.load(f) for f in cm.duration_dir.glob('*.npy')}
    assert stats['clips'] == 7 and sorted(ours) == sorted(theirs)
    mels = {f.stem: np.load(f).shape[0] for f in cm.mel_dir.glob('*.npy')}
    for name, durations in ours.items():
        assert durations.dtype == theirs[name].dtype and durations.sum() == mels[name], name
    same = np.mean(np.concatenate([ours[n] == theirs[n] for n in ours]))
    assert same >= SAME_DURATIONS, same


def test_chip_smoke_tts_language_is_the_convergence_checks():
    """chip_smoke's ForwardTransformer language: the samples and the batch
    draws of ``convergence_check.forward_convergence`` from its seed."""
    import chip_smoke
    from convergence_check import make_language
    rng_ours, rng_theirs = np.random.default_rng(0), np.random.default_rng(0)
    ours, theirs = chip_smoke.make_language(rng_ours), make_language(rng_theirs)
    assert len(ours) == len(theirs) == 64
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    np.testing.assert_array_equal(rng_ours.integers(0, 64, 16), rng_theirs.integers(0, 64, 16))
    batch = chip_smoke.tts_language_batch(ours, np.arange(3))
    t_pad = -(-max(s[2].shape[0] for s in ours) // 16) * 16
    assert batch['mel'].shape == (3, t_pad, chip_smoke.LANG_MEL)
    for row in range(3):
        toks, durs, mel = ours[row]
        np.testing.assert_array_equal(batch['tokens'][row], toks)
        np.testing.assert_array_equal(batch['durations'][row], durs)
        np.testing.assert_array_equal(batch['mel'][row, :mel.shape[0]], mel)
        assert not batch['mel'][row, mel.shape[0]:].any() and not batch['pitch'].any()


@pytest.mark.slow
def test_synthetic_language_convergence_bf16():
    """The Aligner half of the convergence check at bf16 (chip_smoke runs
    the same on the card): extracted durations within 1.5 frames."""
    import chip_smoke
    result = chip_smoke.synthetic_language_convergence('cpu', compute_dtype='bfloat16')
    assert result['duration_mae'] < 1.5, result


@pytest.mark.slow
def test_forward_language_convergence():
    """The port of ``convergence_check.forward_convergence``: its model,
    seed and 700 steps; the mean mel loss of the last 20 steps under a
    quarter of the first 20's."""
    import chip_smoke
    result = chip_smoke.forward_language_convergence('cpu')
    assert result['last'] < 0.25 * result['first'], result
