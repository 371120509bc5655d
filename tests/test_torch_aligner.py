"""Parity of the port's Aligner and its layers with the JAX package's, on the CPU.

The same weights (JAX-initialized, carried over by ``params_from_jax``) and
the same numpy inputs go through both, in float32 at dropout off:

- the mel padding and look-ahead masks bit for bit;
- ``project_kv`` / ``apply_kv`` / ``apply_cached``, the cross-attention
  blocks, ``DecoderPrenet`` and ``Postnet`` to atol 1e-5;
- ``Aligner.apply`` at r 1, 2 and 10 on a batch whose mel and token padding
  differ by row: mel, linear and stop logits to atol 1e-5, attention maps to
  atol 1e-6, on the kernel route (``attention_plain`` on the CPU; the last
  block's map) and on the all-eager route (every map);
- ``align``'s last-block map to atol 1e-6;
- ``predict`` over a bounded number of steps (decoder heads [2, 2] and the
  published-style mixed [2, 1]): mel to atol 1e-4, the same step count, and
  the cached decode against the full teacher-forced decoder;
- model dirs (npz, and the JAX package's hdf5 export) and JAX-layout
  training checkpoints both ways, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformertts_torch.models.aligner import Aligner as TAligner
from transformertts_torch.models.persistence import params_from_jax, params_to_jax
from transformertts_torch.nn import attention as t_attention
from transformertts_torch.nn import blocks as t_blocks
from transformertts_torch.nn import masks as t_masks
from transformertts_tpu.models.aligner import Aligner as JAligner
from transformertts_tpu.nn import attention as j_attention
from transformertts_tpu.nn import blocks as j_blocks
from transformertts_tpu.nn import masks as j_masks
from transformertts_tpu.utils.pytree import flatten_params

torch.set_num_threads(1)

ATOL = 1e-5
MAP_ATOL = 1e-6
MEL = 20
LAST = 'Decoder_LastBlock_CrossAttention'

TINY_ALIGNER = dict(
    encoder_model_dimension=32, decoder_model_dimension=32,
    encoder_num_heads=[2, 2], decoder_num_heads=[2, 2],
    encoder_max_position_encoding=200, decoder_max_position_encoding=600,
    encoder_prenet_dimension=32, decoder_prenet_dimension=32,
    dropout_rate=0.1, mel_start_value=0.5, mel_end_value=-0.5, mel_channels=MEL,
    phoneme_language='en-us', with_stress=False, decoder_prenet_dropout=0.1,
    model_breathing=True, encoder_feed_forward_dimension=64,
    decoder_feed_forward_dimension=64, max_r=10)


def jax_and_port_aligners(seed=0, **overrides):
    """A JAX Aligner with seeded weights and the port's with the same weights."""
    jm = JAligner(**{**TINY_ALIGNER, **overrides})
    jm.init_params(jax.random.PRNGKey(seed))
    tm = TAligner(**jm.config)
    tm.load_state_dict(params_from_jax(flatten_params(jm.params)), strict=True)
    return jm, tm


@pytest.fixture(scope='module')
def aligners():
    return jax_and_port_aligners()


def _port(jax_module, torch_module, seed=0):
    params = jax_module.init(jax.random.PRNGKey(seed))
    torch_module.load_state_dict(params_from_jax(flatten_params(params)), strict=True)
    return params


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(j), atol=atol, rtol=0)


def ragged_batch(vocab, b=3, n_tok=16, n_frames=48, seed=0):
    """Tokens and mels (with start and end vectors) whose lengths differ by
    row; every row's padding is zero."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, n_tok), np.int64)
    mel = np.zeros((b, n_frames, MEL), np.float32)
    for i in range(b):
        n = n_tok - 5 * i
        tokens[i, :n] = rng.integers(1, vocab, n)
        t = n_frames - 2 - 9 * i
        mel[i, 0] = 0.5
        mel[i, 1:t + 1] = rng.standard_normal((t, MEL))
        mel[i, t + 1] = -0.5
    return tokens, mel


# --------------------------------------------------------------------- masks

def test_masks_are_bit_equal():
    mel = _rand(3, 9, MEL)
    mel[0, 6:] = 0.0
    mel[2, 1] = 0.0
    np.testing.assert_array_equal(t_masks.mel_padding_mask(torch.from_numpy(mel)).numpy(),
                                  np.asarray(j_masks.mel_padding_mask(jnp.asarray(mel))))
    for size in (1, 7):
        np.testing.assert_array_equal(t_masks.look_ahead_mask(size).numpy(),
                                      np.asarray(j_masks.look_ahead_mask(size)))


# ----------------------------------------------------------------- attention

def _key_mask(b=2, t=11):
    mask = np.zeros((b, 1, 1, t), np.float32)
    mask[0, ..., 7:] = 1.0
    return mask


@pytest.mark.parametrize('need_weights', [True, False])
def test_project_kv_and_apply_kv(need_weights):
    jm = j_attention.MultiHeadAttention(32, 2, 0.1)
    tm = t_attention.MultiHeadAttention(32, 2)
    params = _port(jm, tm)
    memory, q_in, mask = _rand(2, 11, 32, seed=1), _rand(2, 5, 32, seed=2), _key_mask()
    jk, jv = jm.project_kv(params, jnp.asarray(memory))
    tk, tv = tm.project_kv(torch.from_numpy(memory))
    _close(tk, jk)
    _close(tv, jv)
    j_out, j_w = jm.apply_kv(params, jnp.asarray(q_in), jk, jv, jnp.asarray(mask))
    t_out, t_w = tm.apply_kv(torch.from_numpy(q_in), tk, tv, torch.from_numpy(mask),
                             need_weights=need_weights)
    _close(t_out, j_out)
    if need_weights:
        _close(t_w, j_w, MAP_ATOL)
    else:
        assert t_w is None


@pytest.mark.parametrize('need_weights', [True, False])
def test_apply_cached_writes_the_cache_and_matches(need_weights):
    jm = j_attention.MultiHeadAttention(32, 4, 0.1)
    tm = t_attention.MultiHeadAttention(32, 4)
    params = _port(jm, tm)
    t_max, index = 9, 4
    k_cache, v_cache = _rand(2, 4, t_max, 8, seed=3), _rand(2, 4, t_max, 8, seed=4)
    x = _rand(2, 1, 32, seed=5)
    mask = (np.arange(t_max) > index).astype(np.float32)[None, None, None, :]
    j_out, j_w, jk, jv = jm.apply_cached(params, jnp.asarray(x), jnp.asarray(k_cache),
                                         jnp.asarray(v_cache), jnp.asarray(x), index,
                                         jnp.asarray(mask))
    tk, tv = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
    t_out, t_w = tm.apply_cached(torch.from_numpy(x), tk, tv, torch.from_numpy(x), index,
                                 torch.from_numpy(mask), need_weights=need_weights)
    _close(t_out, j_out)
    _close(tk, jk)
    _close(tv, jv)
    if need_weights:
        _close(t_w, j_w, MAP_ATOL)


def test_causal_kernel_route_matches_the_combined_mask():
    """The decoder's self-attention: the kernels' key bias + causal flag
    against JAX's maximum(padding mask, look-ahead)."""
    jm = j_attention.MultiHeadAttention(32, 2, 0.1)
    tm = t_attention.MultiHeadAttention(32, 2)
    params = _port(jm, tm)
    x, mask = _rand(2, 11, 32, seed=6), _key_mask()
    combined = np.maximum(mask, np.asarray(j_masks.look_ahead_mask(11))[None, None])
    j_out, j_w = jm.apply(params, *(jnp.asarray(x),) * 3, jnp.asarray(combined))
    for need_weights in (True, False):
        t_out, t_w = tm(*(torch.from_numpy(x),) * 3, torch.from_numpy(mask), need_weights,
                        causal=True)
        _close(t_out, j_out)
    _close(tm(*(torch.from_numpy(x),) * 3, torch.from_numpy(mask), True, causal=True)[1],
           j_w, MAP_ATOL)


# -------------------------------------------------------------------- blocks

def test_cross_attention_blocks_decoder_prenet_and_postnet():
    r, t, n = 2, 7, 11
    jd = j_blocks.CrossAttentionBlocks(32, 64, [2, 1], 600, 0.1)
    td = t_blocks.CrossAttentionBlocks(32, 64, [2, 1], 600)
    params = _port(jd, td)
    x, enc = _rand(2, t, 32, seed=7), _rand(2, n, 32, seed=8)
    dec_mask = np.zeros((2, 1, 1, t), np.float32)
    dec_mask[1, ..., 5:] = 1.0
    enc_mask = _key_mask(2, n)
    combined = np.maximum(dec_mask, np.asarray(j_masks.look_ahead_mask(t))[None, None])
    for offset in (0, 3):
        j_y, j_w = jd.apply(params, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(combined),
                            jnp.asarray(enc_mask), reduction_factor=r, pos_offset=offset)
        for need_weights in (True, False):
            t_y, t_w = td(torch.from_numpy(x), torch.from_numpy(enc),
                          torch.from_numpy(dec_mask), torch.from_numpy(enc_mask),
                          need_weights, reduction_factor=r, pos_offset=offset)
            _close(t_y, j_y)
            expected = sorted(j_w) if need_weights else ['Decoder_LastBlock_CrossAttention']
            assert sorted(t_w) == expected
            for key in t_w:
                _close(t_w[key], j_w[key], MAP_ATOL)

    jp, tp = j_blocks.DecoderPrenet(MEL, 32, 24), t_blocks.DecoderPrenet(MEL, 32, 24, 0.1)
    params = _port(jp, tp, seed=1)
    x = _rand(2, 5, MEL, seed=9)
    # no dropout unless training, as the JAX package's deterministic decode
    _close(tp(torch.from_numpy(x)), jp.apply(params, jnp.asarray(x), dropout_rate=0.1))

    jq, tq = j_blocks.Postnet(MEL, MEL), t_blocks.Postnet(MEL, MEL)
    params = _port(jq, tq, seed=2)
    j_out, t_out = jq.apply(params, jnp.asarray(x)), tq(torch.from_numpy(x))
    assert sorted(t_out) == sorted(j_out) == ['mel', 'stop_prob']
    for key in j_out:
        _close(t_out[key], j_out[key])


# ------------------------------------------------------------------- Aligner

@pytest.mark.parametrize('r', [1, 2, 10])
def test_apply_matches_jax_on_both_routes(aligners, r):
    jm, tm = aligners
    tokens, mel = ragged_batch(tm.text_pipeline.tokenizer.vocab_size)
    strided = np.ascontiguousarray(mel[:, :-1][:, ::r])
    ref = jm.apply(jm.params, jnp.asarray(tokens.astype(np.int32)), jnp.asarray(strided), r)
    with torch.no_grad():
        for need_weights in (False, True):
            out = tm.apply(torch.from_numpy(tokens), torch.from_numpy(strided), r,
                           need_weights=need_weights)
            for key in ('mel', 'linear', 'stop_prob', 'mel_mask', 'text_mask'):
                _close(out[key], ref[key])
            groups = ('decoder_attention', 'encoder_attention')
            if need_weights:
                for group in groups:
                    assert sorted(out[group]) == sorted(ref[group])
            else:
                assert list(out['decoder_attention']) == [LAST] and not out['encoder_attention']
            for group in groups:
                for key, w in out[group].items():
                    _close(w, ref[group][key], MAP_ATOL)


def test_align_last_block_map(aligners):
    jm, tm = aligners
    tokens, mel = ragged_batch(tm.text_pipeline.tokenizer.vocab_size, b=1, seed=3)
    jm.set_constants(reduction_factor=1)
    tm.set_constants(reduction_factor=1)
    j_attn, _ = jm.align(tokens[0].astype(np.int32), mel[0], mels_have_start_end_vectors=True)
    t_attn, out = tm.align(tokens[0], mel[0], mels_have_start_end_vectors=True)
    _close(t_attn, j_attn, MAP_ATOL)
    assert LAST in out['decoder_attention'] and out['encoder_attention']
    # without start/end vectors the start vector is prepended
    j_attn, _ = jm.align(tokens[0].astype(np.int32), mel[0, 1:-1])
    _close(tm.align(tokens[0], mel[0, 1:-1])[0], j_attn, MAP_ATOL)


def test_set_constants_refuses_unknown_constants(aligners):
    _, tm = aligners
    with pytest.raises(TypeError, match='decoder_prenet_dropout'):
        tm.set_constants(decoder_prenet_dropout=0.0)
    tm.set_constants(reduction_factor=3)
    assert tm.r == 3


@pytest.mark.parametrize('heads', [[2, 2], [2, 1]])
def test_predict_matches_jax_and_the_full_decoder(heads):
    jm, tm = jax_and_port_aligners(seed=4, encoder_num_heads=[2], decoder_num_heads=heads)
    jm.set_constants(reduction_factor=1)
    tm.set_constants(reduction_factor=1)
    ref = jm.predict('ab', max_length=12)
    out = tm.predict('ab', max_length=12)
    assert out['n_steps'] == ref['n_steps'] >= 2
    _close(out['mel'], ref['mel'], 1e-4)
    _close(out['decoder_attention'], ref['decoder_attention'], 1e-5)
    # the cached decode against the full teacher-forced decoder on its output
    tokens = torch.as_tensor(tm.encode_text('ab'))[None]
    tar = np.concatenate([tm.start_vec[None], out['mel'][None, :-1]], axis=1)
    with torch.no_grad():
        full = tm.apply(tokens, torch.from_numpy(tar), 1)
    _close(full['mel'][0], out['mel'], 1e-4)


def test_predict_at_r_5_matches_jax(aligners):
    jm, tm = aligners
    jm.set_constants(reduction_factor=5)
    tm.set_constants(reduction_factor=5)
    ref, out = jm.predict('hi there', max_length=40), tm.predict('hi there', max_length=40)
    assert out['n_steps'] == ref['n_steps']
    assert out['mel'].shape == ref['mel'].shape and out['mel'].shape[0] == 5 * out['n_steps']
    _close(out['mel'], ref['mel'], 1e-4)
    with pytest.raises(ValueError, match='single-sample'):
        tm.predict(np.ones((2, 5), np.int64), encode=False)


# -------------------------------------------------------------- persistence

def test_model_dirs_load_both_ways_bit_for_bit(aligners, tmp_path):
    jm, _ = aligners
    jm.save_model(tmp_path / 'jax')
    tm = TAligner.load_model(tmp_path / 'jax', device='cpu')
    flat = flatten_params(jax.device_get(jm.params))
    port = params_to_jax(tm.state_dict())
    assert sorted(port) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(port[key], np.asarray(flat[key]))
    tm.step = 7
    tm.save_model(tmp_path / 'port')
    back = JAligner.load_model(tmp_path / 'port')
    assert back.step == 7 and back.config['decoder_num_heads'] == [2, 2]
    for key, value in flatten_params(jax.device_get(back.params)).items():
        np.testing.assert_array_equal(np.asarray(value), port[key])


def test_jax_checkpoint_restores_into_port_and_back(aligners, tmp_path):
    from transformertts_torch.training import checkpointing as t_ckpt
    from transformertts_tpu.training import checkpointing as j_ckpt
    from transformertts_tpu.training.state import init_state, make_optimizer
    jm, _ = aligners
    tx = make_optimizer([(0, 1e-4)])
    state = init_state(jm.params, tx, step=130000)
    path = j_ckpt.save_checkpoint(tmp_path / 'jax', state)
    tm = TAligner(**jm.config)
    assert t_ckpt.restore_checkpoint(path, tm) == 130000
    flat = flatten_params(jax.device_get(jm.params))
    for key, value in params_to_jax(tm.state_dict()).items():
        np.testing.assert_array_equal(value, np.asarray(flat[key]))
    from transformertts_torch.training.state import make_optimizer as t_make_optimizer
    back = t_ckpt.save_checkpoint(tmp_path / 'port', tm, t_make_optimizer(tm), 130000)
    restored = j_ckpt.restore_checkpoint(back, init_state(jm.params, tx))
    assert int(restored.step) == 130000
    for a, b in zip(jax.tree_util.tree_leaves(restored.params),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_hdf5_only_aligner_dir_names_the_missing_reader(aligners, tmp_path):
    """An Aligner dir with hdf5 weights only, the JAX package's legacy
    Keras-2 export, loads into the port bit for bit."""
    jm, _ = aligners
    jm.save_model(tmp_path, weights_format='hdf5')
    assert not (tmp_path / 'model_weights.npz').exists()
    tm = TAligner.load_model(tmp_path, device='cpu')
    flat = flatten_params(jax.device_get(jm.params))
    port = params_to_jax(tm.state_dict())
    assert sorted(port) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(port[key], np.asarray(flat[key]))
