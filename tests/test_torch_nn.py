"""Parity of the PyTorch port's NN modules with the JAX package's, on the CPU.

The same weights (JAX-initialized, carried over by the weight bridge) and
the same numpy inputs go through both. Float32 throughout; the modules agree
to atol 1e-5 (different GEMM summation orders), the length regulator
bit for bit (it only selects rows).

``TINY_CONFIG`` and ``jax_and_port_models`` are shared by the other
``test_torch_*`` files: the tiny ForwardTransformer of the verify notes
(d=64, 2 encoder and 2 decoder blocks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformertts_torch.models.persistence import params_from_jax
from transformertts_torch.nn import attention as t_attention
from transformertts_torch.nn import blocks as t_blocks
from transformertts_torch.nn import core as t_core
from transformertts_torch.nn.length_regulator import regulate_length as t_regulate
from transformertts_tpu.nn import attention as j_attention
from transformertts_tpu.nn import blocks as j_blocks
from transformertts_tpu.nn import core as j_core
from transformertts_tpu.nn.length_regulator import regulate_length as j_regulate
from transformertts_tpu.utils.pytree import flatten_params

torch.set_num_threads(1)

ATOL = 1e-5

TINY_CONFIG = dict(
    encoder_model_dimension=64, decoder_model_dimension=64, dropout_rate=0.1,
    decoder_num_heads=[2, 2], encoder_num_heads=[2, 2],
    encoder_max_position_encoding=2000, decoder_max_position_encoding=10000,
    encoder_dense_blocks=0, decoder_dense_blocks=0,
    duration_conv_filters=[32, 32], pitch_conv_filters=[32, 32],
    duration_kernel_size=3, pitch_kernel_size=3, predictors_dropout=0.1,
    mel_channels=80, phoneme_language='en-us', with_stress=True,
    model_breathing=False, transposed_attn_convs=True,
    encoder_attention_conv_filters=[128, 64], decoder_attention_conv_filters=[128, 64],
    encoder_attention_conv_kernel=3, decoder_attention_conv_kernel=3,
    encoder_feed_forward_dimension=None, decoder_feed_forward_dimension=None,
    sampling_rate=22050, n_fft=1024, hop_length=256, win_length=1024,
    f_min=0, f_max=8000, normalizer='MelGAN', data_name='demo')


def jax_and_port_models(model_dir, seed=42, **overrides):
    """A JAX ForwardTransformer with seeded weights, saved to ``model_dir``,
    and the port's model loaded from that dir on the CPU."""
    from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
    from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
    jm = JFT(**{**TINY_CONFIG, **overrides})
    jm.init_params(jax.random.PRNGKey(seed))
    jm.save_model(model_dir)
    return jm, TFT.load_model(model_dir, device='cpu')


def _port(jax_module, torch_module, seed=0):
    """Init ``jax_module``, load its params into ``torch_module``."""
    params = jax_module.init(jax.random.PRNGKey(seed))
    torch_module.load_state_dict(params_from_jax(flatten_params(params)), strict=True)
    return params


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _key_mask(b=2, t=11):
    mask = np.zeros((b, 1, 1, t), np.float32)
    mask[0, ..., 7:] = 1.0          # sample 0 padded after 7
    return mask


@pytest.mark.parametrize('activation', [None, 'relu'])
def test_dense(activation):
    jm, tm = j_core.Dense(24, 40, activation), t_core.Dense(24, 40, activation)
    params = _port(jm, tm)
    x = _rand(3, 5, 24)
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize('kernel_size', [1, 3, 4])
def test_conv1d_same(kernel_size):
    # k=4 pads unevenly, ((k-1)//2, k//2), as lax's SAME does
    jm = j_core.Conv1D(16, 24, kernel_size, activation='relu')
    tm = t_core.Conv1D(16, 24, kernel_size, activation='relu')
    params = _port(jm, tm)
    x = _rand(2, 9, 16)
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_layer_norm():
    jm, tm = j_core.LayerNorm(32), t_core.LayerNorm(32)
    params = {'gamma': jnp.asarray(_rand(32, seed=1)), 'beta': jnp.asarray(_rand(32, seed=2))}
    tm.load_state_dict(params_from_jax(flatten_params(params)))
    x = 3.0 + 5.0 * _rand(4, 7, 32)
    _close(tm(torch.from_numpy(x)), jm.apply(params, jnp.asarray(x)))


def test_embedding():
    jm, tm = j_core.Embedding(30, 16), t_core.Embedding(30, 16)
    params = _port(jm, tm)
    ids = np.random.default_rng(0).integers(0, 30, (3, 8))
    _close(tm(torch.from_numpy(ids)), jm.apply(params, jnp.asarray(ids)), atol=0)


def test_multi_head_attention_weights_and_output():
    jm = j_attention.MultiHeadAttention(32, 2, 0.1)
    tm = t_attention.MultiHeadAttention(32, 2)
    params = _port(jm, tm)
    x, mask = _rand(2, 11, 32), _key_mask()
    j_out, j_w = jm.apply(params, *(jnp.asarray(x),) * 3, jnp.asarray(mask))
    t_out, t_w = tm(*(torch.from_numpy(x),) * 3, torch.from_numpy(mask))
    _close(t_out, j_out)
    _close(t_w, j_w)


def test_multi_head_attention_kernel_path_matches_weights_path():
    """need_weights=False takes ops.flash_attention (its plain version on
    the CPU) and must give the eager path's output."""
    tm = t_attention.MultiHeadAttention(32, 2)
    _port(j_attention.MultiHeadAttention(32, 2, 0.0), tm)
    x, mask = torch.from_numpy(_rand(2, 11, 32)), torch.from_numpy(_key_mask())
    eager, _ = tm(x, x, x, mask, need_weights=True)
    fused, weights = tm(x, x, x, mask, need_weights=False)
    assert weights is None
    torch.testing.assert_close(fused, eager, atol=ATOL, rtol=0)


def test_stat_predictor():
    jm = j_blocks.StatPredictor(32, [16, 16], 3, 'relu', 'relu', 0.1)
    tm = t_blocks.StatPredictor(32, [16, 16], 3, 'relu', 'relu')
    params = _port(jm, tm)
    x = _rand(2, 11, 32)
    keep = 1.0 - _key_mask()[:, 0, 0, :, None]
    _close(tm(torch.from_numpy(x), torch.from_numpy(keep)),
           jm.apply(params, jnp.asarray(x), jnp.asarray(keep)))


@pytest.mark.parametrize('dense_blocks', [0, 1])
def test_self_attention_blocks(dense_blocks):
    """LN → scalar·posenc → dense/conv self-attention blocks, with the
    attention weights of every block."""
    args = dict(model_dim=32, feed_forward_dimension=48, num_heads=[2, 2],
                maximum_position_encoding=100, conv_filters=[64, 32],
                dense_blocks=dense_blocks, kernel_size=3, conv_activation='relu',
                name='Encoder')
    jm = j_blocks.SelfAttentionBlocks(dropout_rate=0.1, **args)
    tm = t_blocks.SelfAttentionBlocks(**args)
    params = _port(jm, tm)
    params['pos_encoding_scalar'] = jnp.float32(0.7)
    tm.pos_encoding_scalar.data.fill_(0.7)
    x, mask = _rand(2, 11, 32), _key_mask()
    j_y, j_w = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))
    t_y, t_w = tm(torch.from_numpy(x), torch.from_numpy(mask), need_weights=True)
    _close(t_y, j_y)
    assert t_w.keys() == j_w.keys()
    for name in j_w:
        _close(t_w[name], j_w[name])
    t_fused, no_w = tm(torch.from_numpy(x), torch.from_numpy(mask), need_weights=False)
    assert no_w == {}
    torch.testing.assert_close(t_fused, t_y, atol=ATOL, rtol=0)


def test_length_regulator_bit_equal():
    # half-way durations round to even (0.5→0, 1.5→2, 2.5→2), negatives
    # clamp to 0, and sample 1 overruns max_frames
    durations = np.array([[0.5, 1.5, 2.5, 0.0, 3.2, -1.0, 1.0],
                          [4.0, 6.0, 5.5, 0.49, 2.0, 3.0, 4.0]], np.float32)
    x = _rand(2, 7, 16)
    for max_frames in (12, 24):
        j_out, j_valid = j_regulate(jnp.asarray(x), jnp.asarray(durations), max_frames)
        t_out, t_valid = t_regulate(torch.from_numpy(x), torch.from_numpy(durations),
                                    max_frames)
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))


def test_length_regulator_random_durations_bit_equal():
    rng = np.random.default_rng(3)
    durations = rng.uniform(0, 6, (4, 20)).astype(np.float32)
    x = _rand(4, 20, 8, seed=4)
    j_out, j_valid = j_regulate(jnp.asarray(x), jnp.asarray(durations), 128)
    t_out, t_valid = t_regulate(torch.from_numpy(x), torch.from_numpy(durations), 128)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
