"""The weight bridge: one model dir loads into either package.

Layouts are transposes, so every round trip is bit-exact.
"""
import subprocess

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_nn import TINY_CONFIG
from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
from transformertts_torch.models.persistence import params_from_jax, params_to_jax
from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
from transformertts_tpu.utils.pytree import flatten_params

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def jax_model():
    model = JFT(**TINY_CONFIG)
    model.init_params(jax.random.PRNGKey(7))
    return model


def _assert_flat_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_npz_to_port_to_npz_is_bit_exact(jax_model):
    flat = flatten_params(jax.device_get(jax_model.params))
    _assert_flat_equal(params_to_jax(params_from_jax(flat)), flat)


def test_layouts(jax_model):
    flat = flatten_params(jax.device_get(jax_model.params))
    state = params_from_jax(flat)
    dense = flat['encoder/conv_0/sarn/mha/wo/kernel']             # (2d, d)
    conv = flat['encoder/conv_0/conv/conv_0/kernel']             # (w, in, out)
    np.testing.assert_array_equal(state['encoder.conv_0.sarn.mha.wo.weight'].numpy(), dense.T)
    np.testing.assert_array_equal(state['encoder.conv_0.conv.conv_0.weight'].numpy(),
                                  conv.transpose(2, 1, 0))
    np.testing.assert_array_equal(state['encoder.ln.weight'].numpy(), flat['encoder/ln/gamma'])
    np.testing.assert_array_equal(state['encoder_prenet.weight'].numpy(),
                                  flat['encoder_prenet/table'])
    assert state['decoder.pos_encoding_scalar'].shape == ()


def test_unknown_leaf_is_refused():
    with pytest.raises(KeyError, match='unknown JAX parameter leaf'):
        params_from_jax({'encoder/ln/moving_mean': np.zeros(3, np.float32)})


def test_jax_dir_loads_into_port_with_every_key_used(jax_model, tmp_path):
    jax_model.save_model(tmp_path)
    port = TFT.load_model(tmp_path, device='cpu')
    flat = flatten_params(jax.device_get(jax_model.params))
    # load_model loads strictly; the state it holds is the npz, bit for bit
    assert len(port.state_dict()) == len(flat)
    _assert_flat_equal(params_to_jax(port.state_dict()), flat)
    assert port.config['encoder_num_heads'] == TINY_CONFIG['encoder_num_heads']


def test_port_dir_loads_into_jax(tmp_path):
    port = TFT(**TINY_CONFIG).init_params(torch.Generator().manual_seed(3))
    port.save_model(tmp_path)
    loaded = JFT.load_model(str(tmp_path))
    _assert_flat_equal(flatten_params(jax.device_get(loaded.params)),
                       params_to_jax(port.state_dict()))
    # the dir adds the alphabet, the step and, where git tells it, git_hash
    written = {k: loaded.config[k] for k in ('alphabet', 'git_hash') if k in loaded.config}
    assert loaded.config == {**port.config, **written, 'step': 0}


@pytest.mark.parametrize('git', ['repo', 'not-a-repo', 'no-git'])
def test_port_dir_records_git_hash_as_jax_does(tmp_path, monkeypatch, git):
    """config.yaml carries ``git describe --always`` as ``git_hash``, and
    nothing when git cannot tell it; either dir loads into both packages."""
    from transformertts_torch.models import persistence

    def describe(cmd, **kwargs):
        assert cmd == ['git', 'describe', '--always']
        if git == 'no-git':
            raise FileNotFoundError('git')
        if git == 'not-a-repo':
            raise subprocess.CalledProcessError(128, cmd)
        return b'v1.2-3-gabcdef0\n'

    monkeypatch.setattr(persistence.subprocess, 'check_output', describe)
    TFT(**TINY_CONFIG).init_params(torch.Generator().manual_seed(3)).save_model(tmp_path)
    config = yaml.safe_load((tmp_path / 'config.yaml').read_text())
    if git == 'repo':
        assert config['git_hash'] == 'v1.2-3-gabcdef0'
    else:
        assert 'git_hash' not in config
    monkeypatch.undo()
    assert JFT.load_model(str(tmp_path)).config.get('git_hash') == config.get('git_hash')
    assert TFT.load_model(tmp_path, device='cpu').step == 0


def test_port_init_matches_jax_initializer_scales():
    """Seeded random weights follow the JAX package's initializers:
    glorot-uniform kernels, zero biases, unit LayerNorm, ±0.05 embeddings."""
    port = TFT(**TINY_CONFIG).init_params(torch.Generator().manual_seed(0))
    state = port.state_dict()
    w = state['decoder.conv_0.conv.conv_0.weight']            # (128, 64, 3)
    limit = np.sqrt(6.0 / (64 * 3 + 128 * 3))
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
    assert state['decoder.conv_0.conv.conv_0.bias'].eq(0).all()
    assert state['encoder.ln.weight'].eq(1).all()
    assert state['encoder_prenet.weight'].abs().max() <= 0.05
    again = TFT(**TINY_CONFIG).init_params(torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(state[k], again[k]) for k in state)
