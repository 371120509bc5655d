"""The port's model lookup (``models/factory.py``) against dirs written here.

``tts_ljspeech`` looks in $TRANSFORMERTTS_MODELS_DIR, then in the home
cache; both are monkeypatched to dirs under ``tmp_path``, and
``urllib.request.urlretrieve`` raises, so no test reaches the network.
Loaded weights are compared bit for bit with the JAX package's (the loaders
move arrays, they compute nothing).
"""
import re

import jax
import numpy as np
import pytest
import torch
import yaml

from test_torch_aligner import TINY_ALIGNER
from test_torch_nn import TINY_CONFIG
from transformertts_torch.models import factory
from transformertts_torch.models.persistence import params_from_jax
from transformertts_tpu.models.aligner import Aligner as JAligner
from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
from transformertts_tpu.models.persistence import save_model_dir
from transformertts_tpu.utils.pytree import flatten_params

torch.set_num_threads(1)

NAME = 'bdf06b9_ljspeech_step_{}'


@pytest.fixture(scope='module')
def jax_model():
    model = JFT(**TINY_CONFIG)
    model.init_params(jax.random.PRNGKey(7))
    return model


def _assert_weights(model, jax_model):
    want = params_from_jax(flatten_params(jax.device_get(jax_model.params)))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0, msg=key)


@pytest.fixture
def caches(tmp_path, monkeypatch):
    """$TRANSFORMERTTS_MODELS_DIR and $HOME under ``tmp_path``; a download
    raises."""
    def no_network(url, *args, **kwargs):
        raise OSError(f'no network for {url}')

    monkeypatch.setattr('urllib.request.urlretrieve', no_network)
    env, home = tmp_path / 'models', tmp_path / 'home'
    monkeypatch.setenv('TRANSFORMERTTS_MODELS_DIR', str(env))
    monkeypatch.setenv('HOME', str(home))
    return env, home / '.cache' / 'transformertts_tpu' / 'models'


def test_tts_ljspeech_looks_in_the_env_dir_then_the_home_cache(caches, jax_model, monkeypatch):
    env, home = caches
    other = JFT(**{**TINY_CONFIG, 'data_name': 'home'})
    other.init_params(jax.random.PRNGKey(8))
    save_model_dir(jax_model, env / NAME.format('95000'))
    save_model_dir(other, home / NAME.format('95000'))
    save_model_dir(other, home / NAME.format('100'))
    model = factory.tts_ljspeech(device='cpu')
    assert model.config['data_name'] == 'demo'
    _assert_weights(model, jax_model)
    # a step only the home cache holds, then the env var unset
    assert factory.tts_ljspeech('100', device='cpu').config['data_name'] == 'home'
    monkeypatch.delenv('TRANSFORMERTTS_MODELS_DIR')
    _assert_weights(factory.tts_ljspeech(device='cpu'), other)


def test_tts_ljspeech_without_a_cached_dir_names_the_dir_to_fill(caches, monkeypatch):
    env, home = caches
    with pytest.raises(RuntimeError, match=re.escape(str(env / NAME.format('95000')))):
        factory.tts_ljspeech(device='cpu')
    monkeypatch.delenv('TRANSFORMERTTS_MODELS_DIR')
    with pytest.raises(RuntimeError, match='TRANSFORMERTTS_MODELS_DIR') as info:
        factory.tts_ljspeech('5', device='cpu')
    assert str(home / NAME.format('5')) in str(info.value)


@pytest.mark.parametrize('weights_format', ['npz', 'hdf5'])
def test_load_model_dir_reads_npz_and_hdf5(tmp_path, jax_model, weights_format):
    save_model_dir(jax_model, tmp_path, weights_format=weights_format)
    assert (tmp_path / 'model_weights.npz').exists() == (weights_format == 'npz')
    _assert_weights(factory.load_model_dir(tmp_path, device='cpu'), jax_model)


def test_load_model_dir_without_weights_raises(tmp_path):
    with open(tmp_path / 'config.yaml', 'w') as f:
        yaml.safe_dump(dict(TINY_CONFIG), f)
    with pytest.raises(FileNotFoundError, match='no model weights'):
        factory.load_model_dir(tmp_path, device='cpu')


@pytest.mark.parametrize('weights_format', ['npz', 'hdf5'])
def test_tts_custom_reads_a_config_and_a_weights_file(tmp_path, jax_model, weights_format):
    save_model_dir(jax_model, tmp_path, weights_format=weights_format)
    weights = tmp_path / ('model_weights.npz' if weights_format == 'npz'
                          else 'model_weights.hdf5')
    model, config = factory.tts_custom(tmp_path / 'config.yaml', weights, device='cpu')
    assert config['encoder_model_dimension'] == TINY_CONFIG['encoder_model_dimension']
    assert model.device.type == 'cpu'
    _assert_weights(model, jax_model)
    loaded = factory.load_model_dir(tmp_path, device='cpu')
    a, b = model.predict('Hello there.')['mel'], loaded.predict('Hello there.')['mel']
    np.testing.assert_array_equal(a, b)


def test_aligner_custom_reads_npz_and_names_the_missing_hdf5_reader(tmp_path):
    """``aligner_custom`` reads the JAX Aligner's weights from its npz and from
    its hdf5 export, the same bits both ways."""
    jm = JAligner(**TINY_ALIGNER)
    jm.init_params(jax.random.PRNGKey(0))
    jm.save_model(tmp_path, weights_format='both')
    for weights in ('model_weights.npz', 'model_weights.hdf5'):
        model, config = factory.aligner_custom(tmp_path / 'config.yaml', tmp_path / weights,
                                               device='cpu')
        assert config['decoder_num_heads'] == TINY_ALIGNER['decoder_num_heads']
        assert model.device.type == 'cpu'
        _assert_weights(model, jm)
