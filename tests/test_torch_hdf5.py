"""Hdf5-only model dirs load into the port: the JAX package's hdf5 export,
a Keras-3-layout file and a legacy Keras-2 file with Keras's own names,
each against the JAX package's converter, on the tiny float32 config.

``predict`` mels agree within atol 1e-4, rtol 0, the bar of the port's
forward parity tests (``tests/test_torch_forward_tts.py``); state dicts are
compared bit for bit (the converters move arrays, they compute nothing).
"""
import sys

import numpy as np
import pytest
import torch
import yaml

from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
from transformertts_torch.models.persistence import params_from_jax

torch.set_num_threads(1)

SENTENCE = 'The quick brown fox jumps over the lazy dog.'


@pytest.fixture(scope='module')
def jax_model():
    import jax
    from test_torch_nn import TINY_CONFIG
    from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
    model = JFT(**TINY_CONFIG)
    model.init_params(jax.random.PRNGKey(11))
    return model


def _jax_flat(model) -> dict:
    import jax
    from transformertts_tpu.utils.pytree import flatten_params
    return flatten_params(jax.device_get(model.params))


def _assert_state_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].shape == b[key].shape, key
        torch.testing.assert_close(a[key], b[key], atol=0, rtol=0, msg=key)


def _config_only_dir(model, path):
    """A model dir with the JAX model's config.yaml and no weights yet."""
    from transformertts_tpu.models.persistence import save_model_dir
    save_model_dir(model, path)
    (path / 'model_weights.npz').unlink()
    return path


def _keras3_groups(prefix: str, names: list) -> list:
    """Keras-style auto-named sibling groups: name, name_1, name_2, ..."""
    return [f'{prefix}{n}' if i == 0 else f'{prefix}{n}_{i}' for i, n in enumerate(names)]


def _write_keras3_h5(path, flat: dict, config: dict, with_scalar: bool = True):
    """The JAX model's weights in the Keras-3 ``.weights.h5`` layout that
    ``convert_forward_weights`` reads: groups by attribute path, ``vars/N``
    leaves, stacks of auto-named groups."""
    import h5py

    def dense(f, group, path):
        f[f'{group}/vars/0'] = flat[f'{path}/kernel']
        f[f'{group}/vars/1'] = flat[f'{path}/bias']

    def ln(f, group, path):
        f[f'{group}/vars/0'] = flat[f'{path}/gamma']
        f[f'{group}/vars/1'] = flat[f'{path}/beta']

    def sarn(f, group, path):
        for mine, theirs in (('wq', 'wq'), ('wk', 'wk'), ('wv', 'wv'), ('wo', 'dense')):
            dense(f, f'{group}/sarn/mha/{theirs}', f'{path}/sarn/mha/{mine}')
        ln(f, f'{group}/sarn/last_ln', f'{path}/sarn/ln')

    def conv_stack(f, group, path, n_convs, per_conv_ln):
        convs = _keras3_groups(f'{group}/convolutions/', ['conv1d'] * (n_convs - 1))
        for i, g in enumerate(convs):
            dense(f, g, f'{path}/conv_{i}')
        dense(f, f'{group}/last_conv', f'{path}/conv_{n_convs - 1}')
        if per_conv_ln:
            norms = _keras3_groups(f'{group}/normalization/', ['layer_normalization'] * n_convs)
            for i, g in enumerate(norms):
                ln(f, g, f'{path}/ln_{i}')
        else:
            ln(f, f'{group}/normalization', f'{path}/ln')

    def blocks(f, root, n_convs):
        ln(f, f'{root}/layernorm', f'{root}/ln')
        if with_scalar:
            f[f'{root}/pos_encoding_scalar'] = flat[f'{root}/pos_encoding_scalar']
        n_blocks = len({k.split('/')[1] for k in flat if k.startswith(f'{root}/conv_')})
        for i, g in enumerate(_keras3_groups(f'{root}/encoder_SACB/',
                                             ['self_attention_conv_block'] * n_blocks)):
            sarn(f, g, f'{root}/conv_{i}')
            conv_stack(f, f'{g}/conv', f'{root}/conv_{i}/conv', n_convs, per_conv_ln=False)

    def predictor(f, root, n_convs):
        conv_stack(f, f'{root}/conv_blocks', f'{root}/conv_blocks', n_convs, per_conv_ln=True)
        dense(f, f'{root}/linear', f'{root}/linear')

    with h5py.File(path, 'w') as f:
        f['encoder_prenet/vars/0'] = flat['encoder_prenet/table']
        for root in ('encoder', 'decoder'):
            blocks(f, root, len(config['encoder_attention_conv_filters']))
        predictor(f, 'dur_pred', len(config['duration_conv_filters']))
        predictor(f, 'pitch_pred', len(config['pitch_conv_filters']))
        dense(f, 'pitch_embed', 'pitch_embed')
        dense(f, 'out', 'out')


def test_jax_hdf5_only_dir_loads_into_port(jax_model, tmp_path):
    """``save_model_dir(weights_format='hdf5')`` writes the legacy layout and
    no npz; the port loads it as the npz of the same model, bit for bit, and
    predicts the JAX model's mel."""
    from transformertts_tpu.models.persistence import save_model_dir
    h5_dir, npz_dir = tmp_path / 'hdf5', tmp_path / 'npz'
    save_model_dir(jax_model, h5_dir, weights_format='hdf5')
    assert not (h5_dir / 'model_weights.npz').exists()
    save_model_dir(jax_model, npz_dir)
    port = TFT.load_model(h5_dir, device='cpu')
    _assert_state_equal(port.state_dict(), TFT.load_model(npz_dir, device='cpu').state_dict())
    j, t = jax_model.predict(SENTENCE), port.predict(SENTENCE)
    assert t['mel'].shape == np.asarray(j['mel']).shape
    np.testing.assert_allclose(t['mel'], np.asarray(j['mel']), atol=1e-4, rtol=0)


@pytest.mark.parametrize('with_scalar', [True, False], ids=['scalar', 'no-scalar'])
def test_keras3_layout_matches_jax_converter(jax_model, tmp_path, with_scalar):
    """A Keras-3 ``.weights.h5`` (any ``*.h5`` name) gives the JAX
    converter's parameters; an untracked ``pos_encoding_scalar`` is 1."""
    from transformertts_tpu.models import convert as jconvert
    from transformertts_tpu.utils.pytree import flatten_params
    flat = _jax_flat(jax_model)
    path = _config_only_dir(jax_model, tmp_path) / 'ljspeech.weights.h5'
    _write_keras3_h5(path, flat, jax_model.config, with_scalar)
    port = TFT.load_model(tmp_path, device='cpu')
    want = params_from_jax(flatten_params(
        jconvert.convert_forward_weights(jconvert._read_h5_flat(path))))
    _assert_state_equal(port.state_dict(), want)
    _assert_state_equal(port.state_dict(), params_from_jax(
        {**flat, **({} if with_scalar else {f'{r}/pos_encoding_scalar': np.float32(1.0)
                                           for r in ('encoder', 'decoder')})}))


def test_legacy_messy_names_match_jax_converter(jax_model, tmp_path):
    """A legacy Keras-2 file with Keras's auto-names and block tags, written
    as the JAX package's own legacy tests write it, next to a second hdf5
    file that sorts first: ``model_weights.hdf5`` is the one read."""
    from test_legacy_checkpoint import LAYER_NAMES, _write_messy_h5
    from transformertts_tpu.models import convert as jconvert
    from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
    flat = _jax_flat(jax_model)
    path = _config_only_dir(jax_model, tmp_path) / 'model_weights.hdf5'
    _write_messy_h5(path, jconvert.forward_legacy_skeleton(jax_model.config), flat,
                    LAYER_NAMES['forward'])
    (tmp_path / 'a_stale_export.hdf5').write_bytes(b'not hdf5')
    port = TFT.load_model(tmp_path, device='cpu')
    reference = JFT.from_config(jax_model.config)
    jconvert.load_legacy_weights_into(reference, path)
    want = params_from_jax(_jax_flat(reference))
    _assert_state_equal(port.state_dict(), want)
    _assert_state_equal(port.state_dict(), params_from_jax(flat))


def test_hdf5_dir_without_h5py_raises_import_error(jax_model, tmp_path, monkeypatch):
    """Without h5py an hdf5-only dir raises, naming h5py and the dir, while
    an npz dir still loads."""
    from transformertts_tpu.models.persistence import save_model_dir
    h5_dir, npz_dir = tmp_path / 'hdf5', tmp_path / 'npz'
    save_model_dir(jax_model, h5_dir, weights_format='hdf5')
    save_model_dir(jax_model, npz_dir)
    monkeypatch.setitem(sys.modules, 'h5py', None)
    with pytest.raises(ImportError, match='h5py') as info:
        TFT.load_model(h5_dir, device='cpu')
    assert str(h5_dir) in str(info.value)
    assert TFT.load_model(npz_dir, device='cpu').step == 0


def test_dir_without_weights_raises_file_not_found(tmp_path):
    from test_torch_nn import TINY_CONFIG
    with open(tmp_path / 'config.yaml', 'w') as f:
        yaml.safe_dump(dict(TINY_CONFIG), f)
    with pytest.raises(FileNotFoundError, match='no model weights'):
        TFT.load_model(tmp_path, device='cpu')
