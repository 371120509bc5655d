"""Two-way hdf5 checkpoint interop between the port and the JAX package, on
the tiny float32 configs of ``tests/test_torch_nn.py`` (ForwardTransformer)
and ``tests/test_torch_aligner.py`` (Aligner):

- the port's ``save_model(weights_format='hdf5')`` loads into the JAX
  package, and the JAX package's into the port, parameters bit for bit;
  ``predict`` mels within atol 1e-4, rtol 0 (the bar of
  ``tests/test_torch_forward_tts.py``), the Aligner's teacher-forced forward
  within its parity bar (atol 1e-5);
- legacy Keras-2 Aligner files with Keras's own messy names (the rate
  Variable last or first in its group) and Keras-3 Aligner layouts (both
  prefix spellings) against the JAX converter;
- ``describe_weight_match`` and the written files against the JAX package's;
- ``weights_format`` 'both', an unknown value, and an npz save without h5py;
- ``python -m transformertts_torch.verify_checkpoint``.

The converters and the writer move arrays and compute nothing, so
parameters are compared bit for bit.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

h5py = pytest.importorskip('h5py')

from test_legacy_checkpoint import LAYER_NAMES, _write_messy_h5  # noqa: E402
from test_torch_aligner import jax_and_port_aligners, ragged_batch  # noqa: E402
from test_torch_hdf5 import _keras3_groups  # noqa: E402
from test_torch_nn import jax_and_port_models  # noqa: E402
from transformertts_torch.models import convert  # noqa: E402
from transformertts_torch.models.aligner import Aligner as TAligner  # noqa: E402
from transformertts_torch.models.forward_tts import ForwardTransformer as TFT  # noqa: E402
from transformertts_torch.models.persistence import params_to_jax  # noqa: E402
from transformertts_tpu.models import convert as jconvert  # noqa: E402
from transformertts_tpu.models.aligner import Aligner as JAligner  # noqa: E402
from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT  # noqa: E402
from transformertts_tpu.utils.pytree import flatten_params  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SENTENCE = 'The quick brown fox jumps over the lazy dog.'
MEL_ATOL = 1e-4
ALIGNER_ATOL = 1e-5
# decoder heads [2, 2] at seed 4: the Aligner's predict runs more than one step
ALIGNER_OVERRIDES = dict(encoder_num_heads=[2], decoder_num_heads=[2, 2])


@pytest.fixture(scope='module')
def forward_pair(tmp_path_factory):
    return jax_and_port_models(tmp_path_factory.mktemp('forward'), seed=11)


@pytest.fixture(scope='module')
def aligner_pair():
    return jax_and_port_aligners(seed=4, **ALIGNER_OVERRIDES)


def _pair(kind, forward_pair, aligner_pair):
    return forward_pair if kind == 'forward' else aligner_pair


def _jax_flat(model) -> dict:
    return {k: np.asarray(v) for k, v in flatten_params(jax.device_get(model.params)).items()}


def _assert_flat_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        assert np.shape(a[key]) == np.shape(b[key]), key
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)


def _config_only_dir(jax_model, path):
    """A model dir with the JAX model's config.yaml and no weights."""
    jax_model.save_model(path)
    (path / 'model_weights.npz').unlink()
    return path


def _port_cls(kind):
    return TFT if kind == 'forward' else TAligner


def _predict_pair(kind, jm, tm):
    if kind == 'forward':
        return np.asarray(jm.predict(SENTENCE)['mel']), tm.predict(SENTENCE)['mel']
    jm.set_constants(reduction_factor=1)
    tm.set_constants(reduction_factor=1)
    ref, out = jm.predict('ab', max_length=12), tm.predict('ab', max_length=12)
    assert out['n_steps'] == ref['n_steps'] >= 2
    return np.asarray(ref['mel']), out['mel']


# ------------------------------------------------- the port writes, JAX reads

@pytest.mark.parametrize('kind', ['forward', 'aligner'])
def test_port_hdf5_export_loads_into_jax(kind, forward_pair, aligner_pair, tmp_path):
    jm, tm = _pair(kind, forward_pair, aligner_pair)
    tm.save_model(tmp_path, weights_format='hdf5')
    assert (tmp_path / 'model_weights.hdf5').exists()
    assert not (tmp_path / 'model_weights.npz').exists()
    back = (JFT if kind == 'forward' else JAligner).load_model(tmp_path)
    _assert_flat_equal(_jax_flat(back), params_to_jax(tm.state_dict()))
    _assert_flat_equal(_jax_flat(back), _jax_flat(jm))
    ref, out = _predict_pair(kind, back, tm)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=MEL_ATOL, rtol=0)


# ------------------------------------------------- JAX writes, the port reads

def test_jax_hdf5_only_aligner_dir_loads_into_port(aligner_pair, tmp_path):
    jm, _ = aligner_pair
    jm.save_model(tmp_path, weights_format='hdf5')
    assert not (tmp_path / 'model_weights.npz').exists()
    tm = TAligner.load_model(tmp_path, device='cpu')
    _assert_flat_equal(params_to_jax(tm.state_dict()), _jax_flat(jm))
    tokens, mel = ragged_batch(tm.text_pipeline.tokenizer.vocab_size)
    inp = np.ascontiguousarray(mel[:, :-1])
    ref = jm.apply(jm.params, jax.numpy.asarray(tokens.astype(np.int32)),
                   jax.numpy.asarray(inp), 1)
    with torch.no_grad():
        out = tm.apply(torch.from_numpy(tokens), torch.from_numpy(inp), 1)
    for key in ('mel', 'linear', 'stop_prob'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=ALIGNER_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize('rate_first', [False, True], ids=['rate-last', 'rate-first'])
def test_legacy_messy_aligner_file_matches_jax_converter(aligner_pair, tmp_path, rate_first):
    """Keras's auto-names and block tags, with DecoderPrenet's rate Variable
    last in its group or moved to the front."""
    jm, _ = aligner_pair
    flat = _jax_flat(jm)

    def mutate(lname, items):
        return [items[-1]] + items[:-1] if rate_first and lname == 'DecoderPrenet' else items

    path = _config_only_dir(jm, tmp_path) / 'model_weights.hdf5'
    _write_messy_h5(path, jconvert.aligner_legacy_skeleton(jm.config), flat,
                    LAYER_NAMES['aligner'], mutate=mutate)
    port = TAligner.load_model(tmp_path, device='cpu')
    reference = JAligner.from_config(jm.config)
    jconvert.load_legacy_weights_into(reference, path)
    _assert_flat_equal(params_to_jax(port.state_dict()), _jax_flat(reference))
    _assert_flat_equal(params_to_jax(port.state_dict()), flat)


def _write_keras3_aligner_h5(path, flat: dict, n_enc: int, n_dec: int, named: bool,
                             with_scalar: bool = True):
    """The Aligner's weights in the Keras-3 ``.weights.h5`` layout that
    ``convert_aligner_weights`` reads: the encoder's ``encoder_SADB`` stack,
    the decoder's ``CADB`` stack and separate ``last_CADB``, and either the
    attribute names (``decoder_prenet``, ``decoder_postnet``,
    ``final_proj_mel``) or the class names (``DecoderPrenet``, ``Postnet``,
    the loose Dense under ``layers/``)."""
    def dense(f, group, p):
        f[f'{group}/vars/0'] = flat[f'{p}/kernel']
        f[f'{group}/vars/1'] = flat[f'{p}/bias']

    def ln(f, group, p):
        f[f'{group}/vars/0'] = flat[f'{p}/gamma']
        f[f'{group}/vars/1'] = flat[f'{p}/beta']

    def mha(f, group, p):
        for mine, theirs in (('wq', 'wq'), ('wk', 'wk'), ('wv', 'wv'), ('wo', 'dense')):
            dense(f, f'{group}/{theirs}', f'{p}/{mine}')

    def ffn(f, group, p):
        dense(f, f'{group}/d1', f'{p}/d1')
        dense(f, f'{group}/d2', f'{p}/d2')
        ln(f, f'{group}/last_ln', f'{p}/ln')

    def sarn(f, group, p):
        mha(f, f'{group}/sarn/mha', f'{p}/sarn/mha')
        ln(f, f'{group}/sarn/last_ln', f'{p}/sarn/ln')

    def cadb(f, group, p):
        sarn(f, group, p)
        mha(f, f'{group}/carn/mha', f'{p}/carn/mha')
        ln(f, f'{group}/carn/layernorm', f'{p}/carn/ln')
        ffn(f, f'{group}/ffn', f'{p}/ffn')

    with h5py.File(path, 'w') as f:
        f['encoder_prenet/vars/0'] = flat['encoder_prenet/table']
        for root in ('encoder', 'decoder'):
            ln(f, f'{root}/layernorm', f'{root}/ln')
            if with_scalar:
                f[f'{root}/pos_encoding_scalar'] = flat[f'{root}/pos_encoding_scalar']
        for i, g in enumerate(_keras3_groups('encoder/encoder_SADB/',
                                             ['self_attention_dense_block'] * n_enc)):
            sarn(f, g, f'encoder/dense_{i}')
            ffn(f, f'{g}/ffn', f'encoder/dense_{i}/ffn')
        for i, g in enumerate(_keras3_groups('decoder/CADB/',
                                             ['cross_attention_dense_block'] * (n_dec - 1))):
            cadb(f, g, f'decoder/block_{i}')
        cadb(f, 'decoder/last_CADB', f'decoder/block_{n_dec - 1}')
        prenet, postnet = ('decoder_prenet', 'decoder_postnet') if named else \
            ('DecoderPrenet', 'Postnet')
        dense(f, f'{prenet}/d1', 'decoder_prenet/d1')
        dense(f, f'{prenet}/d2', 'decoder_prenet/d2')
        dense(f, f'{postnet}/stop_linear', 'decoder_postnet/stop_linear')
        dense(f, f'{postnet}/mel_out', 'decoder_postnet/mel_out')
        dense(f, 'final_proj_mel' if named else 'layers/dense', 'final_proj_mel')


@pytest.mark.parametrize('named', [True, False], ids=['attribute-names', 'class-names'])
def test_keras3_aligner_layout_matches_jax_converter(aligner_pair, tmp_path, named):
    """A Keras-3 Aligner file gives the JAX converter's parameters; without
    ``pos_encoding_scalar`` (the class-name case) the scalars are 1."""
    jm, _ = aligner_pair
    flat = _jax_flat(jm)
    path = _config_only_dir(jm, tmp_path) / 'aligner.weights.h5'
    _write_keras3_aligner_h5(path, flat, len(jm.config['encoder_num_heads']),
                             len(jm.config['decoder_num_heads']), named, with_scalar=named)
    port = TAligner.load_model(tmp_path, device='cpu')
    want = flatten_params(jconvert.convert_aligner_weights(jconvert._read_h5_flat(path)))
    _assert_flat_equal(params_to_jax(port.state_dict()), want)
    if not named:
        flat = {**flat, **{f'{r}/pos_encoding_scalar': np.float32(1.0)
                           for r in ('encoder', 'decoder')}}
    _assert_flat_equal(params_to_jax(port.state_dict()), flat)


# ----------------------------------------------------------- the same files

def _report_files(kind, jm, tm, tmp_path):
    """(path, skeleton's layer names) of the files both reports read: the
    port's own export and a messy legacy file, plus a Keras-3 Aligner."""
    export = tmp_path / 'export'
    tm.save_model(export, weights_format='hdf5')
    skeleton = (jconvert.forward_legacy_skeleton if kind == 'forward'
                else jconvert.aligner_legacy_skeleton)(jm.config)
    messy = tmp_path / 'messy.hdf5'
    _write_messy_h5(messy, skeleton, _jax_flat(jm), LAYER_NAMES[kind])
    files = [export / 'model_weights.hdf5', messy]
    if kind == 'aligner':
        files.append(tmp_path / 'aligner.weights.h5')
        _write_keras3_aligner_h5(files[-1], _jax_flat(jm), len(jm.config['encoder_num_heads']),
                                 len(jm.config['decoder_num_heads']), named=True)
    return files


@pytest.mark.parametrize('kind', ['forward', 'aligner'])
def test_describe_weight_match_equals_jax_report(kind, forward_pair, aligner_pair, tmp_path):
    jm, tm = _pair(kind, forward_pair, aligner_pair)
    for path in _report_files(kind, jm, tm, tmp_path):
        report = convert.describe_weight_match(tm, path)
        assert report == jconvert.describe_weight_match(jm, path), path.name
        assert len(report) > 0


def _read_file(path) -> list:
    """[(group, weight names, arrays)] of a legacy hdf5 file, in its order."""
    groups, names, layer_names = jconvert.read_legacy_h5(path)
    return list(zip(layer_names, names, groups))


@pytest.mark.parametrize('bare', [True, False], ids=['bare-variables', 'keras3-consumer'])
@pytest.mark.parametrize('kind', ['forward', 'aligner'])
def test_written_file_equals_jax_writer(kind, bare, forward_pair, aligner_pair, tmp_path):
    """The port's writer gives the JAX writer's file for the same weights:
    layer and weight names in the same order, arrays bit for bit; with
    ``include_bare_variables=False`` neither writes DecoderPrenet's rate nor
    a ``pos_encoding_scalar``."""
    jm, tm = _pair(kind, forward_pair, aligner_pair)
    mine, theirs = tmp_path / 'port.hdf5', tmp_path / 'jax.hdf5'
    convert.write_legacy_h5(tm, mine, include_bare_variables=bare)
    jconvert.write_legacy_h5(jm, theirs, include_bare_variables=bare)
    got, want = _read_file(mine), _read_file(theirs)
    assert [(g, n) for g, n, _ in got] == [(g, n) for g, n, _ in want]
    for (group, names, arrays), (_, _, ref) in zip(got, want):
        for name, a, b in zip(names, arrays, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=f'{group}: {name}')
    names = [n for _, group_names, _ in got for n in group_names]
    bare_names = [n for n in names if n.endswith(('/rate:0', '/pos_encoding_scalar:0'))]
    if bare:
        assert len(bare_names) == (2 if kind == 'forward' else 3)
    else:
        assert not bare_names


# ------------------------------------------------------------ weights_format

@pytest.mark.parametrize('kind', ['forward', 'aligner'])
def test_both_formats_round_trip_and_the_hdf5_alone(kind, forward_pair, aligner_pair, tmp_path):
    _, tm = _pair(kind, forward_pair, aligner_pair)
    tm.step = 321
    tm.save_model(tmp_path, weights_format='both')
    want = params_to_jax(tm.state_dict())
    loaded = _port_cls(kind).load_model(tmp_path, device='cpu')
    assert loaded.step == 321
    _assert_flat_equal(params_to_jax(loaded.state_dict()), want)
    (tmp_path / 'model_weights.npz').unlink()
    loaded = _port_cls(kind).load_model(tmp_path, device='cpu')
    assert loaded.step == 321
    _assert_flat_equal(params_to_jax(loaded.state_dict()), want)


@pytest.mark.parametrize('kind', ['forward', 'aligner'])
def test_unknown_weights_format_raises_and_npz_needs_no_h5py(kind, forward_pair, aligner_pair,
                                                             tmp_path, monkeypatch):
    _, tm = _pair(kind, forward_pair, aligner_pair)
    with pytest.raises(ValueError, match='weights_format'):
        tm.save_model(tmp_path / 'h5', weights_format='h5')
    assert not (tmp_path / 'h5').exists()
    monkeypatch.setitem(sys.modules, 'h5py', None)
    tm.save_model(tmp_path / 'npz')
    assert sorted(p.name for p in (tmp_path / 'npz').iterdir()) == ['config.yaml',
                                                                    'model_weights.npz']
    loaded = _port_cls(kind).load_model(tmp_path / 'npz', device='cpu')
    _assert_flat_equal(params_to_jax(loaded.state_dict()), params_to_jax(tm.state_dict()))
    with pytest.raises(ImportError):
        tm.save_model(tmp_path / 'hdf5', weights_format='hdf5')


def test_load_reference_checkpoint_picks_the_hdf5(forward_pair, tmp_path):
    """``load_reference_checkpoint`` reads ``model_weights.hdf5`` beside an
    hdf5 file that sorts first, and carries the config's step."""
    jm, tm = forward_pair
    jm.step = 95
    jm.save_model(tmp_path, weights_format='both')
    jm.step = 0
    (tmp_path / 'model_weights.npz').rename(tmp_path / 'a_model_weights.npz')
    (tmp_path / 'a_stale.hdf5').write_bytes(b'not hdf5')
    model = convert.load_reference_checkpoint(tmp_path, device='cpu')
    assert model.step == 95 and model.device.type == 'cpu'
    _assert_flat_equal(params_to_jax(model.state_dict()), _jax_flat(jm))


# ----------------------------------------------------------- the CLI report

def test_verify_checkpoint_prints_one_line_a_weighted_layer(forward_pair, tmp_path):
    _, tm = forward_pair
    tm.save_model(tmp_path, weights_format='hdf5')
    out = subprocess.run([sys.executable, '-m', 'transformertts_torch.verify_checkpoint',
                          str(tmp_path), '--device', 'cpu'], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = [l for l in out.stdout.splitlines() if ' -> ' in l]
    # 'expand' carries no weights: 7 of the ForwardTransformer's 8 layers
    assert len(report) == len(LAYER_NAMES['forward']) - 1
    assert [l.split()[0] for l in report] == [n for n in LAYER_NAMES['forward'] if n != 'expand']
    assert 'conversion OK' in out.stdout and 'finite=True' in out.stdout
    assert 'device cpu' in out.stdout

