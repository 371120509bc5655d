"""ForwardTransformer: the port against the JAX package on the tiny config
(and ``predict`` once at the published width), float32, the same weights
through the shared model dir.

Bars: encoder durations and pitch within 1e-4; rounded durations equal;
``predict`` mel MAE < 1e-4, the bar the JAX package holds against the TF
reference; the kernel path (``need_weights=False``) equal to the eager path
within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_nn import jax_and_port_models

torch.set_num_threads(1)

SENTENCES = ['The quick brown fox jumps over the lazy dog.',
             'Please call Stella.']


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return jax_and_port_models(tmp_path_factory.mktemp('tiny'))


def _tokens(jm, texts):
    toks = [jm.encode_text(t) for t in texts]
    out = np.zeros((len(toks), 64), np.int32)
    for i, t in enumerate(toks):
        out[i, :len(t)] = t
    return out


def test_encode_matches(models):
    jm, tm = models
    tok = _tokens(jm, SENTENCES)
    j = jm.encode(jm.params, jnp.asarray(tok))
    t = tm.encode(torch.from_numpy(tok).long())
    for key in ('durations', 'pitch', 'features'):
        np.testing.assert_allclose(t[key].detach().numpy(), np.asarray(j[key]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(torch.round(t['durations']).detach().numpy(),
                                  np.round(np.asarray(j['durations'])))


def test_apply_with_weights_matches(models):
    jm, tm = models
    tok = _tokens(jm, SENTENCES)
    j = jm.apply(jm.params, jnp.asarray(tok), max_frames=256)
    t = tm.apply(torch.from_numpy(tok).long(), max_frames=256, need_weights=True)
    np.testing.assert_allclose(t['mel'].detach().numpy(), np.asarray(j['mel']), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t['expanded_mask'].numpy(), np.asarray(j['expanded_mask']))
    for group in ('encoder_attention', 'decoder_attention'):
        assert t[group].keys() == j[group].keys()
        for name in j[group]:
            np.testing.assert_allclose(t[group][name].detach().numpy(),
                                       np.asarray(j[group][name]), atol=1e-5, rtol=0)


def test_apply_with_targets_and_masks_matches(models):
    """The training-time inputs of apply: target durations and pitch, the
    duration scalar and the per-phoneme min/max masks."""
    jm, tm = models
    tok = _tokens(jm, SENTENCES)
    rng = np.random.default_rng(5)
    args = dict(target_durations=rng.uniform(0, 4, (2, 64, 1)).astype(np.float32),
                target_pitch=rng.standard_normal((2, 64, 1)).astype(np.float32),
                max_durations_mask=np.full((2, 64), 3.0, np.float32),
                min_durations_mask=np.full((2, 64), 1.0, np.float32))
    j = jm.apply(jm.params, jnp.asarray(tok), 256, durations_scalar=1.5,
                 **{k: jnp.asarray(v) for k, v in args.items()})
    t = tm.apply(torch.from_numpy(tok).long(), 256, durations_scalar=1.5,
                 **{k: torch.from_numpy(v) for k, v in args.items()})
    np.testing.assert_allclose(t['mel'].detach().numpy(), np.asarray(j['mel']), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t['expanded_mask'].numpy(), np.asarray(j['expanded_mask']))


def test_kernel_path_decode_equals_weights_path(models):
    jm, tm = models
    tok = torch.from_numpy(_tokens(jm, SENTENCES)).long()
    with torch.inference_mode():
        enc = tm.encode(tok)
        use = enc['durations'][:, :, 0] * enc['keep_mask'][:, :, 0]
        fused = tm.decode(enc['features'], use, 256, need_weights=False)
        eager = tm.decode(enc['features'], use, 256, need_weights=True)
    assert fused['decoder_attention'] == {}
    torch.testing.assert_close(fused['mel'], eager['mel'], atol=1e-5, rtol=0)


@pytest.mark.parametrize('options', [
    {},
    {'speed_regulator': 1.3},
    {'phoneme_max_duration': {'ð': 1.0, 'ə': 2.0}, 'phoneme_min_duration': {'k': 3.0}},
    {'phoneme_durations': np.arange(1, 65) % 5, 'phoneme_pitch': np.linspace(-1, 1, 64)},
], ids=['plain', 'speed', 'min-max-masks', 'explicit-durations-pitch'])
def test_predict_mel_mae_under_1e4(models, options):
    jm, tm = models
    j = jm.predict(SENTENCES[0], **options)
    t = tm.predict(SENTENCES[0], **options)
    assert t['mel'].shape == j['mel'].shape
    assert np.abs(t['mel'] - np.asarray(j['mel'])).mean() < 1e-4
    np.testing.assert_allclose(t['duration'], np.asarray(j['duration']), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t['pitch'], np.asarray(j['pitch']), atol=1e-4, rtol=0)


def test_predict_at_published_width_mae_under_1e4(tmp_path):
    """The published LJSpeech width and depth (d=384, 6+6 blocks, d_head
    192) that chip_smoke.py runs on the card, here in float32 on the CPU."""
    from chip_smoke import PUBLISHED
    jm, tm = jax_and_port_models(tmp_path, seed=0, **{**PUBLISHED, 'compute_dtype': 'float32'})
    j = jm.predict(SENTENCES[0])
    t = tm.predict(SENTENCES[0])
    assert t['mel'].shape == j['mel'].shape
    assert np.abs(t['mel'] - np.asarray(j['mel'])).mean() < 1e-4
    np.testing.assert_allclose(t['duration'], np.asarray(j['duration']), atol=1e-4, rtol=0)


def test_predict_wav_matches(models):
    from transformertts_torch.audio import Audio as TAudio
    from transformertts_tpu.audio import Audio as JAudio
    jm, tm = models
    # two Griffin-Lim iterations, to 5e-4 of the peak: the phase iteration
    # amplifies float32 rounding differences as it runs (1e-6 of the mel
    # becomes ~2e-4 of the peak here; see test_torch_griffinlim.py)
    j_wav, j_mel = jm.predict_wav(SENTENCES[1], JAudio.from_config(jm.config), n_iter=2)
    t_wav, t_mel = tm.predict_wav(SENTENCES[1], TAudio.from_config(tm.config), n_iter=2)
    assert t_wav.shape == j_wav.shape and t_mel.shape == j_mel.shape
    np.testing.assert_allclose(t_mel, np.asarray(j_mel), atol=1e-4, rtol=0)
    j_wav = np.asarray(j_wav)
    np.testing.assert_allclose(t_wav, j_wav, atol=5e-4 * np.abs(j_wav).max(), rtol=0)


def test_bfloat16_forward_close_to_float32(models):
    """bf16 compute on forced durations against f32, relative to the mel's
    spread: the bar chip_smoke.py holds at the published width."""
    from transformertts_torch.models.forward_tts import ForwardTransformer
    jm, tm = models
    bf16 = ForwardTransformer.from_config({**tm.config, 'compute_dtype': 'bfloat16'},
                                          device='cpu')
    bf16.load_state_dict(tm.state_dict())
    tok = torch.from_numpy(_tokens(jm, SENTENCES)).long()
    with torch.inference_mode():
        ref = tm.apply(tok, max_frames=256)
        forced = torch.round(ref['duration'])
        ref = tm.apply(tok, max_frames=256, target_durations=forced)
        out = bf16.apply(tok, max_frames=256, target_durations=forced)
    valid = (1.0 - ref['expanded_mask'][:, 0, 0, :]).bool()
    assert torch.isfinite(out['mel']).all()
    mae = (out['mel'] - ref['mel']).abs()[valid].mean()
    assert mae < 0.05 * ref['mel'][valid].std()
