"""The port's neural vocoders (MelGAN, HiFi-GAN) against the JAX package's, on the CPU.

Two routes carry the same weights into both packages: one upstream-layout
torch checkpoint (weight-norm pairs, built by the JAX tests' torch
references of the seungwonpark/melgan and jik876/hifi-gan generators)
loaded by each package's converter, and the JAX generator's
``init_params`` carried over by the port's ``from_jax_params``. Float32
throughout, at the 2e-5 bar of the JAX package's own vocoder tests.

Random weights at the initialisers' scale give almost no signal: the deep
stacks shrink it layer by layer, MelGAN's at rates (8, 8, 2, 2) to peaks
near 1e-7, far under every bar here, where a comparison would pass
silence. So each test draws its generators with their conv weights scaled
by a gain that puts the output at speech level, and every comparison first
asserts that its reference peaks a hundredfold above the bar.

Serving with a vocoder (``synthesize_lines(vocoder=...)``, ``predict_tts
--vocoder``) runs the tiny ForwardTransformer of ``test_torch_nn`` with its
duration head's bias raised, so both packages predict whole frames (the JAX
serving path trims a line whose durations all round to zero to nothing).
The JAX side ships PCM16, so its wavs sit within 1/32767 of the float.
"""
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_hifigan import _TorchHiFiGAN
from test_melgan import _TorchGenerator
from test_torch_nn import TINY_CONFIG
from transformertts_torch.audio import Audio as TAudio
from transformertts_torch.audio.wav_io import load_wav
from transformertts_torch.models.forward_tts import ForwardTransformer as TFT
from transformertts_torch.models.hifigan import HiFiGANVocoder as THiFiGAN
from transformertts_torch.models.melgan import LOG_MEL_SILENCE, MelGANVocoder as TMelGAN
from transformertts_torch.models.synthesis import synthesize_lines as t_synthesize
from transformertts_torch.models.vocoder import load_vocoder, unwrap_torch_checkpoint
from transformertts_tpu.audio import Audio as JAudio
from transformertts_tpu.models.forward_tts import ForwardTransformer as JFT
from transformertts_tpu.models.hifigan import HiFiGANVocoder as JHiFiGAN
from transformertts_tpu.models.melgan import MelGANVocoder as JMelGAN
from transformertts_tpu.models.synthesis import synthesize_lines as j_synthesize

torch.set_num_threads(1)

ATOL = 2e-5  # tests/test_melgan.py and tests/test_hifigan.py pin the JAX side at this
PCM16_STEP = 1.0 / 32767
ROOT = Path(__file__).resolve().parent.parent
LINES = [l for l in (ROOT / 'config' / 'test_sentences.txt').read_text().splitlines()
         if l.strip()]
DURATION_BIAS = 2.0  # the tiny model's durations at about two frames a token

MELGAN_RATES = {'r22': (2, 2), 'r8822': (8, 8, 2, 2)}
# conv-weight gains that bring each seeded generator's output to peaks of
# about 0.1-0.9: upstream checkpoints (torch's initialisers, biases drawn)
# and JAX ``init_params`` (zero biases) shrink the signal at different rates,
# and the tiny model's mels (``served``) sit higher than ``_mel``'s
UPSTREAM_GAIN = {'melgan': 1.5, 'hifigan': 1.3}
JAX_GAIN = {'melgan': 2.0, 'hifigan': 1.8}
SERVED_GAIN = 1.8


def hifigan_config(resblock: str, rates) -> dict:
    return {'resblock': resblock, 'upsample_rates': list(rates),
            'upsample_kernel_sizes': [2 * r for r in rates], 'upsample_initial_channel': 32,
            'resblock_kernel_sizes': [3, 7], 'resblock_dilation_sizes': [[1, 3], [1, 3, 5]]}


HIFIGAN_CONFIGS = {f'type{t}-{name}': hifigan_config(t, rates)
                   for t in ('1', '2') for name, rates in MELGAN_RATES.items()}


def _mel(b, t, seed=0, channels=80):
    return (np.random.default_rng(seed).standard_normal((b, channels, t)) - 4.0).astype(
        np.float32)


def _upstream(module, gain, seed=0):
    """An upstream generator with each weight-norm g drawn around ``gain``
    times its initial ‖v‖, so the fold is exercised and the output is at
    speech level."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith('weight_g'):
                p.mul_(gain * (0.75 + 0.5 * torch.rand(p.shape, generator=gen)))
    return module.eval()


def _upstream_melgan(base, rates, seed=0):
    torch.manual_seed(seed)
    return _upstream(_TorchGenerator(base=base, rates=rates), UPSTREAM_GAIN['melgan'], seed)


def _upstream_hifigan(config, seed=0):
    torch.manual_seed(seed)
    return _upstream(_TorchHiFiGAN(config), UPSTREAM_GAIN['hifigan'], seed)


def _jax_generator(vocoder, seed, gain):
    """A JAX generator's ``init_params(seed)`` with its conv kernels (the
    ``w`` leaves) scaled by ``gain``."""
    vocoder.init_params(jax.random.PRNGKey(seed))
    vocoder.params = jax.tree_util.tree_map_with_path(
        lambda path, x: x * gain if path[-1].key == 'w' else x,
        jax.device_get(vocoder.params))
    return vocoder


def assert_close_at_level(out, ref, atol):
    """``out`` within ``atol`` of ``ref``, whose peak must clear ``atol`` a
    hundredfold, so that silence or a misplaced signal cannot pass."""
    peak = float(np.abs(ref).max())
    assert peak > 100 * atol, f'reference peak {peak} too near the bar {atol}'
    np.testing.assert_allclose(out, ref, atol=atol, rtol=0)


def _port_out(vocoder, mel_bct):
    with torch.no_grad():
        return vocoder(torch.from_numpy(mel_bct.transpose(0, 2, 1))).numpy()


def _jax_out(vocoder, mel_bct):
    return np.asarray(vocoder.apply(vocoder.params, mel_bct.transpose(0, 2, 1)))


# ------------------------------------------------------------- generators

@pytest.mark.parametrize('rates', sorted(MELGAN_RATES))
def test_melgan_one_torch_checkpoint_into_both_packages(rates):
    tg = _upstream_melgan(32, MELGAN_RATES[rates])
    sd = tg.state_dict()
    tv = TMelGAN.from_torch_state_dict(sd, device='cpu')
    jv = JMelGAN.from_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert tv.upsample_rates == jv.upsample_rates == MELGAN_RATES[rates]
    assert tv.base_channels == 32 and tv.hop_length == jv.hop_length
    mel = _mel(2, 17)
    out = _port_out(tv, mel)
    assert out.shape == (2, 17 * tv.hop_length) and out.dtype == np.float32
    assert_close_at_level(out, _jax_out(jv, mel), ATOL)
    with torch.no_grad():
        ref = tg(torch.from_numpy(mel)).numpy()[:, 0]
    assert_close_at_level(out, ref, ATOL)


@pytest.mark.parametrize('rates', sorted(MELGAN_RATES))
def test_melgan_from_jax_params(rates):
    jv = _jax_generator(JMelGAN(base_channels=32, upsample_rates=MELGAN_RATES[rates]), 3,
                        JAX_GAIN['melgan'])
    tv = TMelGAN.from_jax_params(jv.params, device='cpu')
    assert tv.upsample_rates == MELGAN_RATES[rates] and tv.base_channels == 32
    mel = _mel(2, 12, seed=1)
    assert_close_at_level(_port_out(tv, mel), _jax_out(jv, mel), ATOL)
    # bf16 input is computed in float32, as the JAX generator casts it
    mel_bf16 = torch.from_numpy(mel.transpose(0, 2, 1)).bfloat16()
    with torch.no_grad():
        out = tv(mel_bf16)
    assert out.dtype == torch.float32
    assert_close_at_level(out.numpy(), _jax_out(jv, mel_bf16.float().numpy().transpose(
        0, 2, 1)), ATOL)


@pytest.mark.parametrize('name', sorted(HIFIGAN_CONFIGS))
def test_hifigan_one_torch_checkpoint_into_both_packages(name):
    cfg = HIFIGAN_CONFIGS[name]
    tg = _upstream_hifigan(cfg)
    sd = tg.state_dict()
    assert any('.convs.' in k for k in sd) == (cfg['resblock'] == '2')
    tv = THiFiGAN.from_torch_state_dict(sd, cfg, device='cpu')
    jv = JHiFiGAN.from_torch_state_dict({k: v.numpy() for k, v in sd.items()}, config=cfg)
    mel = _mel(2, 19)
    out = _port_out(tv, mel)
    assert out.shape == (2, 19 * tv.hop_length)
    assert_close_at_level(out, _jax_out(jv, mel), ATOL)
    with torch.no_grad():
        ref = tg(torch.from_numpy(mel)).numpy()[:, 0]
    assert_close_at_level(out, ref, ATOL)


@pytest.mark.parametrize('name', sorted(HIFIGAN_CONFIGS))
def test_hifigan_from_jax_params(name):
    cfg = HIFIGAN_CONFIGS[name]
    jv = _jax_generator(JHiFiGAN(config=cfg), 4, JAX_GAIN['hifigan'])
    tv = THiFiGAN.from_jax_params(jv.params, cfg, device='cpu')
    mel = _mel(1, 24, seed=2)
    assert_close_at_level(_port_out(tv, mel), _jax_out(jv, mel), ATOL)


def test_hifigan_checkpoint_shapes_are_checked_against_the_config():
    sd = _upstream_hifigan(HIFIGAN_CONFIGS['type1-r22']).state_dict()
    with pytest.raises(RuntimeError, match='size mismatch'):
        THiFiGAN.from_torch_state_dict(sd, {**HIFIGAN_CONFIGS['type1-r22'],
                                            'upsample_initial_channel': 16}, device='cpu')
    with pytest.raises(RuntimeError, match='convs'):
        THiFiGAN.from_torch_state_dict(sd, HIFIGAN_CONFIGS['type2-r22'], device='cpu')
    with pytest.raises(RuntimeError, match='size mismatch'):
        TMelGAN.from_torch_state_dict(_upstream_melgan(16, (2, 2)).state_dict(),
                                      mel_channels=40, device='cpu')


# --------------------------------------------------------------- inference

@pytest.mark.parametrize('family', ['melgan', 'hifigan'])
def test_inference_orientation_trim_and_channels(family):
    if family == 'melgan':
        sd = _upstream_melgan(16, (2, 2)).state_dict()
        tv = TMelGAN.from_torch_state_dict(sd, device='cpu')
        jv = JMelGAN.from_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    else:
        cfg = HIFIGAN_CONFIGS['type1-r22']
        sd = _upstream_hifigan(cfg).state_dict()
        tv = THiFiGAN.from_torch_state_dict(sd, cfg, device='cpu')
        jv = JHiFiGAN.from_torch_state_dict({k: v.numpy() for k, v in sd.items()}, config=cfg)
    mel = _mel(1, 15, seed=5)[0]
    wav = tv.inference(mel)
    assert wav.shape == (15 * tv.hop_length,) and wav.dtype == np.float32
    assert_close_at_level(wav, jv.inference(mel), ATOL)
    np.testing.assert_allclose(tv.inference(mel[None])[0], wav, atol=1e-6, rtol=0)
    if family == 'melgan':
        # 10 frames of silence go on, and their 10 hops come off again
        padded = np.concatenate([mel, np.full((80, 10), LOG_MEL_SILENCE, np.float32)], 1)
        full = _port_out(tv, padded[None])[0]
        np.testing.assert_array_equal(wav, full[:15 * tv.hop_length])
    with pytest.raises(ValueError, match='80'):
        tv.inference(np.zeros((40, 10), np.float32))


# ----------------------------------------------------------- checkpoints

def _save_melgan(path, wrap: bool):
    sd = _upstream_melgan(16, (2, 2)).state_dict()
    torch.save({'model_g': sd, 'hp_str': 'audio: ...'} if wrap else sd, path)
    return sd


def _save_hifigan(path, wrap: bool, config: dict = None):
    sd = _upstream_hifigan(config or HIFIGAN_CONFIGS['type2-r22']).state_dict()
    torch.save({'generator': sd} if wrap else sd, path)
    return sd


@pytest.mark.parametrize('wrap', [True, False], ids=['trainer', 'bare'])
def test_load_vocoder_detects_melgan(tmp_path, wrap):
    sd = _save_melgan(tmp_path / 'melgan.pt', wrap)
    v = load_vocoder(tmp_path / 'melgan.pt', device='cpu')
    assert isinstance(v, TMelGAN) and v.upsample_rates == (2, 2) and v.hop_length == 4
    ref = TMelGAN.from_torch_state_dict(sd, device='cpu')
    mel = _mel(1, 9)
    np.testing.assert_array_equal(_port_out(v, mel), _port_out(ref, mel))
    same = TMelGAN.from_torch_checkpoint(tmp_path / 'melgan.pt', device='cpu')
    np.testing.assert_array_equal(_port_out(same, mel), _port_out(ref, mel))


@pytest.mark.parametrize('wrap', [True, False], ids=['trainer', 'bare'])
def test_load_vocoder_detects_hifigan_and_reads_config_json(tmp_path, wrap):
    cfg = HIFIGAN_CONFIGS['type2-r22']
    sd = _save_hifigan(tmp_path / 'g_00001000', wrap)
    # without config.json the V1 defaults apply, which this checkpoint does not fit
    with pytest.raises(RuntimeError):
        load_vocoder(tmp_path / 'g_00001000', device='cpu')
    (tmp_path / 'config.json').write_text(json.dumps({**cfg, 'sampling_rate': 22050}))
    v = load_vocoder(tmp_path / 'g_00001000', device='cpu')
    assert isinstance(v, THiFiGAN) and v.resblock_type == '2' and v.hop_length == 4
    ref = THiFiGAN.from_torch_state_dict(sd, cfg, device='cpu')
    mel = _mel(1, 9)
    np.testing.assert_array_equal(_port_out(v, mel), _port_out(ref, mel))
    same = THiFiGAN.from_torch_checkpoint(tmp_path / 'g_00001000', cfg, device='cpu')
    np.testing.assert_array_equal(_port_out(same, mel), _port_out(ref, mel))


def test_unwrap_refuses_a_pickled_module_unless_allowed(tmp_path):
    module = _upstream_melgan(16, (2, 2))
    torch.save(module, tmp_path / 'module.pt')
    with pytest.raises(ValueError, match='allow_pickle=True'):
        unwrap_torch_checkpoint(tmp_path / 'module.pt')
    with pytest.raises(ValueError, match='allow_pickle=True'):
        load_vocoder(tmp_path / 'module.pt', device='cpu')
    sd = unwrap_torch_checkpoint(tmp_path / 'module.pt', allow_pickle=True)
    assert set(sd) == set(module.state_dict())
    assert all(isinstance(v, np.ndarray) for v in sd.values())
    v = load_vocoder(tmp_path / 'module.pt', allow_pickle=True, device='cpu')
    assert isinstance(v, TMelGAN)
    with pytest.raises(FileNotFoundError):
        unwrap_torch_checkpoint(tmp_path / 'missing.pt')


# ----------------------------------------------------------------- serving

def models_with_durations(model_dir, **overrides):
    """The tiny JAX ForwardTransformer with its duration bias at
    ``DURATION_BIAS``, saved to ``model_dir``, and the port's model loaded
    from there on the CPU."""
    jm = JFT(**{**TINY_CONFIG, **overrides})
    jm.init_params(jax.random.PRNGKey(42))
    jm.params['dur_pred']['linear']['bias'] = jax.numpy.full_like(
        jm.params['dur_pred']['linear']['bias'], DURATION_BIAS)
    jm.save_model(model_dir)
    return jm, TFT.load_model(model_dir, device='cpu')


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """The tiny model pair and one vocoder pair of each family (80 mels,
    hop 256), carried from JAX-initialized weights at speech level."""
    jm, tm = models_with_durations(tmp_path_factory.mktemp('tiny'))
    jmel = _jax_generator(JMelGAN(base_channels=32), 1, SERVED_GAIN)
    cfg = hifigan_config('1', (8, 8, 2, 2))
    jhifi = _jax_generator(JHiFiGAN(config=cfg), 2, SERVED_GAIN)
    vocoders = {'melgan': (jmel, TMelGAN.from_jax_params(jmel.params, device='cpu')),
                'hifigan': (jhifi, THiFiGAN.from_jax_params(jhifi.params, cfg, device='cpu'))}
    return jm, tm, vocoders


@pytest.mark.parametrize('family', ['melgan', 'hifigan'])
def test_synthesize_lines_with_vocoder_matches_jax(served, family):
    jm, tm, vocoders = served
    jv, tv = vocoders[family]
    j_wavs = j_synthesize(jm, JAudio.from_config(jm.config), LINES, vocoder=jv)
    t_wavs = t_synthesize(tm, TAudio.from_config(tm.config), LINES, vocoder=tv)
    assert len(t_wavs) == len(j_wavs) == len(LINES)
    # the lines make one chunk: its durations give each wav's length
    toks = [tm.encode_text(l) for l in LINES]
    tok = np.zeros((len(LINES), -(-max(map(len, toks)) // 32) * 32), np.int64)
    for row, t in enumerate(toks):
        tok[row, :len(t)] = t
    with torch.inference_mode():
        use = tm.scaled_durations(tm.encode(torch.as_tensor(tok)), 1.0)
    totals = torch.round(use).sum(dim=1).long().numpy() + 1
    assert [w.size for w in t_wavs] == [max(1, t - 1) * tv.hop_length for t in totals]
    for t, j in zip(t_wavs, j_wavs):
        assert t.shape == j.shape and t.size > 0 and t.dtype == np.float32
        assert np.isfinite(t).all() and np.abs(t).max() <= 1.0
        assert_close_at_level(t, j, PCM16_STEP + 1e-4)


def test_vocoder_path_pads_with_the_vocoder_silence(served):
    """Padding frames reach the vocoder at ``LOG_MEL_SILENCE``, not at the
    normalizer's silence, and the waveform is the vocoder's own output."""
    _, tm, vocoders = served
    seen = []

    def spy(mel):
        seen.append(mel)
        return vocoders['melgan'][1](mel)

    spy.hop_length = vocoders['melgan'][1].hop_length
    with torch.inference_mode():
        tok = torch.as_tensor([tm.encode_text(LINES[2])])
        enc = tm.encode(tok)
        use = tm.scaled_durations(enc, 1.0)
        wav = tm.decode_vocoder(spy, enc['features'], enc['pitch'], use, 256)
    n = int(torch.round(use).sum())
    assert seen[0].dtype == torch.float32 and seen[0].shape == (1, 256, 80)
    assert (seen[0][0, n + 1:] == LOG_MEL_SILENCE).all()
    assert wav.shape == (1, 256 * spy.hop_length)


def test_vocoder_needs_a_melgan_normalized_model(tmp_path, served):
    _, _, vocoders = served
    tm = TFT(**{**TINY_CONFIG, 'normalizer': 'WaveRNN'}).init_params(
        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match='MelGAN-normalized'):
        t_synthesize(tm, TAudio.from_config(tm.config), LINES[:1],
                     vocoder=vocoders['melgan'][1])


def test_empty_line_contract_with_a_vocoder(served):
    """'' and '漢字' tokenize to nothing and give empty wavs in both packages;
    '???' keeps its tokens and gives the same wav."""
    jm, tm, vocoders = served
    jv, tv = vocoders['melgan']
    lines = ['', '???', '漢字']
    j_wavs = j_synthesize(jm, JAudio.from_config(jm.config), lines, vocoder=jv)
    t_wavs = t_synthesize(tm, TAudio.from_config(tm.config), lines, vocoder=tv)
    assert [w.size == 0 for w in t_wavs] == [w.size == 0 for w in j_wavs] == [True, False, True]
    for t, j in zip(t_wavs, j_wavs):
        assert t.dtype == np.float32 and t.shape == j.shape
        if j.size:
            assert_close_at_level(t, j, PCM16_STEP + 1e-4)


def test_zero_durations_keep_one_hop_with_a_vocoder(served):
    """Durations that all round to zero still give each line one hop of the
    vocoder's audio, as the Griffin-Lim path keeps one frame."""
    _, _, vocoders = served
    tv = vocoders['melgan'][1]
    tm = TFT(**TINY_CONFIG).init_params(torch.Generator().manual_seed(5))
    with torch.no_grad():
        tm.dur_pred.linear.bias.fill_(-10.0)
    wavs = t_synthesize(tm, TAudio.from_config(tm.config), LINES, vocoder=tv, max_batch=2)
    assert [w.size for w in wavs] == [tv.hop_length] * len(LINES)


# -------------------------------------------------------------------- CLI

@pytest.fixture
def checkpoints(tmp_path):
    melgan = tmp_path / 'melgan' / 'melgan.pt'
    melgan.parent.mkdir()
    _save_melgan(melgan, wrap=True)
    cfg = hifigan_config('1', (8, 8, 2, 2))
    hifigan = tmp_path / 'hifigan' / 'g_02500000'
    hifigan.parent.mkdir()
    _save_hifigan(hifigan, wrap=True, config=cfg)
    (hifigan.parent / 'config.json').write_text(json.dumps(cfg))
    return {'melgan': melgan, 'hifigan': hifigan}


@pytest.mark.parametrize('batched', [True, False], ids=['batched', 'per_line'])
@pytest.mark.parametrize('family', ['melgan', 'hifigan'])
def test_predict_tts_with_a_vocoder_writes_a_wav(served, checkpoints, tmp_path, family,
                                                  batched):
    from transformertts_torch import predict_tts
    jm, _, _ = served
    model_dir = tmp_path / 'model'
    jm.save_model(model_dir)
    text = tmp_path / 'lines.txt'
    text.write_text('\n'.join(LINES[:2]) + '\n')
    args = ['-p', str(model_dir), '-f', str(text), '-o', str(tmp_path / 'out'), '--vocoder',
            str(checkpoints[family]), '--device', 'cpu']
    predict_tts.main(args + ([] if batched else ['--per_line']))
    wav, sr = load_wav(next((tmp_path / 'out' / 'outputs' / 'lines').glob('*.wav')))
    hop = 4 if family == 'melgan' else 256
    assert sr == 22050 and wav.size > 0 and wav.size % hop == 0
    assert np.isfinite(wav).all() and np.abs(wav).max() > 100 * PCM16_STEP


def test_predict_tts_without_a_path_takes_the_published_model_at_step(
        served, checkpoints, tmp_path, monkeypatch):
    """No -p: ``tts_ljspeech(--step)`` finds the model dir under
    $TRANSFORMERTTS_MODELS_DIR; a step not placed there would download,
    which this test turns into an error naming the dir to fill."""
    from transformertts_torch import predict_tts

    def no_network(url, *args, **kwargs):
        raise OSError(f'no network for {url}')

    monkeypatch.setattr('urllib.request.urlretrieve', no_network)
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    monkeypatch.setenv('TRANSFORMERTTS_MODELS_DIR', str(tmp_path / 'models'))
    jm, _, _ = served
    jm.save_model(tmp_path / 'models' / 'bdf06b9_ljspeech_step_1234')
    args = ['-t', LINES[0], '-o', str(tmp_path / 'out'), '--vocoder',
            str(checkpoints['melgan']), '--device', 'cpu']
    predict_tts.main(['--step', '1234'] + args)
    wav, sr = load_wav(next((tmp_path / 'out' / 'outputs' / 'custom_text').glob('*.wav')))
    assert sr == 22050 and wav.size > 0 and np.isfinite(wav).all()
    with pytest.raises(RuntimeError, match=re.escape(str(tmp_path / "models"))):
        predict_tts.main(['--step', '95000'] + args)
