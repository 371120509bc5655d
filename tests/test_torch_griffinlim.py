"""Mel inversion and Griffin-Lim: the port against the JAX package, float32.

Griffin-Lim's phase iteration amplifies rounding: inputs that agree to 1e-7
give waveforms that part by ~1e-4 of their peak after two iterations and
~1e-2 after 32. So per-sample parity is held at a few iterations, and at 32
iterations the two are compared by spectral convergence, the quality
measure of the JAX package's DSP fidelity harness.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformertts_torch.audio import Audio as TAudio
from transformertts_torch.audio import griffinlim as tg
from transformertts_tpu.audio import Audio as JAudio
from transformertts_tpu.audio import griffinlim as jg
from transformertts_tpu.audio import spectral as jspectral

torch.set_num_threads(1)

SR, N_FFT, HOP, WIN = 22050, 1024, 256, 1024


@pytest.fixture(scope='module')
def magnitudes():
    """Linear magnitudes (2, 40, 513) from random log-mels, via the JAX inversion."""
    rng = np.random.default_rng(0)
    amp = np.exp(rng.standard_normal((2, 40, 80)).astype(np.float32) - 3.0)
    return amp, np.array(jg.mel_to_linear(jnp.asarray(amp), SR, N_FFT, 0, 8000))


def _jax_gl(S, n_iter):
    return np.stack([np.asarray(jg.griffin_lim(jnp.asarray(s), n_iter, N_FFT, HOP, WIN))
                     for s in S])


def _spectral_convergence(wav, S):
    """‖S − |STFT(wav)|‖ / ‖S‖ over the frames Griffin-Lim reconstructed."""
    rebuilt = np.abs(jspectral.stft_np(wav, N_FFT, HOP, WIN))[:S.shape[0]]
    return np.linalg.norm(S - rebuilt) / np.linalg.norm(S)


def test_mel_to_linear_matches(magnitudes):
    amp, S_jax = magnitudes
    S = tg.mel_to_linear(torch.from_numpy(amp), SR, N_FFT, 0, 8000).numpy()
    # relative 1e-4: ten multiplicative NNLS steps compound GEMM rounding
    np.testing.assert_allclose(S, S_jax, rtol=1e-4, atol=1e-5 * np.abs(S_jax).max())


@pytest.mark.parametrize('n_iter', [0, 1, 2])
def test_griffin_lim_matches_per_sample(magnitudes, n_iter):
    _, S = magnitudes
    wav = tg.griffin_lim(torch.from_numpy(S), n_iter, N_FFT, HOP, WIN).numpy()
    ref = _jax_gl(S, n_iter)
    assert wav.shape == ref.shape == (2, HOP * (S.shape[1] - 1))
    np.testing.assert_allclose(wav, ref, rtol=0, atol=2e-4 * np.abs(ref).max())


def test_griffin_lim_32_iterations_converges_like_jax(magnitudes):
    _, S = magnitudes
    wav = tg.griffin_lim(torch.from_numpy(S), 32, N_FFT, HOP, WIN).numpy()
    ref = _jax_gl(S, 32)
    for row in range(2):
        sc_port = _spectral_convergence(wav[row], S[row])
        sc_jax = _spectral_convergence(ref[row], S[row])
        # the same algorithm converges to the same quality: within 2% of
        # the JAX value, far below the gap to zero-iteration quality
        assert abs(sc_port - sc_jax) < 0.02 * sc_jax, (sc_port, sc_jax)
        assert sc_port < 0.9 * _spectral_convergence(_jax_gl(S[row:row + 1], 0)[0], S[row])


@pytest.mark.parametrize('n_fft, hop', [(256, 64), (2048, 512), (1024, 1024)])
def test_plain_version_matches_jax(n_fft, hop):
    """The FFT kernel's plain version (what a CPU tensor runs) against the JAX
    package at the kernel's smallest and largest FFT and a hop with no
    overlap, per sample at two iterations, at this file's bar."""
    from transformertts_torch.ops.griffin_lim import griffin_lim_plain
    S = np.abs(np.random.default_rng(n_fft + hop).standard_normal(
        (2, 30, n_fft // 2 + 1))).astype(np.float32)
    wav = griffin_lim_plain(torch.from_numpy(S), 2, n_fft, hop, n_fft).numpy()
    ref = np.stack([np.asarray(jg.griffin_lim(jnp.asarray(s), 2, n_fft, hop, n_fft))
                    for s in S])
    assert wav.shape == ref.shape == (2, hop * 29)
    np.testing.assert_allclose(wav, ref, rtol=0, atol=2e-4 * np.abs(ref).max())


def test_griffin_lim_batch_rows_are_independent(magnitudes):
    _, S = magnitudes
    batch = tg.griffin_lim(torch.from_numpy(S), 4, N_FFT, HOP, WIN)
    single = tg.griffin_lim(torch.from_numpy(S[1:]), 4, N_FFT, HOP, WIN)
    torch.testing.assert_close(batch[1:], single, atol=1e-5, rtol=1e-5)


def test_griffin_lim_refuses_hops_that_do_not_tile_n_fft():
    """It no longer refuses them: a hop that does not tile n_fft takes the
    gather form, as in the JAX package, and gives (B, hop·(frames − 1))."""
    wav = tg.griffin_lim(torch.ones(1, 10, 257), 2, 512, 200, 512)
    assert wav.shape == (1, 200 * 9) and torch.isfinite(wav).all()


@pytest.mark.parametrize('n_iter', [0, 2, 32])
def test_griffin_lim_gather_path_matches_jax(magnitudes, n_iter):
    """Hop 300 with n_fft 1024: the gather form (JAX
    ``_griffin_lim_general``), at this file's bars."""
    _, S = magnitudes
    hop = 300
    wav = tg.griffin_lim(torch.from_numpy(S), n_iter, N_FFT, hop, WIN).numpy()
    ref = np.stack([np.asarray(jg.griffin_lim(jnp.asarray(s), n_iter, N_FFT, hop, WIN))
                    for s in S])
    assert wav.shape == ref.shape == (2, hop * (S.shape[1] - 1))
    if n_iter <= 2:
        np.testing.assert_allclose(wav, ref, rtol=0, atol=2e-4 * np.abs(ref).max())
        return
    for row in range(2):
        rebuilt = [np.abs(jspectral.stft_np(w, N_FFT, hop, WIN))[:S.shape[1]]
                   for w in (wav[row], ref[row])]
        sc_port, sc_jax = (np.linalg.norm(S[row] - r) / np.linalg.norm(S[row])
                           for r in rebuilt)
        assert abs(sc_port - sc_jax) < 0.02 * sc_jax, (sc_port, sc_jax)


def test_stft_istft_match_jax():
    from transformertts_torch.audio import spectral as tspectral
    y = np.random.default_rng(3).standard_normal((2, 6000)).astype(np.float32)
    re, im = tspectral.stft(torch.from_numpy(y), N_FFT, 300, WIN)
    j = [jspectral.stft(jnp.asarray(row), N_FFT, 300, WIN) for row in y]
    for mine, ref in ((re, [r for r, _ in j]), (im, [i for _, i in j])):
        np.testing.assert_allclose(mine.numpy(), np.stack(ref), rtol=0, atol=2e-4)
    wav = tspectral.istft(re, im, N_FFT, 300, WIN).numpy()
    ref = np.stack([np.asarray(jspectral.istft(r, i, N_FFT, 300, WIN)) for r, i in j])
    np.testing.assert_allclose(wav, ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize('normalizer', ['MelGAN', 'WaveRNN'])
def test_normalizers_match(normalizer):
    config = dict(sampling_rate=SR, n_fft=N_FFT, mel_channels=80, hop_length=HOP,
                  win_length=WIN, f_min=0, f_max=8000, normalizer=normalizer)
    tn, jn = TAudio(**config).normalizer, JAudio(**config).normalizer
    amp = np.exp(np.random.default_rng(1).uniform(-14, 3, (5, 80))).astype(np.float32)
    norm = jn.normalize(amp)
    np.testing.assert_allclose(tn.normalize(torch.from_numpy(amp)).numpy(), norm,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.normalize(amp), norm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.denormalize(torch.from_numpy(norm)).numpy(),
                               jn.denormalize(norm), rtol=1e-5)


def test_reconstruct_waveform_matches():
    config = dict(sampling_rate=SR, n_fft=N_FFT, mel_channels=80, hop_length=HOP,
                  win_length=WIN, f_min=0, f_max=8000, normalizer='MelGAN')
    mel = np.random.default_rng(2).standard_normal((30, 80)).astype(np.float32) - 3.0
    ref = JAudio(**config).reconstruct_waveform(mel, n_iter=2)
    # the reference's (mels, frames) orientation is accepted too
    wav = TAudio(**config).reconstruct_waveform(mel.T, device='cpu', n_iter=2)
    np.testing.assert_allclose(wav, ref, rtol=0, atol=2e-4 * np.abs(ref).max())
