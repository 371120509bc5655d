"""The fused log-mel frontend of the port (K5): plain version vs the JAX
kernel, the kernel's host layout, and the CUDA kernel vs the plain version.

On the CPU ``fused_log_mel`` runs ``fused_log_mel_plain``; it is held against
the JAX Pallas kernel in interpret mode and against the JAX
``spectral.mel_spectrogram(center=False)`` at the bar of the JAX kernel's own
test (``tests/test_stft_pallas.py``: atol 2e-4, rtol 1e-3 on the log-mel).
The port's ``spectral.mel_spectrogram`` matches the JAX one to 1e-5 relative
(float32 GEMMs on both sides, summed in other orders).

The kernel runs only on a card: those tests carry the ``cuda`` marker and
skip without one. JAX is imported inside the parity tests only, so on a
machine with a card and no JAX this file runs as
``python -m pytest --noconftest -m cuda tests/test_torch_log_mel.py``.
"""
import numpy as np
import pytest
import torch

from transformertts_torch.audio import spectral
from transformertts_torch.ops.fused_log_mel import (fused_log_mel, fused_log_mel_plain,
                                                    kernel_layout)

torch.set_num_threads(1)

SR = 22050
TOL = dict(atol=2e-4, rtol=1e-3)   # the JAX fused kernel's own bar
F_MIN, F_MAX = 0, 8000

# (batch, clip samples, n_fft, hop, win_length, n_mels)
CASES = {
    'jax-test-sizes': (1, SR // 2, 512, 128, 512, 20),
    'published': (1, SR, 1024, 256, 1024, 80),
    'batched': (3, SR // 4, 512, 128, 512, 20),
    'win-lt-n_fft': (2, SR // 2, 1024, 256, 800, 80),
    'ragged-frames-hop-300': (2, 20000, 1024, 300, 1024, 80),
}


def _centered(b, n, n_fft, seed=0):
    """(b, n + n_fft) reflect-centred noise clips, made with numpy."""
    wav = np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32) * 0.3
    return np.pad(wav, ((0, 0), (n_fft // 2, n_fft // 2)), mode='reflect')


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_matches_jax_kernel_and_reference(case):
    import jax.numpy as jnp
    from transformertts_tpu.audio import spectral as jspectral
    from transformertts_tpu.ops.stft_pallas import fused_log_mel as jfused
    b, n, n_fft, hop, win, mels = CASES[case]
    centered = _centered(b, n, n_fft)
    args = (SR, n_fft, hop, win, mels, F_MIN, F_MAX)
    out = fused_log_mel(torch.from_numpy(centered), *args).numpy()
    assert out.shape == (b, 1 + n // hop, mels)
    np.testing.assert_allclose(out, fused_log_mel_plain(torch.from_numpy(centered),
                                                        *args).numpy())
    ref = np.asarray(jspectral.mel_spectrogram(jnp.asarray(centered), *args, center=False))
    np.testing.assert_allclose(out, np.log(np.clip(ref, 1e-5, None)), **TOL)
    pallas = np.asarray(jfused(jnp.asarray(centered), *args, interpret=True))
    np.testing.assert_allclose(out, pallas, **TOL)


@pytest.mark.parametrize('center', [True, False])
def test_mel_spectrogram_matches_jax(center):
    import jax.numpy as jnp
    from transformertts_tpu.audio import spectral as jspectral
    wav = np.random.default_rng(1).standard_normal((2, SR // 2)).astype(np.float32) * 0.3
    args = (SR, 1024, 256, 1024, 80, F_MIN, F_MAX)
    mine = spectral.mel_spectrogram(torch.from_numpy(wav), *args, center=center).numpy()
    ref = np.asarray(jspectral.mel_spectrogram(jnp.asarray(wav), *args, center=center))
    assert mine.shape == ref.shape
    np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize('case', sorted(CASES))
def test_kernel_layout_recomputes_the_plain_log_mel(case):
    """What the kernel computes from its host layout, in torch: each 128-bin
    basis tile's magnitudes folded into each mel through its nonzero band.
    Bins without mel weight are left out, so this must equal the full
    transform."""
    b, n, n_fft, hop, win, mels = CASES[case]
    centered = torch.from_numpy(_centered(b, n, n_fft, seed=2))
    layout = kernel_layout('cpu', SR, n_fft, win, mels, F_MIN, F_MAX)
    fb = spectral.mel_filterbank(SR, n_fft, mels, F_MIN, F_MAX)
    used = np.flatnonzero((fb != 0).any(axis=0))
    assert (layout.k_lo, layout.k_hi) == (used[0], used[-1] + 1)
    assert layout.basis.shape == (-(-(layout.k_hi - layout.k_lo) // 128), n_fft, 256)
    frames = centered.unfold(-1, n_fft, hop)
    mel = torch.zeros(*frames.shape[:2], mels)
    for t in range(layout.basis.shape[0]):
        re, im = frames @ layout.basis[t, :, :128], frames @ layout.basis[t, :, 128:]
        mag = torch.sqrt(re * re + im * im + 1e-30)
        k0 = layout.k_lo + t * 128
        for m in range(mels):
            lo, hi = max(int(layout.bands[m, 0]), k0), min(int(layout.bands[m, 1]), k0 + 128)
            if lo < hi:
                mel[..., m] += mag[..., lo - k0:hi - k0] @ layout.fb[m, lo:hi]
            assert not fb[m, :int(layout.bands[m, 0])].any()
            assert not fb[m, int(layout.bands[m, 1]):].any()
    mine = torch.log(torch.clamp(mel, min=1e-5))
    want = fused_log_mel_plain(centered, SR, n_fft, hop, win, mels, F_MIN, F_MAX)
    torch.testing.assert_close(mine, want, **TOL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernel_matches_plain_on_card(cuda, case):
    b, n, n_fft, hop, win, mels = CASES[case]
    centered = torch.from_numpy(_centered(b, n, n_fft)).to(cuda)
    args = (SR, n_fft, hop, win, mels, F_MIN, F_MAX)
    before = fused_log_mel.launches
    out = fused_log_mel(centered, *args)
    torch.cuda.synchronize()
    assert fused_log_mel.launches == before + 1
    torch.testing.assert_close(out, fused_log_mel_plain(centered, *args), **TOL)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    wav = torch.zeros(2, 4096, device=cuda)
    args = (SR, 1024, 256, 1024, 80, F_MIN, F_MAX)
    with pytest.raises(TypeError):
        fused_log_mel(wav.double(), *args)
    with pytest.raises(ValueError):
        fused_log_mel(wav[:, ::2], *args)
    with pytest.raises(ValueError):
        fused_log_mel(wav[:, :512], *args)
    with pytest.raises(ValueError):
        fused_log_mel(wav, SR, 1000, 250, 1000, 80, F_MIN, F_MAX)
    # a wav span of 63·hop + n_fft floats over a block's shared memory
    with pytest.raises(RuntimeError, match='hop 4096, n_fft 1024'):
        fused_log_mel(wav, SR, 1024, 4096, 1024, 80, F_MIN, F_MAX)
