"""The fused log-mel frontend of the port (K5): plain version vs the JAX
kernel, the kernel's FFT recomputed in numpy from its host layout, and the
CUDA kernel vs the plain version.

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
from transformertts_torch.ops.fused_log_mel import (KERNEL_N_FFT, check_kernel_args,
                                                    fft_passes, fused_log_mel,
                                                    fused_log_mel_plain, kernel_layout,
                                                    kernel_resources)

torch.set_num_threads(1)

SR = 22050
TOL = dict(atol=2e-4, rtol=1e-3)   # the JAX fused kernel's own bar
F_MIN, F_MAX = 0, 8000

# (batch, clip samples, n_fft, hop, win_length, n_mels, f_min, f_max)
CASES = {
    'jax-test-sizes': (1, SR // 2, 512, 128, 512, 20, F_MIN, F_MAX),
    'published': (1, SR, 1024, 256, 1024, 80, F_MIN, F_MAX),
    'batched': (3, SR // 4, 512, 128, 512, 20, F_MIN, F_MAX),
    'win-lt-n_fft': (2, SR // 2, 1024, 256, 800, 80, F_MIN, F_MAX),
    'ragged-frames-hop-300': (2, 20000, 1024, 300, 1024, 80, F_MIN, F_MAX),
}
# config/data_config_wavernn.yaml's settings (f_max None is the Nyquist
# frequency), and the kernel's smallest FFT
WAVERNN = {'wavernn': (2, SR // 2, 2048, 275, 1100, 80, 40, None)}
SMALL_FFT = {'n_fft-256': (2, SR // 4, 256, 64, 256, 40, F_MIN, F_MAX)}


def _centered(b, n, n_fft, seed=0):
    """(b, n + n_fft) reflect-centred noise clips, made with numpy."""
    wav = np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32) * 0.3
    return np.pad(wav, ((0, 0), (n_fft // 2, n_fft // 2)), mode='reflect')


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_matches_jax_kernel_and_reference(case):
    import jax.numpy as jnp
    from transformertts_tpu.audio import spectral as jspectral
    from transformertts_tpu.ops.stft_pallas import fused_log_mel as jfused
    b, n, n_fft, hop, win, mels, f_min, f_max = CASES[case]
    centered = _centered(b, n, n_fft)
    args = (SR, n_fft, hop, win, mels, f_min, f_max)
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


def _fft_in_numpy(z: np.ndarray, fft_twiddles: torch.Tensor) -> np.ndarray:
    """The kernel's m-point complex FFT of z (..., m), pass by pass in
    complex64 (``fft_passes``): a pass of radix R and stride Ns reads points
    j + r m/R, multiplies them by its table's entries, does the R-point DFT
    and writes point r to (j − j mod Ns) R + j mod Ns + r Ns."""
    m = z.shape[-1]
    tw = fft_twiddles.numpy().view(np.complex64)[:, 0]
    data = z.astype(np.complex64)
    for radix, ns in fft_passes(m):
        j = np.arange(m // radix)
        k = j % ns
        v = data[..., j[:, None] + np.arange(radix) * (m // radix)]
        v[..., 1:] *= tw[ns - 1 + k[:, None] * (radix - 1) + np.arange(radix - 1)]
        dft = np.exp(-2j * np.pi * np.outer(np.arange(radix), np.arange(radix)) / radix)
        v = v @ dft.astype(np.complex64)
        data = np.empty_like(data)
        data[..., ((j - k) * radix + k)[:, None] + np.arange(radix) * ns] = v
    return data


def _kernel_in_numpy(centered: np.ndarray, layout, n_fft: int, hop: int,
                     clip_min: float = 1e-5) -> np.ndarray:
    """What the kernel computes from its host layout, in numpy float32: the
    windowed frame packed as z[n] = x[2n] + i x[2n+1]; its n_fft/2-point
    complex FFT (``_fft_in_numpy``); the split step over [k_lo, k_hi); each
    mel folded over its band; the clipped log."""
    m = n_fft // 2
    frames = np.lib.stride_tricks.sliding_window_view(centered, n_fft, axis=-1)[:, ::hop]
    x = frames * layout.window.numpy()
    z = _fft_in_numpy(x[..., 0::2] + 1j * x[..., 1::2], layout.fft_twiddles)
    bins = np.arange(layout.k_lo, layout.k_hi)
    a, c = z[..., bins % m], np.conj(z[..., (m - bins) % m])
    w = layout.split_twiddles.numpy().view(np.complex64)[:, 0]
    spec = 0.5 * (a + c) - 0.5j * w * (a - c)
    mag = np.sqrt(spec.real ** 2 + spec.imag ** 2 + np.float32(1e-30))
    fb = layout.fb.numpy()
    mel = np.zeros(mag.shape[:-1] + (fb.shape[0],), np.float32)
    for i, (lo, hi) in enumerate(layout.bands.numpy()):
        if lo < hi:
            mel[..., i] = mag[..., lo - layout.k_lo:hi - layout.k_lo] @ fb[i, lo:hi]
    return np.log(np.maximum(mel, clip_min))


@pytest.mark.parametrize('n_fft', KERNEL_N_FFT)
def test_kernel_passes_make_a_complex_fft(n_fft):
    """The pass schedule, its index order and the twiddle table give numpy's
    FFT of n_fft/2 points."""
    m = n_fft // 2
    assert np.prod([r for r, _ in fft_passes(m)]) == m
    layout = kernel_layout('cpu', SR, n_fft, n_fft, 40, F_MIN, F_MAX)
    assert layout.fft_twiddles.shape == (m - 1, 2)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((4, m)) + 1j * rng.standard_normal((4, m))
    want = np.fft.fft(z)
    np.testing.assert_allclose(_fft_in_numpy(z, layout.fft_twiddles), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('case', sorted(CASES) + sorted(WAVERNN))
def test_kernel_layout_recomputes_the_plain_log_mel(case):
    """The kernel's FFT, split step and band fold recomputed in numpy from its
    host layout (``_kernel_in_numpy``). Bins without mel weight are left out,
    so this must equal the full transform: here the FFT's index mistakes show
    without a card."""
    b, n, n_fft, hop, win, mels, f_min, f_max = {**CASES, **WAVERNN}[case]
    centered = _centered(b, n, n_fft, seed=2)
    layout = kernel_layout('cpu', SR, n_fft, win, mels, f_min, f_max)
    fb = spectral.mel_filterbank(SR, n_fft, mels, f_min, f_max)
    used = np.flatnonzero((fb != 0).any(axis=0))
    assert (layout.k_lo, layout.k_hi) == (used[0], used[-1] + 1)
    np.testing.assert_array_equal(layout.window.numpy(),
                                  spectral.padded_window(n_fft, win).astype(np.float32))
    assert layout.split_twiddles.shape == (layout.k_hi - layout.k_lo, 2)
    for m in range(mels):
        assert not fb[m, :int(layout.bands[m, 0])].any()
        assert not fb[m, int(layout.bands[m, 1]):].any()
    mine = _kernel_in_numpy(centered, layout, n_fft, hop)
    want = fused_log_mel_plain(torch.from_numpy(centered), SR, n_fft, hop, win, mels, f_min,
                               f_max)
    torch.testing.assert_close(torch.from_numpy(mine), want, **TOL)


@pytest.mark.parametrize('n_fft', [128, 768, 1000, 4096])
def test_kernel_arg_check_rejects_n_fft_off_its_sizes(n_fft):
    """Checked on the host before any launch; the plain version on the CPU
    still takes the size."""
    with pytest.raises(ValueError, match='power of two from 256 to 2048'):
        check_kernel_args(2, 8192, n_fft, 256, n_fft // 2, 80)
    out = fused_log_mel(torch.zeros(1, 8192), SR, n_fft, 256, n_fft // 2, 40, F_MIN, F_MAX)
    assert out.shape == (1, 1 + (8192 - n_fft) // 256, 40)
    for good in KERNEL_N_FFT:
        check_kernel_args(2, 8192, good, 256, good, 80)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES) + sorted(WAVERNN) + sorted(SMALL_FFT))
def test_kernel_matches_plain_on_card(cuda, case):
    b, n, n_fft, hop, win, mels, f_min, f_max = {**CASES, **WAVERNN, **SMALL_FFT}[case]
    centered = torch.from_numpy(_centered(b, n, n_fft)).to(cuda)
    args = (SR, n_fft, hop, win, mels, f_min, f_max)
    before = fused_log_mel.launches
    out = fused_log_mel(centered, *args)
    torch.cuda.synchronize()
    assert fused_log_mel.launches == before + 1
    torch.testing.assert_close(out, fused_log_mel_plain(centered, *args), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['published', 'wavernn'])
def test_kernel_fits_an_sm_without_spilling(cuda, case):
    """At the settings of both configs a block fits an SM and the FFT's
    points stay in registers."""
    b, n, n_fft, hop, win, mels, f_min, f_max = {**CASES, **WAVERNN}[case]
    layout = kernel_layout(str(cuda), SR, n_fft, win, mels, f_min, f_max)
    res = kernel_resources(n_fft, hop, layout.k_hi - layout.k_lo)
    assert res['threads'] == 256 and res['blocks_per_sm'] >= 1
    assert res['spill_bytes'] == 0
    assert res['dynamic_smem_bytes'] <= 232448


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
