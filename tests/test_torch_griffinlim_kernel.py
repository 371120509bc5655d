"""Griffin-Lim's FFT kernel (``csrc/griffin_lim.cu``) against its plain
version, and the dispatch of ``audio.griffinlim.griffin_lim``.

The kernel does the plain version's float32 operations in the plain
version's order, built without fused multiply-adds, so the two are expected
to agree to the bit. Griffin-Lim's iteration amplifies a last-bit difference
to ~1e-4 of the peak within two iterations (``test_torch_griffinlim.py``),
so the per-sample bar at 1–3 iterations, 1e-6 of the peak, would catch any
operation done otherwise; at 32 iterations the two are compared by spectral
convergence as the JAX comparison is. The plain version runs on the CPU
here, so the card's result is held to the CPU's arithmetic.

The kernel runs only on a card: those tests carry the ``cuda`` marker and
skip without one. This file imports no JAX, so on the card's machine it runs
as ``python -m pytest --noconftest -m cuda tests/test_torch_griffinlim_kernel.py``.
"""
import numpy as np
import pytest
import torch

from transformertts_torch.audio import griffinlim, spectral
from transformertts_torch.ops import griffin_lim as gl_ops
from transformertts_torch.ops.griffin_lim import (check_kernel_args, griffin_lim_kernel,
                                                  griffin_lim_plain, kernel_resources,
                                                  launch_tile, tile_frames)

torch.set_num_threads(1)

PER_SAMPLE = 1e-6  # of the plain version's peak, at 1-3 iterations

# (batch, frames, n_fft, hop, win_length): the serving settings at B 1, 3 and
# 32, frame counts off a multiple of the tile and below the halo (K − 1 = 3),
# the smallest and largest FFT with the hops that tile them, a window shorter
# than n_fft (an envelope with zeros at both ends)
CASES = {
    'published-b1': (1, 45, 1024, 256, 1024),
    'published-b3-two-tiles': (3, 70, 1024, 256, 1024),
    'published-b32': (32, 40, 1024, 256, 1024),
    'frames-below-halo': (2, 2, 1024, 256, 1024),
    'one-frame': (2, 1, 1024, 256, 1024),
    'n_fft-256-hop-64': (2, 37, 256, 64, 256),
    'n_fft-256-hop-256': (1, 20, 256, 256, 256),
    'n_fft-2048-hop-512': (2, 50, 2048, 512, 2048),
    'n_fft-2048-hop-1024': (1, 30, 2048, 1024, 2048),
    'n_fft-2048-hop-2048': (1, 25, 2048, 2048, 2048),
    'win-lt-n_fft': (2, 33, 1024, 128, 800),
}


def _magnitudes(b, f, n_fft, seed=0):
    return np.abs(np.random.default_rng(seed).standard_normal(
        (b, f, n_fft // 2 + 1))).astype(np.float32)


def _spectral_convergence(wav, S, n_fft, hop, win):
    """‖S − |STFT(wav)|‖ / ‖S‖ over the frames Griffin-Lim reconstructed."""
    re, im = spectral.stft(torch.as_tensor(wav, dtype=torch.float64), n_fft, hop, win)
    rebuilt = torch.sqrt(re * re + im * im).numpy()[:S.shape[0]]
    return np.linalg.norm(S - rebuilt) / np.linalg.norm(S)


# --- the CPU: dispatch and the plain version ---------------------------------------

def test_dispatch_by_shape_and_device():
    """The kernel at K5's FFT sizes with a hop that tiles n_fft, on a CUDA
    tensor; its plain version on a CPU tensor; the gather form at the WaveRNN
    settings' hop 275 of 2048 on either; the DFT GEMMs at another n_fft."""
    form = griffinlim.waveform_form
    assert form('cuda', 1024, 256) == 'kernel' and form('cpu', 1024, 256) == 'plain'
    assert form('cuda', 2048, 275) == form('cpu', 2048, 275) == 'gather'
    assert form('cuda', 800, 200) == form('cpu', 800, 200) == 'padded'
    for n_fft in (256, 512, 2048):
        assert form('cuda', n_fft, n_fft // 4) == 'kernel'


def test_cpu_tensor_runs_the_plain_version():
    S = torch.from_numpy(_magnitudes(2, 20, 1024))
    before = griffin_lim_kernel.launches
    wav = griffinlim.griffin_lim(S, 2, 1024, 256, 1024)
    assert griffin_lim_kernel.launches == before
    assert torch.equal(wav, griffin_lim_plain(S, 2, 1024, 256, 1024))


def test_gather_form_at_hop_275():
    S = torch.from_numpy(_magnitudes(1, 12, 2048))
    wav = griffinlim.griffin_lim(S, 1, 2048, 275, 1100)
    ref = griffinlim._griffin_lim_general(S, 1, 2048, 275, 1100, 0.99)
    assert wav.shape == (1, 275 * 11) and torch.equal(wav, ref)


@pytest.mark.parametrize('case', ['published-b3-two-tiles', 'n_fft-256-hop-64',
                                  'n_fft-2048-hop-1024', 'frames-below-halo'])
def test_plain_is_the_same_for_any_tile(case, monkeypatch):
    """Each tile recomputes its halo frames and adds a position's frames in
    ascending order, so the tile changes no bit."""
    b, f, n_fft, hop, win = CASES[case]
    S = torch.from_numpy(_magnitudes(b, f, n_fft))
    want = griffin_lim_plain(S, 3, n_fft, hop, win)
    for tile in (1, 5, tile_frames(n_fft, hop), 64):
        monkeypatch.setattr(gl_ops, 'tile_frames', lambda *args: tile)
        assert torch.equal(griffin_lim_plain(S, 3, n_fft, hop, win), want), tile


@pytest.mark.parametrize('n_iter', [0, 2])
def test_plain_matches_the_dft_gemm_form(n_iter):
    """The FFT form against the padded DFT-GEMM form it replaces on the card:
    the same iteration, float32 rounded at other places (1e-5 of the peak)."""
    S = torch.from_numpy(_magnitudes(2, 40, 1024))
    plain = griffin_lim_plain(S, n_iter, 1024, 256, 1024)
    gemm = griffinlim._griffin_lim_padded(S, n_iter, 1024, 256, 1024, 0.99)
    torch.testing.assert_close(plain, gemm, rtol=0, atol=1e-5 * gemm.abs().max().item())


def test_tile_keeps_the_segment_in_shared_memory():
    assert tile_frames(1024, 256) == 32 and tile_frames(2048, 512) == 32
    assert tile_frames(2048, 1024) == 23 and tile_frames(2048, 2048) == 12
    for n_fft in (256, 512, 1024, 2048):
        for hop in (n_fft // 8, n_fft // 4, n_fft // 2, n_fft):
            tile = tile_frames(n_fft, hop)
            assert 1 <= tile <= 32 and (tile + n_fft // hop - 1) * hop <= 24576


# (batch, frames, n_fft, hop) → the tile on an H100's 132 SMs; timed there at
# every tile from 32 to 1 (n_fft 1024 hop 256, 32 iterations), the tile
# picked was within 2.4 % of the fastest at each such shape (PERF.md §6)
LAUNCH_TILES = [((32, 768, 1024, 256), 32), ((32, 384, 1024, 256), 32),
                ((16, 384, 1024, 256), 16), ((8, 384, 1024, 256), 8),
                ((4, 384, 1024, 256), 4), ((1, 384, 1024, 256), 2), ((1, 128, 1024, 256), 1),
                ((2, 2, 1024, 256), 1), ((1, 2000, 2048, 2048), 6), ((1, 1000, 2048, 2048), 3)]


def test_launch_tile_spreads_a_small_grid_over_the_sms():
    """The serving chunks keep the largest tile; a smaller batch halves it
    to two blocks an SM, down to the frames transformed at once, and past
    that only until every SM has a block."""
    for args, tile in LAUNCH_TILES:
        assert launch_tile(*args, 132) == tile, args
    for b, f in ((1, 1), (3, 70), (32, 40), (64, 5000), (5, 100)):
        tile = launch_tile(b, f, 1024, 256, 132)
        blocks = b * -(-f // tile)
        assert 1 <= tile <= tile_frames(1024, 256)
        assert tile == 1 or blocks >= 132
        assert tile <= 4 or blocks >= 264 or tile == tile_frames(1024, 256)


def test_kernel_takes_only_a_cuda_tensor():
    with pytest.raises(ValueError):
        griffin_lim_kernel(torch.ones(1, 10, 513), 2, 1024, 256, 1024)


@pytest.mark.parametrize('args', [(2, 800, 200, 800), (2, 1024, 300, 1024), (2, 1024, 256, 1100),
                                  (-1, 1024, 256, 1024)])
def test_kernel_arg_check_rejects_what_it_does_not_take(args):
    with pytest.raises(ValueError):
        check_kernel_args(*args)


# --- the card -------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n_iter', [1, 2, 3])
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernel_matches_plain_per_sample(cuda, case, n_iter):
    b, f, n_fft, hop, win = CASES[case]
    S = _magnitudes(b, f, n_fft, seed=n_iter)
    before = griffin_lim_kernel.launches
    wav = griffin_lim_kernel(torch.from_numpy(S).to(cuda), n_iter, n_fft, hop, win)
    torch.cuda.synchronize()
    assert griffin_lim_kernel.launches == before + n_iter + 1
    ref = griffin_lim_plain(torch.from_numpy(S), n_iter, n_fft, hop, win).numpy()
    wav = wav.cpu().numpy()
    assert wav.shape == ref.shape == (b, hop * (f - 1))
    bar = PER_SAMPLE * np.abs(ref).max(initial=0)
    # the first and last n_fft samples, where the envelope is not flat, and the rest
    edge = min(n_fft, wav.shape[1])
    for part in (np.s_[:, :edge], np.s_[:, -edge:], np.s_[:, :]):
        np.testing.assert_allclose(wav[part], ref[part], rtol=0, atol=bar)


@pytest.mark.cuda
@pytest.mark.parametrize('tile', [1, 3, 8, 32])
def test_kernel_is_the_same_for_any_tile(cuda, tile, monkeypatch):
    """The tile ``launch_tile`` picks from the grid changes no bit: the
    kernel at a forced tile against the plain version at its own."""
    b, f, n_fft, hop, win = CASES['published-b3-two-tiles']
    S = _magnitudes(b, f, n_fft, seed=tile)
    monkeypatch.setattr(gl_ops, 'launch_tile', lambda *args: tile)
    wav = griffin_lim_kernel(torch.from_numpy(S).to(cuda), 3, n_fft, hop, win).cpu()
    assert torch.equal(wav, griffin_lim_plain(torch.from_numpy(S), 3, n_fft, hop, win))


@pytest.mark.cuda
def test_kernel_32_iterations_converges_like_plain(cuda):
    b, f, n_fft, hop, win = CASES['published-b3-two-tiles']
    S = _magnitudes(b, f, n_fft, seed=7)
    wav = griffin_lim_kernel(torch.from_numpy(S).to(cuda), 32, n_fft, hop, win).cpu().numpy()
    ref = griffin_lim_plain(torch.from_numpy(S), 32, n_fft, hop, win).numpy()
    start = griffin_lim_plain(torch.from_numpy(S), 0, n_fft, hop, win).numpy()
    for row in range(b):
        sc, sc_ref, sc_0 = (_spectral_convergence(w[row], S[row], n_fft, hop, win)
                            for w in (wav, ref, start))
        # the same algorithm converges to the same quality, far below zero iterations'
        assert abs(sc - sc_ref) < 0.02 * sc_ref, (sc, sc_ref)
        assert sc < 0.9 * sc_0


@pytest.mark.cuda
def test_kernel_rows_are_independent(cuda):
    S = torch.from_numpy(_magnitudes(3, 45, 1024, seed=3)).to(cuda)
    batch = griffin_lim_kernel(S, 4, 1024, 256, 1024)
    for row in range(3):
        assert torch.equal(batch[row:row + 1], griffin_lim_kernel(S[row:row + 1], 4, 1024, 256,
                                                                  1024))


@pytest.mark.cuda
def test_griffin_lim_on_card_dispatches_by_shape(cuda):
    """1024/256 goes through the kernel (n_iter + 1 launches); the WaveRNN
    settings' hop 275 of 2048 through the gather form, no launch."""
    S = torch.from_numpy(_magnitudes(2, 20, 1024)).to(cuda)
    before = griffin_lim_kernel.launches
    griffinlim.griffin_lim(S, 5, 1024, 256, 1024)
    assert griffin_lim_kernel.launches == before + 6
    S = torch.from_numpy(_magnitudes(1, 12, 2048)).to(cuda)
    wav = griffinlim.griffin_lim(S, 2, 2048, 275, 1100)
    torch.cuda.synchronize()
    assert griffin_lim_kernel.launches == before + 6 and wav.shape == (1, 275 * 11)


@pytest.mark.cuda
@pytest.mark.parametrize('n_fft, hop', [(1024, 256), (2048, 512), (2048, 2048), (256, 64)])
def test_kernel_fits_an_sm_without_spilling(cuda, n_fft, hop):
    res = kernel_resources(n_fft, hop)
    assert res['threads'] == 256 and res['blocks_per_sm'] >= 1
    assert res['spill_bytes'] == 0
    assert res['dynamic_smem_bytes'] <= 232448


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    S = torch.zeros(2, 10, 513, device=cuda)
    with pytest.raises(TypeError):
        griffin_lim_kernel(S.double(), 2, 1024, 256, 1024)
    with pytest.raises(ValueError):
        griffin_lim_kernel(S, 2, 1024, 300, 1024)
    with pytest.raises(ValueError):
        griffin_lim_kernel(S[..., :400], 2, 1024, 256, 1024)
