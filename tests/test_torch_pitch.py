"""Batched YIN pitch of the port against the JAX package's ``yin_f0``.

The two packages take their FFTs from different libraries, which round
differently, so a borderline voicing decision may flip. The bars: voicing
agrees on at least 99 % of frames, and where both call a frame voiced their
F0 agrees within 1e-3 relative.
"""
import numpy as np
import pytest
import torch

from transformertts_torch.audio.pitch import extract_pitch_np, yin_f0

torch.set_num_threads(1)

SR, HOP = 22050, 256
VOICING_AGREEMENT = 0.99
F0_RTOL = 1e-3


def _clips(seed=0, n=SR):
    """A tone with vibrato, a steady tone over noise, noise and silence, and
    a clip that switches between speech-like harmonics and silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    vib = 180 + 12 * np.sin(2 * np.pi * 5.5 * t)
    phase = 2 * np.pi * np.cumsum(vib) / SR
    harmonics = sum(0.3 / k * np.sin(k * phase) for k in range(1, 6))
    gated = harmonics * (np.sin(2 * np.pi * 1.5 * t) > 0)
    clips = [harmonics + 0.01 * rng.standard_normal(n),
             0.4 * np.sin(2 * np.pi * 110 * t) + 0.05 * rng.standard_normal(n),
             0.2 * rng.standard_normal(n),
             np.zeros(n),
             gated + 0.002 * rng.standard_normal(n)]
    return np.stack(clips).astype(np.float32)


def _agree(mine, ref):
    voiced_m, voiced_r = mine > 0, ref > 0
    assert (voiced_m == voiced_r).mean() >= VOICING_AGREEMENT
    both = voiced_m & voiced_r
    np.testing.assert_allclose(mine[both], ref[both], rtol=F0_RTOL)
    return both


@pytest.mark.parametrize('hop', [HOP, 200])
def test_batched_yin_matches_jax(hop):
    import jax.numpy as jnp
    from transformertts_tpu.audio.pitch import yin_f0 as jyin
    wavs = _clips()
    mine = yin_f0(torch.from_numpy(wavs), SR, hop).numpy()
    ref = np.stack([np.asarray(jyin(jnp.asarray(w), SR, hop)) for w in wavs])
    assert mine.shape == ref.shape == (len(wavs), 1 + wavs.shape[1] // hop)
    both = _agree(mine, ref)
    assert both[0].mean() > 0.9 and not both[3].any()


def test_extract_pitch_np_matches_jax():
    from transformertts_tpu.audio.pitch import extract_pitch_np as jextract
    wav = _clips(seed=3, n=SR // 2 + 77)[0]
    mine, ref = extract_pitch_np(wav, SR, HOP, device='cpu'), jextract(wav, SR, HOP)
    assert mine.shape == ref.shape == (1 + len(wav) // HOP,)
    _agree(mine, ref)


def test_batch_rows_are_independent_of_padding():
    """A clip's frames are the same alone or zero-padded in a batch, which is
    what lets featurization pad a bucket to one length."""
    wavs = _clips(seed=4)
    alone = yin_f0(torch.from_numpy(wavs[:1, :15000]), SR, HOP)[0]
    padded = np.zeros_like(wavs[:2])
    padded[0, :15000] = wavs[0, :15000]
    padded[1] = wavs[1]
    batch = yin_f0(torch.from_numpy(padded), SR, HOP)[0, :alone.shape[0]]
    torch.testing.assert_close(batch, alone, rtol=1e-5, atol=1e-3)
