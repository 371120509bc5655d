"""The fused attention forward of the port: plain version vs the JAX kernel,
and the CUDA kernel vs the plain version.

On the CPU ``flash_attention`` runs ``attention_plain``; both are held
against the JAX Pallas kernel in interpret mode and against the JAX
``attention_reference`` at the float32 bar of the JAX kernel's own tests
(atol 2e-5, rtol 1e-4).

The kernel itself runs only on a card: those tests carry the ``cuda``
marker and skip without one. JAX is imported inside the parity tests only,
so on a machine with a card and no JAX this file runs as
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest
import torch

from chip_smoke import EDGE_CASES
from transformertts_torch.ops.flash_attention import (NEG_INF, attention_plain,
                                                      flash_attention, fwd_resources)

torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)   # the JAX kernel's own bfloat16 bar

# (b, h, tq, tk, d, causal, padded keys)
CASES = {
    'padded-keys': (2, 2, 37, 53, 24, False, True),
    'causal': (2, 2, 41, 41, 24, True, True),
    'causal-tq-ne-tk': (2, 2, 30, 50, 16, True, False),
    'tq-gt-tk': (1, 3, 70, 20, 32, False, True),
    'odd-head-width': (2, 2, 19, 23, 13, False, True),
    'published-head-width': (2, 2, 33, 33, 192, False, True),
}

# the Aligner's shapes at test size, (b, h, tq, tk, d, causal, cache step):
# the decoder's causal self-attention with padded keys, a cross-attention
# with Tq >> Tk, the last block's causal self-attention at D 256, and decode
# steps (Tq 1) against a cache whose positions after the step are masked
ALIGNER_CASES = {
    'decoder-self': (2, 4, 300, 300, 64, True, None),
    'cross': (2, 4, 300, 45, 64, False, None),
    'last-self-d256': (2, 1, 300, 300, 256, True, None),
    'decode-step': (1, 4, 1, 300, 64, False, 137),
    'decode-step-d256': (1, 1, 1, 300, 256, False, 0),
}

# the bfloat16 design's edges that chip_smoke.py also runs, (b, h, tq, tk, d)
# and causal, named like '2x2x129x129x192-causal'
EDGE_IDS = ['x'.join(map(str, shape)) + ('-causal' if causal else '')
            for shape, causal in EDGE_CASES]


def _inputs(b, h, tq, tk, d, padded, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    bias = np.zeros((b, tk), np.float32)
    if padded:
        bias[0, tk * 3 // 4:] = NEG_INF
    return q, k, v, bias


def _torch(*arrays, device='cpu'):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_matches_jax_kernel_and_reference(case):
    import jax.numpy as jnp
    from transformertts_tpu.ops import flash_attention as jfa
    b, h, tq, tk, d, causal, padded = CASES[case]
    arrays = _inputs(b, h, tq, tk, d, padded)
    out = attention_plain(*_torch(*arrays), causal=causal).numpy()
    jargs = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(out, np.asarray(jfa.attention_reference(*jargs, causal=causal)),
                               **TOL)
    np.testing.assert_allclose(
        out, np.asarray(jfa.flash_attention(*jargs, causal=causal, interpret=True)), **TOL)


def test_fully_masked_rows_are_finite_means_of_v():
    """Padded batch rows of the serving path mask every key: the row comes
    out finite, the mean of v over the real keys (as attention_reference)."""
    import jax.numpy as jnp
    from transformertts_tpu.ops import flash_attention as jfa
    q, k, v, bias = _inputs(2, 2, 37, 53, 24, padded=False, seed=3)
    bias[:] = NEG_INF
    out = attention_plain(*_torch(q, k, v, bias)).numpy()
    assert np.isfinite(out).all()
    ref = jfa.attention_reference(*(jnp.asarray(a) for a in (q, k, v, bias)))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)
    np.testing.assert_allclose(out, np.broadcast_to(v.mean(axis=2, keepdims=True), out.shape),
                               **TOL)


def test_bfloat16_inputs_return_bfloat16():
    q, k, v, bias = _torch(*_inputs(2, 2, 37, 53, 24, padded=True, seed=2))
    out = flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias)
    assert out.dtype == torch.bfloat16
    # bf16 inputs, f32 softmax: the JAX kernel's own bf16 bar
    torch.testing.assert_close(out.float(), attention_plain(q, k, v, bias),
                               atol=3e-2, rtol=3e-2)


def test_cpu_tensors_take_the_plain_version_without_launching():
    q, k, v, bias = _torch(*_inputs(2, 2, 37, 53, 24, padded=True))
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias, causal=True)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, attention_plain(q, k, v, bias, causal=True),
                               atol=0, rtol=0)


def test_other_devices_raise_instead_of_falling_back():
    q, k, v, bias = (x.to('meta') for x in _torch(*_inputs(1, 1, 8, 8, 8, padded=False)))
    with pytest.raises(ValueError, match='CUDA'):
        flash_attention(q, k, v, bias)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('the CUDA kernel runs only on a card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(c for c in CASES if CASES[c][4] % 8 == 0))
def test_kernel_matches_plain_on_card(cuda, case):
    b, h, tq, tk, d, causal, padded = CASES[case]
    q, k, v, bias = _torch(*_inputs(b, h, tq, tk, d, padded), device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out, attention_plain(q, k, v, bias, causal=causal), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,causal', EDGE_CASES, ids=EDGE_IDS)
def test_kernel_bfloat16_at_the_design_edges(cuda, shape, causal):
    """The wgmma kernel in bfloat16 where its tiles, ring and padding are
    ragged, with the first sample's last keys and the last sample's every
    key masked."""
    b, h, tq, tk, d = shape
    q, k, v, bias = _torch(*_inputs(b, h, tq, tk, d, padded=True, seed=4), device=cuda)
    bias[-1] = NEG_INF
    q, k, v = (x.bfloat16() for x in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), attention_plain(q, k, v, bias, causal).float(),
                               **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('d', [64, 128, 192, 256])
def test_kernel_keeps_its_accumulators_in_registers(cuda, d, train):
    """The bfloat16 design, K1's instance and K2's: a block of two
    warpgroups fits an SM, with Q and a ring of at least two K/V stages in
    shared memory, and O stays in registers (no local memory)."""
    res = fwd_resources(d, train)
    assert res['threads'] == 256 and res['blocks_per_sm'] >= 1
    assert res['spill_bytes'] == 0 and res['registers'] <= 255
    assert res['stages'] == (4 if d <= 128 else 3 if d <= 192 else 2)
    assert res['dynamic_smem_bytes'] <= 232448


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, bias = _torch(*_inputs(1, 2, 8, 8, 12, padded=False), device=cuda)
    with pytest.raises(ValueError, match='head width'):
        flash_attention(q, k, v, bias)
    q, k, v, bias = _torch(*_inputs(1, 2, 8, 8, 16, padded=False), device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, bias)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), bias)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(ALIGNER_CASES))
def test_kernel_at_the_aligner_shapes(cuda, case, dtype):
    """K1 where the Aligner runs it: float32 (the SIMT kernel, the Aligner's
    compute dtype) at the f32 bar, bfloat16 (wgmma) at the bf16 bar."""
    b, h, tq, tk, d, causal, step = ALIGNER_CASES[case]
    q, k, v, bias = _torch(*_inputs(b, h, tq, tk, d, padded=step is None, seed=5),
                           device=cuda)
    if step is not None:
        bias[:, step + 1:] = NEG_INF
    if dtype == 'bfloat16':
        q, k, v = (x.bfloat16() for x in (q, k, v))
    before = flash_attention.launches
    out = flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == q.dtype
    torch.testing.assert_close(out.float(), attention_plain(q, k, v, bias, causal).float(),
                               **(TOL if dtype == 'float32' else BF16_TOL))
