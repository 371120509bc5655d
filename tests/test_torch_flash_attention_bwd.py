"""The trainable fused attention of the port: the logsumexp forward (K2) and
the backward (K3 dQ, K4 dK/dV), plain versions against JAX and autograd, and
the CUDA kernels against the plain versions.

Bars: float32 grads against the JAX ``flash_attention_trainable`` (Pallas in
interpret mode, through ``jax.grad``) at the JAX kernel tests' own float32
bar, atol 5e-5 / rtol 1e-3; bfloat16 at their bfloat16 bar, 0.12. The JAX
kernel includes its 128-padding keys in a fully masked row (the port
excludes keys >= Tk), so parity inputs keep at least one valid key a row;
fully masked rows are tested on their own. Dropout has no JAX counterpart
that matches bit for bit (the TPU draws its own bits): with dropout the
kernels are held against the plain versions fed the same mask.

Kernel tests carry the ``cuda`` marker and skip without a card; JAX is
imported inside the parity tests, so on a machine with a card and no JAX this
file runs as ``python -m pytest --noconftest -m cuda
tests/test_torch_flash_attention_bwd.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from transformertts_torch.ops.flash_attention import (
    NEG_INF, attention_bwd_plain, attention_fwd_lse_plain, attention_plain,
    dkv_resources, dq_resources, dropout_keep_mask, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_fwd_lse, flash_attention_trainable)

from test_torch_flash_attention import EDGE_CASES, EDGE_IDS

torch.set_num_threads(1)

F32_GRAD_TOL = dict(atol=5e-5, rtol=1e-3)
F32_FWD_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_GRAD_TOL = dict(atol=0.12, rtol=0.12)
# bfloat16 dQ, dK and dV against the float32 plain version: relative L2 error.
# atol 0.12 alone would pass a wrong tile whose values are small.
BF16_REL_L2_BAR = 1e-2

# (b, h, tq, tk, d, causal)
CASES = {
    'padded-keys': (2, 2, 37, 53, 24, False),
    'causal': (2, 2, 41, 41, 24, True),
    'tq-gt-tk': (1, 3, 70, 20, 32, False),
    'published-head-width': (2, 2, 33, 33, 192, False),
    # a partial last query tile and a 2-key last key block in K4
    'ragged-tiles': (1, 2, 97, 130, 192, False),
}


def _inputs(b, h, tq, tk, d, seed=0, masked_row=False):
    """q, k, v, bias, dout as numpy float32; sample 0 pads keys 3/4 on, and
    with ``masked_row`` the last sample masks every key."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for t in (tq, tk, tk))
    dout = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    bias = np.zeros((b, tk), np.float32)
    bias[0, tk * 3 // 4:] = NEG_INF
    if masked_row:
        bias[-1] = NEG_INF
    return q, k, v, bias, dout


def _torch(*arrays, device='cpu', dtype=torch.float32):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _plain_grads(q, k, v, bias, dout, causal, rate=0.0, seed=0, offset=0):
    out, lse = attention_fwd_lse_plain(q, k, v, bias, causal, rate, seed, offset)
    return out, lse, attention_bwd_plain(q, k, v, bias, out, lse, dout, causal, rate,
                                         seed, offset)


def _jax_grads(q, k, v, bias, dout, causal, dtype='float32'):
    import jax
    import jax.numpy as jnp
    from transformertts_tpu.ops.flash_attention import flash_attention_trainable as jfa

    def loss(q_, k_, v_):
        out = jfa(q_, k_, v_, jnp.asarray(bias), causal=causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout))

    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_matches_jax_flash_grads(case):
    b, h, tq, tk, d, causal = CASES[case]
    arrays = _inputs(b, h, tq, tk, d)
    _, _, grads = _plain_grads(*_torch(*arrays), causal)
    for mine, ref in zip(grads, _jax_grads(*arrays, causal)):
        np.testing.assert_allclose(mine.numpy(), ref, **F32_GRAD_TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_plain_forward_matches_jax_out_and_lse(causal):
    import jax.numpy as jnp
    from transformertts_tpu.ops.flash_attention import _flash_fwd_res
    b, h, tq, tk, d = 2, 2, 41, 41, 24
    q, k, v, bias, _ = _inputs(b, h, tq, tk, d, seed=1)
    out, lse = attention_fwd_lse_plain(*_torch(q, k, v, bias), causal)
    j_out, j_lse = _flash_fwd_res(*(jnp.asarray(a) for a in (q, k, v, bias)), causal, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **F32_FWD_TOL)
    assert lse.shape == (b, h, tq, 2)
    np.testing.assert_allclose(lse.sum(dim=-1).numpy().reshape(b * h, tq),
                               np.asarray(j_lse)[:, 0, :tq], **F32_FWD_TOL)


def test_plain_backward_bfloat16_matches_jax():
    arrays = _inputs(2, 2, 37, 53, 24, seed=8)
    q, k, v, bias, dout = _torch(*arrays)
    _, _, grads = _plain_grads(q.bfloat16(), k.bfloat16(), v.bfloat16(), bias,
                               dout.bfloat16(), False)
    for mine, ref in zip(grads, _jax_grads(*arrays, False, dtype='bfloat16')):
        assert mine.dtype == torch.bfloat16
        np.testing.assert_allclose(mine.float().numpy(), ref, **BF16_GRAD_TOL)


@pytest.mark.parametrize('masked_row', [False, True])
@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_matches_autograd_of_attention_plain(case, masked_row):
    b, h, tq, tk, d, causal = CASES[case]
    q, k, v, bias, dout = _torch(*_inputs(b, h, tq, tk, d, seed=2, masked_row=masked_row))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention_plain(*leaves, bias, causal)
    auto = torch.autograd.grad(out, leaves, dout)
    _, _, grads = _plain_grads(q, k, v, bias, dout, causal)
    for mine, ref in zip(grads, auto):
        torch.testing.assert_close(mine, ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('causal', [False, True])
def test_trainable_passes_gradcheck_in_float64(rate, causal):
    q, k, v, bias, _ = _torch(*_inputs(1, 2, 6, 7, 8, seed=3), dtype=torch.float64)
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def fn(q_, k_, v_):
        # a fresh generator of one seed: every evaluation draws the same mask
        return flash_attention_trainable(q_, k_, v_, bias, causal, rate,
                                         torch.Generator().manual_seed(11))

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6, rtol=1e-4)


def test_dropout_keep_mask_fraction_and_determinism():
    mask = dropout_keep_mask(7, 3, 4, 2, 250, 500, 0.1)   # 10^6 weights
    assert mask.shape == (4, 2, 250, 500) and mask.dtype == torch.bool
    assert abs(mask.float().mean().item() - 0.9) < 0.01
    assert torch.equal(mask, dropout_keep_mask(7, 3, 4, 2, 250, 500, 0.1))
    other = dropout_keep_mask(7, 4, 4, 2, 250, 500, 0.1)
    assert 0.1 < (mask != other).float().mean().item() < 0.3   # independent draws
    assert dropout_keep_mask(7, 3, 1, 1, 8, 8, 0.0).all()


def test_dropout_is_inverted_dropout_on_the_weights():
    q, k, v, bias, _ = _torch(*_inputs(2, 2, 9, 11, 8, seed=4))
    out, _ = attention_fwd_lse_plain(q, k, v, bias, False, 0.25, 5, 6)
    weights = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(8)
                            + bias[:, None, None, :], dim=-1)
    keep = dropout_keep_mask(5, 6, 2, 2, 9, 11, 0.25)
    torch.testing.assert_close(out, torch.matmul(weights * keep / 0.75, v),
                               atol=1e-6, rtol=1e-5)


def test_masked_keys_get_zero_dk_dv_and_fully_masked_rows_are_finite():
    b, h, tq, tk, d = 3, 2, 20, 24, 16
    q, k, v, bias, dout = _torch(*_inputs(b, h, tq, tk, d, seed=5, masked_row=True))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_trainable(*leaves, bias)
    dq, dk, dv = torch.autograd.grad(out, leaves, dout)
    for g in (out, dq, dk, dv):
        assert torch.isfinite(g).all()
    # sample 0 masks keys 18: on; its other keys carry gradient
    assert dk[0, :, tk * 3 // 4:].abs().max() == 0 and dv[0, :, tk * 3 // 4:].abs().max() == 0
    assert dv[0, :, :tk * 3 // 4].abs().max() > 0
    # the fully masked sample is the mean of v, and its gradients under a
    # nonzero cotangent are those of that mean: dV = Σ_rows dO / Tk
    torch.testing.assert_close(out[-1], v[-1].mean(dim=1, keepdim=True).expand(h, tq, d))
    torch.testing.assert_close(dv[-1], dout[-1].sum(dim=1, keepdim=True).expand(h, tk, d) / tk)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(attention_plain(*plain, bias), plain, dout)
    for mine, ref in zip((dq, dk, dv), auto):
        torch.testing.assert_close(mine[-1], ref[-1], atol=2e-5, rtol=1e-4)
    # padded rows downstream get no cotangent, and then neither do its inputs
    dout[-1] = 0
    dq, dk, dv = torch.autograd.grad(flash_attention_trainable(*leaves, bias), leaves, dout)
    assert dq[-1].abs().max() == 0 and dk[-1].abs().max() == 0 and dv[-1].abs().max() == 0


def test_cpu_tensors_take_the_plain_versions_without_launching():
    q, k, v, bias, dout = _torch(*_inputs(2, 2, 9, 11, 8))
    before = [f.launches for f in (flash_attention_fwd_lse, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    out, lse = flash_attention_fwd_lse(q, k, v, bias, True, 0.1, 1, 2)
    dq = flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, True, 0.1, 1, 2)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, True, 0.1, 1, 2)
    assert before == [f.launches for f in (flash_attention_fwd_lse, flash_attention_bwd_dq,
                                           flash_attention_bwd_dkv)]
    ref = attention_bwd_plain(q, k, v, bias, out, lse, dout, True, 0.1, 1, 2)
    for mine, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(mine, r, atol=0, rtol=0)


def test_dropout_needs_a_generator_and_a_rate_below_one():
    q, k, v, bias, _ = _torch(*_inputs(1, 1, 4, 4, 8))
    with pytest.raises(ValueError, match='generator'):
        flash_attention_trainable(q, k, v, bias, dropout_rate=0.1)
    with pytest.raises(ValueError, match='rate'):
        attention_fwd_lse_plain(q, k, v, bias, dropout_rate=1.0)


# ---------------------------------------------------------------------------
# on the card: K2, K3 and K4 against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('the CUDA kernels run only on a card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernels_match_plain_on_card(cuda, case, dtype, rate):
    b, h, tq, tk, d, causal = CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, bias, dout = _torch(*_inputs(b, h, tq, tk, d, masked_row=True), device=cuda)
    q, k, v, dout = (x.to(dt) for x in (q, k, v, dout))
    args = (causal, rate, 123, 456)
    counts = [f.launches for f in (flash_attention_fwd_lse, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    out, lse = flash_attention_fwd_lse(q, k, v, bias, *args)
    dq = flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention_fwd_lse, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkv)] == [c + 1 for c in counts]
    ref_out, ref_lse = attention_fwd_lse_plain(q, k, v, bias, *args)
    fwd_tol = F32_FWD_TOL if dt == torch.float32 else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(out.float(), ref_out.float(), **fwd_tol)
    torch.testing.assert_close(lse, ref_lse, **F32_FWD_TOL)
    # the backward holds against the plain backward at the kernel's own lse
    ref = attention_bwd_plain(q, k, v, bias, out, lse, dout, *args)
    grad_tol = F32_GRAD_TOL if dt == torch.float32 else BF16_GRAD_TOL
    for mine, r in zip((dq, dk, dv), ref):
        assert mine.dtype == dt and torch.isfinite(mine).all()
        torch.testing.assert_close(mine.float(), r.float(), **grad_tol)


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('shape,causal', EDGE_CASES, ids=EDGE_IDS)
def test_bfloat16_kernels_at_the_forward_design_edges(cuda, shape, causal, rate):
    """K2 in bfloat16 where its wgmma design's tiles, ring and padding are
    ragged, and K3 and K4 from the (m, log l) it writes; the backward's plain
    version runs in float32 from the same inputs."""
    b, h, tq, tk, d = shape
    q, k, v, bias, dout = _torch(*_inputs(b, h, tq, tk, d, seed=7, masked_row=True),
                                 device=cuda)
    q, k, v, dout = (x.bfloat16() for x in (q, k, v, dout))
    args = (causal, rate, 11, 22)
    out, lse = flash_attention_fwd_lse(q, k, v, bias, *args)
    dq = flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention_fwd_lse_plain(q, k, v, bias, *args)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse, ref_lse, **F32_FWD_TOL)
    ref = attention_bwd_plain(q.float(), k.float(), v.float(), bias, out.float(), lse,
                              dout.float(), *args)
    for name, mine, r in zip(('dq', 'dk', 'dv'), (dq, dk, dv), ref):
        assert mine.dtype == torch.bfloat16 and torch.isfinite(mine).all()
        torch.testing.assert_close(mine.float(), r, **BF16_GRAD_TOL)
        # a softmax over one key has no gradient to its logit: dQ and dK are 0
        if tk > 1 or name == 'dv':
            assert ((mine.float() - r).norm() / r.norm()).item() < BF16_REL_L2_BAR


@pytest.mark.cuda
def test_trainable_on_card_launches_k2_k3_k4(cuda):
    q, k, v, bias, dout = _torch(*_inputs(2, 2, 37, 53, 24), device=cuda)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    counts = [f.launches for f in (flash_attention_fwd_lse, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    gen = torch.Generator(device=cuda).manual_seed(0)
    out = flash_attention_trainable(*leaves, bias, dropout_rate=0.1, generator=gen)
    torch.autograd.grad(out, leaves, dout)
    assert [f.launches for f in (flash_attention_fwd_lse, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkv)] == [c + 1 for c in counts]


@pytest.mark.cuda
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('d', [24, 64, 128, 192, 200, 256])
@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
def test_bwd_kernel_bfloat16_at_ragged_tiles(cuda, kernel, d, causal):
    """K3 or K4 in bfloat16 at dropout 0.1 where their tiles are ragged: Tq 97
    ends in a partial query tile (K3's block, K4's tile), Tk 130 in a 2-key
    tile or block. D covers every head width template; at 200 the two warps
    of a pair own 13 and 12 output n-tiles. The plain version runs in float32
    from the same inputs."""
    b, h, tq, tk = 1, 2, 97, 130
    q, k, v, _, dout = _torch(*_inputs(b, h, tq, tk, d, seed=6), device=cuda)
    q, k, v, dout = (x.bfloat16() for x in (q, k, v, dout))
    bias = torch.zeros(b, tk, device=cuda)   # the last keys carry gradient
    args = (causal, 0.1, 321, 654)
    out, lse = attention_fwd_lse_plain(q, k, v, bias, *args)
    fn = flash_attention_bwd_dq if kernel == 'dq' else flash_attention_bwd_dkv
    count = fn.launches
    grads = fn(q, k, v, bias, out, lse, dout, *args)
    torch.cuda.synchronize()
    assert fn.launches == count + 1
    ref = attention_bwd_plain(q.float(), k.float(), v.float(), bias, out.float(), lse,
                              dout.float(), *args)
    grads, ref = ((grads,), ref[:1]) if kernel == 'dq' else (grads, ref[1:])
    for mine, r in zip(grads, ref):
        assert mine.dtype == torch.bfloat16 and torch.isfinite(mine).all()
        torch.testing.assert_close(mine.float(), r, **BF16_GRAD_TOL)
        assert ((mine.float() - r).norm() / r.norm()).item() < BF16_REL_L2_BAR
    if kernel == 'dkv' and not causal:
        dk, dv = grads
        assert dv[0, :, 128:].abs().max() > 0 and dk[0, :, 128:].abs().max() > 0
    if kernel == 'dq':
        # the last, partial query block gets gradient too
        assert grads[0][0, :, 96:].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize('d', [64, 128, 192, 256])
def test_dq_kernel_keeps_its_accumulators_in_registers(cuda, d):
    """The bfloat16 K3 design: a block of 8 warps fits an SM, and dQ stays in
    registers (no local memory) at every head width template."""
    res = dq_resources(d)
    assert res['threads'] == 256 and res['blocks_per_sm'] >= 1
    assert res['spill_bytes'] == 0 and res['registers'] <= 255
    assert res['key_tile'] == (64 if d <= 192 else 32)
    assert res['dynamic_smem_bytes'] <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize('d', [64, 128, 192, 256])
def test_dkv_kernel_keeps_its_accumulators_in_registers(cuda, d):
    """The bfloat16 K4 design: a block of 8 warps fits an SM, and dK and dV
    stay in registers (no local memory) at every head width template."""
    res = dkv_resources(d)
    assert res['threads'] == 256 and res['blocks_per_sm'] >= 1
    assert res['spill_bytes'] == 0 and res['registers'] <= 255
    assert res['query_tile'] == (64 if d <= 192 else 32)
    assert res['dynamic_smem_bytes'] <= 232448


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('shape,causal', [((1, 2, 97, 130, 256), False),
                                          ((1, 2, 97, 130, 256), True),
                                          ((2, 1, 300, 300, 256), True),
                                          ((2, 1, 300, 300, 256), False)],
                         ids=['ragged', 'ragged-causal', 'aligner-last-block',
                              'aligner-last-block-not-causal'])
def test_float32_kernels_at_head_width_256(cuda, shape, causal, rate):
    """K3 and K4 in float32 at D 256, the Aligner's last decoder block
    (one head of 256): K3 takes 32 query rows a block there, K4 32 keys.
    Tq 97 ends in a partial query block, Tk 130 in a 2-key tile; a fully
    masked row's gradients too."""
    b, h, tq, tk, d = shape
    q, k, v, bias, dout = _torch(*_inputs(b, h, tq, tk, d, seed=8, masked_row=b > 1),
                                 device=cuda)
    args = (causal, rate, 77, 88)
    out, lse = flash_attention_fwd_lse(q, k, v, bias, *args)
    counts = [f.launches for f in (flash_attention_bwd_dq, flash_attention_bwd_dkv)]
    dq = flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args)
    torch.cuda.synchronize()
    assert [f.launches for f in (flash_attention_bwd_dq, flash_attention_bwd_dkv)] == \
        [c + 1 for c in counts]
    ref = attention_bwd_plain(q, k, v, bias, out, lse, dout, *args)
    for mine, r in zip((dq, dk, dv), ref):
        assert mine.dtype == torch.float32 and torch.isfinite(mine).all()
        torch.testing.assert_close(mine, r, **F32_GRAD_TOL)
    # the last, partial query block gets gradient too
    assert dq[0, :, tq - 1].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize('d', [64, 128, 192, 256])
@pytest.mark.parametrize('kernel', ['dq', 'dkv'])
def test_float32_kernels_fit_and_keep_accumulators_in_registers(cuda, kernel, d):
    """The float32 SIMT K3 and K4: 256 threads and a block fits an SM at
    every head width template; at the Aligner's widths, 64 and 256, the
    accumulators stay in registers; K3 takes 32 query rows a block at D
    256."""
    res = (dq_resources if kernel == 'dq' else dkv_resources)(d, torch.float32)
    assert res['threads'] == 256 and res['blocks_per_sm'] >= 1
    assert res['registers'] <= 255
    if d in (64, 256):
        assert res['spill_bytes'] == 0
    assert res['dynamic_smem_bytes'] <= SMEM_PER_BLOCK
    if kernel == 'dq':
        assert res['query_rows'] == (32 if d > 224 else 64)
        assert res['dynamic_smem_bytes'] == _dq_simt_smem_bytes(d)


SMEM_PER_BLOCK = 232448   # the most shared memory a block takes on the H100
BWD_SOURCE = (Path(__file__).resolve().parent.parent / 'transformertts_torch' / 'csrc'
              / 'flash_attention_bwd.cu')


def _dq_simt_rows(d: int) -> int:
    """K3 float32's query rows a block, read from the source's rule."""
    rule = re.search(r'int dq_simt_rows\(int d\) \{ return d > (\d+) \? (\d+) : (\d+); \}',
                     BWD_SOURCE.read_text())
    limit, small, large = (int(x) for x in rule.groups())
    return small if d > limit else large


def _dq_simt_smem_bytes(d: int, rows: int = None) -> int:
    """K3 float32's shared memory: Q^T and dO^T [D][rows + 1], K^T and V^T
    [D][33], K [32][D], dS^T [32][rows + 1] and the bias [32], in float32."""
    rows = _dq_simt_rows(d) if rows is None else rows
    return 4 * (2 * d * (rows + 1) + 2 * d * 33 + 32 * d + 32 * (rows + 1) + 32)


def test_float32_dq_layout_fits_a_block_at_every_width():
    """K3 float32 takes 32 query rows a block where 64 would not fit: at D
    256, 64 rows need 241,920 B and 32 need 172,288 B, against the 227 KB a
    block takes; every width it accepts fits. K4's layout at D 256,
    209,536 B, fits too."""
    assert _dq_simt_smem_bytes(256, 64) == 241920 > SMEM_PER_BLOCK
    assert _dq_simt_smem_bytes(256) == 172288
    assert _dq_simt_rows(64) == 64 and _dq_simt_rows(256) == 32
    for d in range(8, 257, 8):
        assert _dq_simt_smem_bytes(d) <= SMEM_PER_BLOCK, d
    assert 4 * (4 * 256 * 33 + 2 * 32 * 256 + 2 * 32 * 33 + 96) == 209536 <= SMEM_PER_BLOCK


def test_float32_backward_takes_head_width_256_on_the_checks():
    """The wrappers' checks no longer refuse float32 D 256 (the CPU runs the
    plain version; the checks are what a CUDA tensor meets first)."""
    from transformertts_torch.ops.flash_attention import _check_bwd
    q, k, v, bias, dout = _torch(*_inputs(1, 1, 5, 7, 256))
    out, lse = attention_fwd_lse_plain(q, k, v, bias)
    _check_bwd((q, k, v, bias, out, lse, dout))
    dq = flash_attention_bwd_dq(q, k, v, bias, out, lse, dout)
    assert dq.shape == q.shape and torch.isfinite(dq).all()
