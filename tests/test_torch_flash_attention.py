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
from transformertts_torch.ops.flash_attention import (NEG_INF, attention_fwd_lse_plain,
                                                      attention_plain, flash_attention,
                                                      flash_attention_fwd_lse,
                                                      fwd_resources)

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


# ---------------------------------------------------------------------------
# the float32 kernel's design, redone on the CPU: 3xTF32 products, 64-row
# query blocks, key tiles in an online softmax with the causal stop, and the
# m16n8k8 fragment layouts (csrc/flash_attention_fwd.cu, attn_fwd_tf32_kernel)
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
F32_ROWS = 64


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (on the sign-magnitude bits: add half of the
    13 dropped bits' unit, clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores compute it from TF32 operands: 3 passes are
    3xTF32 (big·small + small·big + big·big, small = tf32(x − big)), 1 pass
    one TF32 product."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    return ab @ _tf32(b - bb) + _tf32(a - ab) @ bb + ab @ bb


def _emulate_tf32_kernel(q, k, v, bias, causal: bool, passes: int) -> torch.Tensor:
    """The kernel's arithmetic in float32 torch ops, one (b, h) and one
    64-row query block at a time: key tiles of 64 (D <= 64) or 32, a causal
    block stopping at its last row's tile unless a live row's max lies
    within 128 of NEG_INF, logits fmaf(s, scale, bias) in natural units,
    exp2 of (x − m)·log2 e, S and P·V as ``passes`` TF32 products."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    tile = 64 if d <= 64 else 32
    scale = float(np.float32(1.0 / np.sqrt(d)))   # the wrapper passes a c_float
    n_tiles = -(-tk // tile)
    out = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, tq, F32_ROWS):
                qb = q[bi, hi, q0:q0 + F32_ROWS]
                rows = torch.arange(q0, q0 + qb.shape[0])[:, None]
                m = torch.full((qb.shape[0],), -np.inf)
                l = torch.zeros(qb.shape[0])
                o = torch.zeros(qb.shape[0], d)
                n_load = min(n_tiles, -(-(q0 + F32_ROWS) // tile)) if causal else n_tiles
                i = 0
                while i < n_load:
                    kt, vt = k[bi, hi, i * tile:(i + 1) * tile], v[bi, hi, i * tile:(i + 1) * tile]
                    cols = torch.arange(i * tile, i * tile + kt.shape[0])[None, :]
                    s = _product(qb, kt.T, passes)
                    # fmaf: the product is exact in float64, one rounding
                    x = (s.double() * scale + bias[bi, cols].double()).float()
                    if causal:
                        x = x.masked_fill(cols > rows, NEG_INF)
                    m_new = torch.maximum(m, x.amax(dim=-1))
                    alpha = torch.exp2((m - m_new) * LOG2E)
                    p = torch.exp2((x - m_new[:, None]) * LOG2E)
                    l = l * alpha + p.sum(dim=-1)
                    o = o * alpha[:, None] + _product(p, vt, passes)
                    m = m_new
                    if i == n_load - 1 and n_load < n_tiles and (m < NEG_INF + 128).any():
                        n_load = n_tiles
                    i += 1
                out[bi, hi, q0:q0 + F32_ROWS] = o / l[:, None]
    return out


def _mma_m16n8k8(a_regs, b_regs):
    """mma.sync m16n8k8 .tf32 from the 32 lanes' registers by the PTX
    layouts (lane = 4 g + t): A a[r] at (g + 8 (r & 1), t + 4 (r >> 1)),
    B b[r] at (k t + 4 r, column g); returns the (16, 8) product."""
    a, bm = torch.zeros(16, 8, dtype=torch.float64), torch.zeros(8, 8, dtype=torch.float64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            a[g + 8 * (r & 1), t + 4 * (r >> 1)] = a_regs[lane][r]
        for r in range(2):
            bm[t + 4 * r, g] = b_regs[lane][r]
    return a @ bm


def _check_pv_key_permutation():
    """P·V of one 8-key step with P in S's accumulator registers (d[e] at
    (g + 8 (e >> 1), 2 t + (e & 1))) and a one-hot V, whose product is P
    itself: the kernel's A = (d0, d2, d1, d3) with B reading keys 2t, 2t+1
    gives P; S's registers as A unpermuted, with B reading keys t, t+4,
    scramble its columns."""
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.random((16, 8)))
    v = torch.eye(8, dtype=torch.float64)   # key j puts its weight in column j
    d = [[p[lane // 4 + 8 * (e >> 1), 2 * (lane % 4) + (e & 1)].item() for e in range(4)]
         for lane in range(32)]
    kernel = _mma_m16n8k8([[r[0], r[2], r[1], r[3]] for r in d],
                          [[v[2 * (lane % 4) + r, lane // 4].item() for r in range(2)]
                           for lane in range(32)])
    naive = _mma_m16n8k8(d, [[v[lane % 4 + 4 * r, lane // 4].item() for r in range(2)]
                             for lane in range(32)])
    torch.testing.assert_close(kernel, p @ v, atol=0, rtol=0)
    assert not torch.equal(naive, p @ v)


# the Aligner's shapes at emulation size, (b, h, tq, tk, d, causal), each
# with the first sample's last keys masked; 'masked-row' also masks every
# key of the last sample. 2-3 key tiles a block, 2-3 query blocks.
TF32_CASES = {
    'causal-d64': (2, 2, 150, 150, 64, True),
    'causal-d256': (1, 2, 90, 90, 256, True),
    'masked-row-d64': (2, 2, 100, 130, 64, False),
}


@pytest.mark.parametrize('case', sorted(TF32_CASES) + ['pv-key-permutation'])
def test_tf32x3_design_arithmetic(case):
    """The float32 kernel's design meets the float32 bar: 3xTF32 S and P·V
    in its online softmax come within TOL of attention_plain and of a
    float64 reference, where one TF32 product does not; and P·V's permuted
    key order (P fed from S's registers) computes P·V."""
    if case == 'pv-key-permutation':
        _check_pv_key_permutation()
        return
    b, h, tq, tk, d, causal = TF32_CASES[case]
    q, k, v, bias = _torch(*_inputs(b, h, tq, tk, d, padded=True, seed=11))
    if case.startswith('masked-row'):
        bias[-1] = NEG_INF
    ref64 = attention_fwd_lse_plain(q.double(), k.double(), v.double(), bias.double(),
                                    causal)[0]
    live = slice(None)
    three = _emulate_tf32_kernel(q, k, v, bias, causal, passes=3)
    torch.testing.assert_close(three, attention_plain(q, k, v, bias, causal), **TOL)
    if case.startswith('masked-row'):
        # float64 keeps the real logits apart from -1e9; float32 (the
        # kernel, the plain version) rounds them onto it: the mean of v
        torch.testing.assert_close(three[-1], v[-1].mean(dim=1, keepdim=True).expand_as(three[-1]),
                                   **TOL)
        live = slice(0, -1)
    torch.testing.assert_close(three[live].double(), ref64[live], **TOL)
    one = _emulate_tf32_kernel(q, k, v, bias, causal, passes=1)
    assert not torch.allclose(one[live].double(), ref64[live], **TOL)


def _sw_off(r, c, rows):
    """Byte offset of (r, c) in a tile of 32-column, 128-byte-row boxes of
    ``rows`` rows under the 128-byte swizzle (the kernel's sw_off)."""
    return (c >> 5) * rows * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2)


@pytest.mark.parametrize('operand', ['Q', 'K', 'V'])
def test_tf32_fragment_loads_read_distinct_banks(operand):
    """Each fragment load of the float32 kernel (Q's A, K's and V's B, for
    every 8-column step and register) has its 32 lanes on 32 distinct
    banks, and the swizzled layout holds each element of a tile once."""
    rows, dmax = (F32_ROWS, 256) if operand == 'Q' else (32, 256)
    offsets = {_sw_off(r, c, rows) for r in range(rows) for c in range(dmax)}
    assert len(offsets) == rows * dmax and max(offsets) < rows * dmax * 4
    for step in range(dmax // 8 if operand != 'V' else rows // 8):
        for reg in range(4 if operand == 'Q' else 2):
            banks = set()
            for lane in range(32):
                g, t = divmod(lane, 4)
                if operand == 'Q':    # rows 16 w + g (+8), columns 8 kd + t (+4)
                    r, c = 16 + g + 8 * (reg & 1), 8 * step + t + 4 * (reg >> 1)
                elif operand == 'K':  # key 8 n + g, columns 8 kd + t (+4)
                    r, c = 8 + g, 8 * step + t + 4 * reg
                else:                 # keys 8 kk + 2 t (+1), column 8 j + g
                    r, c = 8 * step + 2 * t + reg, 40 + g
                banks.add(_sw_off(r, c, rows) // 4 % 32)
            assert len(banks) == 32, (operand, step, reg)


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
@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('d', [64, 128, 192, 256])
def test_kernel_keeps_its_accumulators_in_registers(cuda, d, train, dtype):
    """K1's instance and K2's of both designs. bfloat16: a block of two
    warpgroups fits an SM, with Q and a ring of at least two K/V stages in
    shared memory, and O stays in registers (no local memory). float32: a
    block of 4 warps with Q and its ring fits, and O stays in registers at
    the Aligner's widths, D 64 and 256 (the others' spill bytes are
    printed)."""
    res = fwd_resources(d, train, getattr(torch, dtype))
    assert res['blocks_per_sm'] >= 1 and res['registers'] <= 255
    assert res['dynamic_smem_bytes'] <= 232448
    if dtype == 'bfloat16':
        assert res['threads'] == 256 and res['spill_bytes'] == 0
        assert res['stages'] == (4 if d <= 128 else 3 if d <= 192 else 2)
        return
    assert res['threads'] == 128
    assert res['stages'] == (3 if d == 192 else 2)
    assert res['key_tile'] == (64 if d <= 64 else 32)
    print(f'float32 D {d} train {train}: {res}')
    if d in (64, 256):
        assert res['spill_bytes'] == 0


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, bias = _torch(*_inputs(1, 2, 8, 8, 264, padded=False), device=cuda)
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
    """K1 where the Aligner runs it: float32 (3xTF32 on mma.sync, the
    Aligner's compute dtype) at the f32 bar, bfloat16 (wgmma) at the bf16
    bar."""
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


# the float32 design's edges beyond EDGE_CASES: head widths 8 (one 8-column
# step) and 24 (a 32-column box zero-filled past D), causal with Tq < Tk
F32_EDGE_CASES = EDGE_CASES + [((2, 2, 45, 70, 8), True), ((3, 1, 70, 33, 24), False)]
F32_EDGE_IDS = EDGE_IDS + ['2x2x45x70x8-causal', '3x1x70x33x24']


def _forward(kernel, q, k, v, bias, causal, rate=0.1):
    """(out, lse, plain out, plain lse): K1's (lse None) or K2's at dropout
    ``rate`` with one (seed, offset), and the plain version's."""
    if kernel == 'K1':
        out = flash_attention(q, k, v, bias, causal)
        torch.cuda.synchronize()
        return out, None, attention_plain(q, k, v, bias, causal), None
    args = (causal, rate, 1234, 5678)
    out, lse = flash_attention_fwd_lse(q, k, v, bias, *args)
    torch.cuda.synchronize()
    return (out, lse, *attention_fwd_lse_plain(q, k, v, bias, *args))


def _assert_forward_close(out, lse, ref, ref_lse):
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **TOL)
    if lse is not None:
        torch.testing.assert_close(lse, ref_lse, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('kernel', ['K1', 'K2'])
@pytest.mark.parametrize('shape,causal', F32_EDGE_CASES, ids=F32_EDGE_IDS)
def test_float32_kernel_at_the_design_edges(cuda, shape, causal, kernel):
    """The 3xTF32 kernel, K1's instance and K2's (dropout 0.1), where its
    tiles, ring, boxes and causal stop are ragged, with the first sample's
    last keys and the last sample's every key masked, at the f32 bar."""
    b, h, tq, tk, d = shape
    q, k, v, bias = _torch(*_inputs(b, h, tq, tk, d, padded=True, seed=4), device=cuda)
    bias[-1] = NEG_INF
    _assert_forward_close(*_forward(kernel, q, k, v, bias, causal))


@pytest.mark.cuda
@pytest.mark.parametrize('kernel', ['K1', 'K2'])
@pytest.mark.parametrize('d', [8, 64, 256])
def test_float32_decode_step_against_a_masked_cache(cuda, d, kernel):
    """Tq 1 (one decode step of the Aligner's predict) against a cache
    whose positions after the step are masked: one query row in a block of
    64, one or more key tiles past the step."""
    q, k, v, bias = _torch(*_inputs(2, 3, 1, 300, d, padded=False, seed=6), device=cuda)
    bias[:, 138:] = NEG_INF
    _assert_forward_close(*_forward(kernel, q, k, v, bias, causal=False))


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ALIGNER_CASES))
def test_k2_float32_at_the_aligner_shapes_with_dropout(cuda, case):
    """K2's float32 instance, the forward of the Aligner's training step,
    at dropout 0.1 against the plain version fed the same mask."""
    b, h, tq, tk, d, causal, step = ALIGNER_CASES[case]
    q, k, v, bias = _torch(*_inputs(b, h, tq, tk, d, padded=step is None, seed=5),
                           device=cuda)
    if step is not None:
        bias[:, step + 1:] = NEG_INF
    before = flash_attention_fwd_lse.launches
    result = _forward('K2', q, k, v, bias, causal)
    assert flash_attention_fwd_lse.launches == before + 1
    _assert_forward_close(*result)


@pytest.mark.cuda
@pytest.mark.parametrize('d,tk', [(64, 64), (256, 96)])
def test_float32_kernel_with_one_hot_v_returns_the_weights(cuda, d, tk):
    """V = the identity (key j puts its weight in column j), so the output
    is the softmax weights themselves: a key order of P·V that does not
    match P's registers would show as permuted columns."""
    q, k, _, bias = _torch(*_inputs(2, 2, 80, tk, d, padded=True, seed=8), device=cuda)
    v = torch.eye(tk, d, device=cuda).expand(2, 2, tk, d).contiguous()
    out = flash_attention(q, k, v, bias, causal=True)
    torch.cuda.synchronize()
    logits = q @ k.transpose(-1, -2) / d ** 0.5 + bias[:, None, None, :]
    rows, cols = torch.arange(80, device=cuda)[:, None], torch.arange(tk, device=cuda)[None]
    weights = torch.softmax(logits.masked_fill(cols > rows, NEG_INF), dim=-1)
    torch.testing.assert_close(out[..., :tk], weights, **TOL)
    assert not out[..., tk:].any()
