"""The float32 backward designs, redone on the CPU: K4 (dK, dV:
``attn_dkv_tf32_kernel`` in ``csrc/flash_attention_bwd.cu``) and its mirror
K3 (dQ: ``attn_dq_tf32_kernel``).

K4 float32 runs its four products as 3xTF32 on ``mma.sync`` m16n8k8: a block
owns BK keys, query tiles of BQ stream past it, and a causal block starts
its walk at the tile of its first key unless an earlier row is fully masked.
K3 float32 runs its three as 3xTF32 too: a block owns BQ queries, key tiles
of BK stream past it, and a causal block stops its walk at its last row.
The emulations below redo that arithmetic in float32 torch ops with the
tile sizes read from the source's rules, and are held at the float32 bar of
the JAX flash backward (atol 5e-5, rtol 1e-3) against the plain version,
the JAX flash backward (Pallas in interpret mode) and float64; one TF32
product misses that bar. The fragment layouts (the permuted order of the
output products' k) and the banks of every fragment load are checked lane
by lane. The card tests carry the ``cuda`` marker and skip without one.
"""
import re

import numpy as np
import pytest
import torch

from test_torch_flash_attention import _mma_m16n8k8, _product, _sw_off
from test_torch_flash_attention_bwd import (BWD_SOURCE, F32_GRAD_TOL, SMEM_PER_BLOCK,
                                            _inputs, _jax_grads, _rule, _torch)
from transformertts_torch.ops.flash_attention import (
    NEG_INF, attention_bwd_plain, attention_fwd_lse_plain, dkv_resources, dq_resources,
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd_lse)

torch.set_num_threads(1)


# keys a block, ring stages and blocks an SM by head-width template, and the
# queries of a tile, the same at every width
KEYS, STAGES, BLOCKS = (_rule(f'dkv_tf32_{n}') for n in ('keys', 'stages', 'blocks'))
BQ = int(re.search(r'constexpr int DKV_TF32_QUERIES = (\d+);', BWD_SOURCE.read_text()).group(1))
# K3's mirror: queries a block, ring stages and blocks an SM by head-width
# template, and the keys of a tile, the same at every width
DQ_QUERIES, DQ_STAGES, DQ_BLOCKS = (_rule(f'dq_tf32_{n}')
                                    for n in ('queries', 'stages', 'blocks'))
BK = int(re.search(r'constexpr int DQ_TF32_KEYS = (\d+);', BWD_SOURCE.read_text()).group(1))


def _dmax(d: int) -> int:
    return next(m for m in (64, 128, 192, 256) if d <= m)


def _group(dmax: int) -> int:
    """Warps that share 16 keys: the block's 8 warps over its BK / 16 groups."""
    return 8 // (KEYS(dmax) // 16)


def _smem_bytes(dmax: int) -> int:
    """K4 float32's shared memory: K and V; STAGES x (Q, dO, (m, log l), D and
    the dropout row hashes); the score swap buffer (8 B a key x query); the
    barriers; one 1024-byte swizzle pattern of alignment."""
    bk, bq, stages = KEYS(dmax), BQ, STAGES(dmax)
    return (1024 + 2 * bk * dmax * 4 + stages * bq * (2 * dmax * 4 + 16) + bk * bq * 8
            + 8 * (1 + 2 * stages))


def _dq_group(dmax: int) -> int:
    """Warps that share 16 queries: the block's 8 warps over its BQ / 16 groups."""
    return 8 // (DQ_QUERIES(dmax) // 16)


def _dq_smem_bytes(dmax: int, queries: int = None) -> int:
    """K3 float32's shared memory: Q and dO; STAGES x (K, V and the bias);
    the score swap buffer (8 B a query x key); the barriers; one 1024-byte
    swizzle pattern of alignment."""
    bq, stages = queries or DQ_QUERIES(dmax), DQ_STAGES(dmax)
    return (1024 + 2 * bq * dmax * 4 + stages * BK * (2 * dmax * 4 + 4) + bq * BK * 8
            + 8 * (1 + 2 * stages))


def _fmaf_logits(s, scale, bias_row):
    """fmaf(s, scale, bias): the product exact in float64, one rounding."""
    return (s.double() * scale + bias_row.double()).float()


def _first_tile(lse_m, kb0: int, bq: int, causal: bool) -> int:
    """The query tile a key block's walk starts at: the tile of kb0 (causal),
    or that of the first earlier row whose max lies within 128 of NEG_INF."""
    n_qt = -(-lse_m.shape[0] // bq)
    if not causal:
        return 0
    skip = min(kb0 // bq, n_qt)
    low = torch.nonzero(lse_m[:skip * bq] < NEG_INF + 128).flatten()
    return min(skip, int(low[0]) // bq) if len(low) else skip


def _emulate_dkv(q, k, v, bias, lse, dout, dsum, causal: bool, passes: int):
    """The float32 K4 kernel's arithmetic in float32 torch ops, one (b, h)
    and one block of BK keys at a time: query tiles of BQ from the causal
    start, the four products as ``passes`` TF32 products, fmaf logits,
    P = exp(min((x − m) − log l, 0)) and dS = P∘(dPᵀ − D), 0 at look-ahead."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dmax = _dmax(d)
    bk, bq = KEYS(dmax), BQ
    scale = float(np.float32(1.0 / np.sqrt(d)))   # the wrapper passes a c_float
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for hi in range(h):
            for kb0 in range(0, tk, bk):
                keys = torch.arange(kb0, min(kb0 + bk, tk))
                kt, vt = k[bi, hi, keys], v[bi, hi, keys]
                acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
                start = _first_tile(lse[bi, hi, :, 0], kb0, bq, causal)
                for q0 in range(start * bq, tq, bq):
                    rows = torch.arange(q0, min(q0 + bq, tq))
                    qt, ot = q[bi, hi, rows], dout[bi, hi, rows]
                    x = _fmaf_logits(_product(kt, qt.T, passes), scale, bias[bi, keys][:, None])
                    ahead = keys[:, None] > rows[None, :]
                    if causal:
                        x = x.masked_fill(ahead, NEG_INF)
                    rl = lse[bi, hi, rows]
                    p = torch.exp(torch.clamp_max((x - rl[:, 0]) - rl[:, 1], 0.0))
                    ds = p * (_product(vt, ot.T, passes) - dsum[bi, hi, rows])
                    if causal:
                        ds = ds.masked_fill(ahead, 0.0)
                    acc_v = acc_v + _product(p, ot, passes)
                    acc_k = acc_k + _product(ds, qt, passes)
                dk[bi, hi, keys], dv[bi, hi, keys] = acc_k * scale, acc_v
    return dk, dv


# (b, h, tq, tk, d, causal, masking): the first sample's last keys masked;
# 'row' also masks every key of the last sample, 'prefix' the first 10 keys
# of the last sample (causal: its rows 0-9 see only masked keys, and lie
# before its later key blocks). 2-3 key blocks, 3-5 query tiles.
BWD_CASES = {
    'causal-d64': (2, 2, 150, 150, 64, True, None),
    'causal-d256': (1, 2, 90, 90, 256, True, None),
    'masked-row-d64': (2, 2, 100, 130, 64, False, 'row'),
    'masked-row-causal-d64': (2, 2, 140, 140, 64, True, 'row'),
    'masked-prefix-causal-d256': (2, 1, 100, 100, 256, True, 'prefix'),
}


def _case_inputs(case):
    b, h, tq, tk, d, causal, masking = BWD_CASES[case]
    arrays = list(_inputs(b, h, tq, tk, d, seed=12, masked_row=masking == 'row'))
    if masking == 'prefix':
        arrays[3][-1, :10] = NEG_INF
    return arrays, causal, masking


@pytest.mark.parametrize('case', sorted(BWD_CASES))
def test_dkv_tf32x3_design_arithmetic(case):
    """3xTF32 with the causal skip and the fully-masked-row rule comes within
    the float32 bar of the plain version, of the JAX flash backward and of
    float64 at every sample whose rows see a real key; one TF32 product
    does not. A fully masked row's weights (1/Tk at every key, look-ahead
    included) are what float32 makes of its logits, so there the plain
    version is the reference."""
    arrays, causal, masking = _case_inputs(case)
    q, k, v, bias, dout = _torch(*arrays)
    out, lse = attention_fwd_lse_plain(q, k, v, bias, causal)
    dsum = (dout * out).sum(dim=-1)
    three = _emulate_dkv(q, k, v, bias, lse, dout, dsum, causal, passes=3)
    plain = attention_bwd_plain(q, k, v, bias, out, lse, dout, causal)[1:]
    for mine, ref in zip(three, plain):
        torch.testing.assert_close(mine, ref, **F32_GRAD_TOL)
    live = slice(None) if masking is None else slice(0, -1)
    q64, k64, v64, bias64, dout64 = (x.double() for x in (q, k, v, bias, dout))
    out64, lse64 = attention_fwd_lse_plain(q64, k64, v64, bias64, causal)
    ref64 = attention_bwd_plain(q64, k64, v64, bias64, out64, lse64, dout64, causal)[1:]
    jax_live = [a[live] for a in arrays]
    jax_grads = _jax_grads(*jax_live, causal)[1:]
    for mine, r64, rjax in zip(three, ref64, jax_grads):
        torch.testing.assert_close(mine[live].double(), r64[live], **F32_GRAD_TOL)
        np.testing.assert_allclose(mine[live].numpy(), rjax, **F32_GRAD_TOL)
    one = _emulate_dkv(q, k, v, bias, lse, dout, dsum, causal, passes=1)
    assert not all(torch.allclose(m[live].double(), r[live], **F32_GRAD_TOL)
                   for m, r in zip(one, ref64))


def _check_permuted_k_order(seed: int):
    """An output product's step of 8 (K4: dV += (P∘M)ᵀ·dO or dK += dSᵀ·Q
    over 8 queries; K3: dQ += dS·K over 8 keys) with its A in the score
    accumulator's registers (d[e] at row g + 8 (e >> 1), k 2 t + (e & 1))
    and a one-hot B, whose product is A itself: the kernel's A = (d0, d2,
    d1, d3) with B reading rows 2t, 2t+1 gives it; the registers as A
    unpermuted, with B reading rows t, t+4, scramble its columns."""
    rng = np.random.default_rng(seed)
    pt = torch.from_numpy(rng.standard_normal((16, 8)))   # rows x k
    one_hot = torch.eye(8, dtype=torch.float64)   # k = j puts its weight in column j
    d = [[pt[lane // 4 + 8 * (e >> 1), 2 * (lane % 4) + (e & 1)].item() for e in range(4)]
         for lane in range(32)]
    kernel = _mma_m16n8k8([[r[0], r[2], r[1], r[3]] for r in d],
                          [[one_hot[2 * (lane % 4) + r, lane // 4].item() for r in range(2)]
                           for lane in range(32)])
    naive = _mma_m16n8k8(d, [[one_hot[lane % 4 + 4 * r, lane // 4].item() for r in range(2)]
                             for lane in range(32)])
    torch.testing.assert_close(kernel, pt @ one_hot, atol=0, rtol=0)
    assert not torch.equal(naive, pt @ one_hot)


@pytest.mark.parametrize('product', ['dV', 'dK'])
def test_output_products_read_queries_in_the_permuted_order(product):
    _check_permuted_k_order(seed={'dV': 3, 'dK': 4}[product])


def test_dq_product_reads_keys_in_the_permuted_order():
    """K3's dQ += dS·K: dS in S's accumulators (queries x keys), K one-hot."""
    _check_permuted_k_order(seed=5)


def _fragment_rows_cols(layout: str, lane: int, step: int, reg: int, block: int):
    """(row, column) of the resident or streamed tile that a lane's register
    ``reg`` of a fragment load reads: 'A' of a score product (rows 16 block
    + g (+8), columns 8 step + t (+4)), 'B' of a score product (rows 8 block
    + g, columns 8 step + t + 4 reg), and 'B-permuted', the B of an output
    product (rows 8 step + 2 t + reg, column 8 block + g)."""
    g, t = divmod(lane, 4)
    if layout == 'A':
        return 16 * block + g + 8 * (reg & 1), 8 * step + t + 4 * (reg >> 1)
    if layout == 'B':
        return 8 * block + g, 8 * step + t + 4 * reg
    return 8 * step + 2 * t + reg, 8 * block + g


def _check_banks(layout: str, rows: int, d: int):
    """Every fragment load of ``layout`` from a swizzled tile of ``rows`` x
    ``d``, for each step, register and block of rows or columns, has its 32
    lanes on 32 distinct banks, and the tile holds each element once."""
    offsets = {_sw_off(r, c, rows) for r in range(rows) for c in range(d)}
    assert len(offsets) == rows * d and max(offsets) < rows * d * 4
    steps, regs, blocks = {'A': (d // 8, 4, rows // 16), 'B': (d // 8, 2, rows // 8),
                           'B-permuted': (rows // 8, 2, d // 8)}[layout]
    for step in range(steps):
        for reg in range(regs):
            for block in range(blocks):
                banks = {_sw_off(*_fragment_rows_cols(layout, lane, step, reg, block),
                                 rows) // 4 % 32 for lane in range(32)}
                assert len(banks) == 32, (layout, step, reg, block)


@pytest.mark.parametrize('d', [64, 256])
@pytest.mark.parametrize('operand', ['K', 'V', 'Q', 'dO', 'Q-permuted', 'dO-permuted'])
def test_dkv_tf32_fragment_loads_read_distinct_banks(operand, d):
    """K4 float32: K and V (resident) as A, Q and dO (streamed) as B."""
    if operand in ('K', 'V'):
        _check_banks('A', KEYS(d), d)
    else:
        _check_banks('B-permuted' if operand.endswith('-permuted') else 'B', BQ, d)


@pytest.mark.parametrize('d', [64, 256])
@pytest.mark.parametrize('operand', ['Q', 'dO', 'K', 'V', 'K-permuted'])
def test_dq_tf32_fragment_loads_read_distinct_banks(operand, d):
    """K3 float32: Q and dO (resident) as A, K and V (streamed) as B, and K
    as the B of dQ += dS·K."""
    if operand in ('Q', 'dO'):
        _check_banks('A', DQ_QUERIES(d), d)
    else:
        _check_banks('B-permuted' if operand == 'K-permuted' else 'B', BK, d)


def test_dkv_tf32_layout_fits_a_block_at_every_width():
    """The design's tiles at each head-width template: 8 warps as BK / 16
    groups of G, each score warp over a whole number of 8-query steps, the
    columns split evenly in groups of 4 n-tiles, and the shared memory
    within a block's 232,448 B (D 256: K and V of 32 keys 64 KB, two
    32-query stages of Q and dO 128 KB)."""
    for dmax in (64, 128, 192, 256):
        bk, bq, group = KEYS(dmax), BQ, _group(dmax)
        assert (bk // 16) * group == 8 and group in (2, 4)
        assert (bq // 8) % (group // 2) == 0 and (dmax // 8 // group) % 4 == 0
        assert _smem_bytes(dmax) <= SMEM_PER_BLOCK, dmax
    assert (KEYS(64), BQ, STAGES(64), BLOCKS(64)) == (64, 32, 3, 2)
    assert (KEYS(256), STAGES(256), _group(256)) == (32, 2, 4)
    assert _smem_bytes(256) == 206888 and _smem_bytes(64) == 100920
    # two blocks an SM at D 64: twice its shared memory within the SM's 228 KB
    assert 2 * (_smem_bytes(64) + 1024) <= 233472


def _dq_walk(q0: int, tk: int, bq: int, causal: bool) -> range:
    """The key tiles' first keys that a K3 block of queries q0 .. q0 + bq − 1
    walks: up to its last row when causal (dS is 0 at look-ahead keys)."""
    return range(0, min(tk, q0 + bq) if causal else tk, BK)


def _stepped(a, b, passes: int):
    """a @ b as the kernel sums it: one ``passes``-TF32 product an 8-wide
    step of the contraction, each added in float32 (mma_3xtf32_add)."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for c in range(0, a.shape[1], 8):
        out = out + _product(a[:, c:c + 8], b[c:c + 8], passes)
    return out


def _emulate_dq(q, k, v, bias, lse, dout, dsum, causal: bool, passes: int):
    """The float32 K3 kernel's arithmetic in float32 torch ops, one (b, h)
    and one block of BQ queries at a time: key tiles of BK up to the causal
    stop, S, dP and dQ += dS·K stepped as the kernel sums them, fmaf logits,
    P = exp(min((x − m) − log l, 0)) and dS = P∘(dP − D), 0 at look-ahead."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    bq = DQ_QUERIES(_dmax(d))
    scale = float(np.float32(1.0 / np.sqrt(d)))   # the wrapper passes a c_float
    dq = torch.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, tq, bq):
                rows = torch.arange(q0, min(q0 + bq, tq))
                qt, ot, rl = q[bi, hi, rows], dout[bi, hi, rows], lse[bi, hi, rows]
                acc = torch.zeros_like(qt)
                for k0 in _dq_walk(q0, tk, bq, causal):
                    keys = torch.arange(k0, min(k0 + BK, tk))
                    kt, vt = k[bi, hi, keys], v[bi, hi, keys]
                    x = _fmaf_logits(_stepped(qt, kt.T, passes), scale, bias[bi, keys][None, :])
                    ahead = keys[None, :] > rows[:, None]
                    if causal:
                        x = x.masked_fill(ahead, NEG_INF)
                    p = torch.exp(torch.clamp_max((x - rl[:, :1]) - rl[:, 1:], 0.0))
                    ds = p * (_stepped(ot, vt.T, passes) - dsum[bi, hi, rows][:, None])
                    if causal:
                        ds = ds.masked_fill(ahead, 0.0)
                    for c in range(0, len(keys), 8):
                        acc = acc + _product(ds[:, c:c + 8], kt[c:c + 8], passes)
                dq[bi, hi, rows] = acc * scale
    return dq


@pytest.mark.parametrize('case', sorted(BWD_CASES))
def test_dq_tf32x3_design_arithmetic(case):
    """K3's 3xTF32 with its causal stop comes within the float32 bar of the
    plain version, of the JAX flash backward and of float64 at every sample
    whose rows see a real key; one TF32 product does not. A fully masked
    row's weights are what float32 makes of its logits, so there the plain
    version is the reference."""
    arrays, causal, masking = _case_inputs(case)
    q, k, v, bias, dout = _torch(*arrays)
    out, lse = attention_fwd_lse_plain(q, k, v, bias, causal)
    dsum = (dout * out).sum(dim=-1)
    three = _emulate_dq(q, k, v, bias, lse, dout, dsum, causal, passes=3)
    torch.testing.assert_close(three, attention_bwd_plain(q, k, v, bias, out, lse, dout,
                                                          causal)[0], **F32_GRAD_TOL)
    live = slice(None) if masking is None else slice(0, -1)
    q64, k64, v64, bias64, dout64 = (x.double() for x in (q, k, v, bias, dout))
    out64, lse64 = attention_fwd_lse_plain(q64, k64, v64, bias64, causal)
    ref64 = attention_bwd_plain(q64, k64, v64, bias64, out64, lse64, dout64, causal)[0]
    torch.testing.assert_close(three[live].double(), ref64[live], **F32_GRAD_TOL)
    jax_dq = _jax_grads(*[a[live] for a in arrays], causal)[0]
    np.testing.assert_allclose(three[live].numpy(), jax_dq, **F32_GRAD_TOL)
    one = _emulate_dq(q, k, v, bias, lse, dout, dsum, causal, passes=1)
    assert not torch.allclose(one[live].double(), ref64[live], **F32_GRAD_TOL)


@pytest.mark.parametrize('d', [64, 256])
def test_dq_float32_causal_stop_matches_plain(d):
    """K3 float32 stopping each causal block of BQ queries at its last row:
    dQ takes nothing from look-ahead keys (dS = 0 there), fully masked rows
    included, so it equals the plain version, though the blocks walk 11 of
    the 15 key tiles at D 64 (64-query blocks) and 15 of 25 at D 256 (32)."""
    arrays = list(_inputs(2, 2, 150, 150, d, seed=13, masked_row=True))
    arrays[3][0, :10] = NEG_INF   # and the first sample's rows 0-9 fully masked
    q, k, v, bias, dout = _torch(*arrays)
    out, lse = attention_fwd_lse_plain(q, k, v, bias, True)
    bq = DQ_QUERIES(d)
    walked = sum(len(_dq_walk(q0, 150, bq, True)) for q0 in range(0, 150, bq))
    everything = sum(len(_dq_walk(q0, 150, bq, False)) for q0 in range(0, 150, bq))
    assert (walked, everything) == ((11, 15) if d == 64 else (15, 25))
    dq = _emulate_dq(q, k, v, bias, lse, dout, (dout * out).sum(-1), True, passes=3)
    ref = attention_bwd_plain(q, k, v, bias, out, lse, dout, True)[0]
    torch.testing.assert_close(dq, ref, **F32_GRAD_TOL)
    assert dq[-1].abs().max() > 0 and dq[0, :, 10:].abs().max() > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('the CUDA kernels run only on a card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


# (b, h, tq, tk, d, causal, masking) of the float32 K4's own edges: the
# Aligner's cross-attention (Tk 160: 3 key blocks at D 64, the last of 32
# keys); causal self-attentions whose fully masked rows (the first 10 keys
# masked) lie before later key blocks, at D 64 and 256; and a sample with
# one key, where P = 1 and dS = dP - D cancels to 0 (the TTS encoder's
# width, D 192, and D 64)
CARD_CASES = {
    'cross-d64': (2, 4, 300, 160, 64, False, None),
    'masked-prefix-causal-d64': (2, 2, 300, 300, 64, True, 'prefix'),
    'masked-prefix-causal-d256': (2, 1, 300, 300, 256, True, 'prefix'),
    'one-key-d192': (2, 2, 128, 128, 192, False, 'one-key'),
    'one-key-d64': (2, 4, 300, 300, 64, False, 'one-key'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_float32_dkv_kernel_at_its_design_edges(cuda, case, rate):
    b, h, tq, tk, d, causal, masking = CARD_CASES[case]
    arrays = list(_inputs(b, h, tq, tk, d, seed=14))
    if masking == 'prefix':
        arrays[3][-1, :10] = NEG_INF
    if masking == 'one-key':
        arrays[3][-1, 1:] = NEG_INF
    q, k, v, bias, dout = _torch(*arrays, device=cuda)
    args = (causal, rate, 31, 41)
    out, lse = flash_attention_fwd_lse(q, k, v, bias, *args)
    count = flash_attention_bwd_dkv.launches
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, out, lse, dout, *args)
    dq = flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dkv.launches == count + 1
    ref = attention_bwd_plain(q, k, v, bias, out, lse, dout, *args)
    for mine, r in zip((dq, dk, dv), ref):
        assert mine.dtype == torch.float32 and torch.isfinite(mine).all()
        torch.testing.assert_close(mine, r, **F32_GRAD_TOL)
    if masking == 'prefix':
        # the fully masked rows 0-9 weigh every key 1/Tk: the last key block
        # gets dV from them though it starts past them
        assert dv[-1, :, -1].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize('d', [64, 128, 192, 256])
def test_float32_dkv_resources_follow_the_source_rules(cuda, d):
    res = dkv_resources(d, torch.float32)
    assert res['threads'] == 256 and res['blocks_per_sm'] == BLOCKS(d)
    assert (res['query_tile'], res['key_block'], res['stages']) == \
        (BQ, KEYS(d), STAGES(d))
    assert res['dynamic_smem_bytes'] == _smem_bytes(d)


@pytest.mark.cuda
@pytest.mark.parametrize('rate', [0.0, 0.1])
@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_float32_dq_kernel_at_its_design_edges(cuda, case, rate):
    """K3 float32 at K4's edges: the cross-attention (Tq 300 past 5 key
    tiles, the last of 32), fully masked rows in a causal block that stops
    at its first key tile, and the one-key sample whose dS cancels."""
    b, h, tq, tk, d, causal, masking = CARD_CASES[case]
    arrays = list(_inputs(b, h, tq, tk, d, seed=15))
    if masking == 'prefix':
        arrays[3][-1, :10] = NEG_INF
    if masking == 'one-key':
        arrays[3][-1, 1:] = NEG_INF
    q, k, v, bias, dout = _torch(*arrays, device=cuda)
    args = (causal, rate, 37, 43)
    out, lse = flash_attention_fwd_lse(q, k, v, bias, *args)
    count = flash_attention_bwd_dq.launches
    dq = flash_attention_bwd_dq(q, k, v, bias, out, lse, dout, *args)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == count + 1
    ref = attention_bwd_plain(q, k, v, bias, out, lse, dout, *args)[0]
    assert dq.dtype == torch.float32 and torch.isfinite(dq).all()
    torch.testing.assert_close(dq, ref, **F32_GRAD_TOL)
    if masking == 'prefix':
        # the fully masked rows 0-9 weigh their keys 1/Tk: they get dQ too
        assert dq[-1, :, :10].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize('d', [64, 128, 192, 256])
def test_float32_dq_resources_follow_the_source_rules(cuda, d):
    res = dq_resources(d, torch.float32)
    assert res['threads'] == 256 and res['blocks_per_sm'] == DQ_BLOCKS(d)
    assert (res['key_tile'], res['query_block'], res['stages']) == \
        (BK, DQ_QUERIES(d), DQ_STAGES(d))
    assert res['dynamic_smem_bytes'] == _dq_smem_bytes(d)
