// Fused attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernels of transformertts_tpu/ops/flash_attention.py
// called through _flash_core_bwd:
// - flash_attention_bwd_dq (K3) replaces ::_attn_dq_kernel;
// - flash_attention_bwd_dkv (K4) replaces ::_attn_dkv_kernel.
//
// Both recompute the weights from the forward's logsumexp instead of storing
// them (Dao 2022, Alg. 4): with x = q.k * scale + bias (causal look-ahead set
// to -1e9, keys >= Tk excluded) and the row's lse as K2 stores it, the pair
// (m, log l), P = exp(min((x - m) - log l, 0)), the dropout mask M
// = keep / (1 - rate) regenerated from dropout_hash.cuh, and D = rowsum(dO o O)
// computed by the caller,
//
//     dV = (P o M)^T dO,   dS = P o ((dO V^T) o M - D),
//     dQ = dS K * scale,   dK = dS^T Q * scale,
//
// with dS = 0 at the causal look-ahead, whose logit is the constant -1e9.
// (x - m is exact where it matters: in a fully masked row every x and m lie
// near -1e9, and the pair keeps that row's weights at the forward's 1/Tk.
// The clamp at 0 is exact, since x <= m and l >= 1.) The bias is a mask, not
// a parameter: it gets no gradient, as in the TPU design.
//
// What bounds them on this card, and the design:
// - The TPU kernels keep a (batch, head)'s whole K/V (dQ) or whole Q/dO (dK,
//   dV) in VMEM. At the training shapes (T 512-896, D 192, bf16) each is
//   0.2-0.35 MB, over the 227 KB of shared memory a block has. Since lse is
//   known, no online rescaling is needed: K3 streams key tiles past a
//   64-query block, K4 streams query tiles past a 64-key block, and each
//   block owns its output rows, so there are no atomics.
// - bfloat16 runs all products on the tensor cores with mma.sync m16n8k16
//   (float32 accumulate); P and dS go back to them in bfloat16. Both kernels
//   have one structure, below.
// - float32 runs SIMT kernels on the CUDA cores (TF32 would not hold float32
//   parity): 256 threads, K3 with 64 queries (32 at D > 224) x 32-key tiles,
//   K4 with 32 keys x 32-query tiles.
//
// K4 in bfloat16 (attn_dkv_mma_kernel). At the decoder's training shape,
// B32 H2 Tq = Tk = 512 D 192, its four products (S, dP, dV, dK) are
// 25.8 GFLOP against 76 MB of inputs and outputs: bound by operations,
// 0.0261 ms at 989 TFLOP/s. The first design (32-query tiles, 4 warps)
// took 0.848 ms, for five reasons; what this design does about each:
// 1. Four warps an SM: 158,720 B of shared memory a block (K, V, Q, dO,
//    Q^T, dO^T and dK in float32) let one block of 4 warps onto an SM, and
//    nothing hid the latency of mma.sync or of the fragment loads. Now a
//    block runs 8 warps in pairs: warps w and w + 4 share keys 16 (w % 4)
//    .. + 15; w computes S^T = K Q^T, w + 4 dP^T = V dO^T, each over the
//    full depth. They swap accumulators through shared memory (a float4 a
//    lane: each lane stores and loads the same positions, no conflicts),
//    both form P o M and dS (elementwise work done twice; no product is),
//    and w accumulates dV and dK for the lower half of the columns, w + 4
//    for the upper half. 188,416 B a block at D 192: one block of 8 warps.
// 2. No copy overlapped math. Now the next query tile's Q, dO, (m, log l)
//    and D arrive by cp.async (16 B, zero-filled outside Tq and D) in a
//    two-stage ring while the current tile computes: one barrier a tile,
//    plus one 64-thread barrier a pair for the swap.
// 3. Q^T and dO^T were written to shared memory 2 bytes at a time for the
//    B operands. Now ldmatrix.x4 loads every operand from the row-major
//    tiles, and ldmatrix.x4.trans gives Q and dO as the B operands of
//    dK += dS^T Q and dV += (P o M)^T dO; the rows keep their 8-element
//    pad, so the 8 rows of an ldmatrix fall in different banks.
// 4. dK was read and rewritten in shared memory on every tile. Now dK and
//    dV stay in registers: 2 x 12 n-tiles, 96 floats a thread at D 192.
// 5. 32-query tiles gave the output products 2 k-steps a tile. Now a tile
//    has 64 queries (4 k-steps), and the dropout row hash is computed once
//    a query row a tile, beside (m, log l) and D, not once an element.
// The query tile is 64 up to D = 192, picked by measurement: on an H100
// 80GB HBM3 at 700 W, 0.316 ms at the decoder's training shape (dropout
// 0.1) against 0.329 ms with 32-query tiles, which still leave one block an
// SM. At D > 192 it is 32, since 64 would need 237,568 B of shared memory.
//
// K3 in bfloat16 (attn_dq_mma_kernel). At the same shape its three products
// (S, dP, dS K) are 19.3 GFLOP against 63 MB: bound by operations, 0.0195
// ms. The first design took 0.587 ms: 4 warps a block, one block an SM (Q,
// dO, K, V and K^T in 130 KB of shared memory), K^T stored 2 bytes at a
// time, every operand by scalar 32-bit loads, and each key tile loaded
// between two barriers before any math. It now has K4's structure, with the
// roles of queries and keys exchanged:
// - 8 warps in pairs: warps w and w + 4 share queries q0 + 16 (w % 4) .. + 15;
//   over a key tile w computes S = Q K^T, w + 4 dP = dO V^T, they swap
//   accumulators as K4's pairs do, both form dS, and each accumulates
//   dQ += dS K over half of the columns: 48 floats a thread at D 192.
// - ldmatrix.x4 loads every operand; .trans on the row-major K tile gives
//   the B operands of dS K, so there is no K^T copy.
// - K, V and the bias of the next key tile arrive by cp.async (zero-filled
//   outside Tk and D) in a two-stage ring while the current tile computes.
// - A block's query rows are fixed, so each thread holds (m, log l), D and
//   the dropout row hash of its two rows in registers throughout.
// Shared memory at D 192: Q and dO 51,200 B, the K/V ring 102,400 B, the
// swap buffer 32,768 B and the bias ring 512 B, 186,880 B in all: one block
// of 8 warps an SM. At D > 192 the key tile is 32, since 64 would need
// 236,032 B, over a block's 232,448.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr float NEG_INF = -1e9f;

struct Drop {
    uint32_t key, thr;
    float keep_scale;
};

// x -> P, given the row's lse (m, log l); 0 outside the (Tq, Tk) rectangle
__device__ __forceinline__ float recompute_p(float s, float scale, float b, int row,
                                             int col, int Tq, int Tk, int causal,
                                             float2 lse) {
    if (row >= Tq || col >= Tk) return 0.f;
    float x = s * scale + b;
    if (causal && col > row) x = NEG_INF;
    return expf(fminf((x - lse.x) - lse.y, 0.f));
}

// dS from P and dP o M; 0 at the causal look-ahead, whose logit does not
// depend on q or k (P there is 0 unless the whole row is masked)
__device__ __forceinline__ float recompute_ds(float p, float dpm, float d, int row,
                                              int col, int causal) {
    return (causal && col > row) ? 0.f : p * (dpm - d);
}

__device__ __forceinline__ float2 row_lse_at(const float* lse, long long i) {
    return reinterpret_cast<const float2*>(lse)[i];
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), 8 warps in pairs, ldmatrix
// operands, a two-stage cp.async ring (see the notes at the top)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;   // 4 pairs of warps, 16 rows a pair
constexpr int TILE = 64;           // K3: queries a block; K4: keys a block

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i receives it in mma fragment order
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// cp.async of 16, 8 or 4 bytes; with valid false the destination is zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the 64 threads of warps w and w + 4 (barrier 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int pair) {
    asm volatile("bar.sync %0, 64;\n" :: "r"(pair + 1) : "memory");
}

// Rows [r0, r0 + n) of a (T, D) bf16 matrix into a row-major [n][rs] tile by
// 16-byte cp.async, zero outside rows < T and columns < D (up to DP).
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst, int rs,
                                              const __nv_bfloat16* src, int r0, int n,
                                              int T, int D, int DP) {
    const int C8 = DP / 8;
    for (int idx = threadIdx.x; idx < n * C8; idx += MMA_THREADS) {
        int r = idx / C8, c = (idx - r * C8) * 8;
        bool in = r0 + r < T && c < D;
        cp_async16(dst + r * rs + c, in ? src + (long long)(r0 + r) * D + c : src, in);
    }
}

// acc(16 x 8 SN) = A B^T over the depth DP, with A 16 rows and B 8 SN rows
// of row-major tiles of stride rs: the score products (S, dP and, in K4,
// their transposes). a: this lane's ldmatrix address of A's rows; b: of B's
// n-tiles 0 and 1.
template <int SN>
__device__ __forceinline__ void tile_scores(float (*acc)[4], const __nv_bfloat16* a,
                                            const __nv_bfloat16* b, int rs, int DP) {
#pragma unroll
    for (int n = 0; n < SN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kd = 0; kd < DP; kd += 16) {
        uint32_t af[4];
        ldsm_x4(af, a + kd);
#pragma unroll
        for (int np = 0; np < SN; np += 2) {
            uint32_t bb[4];
            ldsm_x4(bb, b + np * 8 * rs + kd);
            mma_bf16(acc[np], af[0], af[1], af[2], af[3], bb[0], bb[1]);
            mma_bf16(acc[np + 1], af[0], af[1], af[2], af[3], bb[2], bb[3]);
        }
    }
}

// K3's dQ += dS K, one k-step: acc[j] += A B_j for the warp's output n-tiles
// j < cnt, A the k-step's fragment of dS, B_j its 16 rows of the row-major K
// tile at n-tile j, read transposed (tr: this lane's address of n-tiles 0
// and 1). An odd cnt reads one n-tile past its last (still inside the row:
// DP rounds D up to 16) and skips that mma.
template <int NH>
__device__ __forceinline__ void mma_trans(float (*acc)[4], const uint32_t* a,
                                          const __nv_bfloat16* tr, int cnt) {
#pragma unroll
    for (int j = 0; j < NH; j += 2) {
        if (j < cnt) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, tr + j * 8);
            mma_bf16(acc[j], a[0], a[1], a[2], a[3], bb[0], bb[1]);
            if (j + 1 < cnt) mma_bf16(acc[j + 1], a[0], a[1], a[2], a[3], bb[2], bb[3]);
        }
    }
}

// ---------------------------------------------------------------------------
// K3, bfloat16
// ---------------------------------------------------------------------------

// keys a tile (see the note at the top)
__host__ __device__ constexpr int dq_ktile(int d) { return d > 192 ? 32 : 64; }

size_t dq_mma_smem_bytes(int d) {
    size_t rs = (d + 15) / 16 * 16 + 8, bk = dq_ktile(d);
    // bf16 Q, dO [64][rs] and a ring of 2 x (K, V) [bk][rs]; the swap buffer,
    // float4 [8 warps][bk / 8][32 lanes]; a ring of 2 x bias [bk]
    return (2 * TILE + 4 * bk) * rs * sizeof(__nv_bfloat16)
        + 8 * (bk / 8) * 32 * sizeof(float4) + 2 * bk * sizeof(float);
}

// K3: grid (B*H, ceil(Tq / 64)), 8 warps. Warps w and w + 4 own query rows
// q0 + 16 (w % 4) .. + 15.
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS, 1)
attn_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk, int D,
                   int causal, float scale, Drop drop) {
    constexpr int BK = dq_ktile(DMAX);
    constexpr int SN = BK / 8;        // score n-tiles of 8 keys
    constexpr int KS = BK / 16;       // k-steps of dS K
    constexpr int NH = DMAX / 16;     // dQ n-tiles a warp: half the columns
    const int DP = (D + 15) / 16 * 16;
    const int RS = DP + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][RS]
    __nv_bfloat16* dos = qs + TILE * RS;                                // [64][RS]
    __nv_bfloat16* ring = dos + TILE * RS;         // [2 stages][K, V][BK][RS]
    float4* xch = reinterpret_cast<float4*>(ring + 4 * BK * RS);   // [8][SN][32]
    float* bias_s = reinterpret_cast<float*>(xch + 8 * SN * 32);   // [2][BK]

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int pair = warp % 4, half = warp / 4;
    const int bh = blockIdx.x, b = bh / H;
    const int q0 = blockIdx.y * TILE;
    const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
    const float* bias_b = bias + (long long)b * Tk;

    // one key tile into ring stage st: K, V and the bias by cp.async, one
    // commit group
    auto load_stage = [&](int st, int k0) {
        cp_async_rows(ring + 2 * st * BK * RS, RS, k + koff, k0, BK, Tk, D, DP);
        cp_async_rows(ring + (2 * st + 1) * BK * RS, RS, v + koff, k0, BK, Tk, D, DP);
        if (tid < BK) {
            bool in = k0 + tid < Tk;
            cp_async4(bias_s + st * BK + tid, in ? bias_b + k0 + tid : bias_b, in);
        }
        cp_async_commit();
    };
    cp_async_rows(qs, RS, q + qoff, q0, TILE, Tq, D, DP);
    cp_async_rows(dos, RS, dout + qoff, q0, TILE, Tq, D, DP);
    load_stage(0, 0);   // one group with Q and dO

    const int row0 = q0 + pair * 16 + g;   // rows row0 and row0 + 8
    float2 row_lse[2];
    float row_d[2];
    uint32_t hr[2] = {0u, 0u};
    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int row = row0 + 8 * h;
        row_lse[h] = row < Tq ? row_lse_at(lse, (long long)bh * Tq + row)
                              : make_float2(0.f, 0.f);
        row_d[h] = row < Tq ? dsum[(long long)bh * Tq + row] : 0.f;
        if (dropping) hr[h] = dropout_row_hash(hb, row);
    }

    // this warp's dQ columns: n-tiles [nb, nb + cnt) of the D / 8
    const int nd = D / 8, nlow = (nd + 1) / 2;
    const int nb = half ? nlow : 0, cnt = half ? nd - nlow : nlow;
    float acc[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    // ldmatrix lane offsets: A rows (this pair's 16 queries of Q or dO); B of
    // the score product, n-tiles np and np + 1 (rows of K or V); B of dS K,
    // transposed, k-step rows and n-tiles j and j + 1
    const __nv_bfloat16* a_src = (half ? dos : qs) + (pair * 16 + lane % 16) * RS
                                 + (lane / 16) * 8;
    const int b_off = ((lane / 16) * 8 + lane % 8) * RS + ((lane / 8) % 2) * 8;
    const int t_off = (((lane / 8) % 2) * 8 + lane % 8) * RS + (lane / 16) * 8 + nb * 8;
    float4* swap_out = xch + warp * SN * 32 + lane;
    const float4* swap_in = xch + (warp ^ 4) * SN * 32 + lane;

    for (int it = 0, k0 = 0; k0 < Tk; ++it, k0 += BK) {
        const int st = it & 1;
        cp_async_wait_all();
        __syncthreads();   // stage st landed for all; stage st ^ 1 is free
        if (k0 + BK < Tk) load_stage(st ^ 1, k0 + BK);
        const __nv_bfloat16* ks = ring + 2 * st * BK * RS;
        const __nv_bfloat16* vs = ks + BK * RS;
        const float* bs = bias_s + st * BK;

        // S = Q K^T (w < 4) or dP = dO V^T (w >= 4) for 16 queries x BK keys
        float mine[SN][4];
        tile_scores<SN>(mine, a_src, (half ? vs : ks) + b_off, RS, DP);
        // swap with the partner warp: both then hold S and dP
#pragma unroll
        for (int n = 0; n < SN; ++n)
            swap_out[n * 32] = make_float4(mine[n][0], mine[n][1], mine[n][2], mine[n][3]);
        pair_sync(pair);
        uint32_t sa[KS][4];   // A fragments of dS
#pragma unroll
        for (int n = 0; n < SN; ++n) {
            const float4 o4 = swap_in[n * 32];
            const float other[4] = {o4.x, o4.y, o4.z, o4.w};
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int h = e >> 1, key = n * 8 + 2 * t + (e & 1);
                const int row = row0 + 8 * h, col = k0 + key;
                const float s = half ? other[e] : mine[n][e];
                float dp = half ? mine[n][e] : other[e];
                float p = recompute_p(s, scale, bs[key], row, col, Tq, Tk, causal, row_lse[h]);
                if (dropping)
                    dp = dropout_keep(hr[h], col, drop.thr) ? dp * drop.keep_scale : 0.f;
                ds[e] = recompute_ds(p, dp, row_d[h], row, col, causal);
            }
            // accumulator n-tiles 2kk, 2kk + 1 are the A fragment of k-step kk
            sa[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
            sa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dQ += dS K over this warp's columns
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
            mma_trans<NH>(acc, sa[kk], ks + kk * 16 * RS + t_off, cnt);
    }

    __nv_bfloat16* dqb = dq + qoff;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int row = row0 + 8 * h;
        if (row >= Tq) continue;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
            if (j < cnt)
                *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)row * D + (nb + j) * 8 + 2 * t) =
                    __floats2bfloat162_rn(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
        }
    }
}

// ---------------------------------------------------------------------------
// K4, bfloat16
// ---------------------------------------------------------------------------

// queries a tile (see the note at the top)
__host__ __device__ constexpr int dkv_qtile(int d) { return d > 192 ? 32 : 64; }

size_t dkv_mma_smem_bytes(int d) {
    size_t rs = (d + 15) / 16 * 16 + 8, bq = dkv_qtile(d);
    // bf16 K, V [64][rs] and a ring of 2 x (Q, dO) [bq][rs]; the swap buffer,
    // float4 [8 warps][bq / 8][32 lanes]; a ring of 2 x (m, log l), D and
    // the dropout row hash [bq]
    return (2 * TILE + 4 * bq) * rs * sizeof(__nv_bfloat16)
        + 8 * (bq / 8) * 32 * sizeof(float4) + 2 * bq * (sizeof(float2) + 8);
}

// K4: grid (B*H, ceil(Tk / 64)), 8 warps. Warps w and w + 4 own key rows
// k0 + 16 (w % 4) .. + 15; the score tiles are transposed (keys x queries).
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS, 1)
attn_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                    int H, int Tq, int Tk, int D, int causal, float scale, Drop drop) {
    constexpr int BQ = dkv_qtile(DMAX);
    constexpr int SN = BQ / 8;        // score n-tiles of 8 queries
    constexpr int KS = BQ / 16;       // k-steps of the output products
    constexpr int NH = DMAX / 16;     // output n-tiles a warp: half the columns
    const int DP = (D + 15) / 16 * 16;
    const int RS = DP + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][RS]
    __nv_bfloat16* vs = ks + TILE * RS;                                 // [64][RS]
    __nv_bfloat16* ring = vs + TILE * RS;          // [2 stages][Q, dO][BQ][RS]
    float4* xch = reinterpret_cast<float4*>(ring + 4 * BQ * RS);   // [8][SN][32]
    float2* lse_s = reinterpret_cast<float2*>(xch + 8 * SN * 32);  // [2][BQ]
    float* d_s = reinterpret_cast<float*>(lse_s + 2 * BQ);         // [2][BQ]
    uint32_t* hr_s = reinterpret_cast<uint32_t*>(d_s + 2 * BQ);    // [2][BQ]

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int pair = warp % 4, half = warp / 4;
    const int bh = blockIdx.x, b = bh / H;
    const int kb0 = blockIdx.y * TILE;
    const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
    const float* lse_b = lse + (long long)bh * Tq * 2;
    const float* dsum_b = dsum + (long long)bh * Tq;
    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;

    // one query tile into ring stage st: Q, dO, (m, log l) and D by
    // cp.async, the dropout row hashes by plain stores; one commit group
    auto load_stage = [&](int st, int q0) {
        cp_async_rows(ring + 2 * st * BQ * RS, RS, q + qoff, q0, BQ, Tq, D, DP);
        cp_async_rows(ring + (2 * st + 1) * BQ * RS, RS, dout + qoff, q0, BQ, Tq, D, DP);
        if (tid < BQ) {
            int row = q0 + tid;
            bool in = row < Tq;
            cp_async8(lse_s + st * BQ + tid, in ? lse_b + 2 * row : lse_b, in);
            cp_async4(d_s + st * BQ + tid, in ? dsum_b + row : dsum_b, in);
            hr_s[st * BQ + tid] = dropping ? dropout_row_hash(hb, row) : 0u;
        }
        cp_async_commit();
    };
    cp_async_rows(ks, RS, k + koff, kb0, TILE, Tk, D, DP);
    cp_async_rows(vs, RS, v + koff, kb0, TILE, Tk, D, DP);
    load_stage(0, 0);   // one group with K and V

    const int key0 = kb0 + pair * 16 + g;   // keys key0 and key0 + 8
    float key_bias[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
        key_bias[h] = key0 + 8 * h < Tk ? bias[(long long)b * Tk + key0 + 8 * h] : 0.f;

    // this warp's output columns: n-tiles [nb, nb + cnt) of the D / 8
    const int nd = D / 8, nlow = (nd + 1) / 2;
    const int nb = half ? nlow : 0, cnt = half ? nd - nlow : nlow;
    float acc_v[NH][4], acc_k[NH][4];
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_v[n][e] = acc_k[n][e] = 0.f;

    // ldmatrix lane offsets: A rows (this pair's 16 keys of K or V); B of
    // the score product, n-tiles np and np + 1 (rows of Q or dO); B of the
    // output products, transposed, k-step rows and n-tiles j and j + 1
    const __nv_bfloat16* a_src = (half ? vs : ks) + (pair * 16 + lane % 16) * RS
                                 + (lane / 16) * 8;
    const int b_off = ((lane / 16) * 8 + lane % 8) * RS + ((lane / 8) % 2) * 8;
    const int t_off = (((lane / 8) % 2) * 8 + lane % 8) * RS + (lane / 16) * 8 + nb * 8;
    float4* swap_out = xch + warp * SN * 32 + lane;
    const float4* swap_in = xch + (warp ^ 4) * SN * 32 + lane;

    for (int it = 0, q0 = 0; q0 < Tq; ++it, q0 += BQ) {
        const int st = it & 1;
        cp_async_wait_all();
        __syncthreads();   // stage st landed for all; stage st ^ 1 is free
        if (q0 + BQ < Tq) load_stage(st ^ 1, q0 + BQ);
        const __nv_bfloat16* qs = ring + 2 * st * BQ * RS;
        const __nv_bfloat16* dos = qs + BQ * RS;

        // S^T = K Q^T (w < 4) or dP^T = V dO^T (w >= 4) for 16 keys x BQ
        float mine[SN][4];
        tile_scores<SN>(mine, a_src, (half ? dos : qs) + b_off, RS, DP);
        // swap with the partner warp: both then hold S^T and dP^T
#pragma unroll
        for (int n = 0; n < SN; ++n)
            swap_out[n * 32] = make_float4(mine[n][0], mine[n][1], mine[n][2], mine[n][3]);
        pair_sync(pair);
        uint32_t pa[KS][4], sa[KS][4];   // A fragments of P o M and of dS
#pragma unroll
        for (int n = 0; n < SN; ++n) {
            const float4 o4 = swap_in[n * 32];
            const float other[4] = {o4.x, o4.y, o4.z, o4.w};
            float pd[4], ds[4];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int qi = n * 8 + 2 * t + j, row = q0 + qi;
                const float2 rl = lse_s[st * BQ + qi];
                const float rd = d_s[st * BQ + qi];
                const uint32_t hr = dropping ? hr_s[st * BQ + qi] : 0u;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int e = 2 * h + j, key = key0 + 8 * h;
                    const float s = half ? other[e] : mine[n][e];
                    const float dp = half ? mine[n][e] : other[e];
                    float p = recompute_p(s, scale, key_bias[h], row, key, Tq, Tk, causal, rl);
                    float m = 1.f;
                    if (dropping) m = dropout_keep(hr, key, drop.thr) ? drop.keep_scale : 0.f;
                    pd[e] = p * m;
                    ds[e] = recompute_ds(p, dp * m, rd, row, key, causal);
                }
            }
            // accumulator n-tiles 2kk, 2kk + 1 are the A fragment of k-step kk
            pa[n / 2][(n % 2) * 2] = pack_bf16(pd[0], pd[1]);
            pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(pd[2], pd[3]);
            sa[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
            sa[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dV += (P o M)^T dO and dK += dS^T Q over this warp's columns, their
        // n-tiles interleaved: one product after the other (mma_trans twice)
        // ran about 5 % slower at the decoder's training shape
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            const __nv_bfloat16* dot = dos + kk * 16 * RS + t_off;
            const __nv_bfloat16* qt = qs + kk * 16 * RS + t_off;
#pragma unroll
            for (int j = 0; j < NH; j += 2) {
                if (j < cnt) {
                    uint32_t bb[4];
                    ldsm_x4_trans(bb, dot + j * 8);
                    mma_bf16(acc_v[j], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3], bb[0], bb[1]);
                    if (j + 1 < cnt)
                        mma_bf16(acc_v[j + 1], pa[kk][0], pa[kk][1], pa[kk][2], pa[kk][3],
                                 bb[2], bb[3]);
                    ldsm_x4_trans(bb, qt + j * 8);
                    mma_bf16(acc_k[j], sa[kk][0], sa[kk][1], sa[kk][2], sa[kk][3], bb[0], bb[1]);
                    if (j + 1 < cnt)
                        mma_bf16(acc_k[j + 1], sa[kk][0], sa[kk][1], sa[kk][2], sa[kk][3],
                                 bb[2], bb[3]);
                }
            }
        }
    }

    __nv_bfloat16* dkb = dk + koff;
    __nv_bfloat16* dvb = dv + koff;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int key = key0 + 8 * h;
        if (key >= Tk) continue;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
            if (j < cnt) {
                long long at = (long long)key * D + (nb + j) * 8 + 2 * t;
                *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
                    __floats2bfloat162_rn(acc_k[j][2 * h] * scale, acc_k[j][2 * h + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
                    __floats2bfloat162_rn(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores (SIMT), 256 threads as 16 x 16
// ---------------------------------------------------------------------------

constexpr int SIMT_THREADS = 256;
constexpr int S32 = 32 + 1;   // stride of transposed 32-wide tiles

// Rows [r0, r0 + n) of a (T, D) float32 matrix: row-major [n][D] (rm) and/or
// transposed [D][ts] (tr), zero outside.
__device__ __forceinline__ void load_tile_f32(const float* src, int r0, int n, int T,
                                              int D, float* rm, float* tr, int ts) {
    for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
        int r = idx / D, d = idx % D;
        float x = r0 + r < T ? src[(long long)(r0 + r) * D + d] : 0.f;
        if (rm) rm[r * D + d] = x;
        if (tr) tr[d * ts + r] = x;
    }
}

// K3's float32 query rows a block: 64, or 32 at D > 224, where Q^T and dO^T
// of 64 rows would take the shared memory over 227 KB (241,920 B at D 256)
constexpr int dq_simt_rows(int d) { return d > 224 ? 32 : 64; }

size_t dq_simt_smem_bytes(int d) {
    // Q^T, dO^T [D][rows + 1]; K^T, V^T [D][33]; K [32][D]; dS^T [32][rows + 1];
    // bias [32]
    const size_t sq = dq_simt_rows(d) + 1;
    return ((size_t)2 * d * sq + (size_t)2 * d * S32 + (size_t)32 * d + 32 * sq + 32)
        * sizeof(float);
}

// K3: grid (B*H, ceil(Tq / ROWS)); a thread owns query rows ty + 16 i
// (i < ROWS / 16).
template <int DMAX, int ROWS>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dq, int H,
                    int Tq, int Tk, int D, int causal, float scale, Drop drop) {
    constexpr int NC = DMAX / 16;
    constexpr int RI = ROWS / 16;
    constexpr int SQ = ROWS + 1;
    extern __shared__ float smem[];
    float* qt = smem;                 // [D][SQ]
    float* dot = qt + D * SQ;         // [D][SQ]
    float* kt = dot + D * SQ;         // [D][33]
    float* vt = kt + D * S32;         // [D][33]
    float* ks = vt + D * S32;         // [32][D]
    float* dst = ks + 32 * D;         // [32][SQ]
    float* bs = dst + 32 * SQ;        // [32]

    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int bh = blockIdx.x, b = bh / H;
    const int q0 = blockIdx.y * ROWS;
    const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
    const float* biasb = bias + (long long)b * Tk;

    load_tile_f32(q + qoff, q0, ROWS, Tq, D, nullptr, qt, SQ);
    load_tile_f32(dout + qoff, q0, ROWS, Tq, D, nullptr, dot, SQ);

    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;
    float2 row_lse[RI];
    float row_d[RI], acc[RI][NC];
    uint32_t hr[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        int row = q0 + ty + 16 * i;
        row_lse[i] = row < Tq ? row_lse_at(lse, (long long)bh * Tq + row)
                              : make_float2(0.f, 0.f);
        row_d[i] = row < Tq ? dsum[(long long)bh * Tq + row] : 0.f;
        hr[i] = dropping ? dropout_row_hash(hb, row) : 0u;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = 0; k0 < Tk; k0 += 32) {
        __syncthreads();
        load_tile_f32(k + koff, k0, 32, Tk, D, ks, kt, S32);
        load_tile_f32(v + koff, k0, 32, Tk, D, nullptr, vt, S32);
        if (tid < 32) bs[tid] = (k0 + tid < Tk) ? biasb[k0 + tid] : 0.f;
        __syncthreads();

        float s[RI][2] = {}, dp[RI][2] = {};
        for (int d = 0; d < D; ++d) {
            const float* qrow = qt + d * SQ + ty;
            const float* orow = dot + d * SQ + ty;
            float k0v = kt[d * S32 + tx], k1v = kt[d * S32 + tx + 16];
            float v0v = vt[d * S32 + tx], v1v = vt[d * S32 + tx + 16];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
                float qv = qrow[16 * i], ov = orow[16 * i];
                s[i][0] = fmaf(qv, k0v, s[i][0]);
                s[i][1] = fmaf(qv, k1v, s[i][1]);
                dp[i][0] = fmaf(ov, v0v, dp[i][0]);
                dp[i][1] = fmaf(ov, v1v, dp[i][1]);
            }
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            int row = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                int kk = tx + 16 * j, col = k0 + kk;
                float p = recompute_p(s[i][j], scale, bs[kk], row, col, Tq, Tk, causal,
                                      row_lse[i]);
                float dpd = dp[i][j];
                if (dropping)
                    dpd = dropout_keep(hr[i], col, drop.thr) ? dpd * drop.keep_scale : 0.f;
                dst[kk * SQ + ty + 16 * i] = recompute_ds(p, dpd, row_d[i], row, col, causal);
            }
        }
        __syncthreads();   // dS tile complete

        for (int kk = 0; kk < 32; ++kk) {
            const float* srow = dst + kk * SQ + ty;
            const float* krow = ks + kk * D + tx;
            float sv[RI];
#pragma unroll
            for (int i = 0; i < RI; ++i) sv[i] = srow[16 * i];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                if (tx + 16 * c < D) {
                    float kv = krow[16 * c];
#pragma unroll
                    for (int i = 0; i < RI; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
        int row = q0 + ty + 16 * i;
        if (row >= Tq) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            int col = tx + 16 * c;
            if (col < D) dq[qoff + (long long)row * D + col] = acc[i][c] * scale;
        }
    }
}

size_t dkv_simt_smem_bytes(int d) {
    // K^T, V^T, Q^T, dO^T [D][33]; Q, dO [32][D]; (P o M) and dS as [32][33];
    // lse [32][2], D [32]
    return ((size_t)4 * d * S32 + (size_t)2 * 32 * d + 2 * 32 * S32 + 96) * sizeof(float);
}

// K4: grid (B*H, ceil(Tk / 32)); a thread owns keys ty + 16 i (i < 2).
template <int DMAX>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_dkv_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tq, int Tk, int D, int causal,
                     float scale, Drop drop) {
    constexpr int NC = DMAX / 16;
    extern __shared__ float smem[];
    float* kt = smem;                 // [D][33]
    float* vt = kt + D * S32;         // [D][33]
    float* qt = vt + D * S32;         // [D][33]
    float* dot = qt + D * S32;        // [D][33]
    float* qs = dot + D * S32;        // [32][D]
    float* dos = qs + 32 * D;         // [32][D]
    float* pdt = dos + 32 * D;        // [32 queries][33]
    float* dst = pdt + 32 * S32;      // [32 queries][33]
    float2* lse_s = reinterpret_cast<float2*>(dst + 32 * S32);   // [32]
    float* d_s = reinterpret_cast<float*>(lse_s + 32);           // [32]

    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int bh = blockIdx.x, b = bh / H;
    const int kb0 = blockIdx.y * 32;
    const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;

    load_tile_f32(k + koff, kb0, 32, Tk, D, nullptr, kt, S32);
    load_tile_f32(v + koff, kb0, 32, Tk, D, nullptr, vt, S32);

    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;
    float key_bias[2], acc_k[2][NC], acc_v[2][NC];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        int key = kb0 + ty + 16 * i;
        key_bias[i] = key < Tk ? bias[(long long)b * Tk + key] : 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
    }

    for (int q0 = 0; q0 < Tq; q0 += 32) {
        __syncthreads();
        load_tile_f32(q + qoff, q0, 32, Tq, D, qs, qt, S32);
        load_tile_f32(dout + qoff, q0, 32, Tq, D, dos, dot, S32);
        if (tid < 32) {
            bool in = q0 + tid < Tq;
            lse_s[tid] = in ? row_lse_at(lse, (long long)bh * Tq + q0 + tid)
                            : make_float2(0.f, 0.f);
            d_s[tid] = in ? dsum[(long long)bh * Tq + q0 + tid] : 0.f;
        }
        __syncthreads();

        float s[2][2] = {}, dp[2][2] = {};   // [key i][query j]
        for (int d = 0; d < D; ++d) {
            float q0v = qt[d * S32 + tx], q1v = qt[d * S32 + tx + 16];
            float o0v = dot[d * S32 + tx], o1v = dot[d * S32 + tx + 16];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float kv = kt[d * S32 + ty + 16 * i], vv = vt[d * S32 + ty + 16 * i];
                s[i][0] = fmaf(kv, q0v, s[i][0]);
                s[i][1] = fmaf(kv, q1v, s[i][1]);
                dp[i][0] = fmaf(vv, o0v, dp[i][0]);
                dp[i][1] = fmaf(vv, o1v, dp[i][1]);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            int col = kb0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                int qi = tx + 16 * j, row = q0 + qi;
                float p = recompute_p(s[i][j], scale, key_bias[i], row, col, Tq, Tk,
                                      causal, lse_s[qi]);
                float m = 1.f;
                if (dropping)
                    m = dropout_keep(dropout_row_hash(hb, row), col, drop.thr)
                        ? drop.keep_scale : 0.f;
                pdt[qi * S32 + ty + 16 * i] = p * m;
                dst[qi * S32 + ty + 16 * i] = recompute_ds(p, dp[i][j] * m, d_s[qi], row, col,
                                                           causal);
            }
        }
        __syncthreads();   // P and dS tiles complete

        for (int qq = 0; qq < 32; ++qq) {
            float pv[2], sv[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                pv[i] = pdt[qq * S32 + ty + 16 * i];
                sv[i] = dst[qq * S32 + ty + 16 * i];
            }
            const float* orow = dos + qq * D + tx;
            const float* qrow = qs + qq * D + tx;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                if (tx + 16 * c < D) {
                    float ov = orow[16 * c], qv = qrow[16 * c];
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
                        acc_k[i][c] = fmaf(sv[i], qv, acc_k[i][c]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        int key = kb0 + ty + 16 * i;
        if (key >= Tk) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            int col = tx + 16 * c;
            if (col < D) {
                dk[koff + (long long)key * D + col] = acc_k[i][c] * scale;
                dv[koff + (long long)key * D + col] = acc_v[i][c];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t bytes, cudaStream_t stream,
           Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, bytes, stream>>>(args...);
    return (int)cudaGetLastError();
}

// What a kernel uses, as the card reports it: out = {registers a thread,
// local (spill) bytes a thread, static and dynamic shared memory a block,
// blocks an SM, threads a block, the tile its width sets (bf16 K3: keys;
// bf16 K4: queries; f32 K3: query rows a block; f32 K4: queries)}.
template <typename Kernel>
int kernel_resources(Kernel kernel, int threads, size_t bytes, int tile, int* out) {
    int blocks = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
    if (err != cudaSuccess) return (int)err;
    const int values[7] = {attr.numRegs, (int)attr.localSizeBytes,
                           (int)attr.sharedSizeBytes, (int)bytes, blocks, threads, tile};
    for (int i = 0; i < 7; ++i) out[i] = values[i];
    return 0;
}

bool bad_width(int D) { return D < 8 || D > 256 || D % 8 != 0; }

// the smallest tiles (32 query rows, 32 keys) set the most blocks a grid axis
bool bad_shape(int B, int H, int Tq, int Tk, int D) {
    return B < 1 || H < 1 || Tq < 1 || Tk < 1 || bad_width(D)
        || (Tq + 31) / 32 > 65535 || (Tk + 31) / 32 > 65535;
}

}  // namespace

// the instance of KERNEL for head width D
#define PICK_D(KERNEL)                                                               \
    (D <= 64 ? KERNEL<64> : D <= 128 ? KERNEL<128> : D <= 192 ? KERNEL<192> : KERNEL<256>)

// the float32 K3 instance for head width D, with its query rows a block
#define PICK_DQ_SIMT                                                                  \
    (D <= 64    ? attn_dq_simt_kernel<64, 64>                                          \
     : D <= 128 ? attn_dq_simt_kernel<128, 64>                                         \
     : D <= 192 ? attn_dq_simt_kernel<192, 64>                                         \
     : D <= 224 ? attn_dq_simt_kernel<256, 64>                                         \
                : attn_dq_simt_kernel<256, 32>)

// K3. dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and dq share it).
// Contiguous tensors: q, dout, dq (B, H, Tq, D); k, v (B, H, Tk, D); bias
// (B, Tk), lse (B, H, Tq, 2) as K2 writes it and dsum (B, H, Tq) float32.
// key/thr/keep_scale as in flash_attention_fwd_lse. Returns 0, a cudaError_t,
// or -1 for arguments the kernels do not take.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout,
                                      const float* lse, const float* dsum, void* dq,
                                      int B, int H, int Tq, int Tk, int D, int causal,
                                      int dtype, float scale, uint32_t key,
                                      uint32_t thr, float keep_scale, void* stream) {
    if (bad_shape(B, H, Tq, Tk, D)) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Drop drop{key, thr, keep_scale};
    if (dtype == 0) {
        using T = float;
        const int rows = dq_simt_rows(D);
        return launch(PICK_DQ_SIMT, dim3(B * H, (Tq + rows - 1) / rows), SIMT_THREADS,
                      dq_simt_smem_bytes(D), s, (const T*)q, (const T*)k, (const T*)v,
                      bias, (const T*)dout, lse, dsum, (T*)dq, H, Tq, Tk, D, causal,
                      scale, drop);
    }
    if (dtype == 1) {
        using T = __nv_bfloat16;
        return launch(PICK_D(attn_dq_mma_kernel), dim3(B * H, (Tq + 63) / 64), MMA_THREADS,
                      dq_mma_smem_bytes(D),
                      s, (const T*)q, (const T*)k, (const T*)v, bias, (const T*)dout, lse,
                      dsum, (T*)dq, H, Tq, Tk, D, causal, scale, drop);
    }
    return -1;
}

// K4. As flash_attention_bwd_dq; dk, dv (B, H, Tk, D) in q's dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const float* bias, const void* dout,
                                       const float* lse, const float* dsum, void* dk,
                                       void* dv, int B, int H, int Tq, int Tk, int D,
                                       int causal, int dtype, float scale, uint32_t key,
                                       uint32_t thr, float keep_scale, void* stream) {
    if (bad_shape(B, H, Tq, Tk, D)) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Drop drop{key, thr, keep_scale};
    if (dtype == 0) {
        using T = float;
        return launch(PICK_D(attn_dkv_simt_kernel), dim3(B * H, (Tk + 31) / 32),
                      SIMT_THREADS, dkv_simt_smem_bytes(D), s, (const T*)q, (const T*)k,
                      (const T*)v, bias, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, H, Tq,
                      Tk, D, causal, scale, drop);
    }
    if (dtype == 1) {
        using T = __nv_bfloat16;
        return launch(PICK_D(attn_dkv_mma_kernel), dim3(B * H, (Tk + 63) / 64),
                      MMA_THREADS, dkv_mma_smem_bytes(D), s, (const T*)q, (const T*)k,
                      (const T*)v, bias, (const T*)dout, lse, dsum, (T*)dk, (T*)dv, H, Tq,
                      Tk, D, causal, scale, drop);
    }
    return -1;
}

// K3's and K4's resources at head width D for dtype (0 float32, 1 bfloat16;
// see kernel_resources): 0, a cudaError_t, or -1 for arguments the kernels
// do not take.
extern "C" int flash_attention_bwd_dq_resources(int D, int dtype, int* out) {
    if (bad_width(D) || dtype < 0 || dtype > 1) return -1;
    if (dtype == 0)
        return kernel_resources(PICK_DQ_SIMT, SIMT_THREADS, dq_simt_smem_bytes(D),
                                dq_simt_rows(D), out);
    return kernel_resources(PICK_D(attn_dq_mma_kernel), MMA_THREADS, dq_mma_smem_bytes(D),
                            dq_ktile(D), out);
}

extern "C" int flash_attention_bwd_dkv_resources(int D, int dtype, int* out) {
    if (bad_width(D) || dtype < 0 || dtype > 1) return -1;
    if (dtype == 0)
        return kernel_resources(PICK_D(attn_dkv_simt_kernel), SIMT_THREADS,
                                dkv_simt_smem_bytes(D), 32, out);
    return kernel_resources(PICK_D(attn_dkv_mma_kernel), MMA_THREADS, dkv_mma_smem_bytes(D),
                            dkv_qtile(D), out);
}
