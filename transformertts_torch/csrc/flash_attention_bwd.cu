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
// - float32 (the Aligner) runs both on the tensor cores as 3xTF32 (one TF32
//   product would not hold float32 parity; see tf32_tma.cuh), K4 below and
//   K3 as its mirror, with queries and keys exchanged.
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
//
// K4 in float32 (attn_dkv_tf32_kernel), the Aligner's. At its decoder
// self-attention, B16 H4 Tq = Tk = 896 D 64 causal, the four products keep
// 13.2 GFLOP once the mask is taken out; as 3xTF32 (three TF32 products
// each) that is 0.0798 ms at 495 TFLOP/s, against 88.8 MB of inputs and
// outputs in 0.0265 ms: bound by operations. The SIMT kernel it replaced
// took 2.1978 ms there (H100 80GB HBM3, 700 W), for five reasons; what this
// design does about each:
// 1. Every product was FMA on the CUDA cores, one shared-memory load an
//    FMA. Now all four run on the tensor cores as 3xTF32 on mma.sync
//    m16n8k8 (tf32_tma.cuh): S^T = K Q^T and dP^T = V dO^T take K or V,
//    resident, as A and the streamed Q or dO as B (the forward's S with
//    queries and keys exchanged); P o M and dS are formed in the score
//    accumulators and fed as the A operand of dV += (P o M)^T dO and
//    dK += dS^T Q, whose B fragments read dO and Q in the permuted query
//    order 2 t, 2 t + 1 (the forward's P.V). Every fragment load reads 32
//    distinct banks of the swizzled tiles. Each 8-wide step's three
//    products go to a fresh accumulator that is added in float32
//    (mma_3xtf32_add): chained in one accumulator, the tensor cores'
//    truncation of the carried sum put dK over the float32 bar where
//    dS = P o (dP - D) cancels, and dV where a sum over 896 queries does.
// 2. It walked every query tile. A causal block now starts at the tile of
//    its first key kb0: rows before kb0 see its keys only as look-ahead,
//    where dS = 0 and P = 0 exactly, so the skip is exact, and the walk
//    drops to about half. A fully masked row (m within 128 of NEG_INF) has
//    P = 1/Tk at every key, so the block reads the (m, log l) of the rows
//    before kb0 first and starts at the tile of the first such row.
// 3. Each tile was loaded and transposed by scalar loads between two
//    barriers. Now K and V come in once by TMA and Q and dO through a ring
//    of 32-query tiles (3 stages, 2 at D > 128) under full/empty mbarriers,
//    all in 32-column boxes under the 128-byte swizzle, with no transposed
//    copy; warp 0 issues tile i + STAGES - 1 while tile i computes.
// 4. The dropout row hash was recomputed for every element. Now each
//    tile's (m, log l) and D (by cp.async, tracked by the stage's full
//    barrier) and its rows' hashes sit in the ring beside Q and dO.
// 5. D 256 had one 256-thread block of 2 x 2 x 16 accumulators a thread.
//    Now a block is 8 warps in groups that share 16 keys: pairs at D <= 192
//    (64 keys a block), quads at D 256 (32 keys). Half the group computes
//    S^T and half dP^T, each over its share of the tile's queries; they
//    swap the scores through shared memory (a float4 a lane, between two
//    barriers of the group), every warp forms P o M and dS, and each
//    accumulates dK and dV in registers over its 1/G of the columns: 64
//    floats a thread at D 256, 32 at D 64.
// Grids on the 132 SMs: the decoder's self-attention is 896 blocks of 64
// keys at two blocks an SM (100,920 B each, at most 128 registers a
// thread), 13,440 (block, tile) pairs once causal; the last block's head of
// 256 is 448 blocks of 32 keys at one an SM (206,888 B), 6,496 pairs; the
// cross-attention (Tk 160) 192 blocks, one round at two an SM. The grid
// takes the lowest key blocks (a causal mask's heaviest) first.
//
// K3 in float32 (attn_dq_tf32_kernel), K4 f32's mirror. At the same decoder
// shape its three products keep 9.88 GFLOP; as 3xTF32 that is 0.0599 ms,
// against 74.1 MB in 0.0221 ms: bound by operations. The SIMT kernel it
// replaced took 0.8063 ms there and 2.1808 ms at the last block's head of
// 256 (H100 80GB HBM3, 700 W), for five reasons; what this design does
// about each:
// 1. Every product was FMA on the CUDA cores. Now all three run as 3xTF32
//    on mma.sync m16n8k8: S = Q K^T and dP = dO V^T take Q or dO, resident,
//    as A and the streamed K or V as B (the forward's S); dS is formed in
//    the score accumulators and fed as the A operand of dQ += dS K, whose B
//    fragment reads K in the permuted key order 2 t, 2 t + 1, as K4's
//    output products read queries. Each 8-wide step's products go to a
//    fresh accumulator added in float32 (mma_3xtf32_add): dS cancels where
//    a row sees one key, as in K4.
// 2. Q and dO were loaded transposed, one element at a time. Now TMA brings
//    them in once, in 32-column boxes under the 128-byte swizzle, and every
//    fragment load reads 32 distinct banks.
// 3. Each 32-key tile was loaded by scalar loads between two barriers. Now
//    K, V and the bias (by cp.async, tracked by the stage's full barrier)
//    come through a ring of 32-key tiles (3 stages, 2 at D > 128) under
//    full/empty mbarriers; warp 0 issues tile i + STAGES - 1 while tile i
//    computes. A block's query rows are fixed, so each thread holds
//    (m, log l), D and the dropout row hash of its two rows in registers.
// 4. dS went through shared memory before dS K. Now it stays in the
//    registers where it is formed; only the scores cross between the warps
//    of a group.
// 5. D 256 had one 256-thread block of 32 query rows an SM (172,288 B).
//    Now a block is 8 warps in groups that share 16 queries: pairs at
//    D <= 192 (64 queries a block), quads at D 256 (32). Half the group
//    computes S and half dP, each over its share of the tile's keys; they
//    swap through shared memory as K4's groups do, every warp forms dS, and
//    each accumulates dQ over its 1/G of the columns: 32 floats a thread at
//    D 256, 16 at D 64, half of K4's.
// A causal block stops its walk at min(Tk, q0 + BQ): dS is 0 at look-ahead
// keys, so the stop is exact even for a fully masked row, and the grid
// takes the highest query blocks (a causal mask's heaviest) first. The
// decoder's self-attention is 896 blocks of 64 queries at two an SM
// (99,768 B), the head of 256 448 blocks of 32 at one (206,120 B).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "tf32_tma.cuh"

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
// K4, float32: 3xTF32 on mma.sync m16n8k8, K/V resident, query tiles that
// TMA brings into a ring (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int TF32_THREADS = 256;       // 8 warps: BK / 16 groups of G warps
constexpr uint32_t TILE_ALIGN = 1024;   // the 128-byte swizzle's pattern: 8 rows

// the design by head-width template: keys a block (BK), stages of the query
// ring, blocks an SM (the register cap: 128 a thread for 2), the warps that
// share 16 keys (G); every width takes 32-query tiles (BQ)
constexpr int DKV_TF32_QUERIES = 32;
__host__ __device__ constexpr int dkv_tf32_keys(int d) { return d > 192 ? 32 : 64; }
__host__ __device__ constexpr int dkv_tf32_stages(int d) { return d > 128 ? 2 : 3; }
__host__ __device__ constexpr int dkv_tf32_blocks(int d) { return d > 64 ? 1 : 2; }
__host__ __device__ constexpr int dkv_tf32_group(int d) { return 8 / (dkv_tf32_keys(d) / 16); }

// K and V; a ring of Q, dO, (m, log l), D and the dropout row hashes; the
// swap buffer of S^T and dP^T (float4 [BK / 16][2][BQ / 8][32 lanes]); a full
// and an empty barrier a stage and K/V's; one swizzle pattern of alignment
__host__ __device__ constexpr size_t dkv_tf32_smem_bytes(int d) {
    return TILE_ALIGN + (size_t)2 * dkv_tf32_keys(d) * d * 4
        + (size_t)dkv_tf32_stages(d) * DKV_TF32_QUERIES * (2 * d * 4 + 16)
        + (size_t)dkv_tf32_keys(d) * DKV_TF32_QUERIES * 8
        + 8 * (1 + 2 * dkv_tf32_stages(d));
}

// d += A B as mma_3xtf32, but the three products go to a fresh accumulator
// that is then added to d in float32 (round to nearest). The tensor cores
// truncate the sum they carry: chained over the Tq / 8 steps of dV or dK, or
// the D / 8 of a score, that bias grows with the chain and showed over the
// float32 bar where the sum cancels (dV of the cross-attention, dS where
// dP = D); added this way the errors stay unbiased.
__device__ __forceinline__ void mma_3xtf32_add(float (&d)[4], const uint32_t (&ab)[4],
                                               const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                               const uint32_t (&bs)[2]) {
    float step[4] = {0.f, 0.f, 0.f, 0.f};
    mma_3xtf32(step, ab, as, bb, bs);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += step[e];
}

// the threads of one key group (barrier 0 is __syncthreads')
__device__ __forceinline__ void group_sync(int group, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(group + 1), "r"(threads) : "memory");
}

// K4 f32: a 1-D grid of B*H x ceil(Tk / BK) blocks, the lowest key blocks
// (a causal mask's heaviest) first. Warp w belongs to key group w % (BK / 16),
// keys kb0 + 16 (w % (BK / 16)) .. + 15, with rank w / (BK / 16) of G in it:
// ranks below G / 2 compute S^T = K Q^T, the others dP^T = V dO^T, each over
// BQ / (G / 2) of the tile's queries; they swap the scores through shared
// memory, and every warp of the group forms P o M and dS for the group's
// 16 keys x BQ queries and accumulates dV += (P o M)^T dO and dK += dS^T Q
// over its G-th of the columns.
//
// The A operand of dV and dK is the score accumulator (query columns 2 t,
// 2 t + 1), not the m16n8k8 A layout (columns t, t + 4): the sum over
// queries does not depend on their order, so A's k = t is read as query
// 2 t and k = t + 4 as query 2 t + 1, a = (d[0], d[2], d[1], d[3]), and dO's
// or Q's B fragment reads the same queries, b[r] = dO[8 kk + 2 t + r][col g].
template <int DMAX>
__global__ void __launch_bounds__(TF32_THREADS, dkv_tf32_blocks(DMAX))
attn_dkv_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap,    // dO
                     const float* __restrict__ bias, const float* __restrict__ lse,
                     const float* __restrict__ dsum, float* __restrict__ dk, float* __restrict__ dv, int H, int Tq,
                     int Tk, int D, int causal, float scale, Drop drop) {
    constexpr int BK = dkv_tf32_keys(DMAX), BQ = DKV_TF32_QUERIES;
    constexpr int STAGES = dkv_tf32_stages(DMAX), G = dkv_tf32_group(DMAX);
    constexpr int NG = BK / 16;          // key groups
    constexpr int NQ = BQ / 8;           // 8-query steps of a tile
    constexpr int SN = NQ / (G / 2);     // score n-tiles a warp computes
    constexpr int NJ = DMAX / 8 / G;     // output n-tiles a warp owns, at most
    constexpr uint32_t KV_BOX = BK * 128, Q_BOX = BQ * 128;
    constexpr uint32_t KV_BYTES = (DMAX / F32_BOX) * KV_BOX, Q_BYTES = (DMAX / F32_BOX) * Q_BOX;
    extern __shared__ unsigned char smem_raw[];
    __shared__ int first_tile;
    unsigned char* k_smem =
        smem_raw + ((TILE_ALIGN - (smem_u32(smem_raw) & (TILE_ALIGN - 1))) & (TILE_ALIGN - 1));
    unsigned char* v_smem = k_smem + KV_BYTES;
    unsigned char* ring = v_smem + KV_BYTES;                           // stage s: Q, dO
    float4* swap = reinterpret_cast<float4*>(ring + STAGES * 2 * Q_BYTES);
    float2* lse_s = reinterpret_cast<float2*>(swap + NG * 2 * NQ * 32);   // [STAGES][BQ]
    float* d_s = reinterpret_cast<float*>(lse_s + STAGES * BQ);          // [STAGES][BQ]
    uint32_t* hr_s = reinterpret_cast<uint32_t*>(d_s + STAGES * BQ);     // [STAGES][BQ]
    const uint32_t kv_bar = smem_u32(hr_s + STAGES * BQ);
    const uint32_t full_bar = kv_bar + 8, empty_bar = full_bar + 8 * STAGES;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kg = warp % NG, rank = warp / NG;
    const int role = rank / (G / 2), part = rank % (G / 2);   // role 0: S^T, 1: dP^T
    const int n_kb = (Tk + BK - 1) / BK, BH = gridDim.x / n_kb;
    const int bh = blockIdx.x % BH, b = bh / H, kb0 = (blockIdx.x / BH) * BK;
    const int nb = (D + F32_BOX - 1) / F32_BOX;   // the boxes that hold columns < D
    const int n_qt = (Tq + BQ - 1) / BQ;
    // Causal, the rows before kb0 see this block's keys only as look-ahead,
    // whose dS is exactly 0 and whose P, exp(NEG_INF - m - log l), is
    // exactly 0 too, unless the row's max lies within 128 of NEG_INF (every
    // key it sees is masked, and each weight is 1/Tk). So the walk starts at
    // the tile of kb0 or at that of the first such row, if one comes before.
    const int skip = causal ? min(kb0 / BQ, n_qt) : 0;
    if (tid == 0) {
        first_tile = skip;
        mbar_init(kv_bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_bar + 8 * s, 1 + 32);   // the TMA bytes and warp 0's lanes
            mbar_init(empty_bar + 8 * s, TF32_THREADS / 32);   // one arrival a warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(kv_bar, 2 * nb * KV_BOX);
        for (int j = 0; j < nb; ++j) {
            tma_load(smem_u32(k_smem) + j * KV_BOX, &kmap, j * F32_BOX, kb0, bh, kv_bar);
            tma_load(smem_u32(v_smem) + j * KV_BOX, &vmap, j * F32_BOX, kb0, bh, kv_bar);
        }
    }
    const float* lse_b = lse + (long long)bh * Tq * 2;
    for (int r = tid; r < min(skip * BQ, Tq); r += TF32_THREADS)
        if (lse_b[2 * r] < NEG_INF + 128.f) atomicMin(&first_tile, r / BQ);
    __syncthreads();
    const int start = first_tile, n_walk = n_qt - start;

    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;
    // Warp 0: tile start + i into stage i % STAGES once every warp has
    // released the stage's last tile. Q and dO come by TMA; (m, log l) and D
    // by each lane's cp.async (zero-filled at rows >= Tq), which the stage's
    // full barrier tracks; the dropout row hashes from the lanes, each of
    // which arrives on that barrier after its stores.
    const float* dsum_b = dsum + (long long)bh * Tq;
    auto produce = [&](int i) {
        const int s = i % STAGES, q0 = (start + i) * BQ;
        const uint32_t full = full_bar + 8 * s;
        if (lane == 0) {
            if (i >= STAGES) mbar_wait(empty_bar + 8 * s, (i / STAGES - 1) & 1);
            mbar_expect_tx(full, 2 * nb * Q_BOX);
            const uint32_t dst = smem_u32(ring) + s * 2 * Q_BYTES;
            for (int j = 0; j < nb; ++j) {
                tma_load(dst + j * Q_BOX, &qmap, j * F32_BOX, q0, bh, full);
                tma_load(dst + Q_BYTES + j * Q_BOX, &omap, j * F32_BOX, q0, bh, full);
            }
        }
        __syncwarp();
        for (int r = lane; r < BQ; r += 32) {
            const bool in = q0 + r < Tq;
            cp_async8(lse_s + s * BQ + r, in ? lse_b + 2 * (q0 + r) : lse_b, in);
            cp_async4(d_s + s * BQ + r, in ? dsum_b + q0 + r : dsum_b, in);
            if (dropping) hr_s[s * BQ + r] = dropout_row_hash(hb, q0 + r);
        }
        // the barrier's phase waits for this lane's copies too
        asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" :: "r"(full) : "memory");
        mbar_arrive(full);
    };
    if (warp == 0)
        for (int i = 0; i < min(n_walk, STAGES - 1); ++i) produce(i);

    const int key0 = kb0 + 16 * kg + g;   // this lane's keys key0 and key0 + 8
    float key_bias[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
        key_bias[h] = key0 + 8 * h < Tk ? bias[(long long)b * Tk + key0 + 8 * h] : 0.f;
    // this warp's output columns: n-tiles [jb, jb + cnt) of the D / 8
    const int nd = D / 8, per = (nd + G - 1) / G;
    const int jb = rank * per, cnt = max(0, min(per, nd - jb));
    float acc_k[NJ][4], acc_v[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
    const unsigned char* a_tile = role ? v_smem : k_smem;
    const int ar = 16 * kg + g;           // A rows ar, ar + 8 of the K or V tile
    float4* swap_out = swap + ((kg * 2 + role) * NQ + part * SN) * 32 + lane;
    const float4* swap_s = swap + kg * 2 * NQ * 32 + lane;
    const float4* swap_p = swap_s + NQ * 32;
    mbar_wait(kv_bar, 0);

    for (int i = 0; i < n_walk; ++i) {
        if (warp == 0 && i + STAGES - 1 < n_walk) produce(i + STAGES - 1);
        const int s = i % STAGES, q0 = (start + i) * BQ;
        mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
        const unsigned char* q_tile = ring + s * 2 * Q_BYTES;
        const unsigned char* o_tile = q_tile + Q_BYTES;

        // S^T = K Q^T or dP^T = V dO^T: 16 keys by this warp's SN n-tiles of
        // 8 queries, over the 8-column steps that hold columns < D (each step
        // added in float32, see mma_3xtf32_add: a chained sum's bias would
        // show where dS = P o (dP - D) cancels, as in a row with one key); a
        // loop at run time, unrolled by 2 but at D 64, where a step pair
        // spills at its 128 registers a thread
        const unsigned char* b_tile = role ? o_tile : q_tile;
        float mine[SN][4];
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) mine[n][e] = 0.f;
#pragma unroll (DMAX <= 64 ? 1 : 2)
        for (int kd = 0; kd < D / 8; ++kd) {
            const int c = 8 * kd + t;
            uint32_t ab[4], as[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                split_tf32(lds(a_tile, sw_off(ar + 8 * (r & 1), c + 4 * (r >> 1), BK)), ab[r],
                           as[r]);
#pragma unroll
            for (int n = 0; n < SN; ++n) {
                uint32_t bb[2], bs[2];
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    split_tf32(lds(b_tile, sw_off(8 * (part * SN + n) + g, c + 4 * r, BQ)),
                               bb[r], bs[r]);
                mma_3xtf32_add(mine[n], ab, as, bb, bs);
            }
        }
        group_sync(kg, 32 * G);   // the group has read the last tile's scores
#pragma unroll
        for (int n = 0; n < SN; ++n)
            swap_out[n * 32] = make_float4(mine[n][0], mine[n][1], mine[n][2], mine[n][3]);
        group_sync(kg, 32 * G);   // this tile's S^T and dP^T are whole

        // P o M and dS, 8 queries at a time, as the A operands of
        // dV += (P o M)^T dO and dK += dS^T Q over this warp's columns, the
        // query order permuted (see above); column blocks in groups of 4
        // with no branch inside a group, so that their products interleave
        const float2* rl = lse_s + s * BQ;
        const float* rd = d_s + s * BQ;
        const uint32_t* rh = hr_s + s * BQ;
#pragma unroll 1
        for (int kk = 0; kk < NQ; ++kk) {
            const float4 s4 = swap_s[kk * 32], p4 = swap_p[kk * 32];
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, dpv[4] = {p4.x, p4.y, p4.z, p4.w};
            float pd[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = 8 * kk + 2 * t + (e & 1), row = q0 + qi;
                const int key = key0 + 8 * (e >> 1);
                const float p = recompute_p(sv[e], scale, key_bias[e >> 1], row, key, Tq, Tk,
                                            causal, rl[qi]);
                float m = 1.f;
                if (dropping) m = dropout_keep(rh[qi], key, drop.thr) ? drop.keep_scale : 0.f;
                pd[e] = p * m;
                ds[e] = recompute_ds(p, dpv[e] * m, rd[qi], row, key, causal);
            }
            uint32_t pb[4], ps[4], sb[4], ss[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int e = (r >> 1) | ((r & 1) << 1);   // a = (d0, d2, d1, d3)
                split_tf32(pd[e], pb[r], ps[r]);
                split_tf32(ds[e], sb[r], ss[r]);
            }
            const int qr = 8 * kk + 2 * t;   // the B rows qr, qr + 1
#pragma unroll
            for (int j0 = 0; j0 < NJ; j0 += 4) {
                if (j0 >= cnt) break;
#pragma unroll
                for (int j = j0; j < j0 + 4; ++j) {
                    const int col = 8 * (jb + j) + g;
                    uint32_t bb[2], bs[2];
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        split_tf32(lds(o_tile, sw_off(qr + r, col, BQ)), bb[r], bs[r]);
                    mma_3xtf32_add(acc_v[j], pb, ps, bb, bs);
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        split_tf32(lds(q_tile, sw_off(qr + r, col, BQ)), bb[r], bs[r]);
                    mma_3xtf32_add(acc_k[j], sb, ss, bb, bs);
                }
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);   // this warp is done with it
    }

    float* dkb = dk + (long long)bh * Tk * D;
    float* dvb = dv + (long long)bh * Tk * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int key = key0 + 8 * h;
        if (key >= Tk) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            if (j < cnt) {
                const long long at = (long long)key * D + 8 * (jb + j) + 2 * t;
                *reinterpret_cast<float2*>(dkb + at) =
                    make_float2(acc_k[j][2 * h] * scale, acc_k[j][2 * h + 1] * scale);
                *reinterpret_cast<float2*>(dvb + at) =
                    make_float2(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// K3, float32: 3xTF32 on mma.sync m16n8k8, Q/dO resident, key tiles that TMA
// brings into a ring (K4 f32 with queries and keys exchanged; see the note
// at the top)
// ---------------------------------------------------------------------------

// the design by head-width template: queries a block (BQ), stages of the key
// ring, blocks an SM (the register cap: 128 a thread for 2), the warps that
// share 16 queries (G); every width takes 32-key tiles (BK)
constexpr int DQ_TF32_KEYS = 32;
__host__ __device__ constexpr int dq_tf32_queries(int d) { return d > 192 ? 32 : 64; }
__host__ __device__ constexpr int dq_tf32_stages(int d) { return d > 128 ? 2 : 3; }
__host__ __device__ constexpr int dq_tf32_blocks(int d) { return d > 64 ? 1 : 2; }
__host__ __device__ constexpr int dq_tf32_group(int d) { return 8 / (dq_tf32_queries(d) / 16); }

// Q and dO; a ring of K, V and the bias; the swap buffer of S and dP (float4
// [BQ / 16][2][BK / 8][32 lanes]); a full and an empty barrier a stage and
// Q/dO's; one swizzle pattern of alignment
__host__ __device__ constexpr size_t dq_tf32_smem_bytes(int d) {
    return TILE_ALIGN + (size_t)2 * dq_tf32_queries(d) * d * 4
        + (size_t)dq_tf32_stages(d) * DQ_TF32_KEYS * (2 * d * 4 + 4)
        + (size_t)dq_tf32_queries(d) * DQ_TF32_KEYS * 8
        + 8 * (1 + 2 * dq_tf32_stages(d));
}

// K3 f32: a 1-D grid of B*H x ceil(Tq / BQ) blocks, the highest query blocks
// (a causal mask's heaviest) first. Warp w belongs to query group
// w % (BQ / 16), queries q0 + 16 (w % (BQ / 16)) .. + 15, with rank
// w / (BQ / 16) of G in it: ranks below G / 2 compute S = Q K^T, the others
// dP = dO V^T, each over BK / (G / 2) of the tile's keys; they swap the
// scores through shared memory, and every warp of the group forms dS for the
// group's 16 queries x BK keys and accumulates dQ += dS K over its G-th of
// the columns. dS is the A operand as it lies in the score accumulators (key
// columns 2 t, 2 t + 1), read in the permuted key order of K4's output
// products: a = (d[0], d[2], d[1], d[3]), and K's B fragment reads the same
// keys, b[r] = K[8 kk + 2 t + r][col g].
template <int DMAX>
__global__ void __launch_bounds__(TF32_THREADS, dq_tf32_blocks(DMAX))
attn_dq_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,    // dO
                    const float* __restrict__ bias, const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dq, int H, int Tq,
                    int Tk, int D, int causal, float scale, Drop drop) {
    constexpr int BQ = dq_tf32_queries(DMAX), BK = DQ_TF32_KEYS;
    constexpr int STAGES = dq_tf32_stages(DMAX), G = dq_tf32_group(DMAX);
    constexpr int NG = BQ / 16;          // query groups
    constexpr int NK = BK / 8;           // 8-key steps of a tile
    constexpr int SN = NK / (G / 2);     // score n-tiles a warp computes
    constexpr int NJ = DMAX / 8 / G;     // dQ n-tiles a warp owns, at most
    constexpr uint32_t Q_BOX = BQ * 128, KV_BOX = BK * 128;
    constexpr uint32_t Q_BYTES = (DMAX / F32_BOX) * Q_BOX, KV_BYTES = (DMAX / F32_BOX) * KV_BOX;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* q_smem =
        smem_raw + ((TILE_ALIGN - (smem_u32(smem_raw) & (TILE_ALIGN - 1))) & (TILE_ALIGN - 1));
    unsigned char* o_smem = q_smem + Q_BYTES;
    unsigned char* ring = o_smem + Q_BYTES;                             // stage s: K, V
    float4* swap = reinterpret_cast<float4*>(ring + STAGES * 2 * KV_BYTES);
    float* bias_s = reinterpret_cast<float*>(swap + NG * 2 * NK * 32);   // [STAGES][BK]
    const uint32_t qo_bar = smem_u32(bias_s + STAGES * BK);
    const uint32_t full_bar = qo_bar + 8, empty_bar = full_bar + 8 * STAGES;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int qg = warp % NG, rank = warp / NG;
    const int role = rank / (G / 2), part = rank % (G / 2);   // role 0: S, 1: dP
    const int n_qb = (Tq + BQ - 1) / BQ, BH = gridDim.x / n_qb;
    const int bh = blockIdx.x % BH, b = bh / H, q0 = (n_qb - 1 - blockIdx.x / BH) * BQ;
    const int nb = (D + F32_BOX - 1) / F32_BOX;   // the boxes that hold columns < D
    // Causal, the keys past the block's last row are look-ahead for all its
    // rows, where dS is exactly 0 (fully masked rows included: their weights
    // are 1/Tk there, but dS is not), so the walk stops at that row.
    const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
    const int n_walk = (k_end + BK - 1) / BK;
    if (tid == 0) {
        mbar_init(qo_bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_bar + 8 * s, 1 + 32);   // the TMA bytes and warp 0's lanes
            mbar_init(empty_bar + 8 * s, TF32_THREADS / 32);   // one arrival a warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(qo_bar, 2 * nb * Q_BOX);
        for (int j = 0; j < nb; ++j) {
            tma_load(smem_u32(q_smem) + j * Q_BOX, &qmap, j * F32_BOX, q0, bh, qo_bar);
            tma_load(smem_u32(o_smem) + j * Q_BOX, &omap, j * F32_BOX, q0, bh, qo_bar);
        }
    }

    // Warp 0: tile i into stage i % STAGES once every warp has released the
    // stage's last tile. K and V come by TMA; the bias by each lane's
    // cp.async (zero-filled at keys >= Tk; a 1-D box of it would start
    // unaligned), which the stage's full barrier tracks.
    const float* bias_b = bias + (long long)b * Tk;
    auto produce = [&](int i) {
        const int s = i % STAGES, k0 = i * BK;
        const uint32_t full = full_bar + 8 * s;
        if (lane == 0) {
            if (i >= STAGES) mbar_wait(empty_bar + 8 * s, (i / STAGES - 1) & 1);
            mbar_expect_tx(full, 2 * nb * KV_BOX);
            const uint32_t dst = smem_u32(ring) + s * 2 * KV_BYTES;
            for (int j = 0; j < nb; ++j) {
                tma_load(dst + j * KV_BOX, &kmap, j * F32_BOX, k0, bh, full);
                tma_load(dst + KV_BYTES + j * KV_BOX, &vmap, j * F32_BOX, k0, bh, full);
            }
        }
        __syncwarp();
        for (int r = lane; r < BK; r += 32) {
            const bool in = k0 + r < Tk;
            cp_async4(bias_s + s * BK + r, in ? bias_b + k0 + r : bias_b, in);
        }
        // the barrier's phase waits for this lane's copy too
        asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" :: "r"(full) : "memory");
        mbar_arrive(full);
    };
    if (warp == 0)
        for (int i = 0; i < min(n_walk, STAGES - 1); ++i) produce(i);

    // this lane's rows row0 and row0 + 8: (m, log l), D and the dropout row
    // hash stay in registers
    const int row0 = q0 + 16 * qg + g;
    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;
    float2 row_lse[2];
    float row_d[2];
    uint32_t hr[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        row_lse[h] = row < Tq ? row_lse_at(lse, (long long)bh * Tq + row)
                              : make_float2(0.f, 0.f);
        row_d[h] = row < Tq ? dsum[(long long)bh * Tq + row] : 0.f;
        if (dropping) hr[h] = dropout_row_hash(hb, row);
    }
    // this warp's dQ columns: n-tiles [jb, jb + cnt) of the D / 8
    const int nd = D / 8, per = (nd + G - 1) / G;
    const int jb = rank * per, cnt = max(0, min(per, nd - jb));
    float acc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const unsigned char* a_tile = role ? o_smem : q_smem;
    const int ar = 16 * qg + g;           // A rows ar, ar + 8 of the Q or dO tile
    float4* swap_out = swap + ((qg * 2 + role) * NK + part * SN) * 32 + lane;
    const float4* swap_s = swap + qg * 2 * NK * 32 + lane;
    const float4* swap_p = swap_s + NK * 32;
    mbar_wait(qo_bar, 0);

    for (int i = 0; i < n_walk; ++i) {
        if (warp == 0 && i + STAGES - 1 < n_walk) produce(i + STAGES - 1);
        const int s = i % STAGES, k0 = i * BK;
        mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
        const unsigned char* k_tile = ring + s * 2 * KV_BYTES;
        const unsigned char* v_tile = k_tile + KV_BYTES;

        // S = Q K^T or dP = dO V^T: 16 queries by this warp's SN n-tiles of 8
        // keys, over the 8-column steps that hold columns < D, each step
        // added in float32 (mma_3xtf32_add); unrolled by 2 but at D 64, as
        // K4's score loop
        const unsigned char* b_tile = role ? v_tile : k_tile;
        float mine[SN][4];
#pragma unroll
        for (int n = 0; n < SN; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) mine[n][e] = 0.f;
#pragma unroll (DMAX <= 64 ? 1 : 2)
        for (int kd = 0; kd < D / 8; ++kd) {
            const int c = 8 * kd + t;
            uint32_t ab[4], as[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                split_tf32(lds(a_tile, sw_off(ar + 8 * (r & 1), c + 4 * (r >> 1), BQ)), ab[r],
                           as[r]);
#pragma unroll
            for (int n = 0; n < SN; ++n) {
                uint32_t bb[2], bs[2];
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    split_tf32(lds(b_tile, sw_off(8 * (part * SN + n) + g, c + 4 * r, BK)),
                               bb[r], bs[r]);
                mma_3xtf32_add(mine[n], ab, as, bb, bs);
            }
        }
        group_sync(qg, 32 * G);   // the group has read the last tile's scores
#pragma unroll
        for (int n = 0; n < SN; ++n)
            swap_out[n * 32] = make_float4(mine[n][0], mine[n][1], mine[n][2], mine[n][3]);
        group_sync(qg, 32 * G);   // this tile's S and dP are whole

        // dS, 8 keys at a time, as the A operand of dQ += dS K over this
        // warp's columns, the key order permuted (see above); column blocks
        // in groups of 4 with no branch inside a group, so that their
        // products interleave
        const float* bk = bias_s + s * BK;
#pragma unroll 1
        for (int kk = 0; kk < NK; ++kk) {
            const float4 s4 = swap_s[kk * 32], p4 = swap_p[kk * 32];
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, dpv[4] = {p4.x, p4.y, p4.z, p4.w};
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int ki = 8 * kk + 2 * t + (e & 1), key = k0 + ki;
                const int h = e >> 1, row = row0 + 8 * h;
                const float p = recompute_p(sv[e], scale, bk[ki], row, key, Tq, Tk, causal,
                                            row_lse[h]);
                float dp = dpv[e];
                if (dropping)
                    dp = dropout_keep(hr[h], key, drop.thr) ? dp * drop.keep_scale : 0.f;
                ds[e] = recompute_ds(p, dp, row_d[h], row, key, causal);
            }
            uint32_t sb[4], ss[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                split_tf32(ds[(r >> 1) | ((r & 1) << 1)], sb[r], ss[r]);   // (d0, d2, d1, d3)
            const int kr = 8 * kk + 2 * t;   // the B rows kr, kr + 1
#pragma unroll
            for (int j0 = 0; j0 < NJ; j0 += 4) {
                if (j0 >= cnt) break;
#pragma unroll
                for (int j = j0; j < j0 + 4; ++j) {
                    const int col = 8 * (jb + j) + g;
                    uint32_t bb[2], bs[2];
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        split_tf32(lds(k_tile, sw_off(kr + r, col, BK)), bb[r], bs[r]);
                    mma_3xtf32_add(acc[j], sb, ss, bb, bs);
                }
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * s);   // this warp is done with it
    }

    float* dqb = dq + (long long)bh * Tq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= Tq) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            if (j < cnt)
                *reinterpret_cast<float2*>(dqb + (long long)row * D + 8 * (jb + j) + 2 * t) =
                    make_float2(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
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
// blocks an SM, threads a block, the tile its width sets (K3: keys a tile;
// K4: queries a tile)}.
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

// The float32 kernels' TMA sources: Q and dO (maps 0 and 3) in bq-row
// boxes, K and V (1 and 2) in bk-row boxes
static bool tf32_maps(CUtensorMap* maps, const float* q, const float* k, const float* v,
                      const float* dout, int BH, int Tq, int Tk, int D, int bq, int bk) {
    return tensor_map(&maps[0], q, BH, Tq, D, bq, 4) && tensor_map(&maps[1], k, BH, Tk, D, bk, 4)
        && tensor_map(&maps[2], v, BH, Tk, D, bk, 4) && tensor_map(&maps[3], dout, BH, Tq, D, bq, 4);
}

// K3 float32: a block of BQ queries, 32-key tiles
static int launch_dq_tf32(const float* q, const float* k, const float* v, const float* bias,
                          const float* dout, const float* lse, const float* dsum, float* dq,
                          int B, int H, int Tq, int Tk, int D, int causal, float scale,
                          Drop drop, cudaStream_t stream) {
    const int dmax = dmax_of(D), bq = dq_tf32_queries(dmax);
    const long long BH = (long long)B * H, blocks = BH * ((Tq + bq - 1) / bq);
    if (blocks > INT_MAX) return -1;
    CUtensorMap m[4];
    if (!tf32_maps(m, q, k, v, dout, (int)BH, Tq, Tk, D, bq, DQ_TF32_KEYS)) return -2;
    return launch(PICK_D(attn_dq_tf32_kernel), dim3((unsigned)blocks), TF32_THREADS,
                  dq_tf32_smem_bytes(dmax), stream, m[0], m[1], m[2], m[3], bias, lse, dsum,
                  dq, H, Tq, Tk, D, causal, scale, drop);
}

// K4 float32: a block of BK keys, 32-query tiles
static int launch_dkv_tf32(const float* q, const float* k, const float* v, const float* bias,
                           const float* dout, const float* lse, const float* dsum, float* dk,
                           float* dv, int B, int H, int Tq, int Tk, int D, int causal,
                           float scale, Drop drop, cudaStream_t stream) {
    const int dmax = dmax_of(D), bk = dkv_tf32_keys(dmax);
    const long long BH = (long long)B * H, blocks = BH * ((Tk + bk - 1) / bk);
    if (blocks > INT_MAX) return -1;
    CUtensorMap m[4];
    if (!tf32_maps(m, q, k, v, dout, (int)BH, Tq, Tk, D, DKV_TF32_QUERIES, bk)) return -2;
    return launch(PICK_D(attn_dkv_tf32_kernel), dim3((unsigned)blocks), TF32_THREADS,
                  dkv_tf32_smem_bytes(dmax), stream, m[0], m[1], m[2], m[3], bias, lse, dsum,
                  dk, dv, H, Tq, Tk, D, causal, scale, drop);
}

// K3. dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and dq share it).
// Contiguous tensors: q, dout, dq (B, H, Tq, D); k, v (B, H, Tk, D); bias
// (B, Tk), lse (B, H, Tq, 2) as K2 writes it and dsum (B, H, Tq) float32.
// key/thr/keep_scale as in flash_attention_fwd_lse. Returns 0, a cudaError_t,
// -1 for arguments the kernels do not take, or -2 when the float32 kernel's
// tensor maps cannot be made (cuTensorMapEncodeTiled not found, or a map it
// refuses).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const float* bias, const void* dout,
                                      const float* lse, const float* dsum, void* dq,
                                      int B, int H, int Tq, int Tk, int D, int causal,
                                      int dtype, float scale, uint32_t key,
                                      uint32_t thr, float keep_scale, void* stream) {
    if (bad_shape(B, H, Tq, Tk, D)) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Drop drop{key, thr, keep_scale};
    if (dtype == 0)
        return launch_dq_tf32((const float*)q, (const float*)k, (const float*)v, bias,
                              (const float*)dout, lse, dsum, (float*)dq, B, H, Tq, Tk, D,
                              causal, scale, drop, s);
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
    if (dtype == 0)
        return launch_dkv_tf32((const float*)q, (const float*)k, (const float*)v, bias,
                               (const float*)dout, lse, dsum, (float*)dk, (float*)dv, B, H,
                               Tq, Tk, D, causal, scale, drop, s);
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
// do not take. The float32 K3 fills two more: {..., keys a tile, queries a
// block, stages of its key ring}.
extern "C" int flash_attention_bwd_dq_resources(int D, int dtype, int* out) {
    if (bad_width(D) || dtype < 0 || dtype > 1) return -1;
    if (dtype == 0) {
        const int dmax = dmax_of(D);
        out[7] = dq_tf32_queries(dmax);
        out[8] = dq_tf32_stages(dmax);
        return kernel_resources(PICK_D(attn_dq_tf32_kernel), TF32_THREADS,
                                dq_tf32_smem_bytes(dmax), DQ_TF32_KEYS, out);
    }
    return kernel_resources(PICK_D(attn_dq_mma_kernel), MMA_THREADS, dq_mma_smem_bytes(D),
                            dq_ktile(D), out);
}

// The float32 K4 fills two more: {..., queries a tile, keys a block, stages
// of its query ring}.
extern "C" int flash_attention_bwd_dkv_resources(int D, int dtype, int* out) {
    if (bad_width(D) || dtype < 0 || dtype > 1) return -1;
    if (dtype == 0) {
        const int dmax = dmax_of(D);
        out[7] = dkv_tf32_keys(dmax);
        out[8] = dkv_tf32_stages(dmax);
        return kernel_resources(PICK_D(attn_dkv_tf32_kernel), TF32_THREADS,
                                dkv_tf32_smem_bytes(dmax), DKV_TF32_QUERIES, out);
    }
    return kernel_resources(PICK_D(attn_dkv_mma_kernel), MMA_THREADS, dkv_mma_smem_bytes(D),
                            dkv_qtile(D), out);
}
