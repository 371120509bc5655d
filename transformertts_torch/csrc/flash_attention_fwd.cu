// Fused attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two entries share these kernels through the TRAIN template flag:
// - flash_attention_fwd (K1) replaces the Pallas TPU kernel
//   transformertts_tpu/ops/flash_attention.py::_attn_kernel (called through
//   flash_attention -> _flash_attention):
//
//     out = softmax(q k^T / sqrt(D) + bias [+ causal look-ahead]) v
//
// - flash_attention_fwd_lse (K2) replaces ::_attn_fwd_kernel (called through
//   flash_attention_trainable -> _flash_fwd_res): the same output plus the
//   per-row logsumexp m + log(sum exp(x - m)), stored as the pair (m, log l)
//   that the backward kernels (flash_attention_bwd.cu) recompute the weights
//   from, and inverted dropout on the weights (the JAX training path's
//   attention-weight dropout, which the TPU kernel lacks): P.V takes
//   P * keep / (1 - rate) with keep from the counter-based hash of
//   dropout_hash.cuh, while the row sum and lse stay those of the undropped
//   weights. The pair is not summed: a fully masked row has m near -1e9,
//   where a float32 sum would round log l away and the backward would weigh
//   each key 1 instead of 1/Tk.
//
// with the softmax in float32, the output in q's dtype, and the (Tq, Tk)
// weights never written to device memory. bias is the (B, Tk) additive key
// mask (0 or -1e9); causal sets logits of keys after the query to exactly
// -1e9, as the TPU kernel does. Keys at or beyond Tk take no part in the
// softmax, so a row whose keys are all masked comes out as the mean of v
// (its logits all round onto -1e9).
//
// What bounds it on this card, and the design:
// - The TPU kernel keeps one (batch, head)'s whole K/V resident in VMEM. On
//   an H100 a block has 227 KB of shared memory; at Tk = 768, D = 192 in
//   bf16, K and V alone take 590 KB. So keys stream through shared memory
//   in 64-key tiles with an online softmax (running max, running sum,
//   float32 accumulator in registers). At the synthesis shape (B64 H2
//   768 x 768 x 192) the function is 58 GFLOP against 151 MB of q, k, v and
//   out: 0.059 ms at 989 TFLOP/s, 0.045 ms at 3.35 TB/s, so the tensor
//   cores bound it, and each K/V tile is read once per 128-query block.
// - bfloat16 (serving and training) runs both products with wgmma, the only
//   way to Hopper's full tensor-core rate. A block is two warpgroups (256
//   threads), 64 query rows each (wgmma's M), 128 rows a block; the grid is
//   B*H x ceil(Tq / 128) blocks, the query blocks of one (batch, head) next
//   to each other so that they share its K/V in L2. D is padded to DP, a
//   multiple of 64 (the template DMAX); TMA fills columns >= D and rows past
//   Tq or Tk with zeros. Three tensor maps view q, k, v as (D, T, B*H), so a
//   tile's tail rows never read the next head's rows, in 64-column boxes
//   under the 128-byte swizzle (one swizzle atom a row). Q's 128 x DP tile
//   is loaded once and stays in shared memory as wgmma's A operand. K and V
//   come in 64-key tiles through a ring of STAGES stages: thread 0 issues
//   the TMA copies of tile i + STAGES - 1 before tile i is computed, each
//   stage has a "full" mbarrier armed with the stage's bytes and an "empty"
//   one that each of the 8 warps arrives at once its P.V has retired.
//   S = Q K^T is m64n64k16 with both operands K-major in shared memory;
//   the softmax runs on the accumulator registers (a thread holds two rows,
//   a quad shuffle gives their max); P, packed to bf16 pairs, is the
//   register A operand of O += P V (the m64nNk16 accumulator and A layouts
//   coincide), and B is V straight from the ring with the transpose bit, one
//   m64n64k16 a 64-column box, so V is never copied or transposed. O stays
//   in registers (DP / 2 floats a thread).
//   The logits stay in natural units, so the -1e9 mask constants and m are
//   exactly what K3/K4 recompute; the exponent is (x - m) * log2(e) in exp2f.
// - float32 (the Aligner) runs both products on the tensor cores at float32
//   accuracy, as 3xTF32: each operand x is split in registers into
//   big = tf32(x) and small = tf32(x - big) (cvt.rna's rounding, done with
//   integer operations), and each product is
//   big.big + big.small + small.big, summed in float32 (small.small, 2^-22
//   of it, is dropped); one TF32 product keeps 10 mantissa bits and misses
//   the float32 bar. The instruction is mma.sync m16n8k8 .tf32, not wgmma:
//   wgmma takes TF32 operands from shared memory only K-major (V would need
//   a transposed copy) and both halves there (Q and one K/V stage at D 256
//   would not fit). A block is 4 warps, 16 query rows each, 64 rows a
//   block; the grid takes the heaviest (last) query blocks first. Q's tile
//   is loaded once, K and V come in 64-key tiles (32 at D > 64) through a
//   ring of 2 stages (3 at D 192) that TMA fills under mbarriers, as for
//   bf16, in 32-column boxes (128-byte rows) under the 128-byte swizzle, so
//   every fragment load of Q, K and V reads 32 distinct banks. The m16n8k8
//   accumulator (columns 2t, 2t+1) is not its A layout (columns t, t+4), so
//   P.V reads V's B fragment in a permuted key order that matches P's
//   registers (see attn_fwd_tf32_kernel). Causal, a block stops loading at
//   the key tile of its last query row (the Aligner's decoder
//   self-attention, where that halves the work) unless one of its rows has
//   every key so far masked; then it takes every tile.
// - D (the head width) is any multiple of 8 up to 256: 192 at the published
//   width. Register tiles are sized by a compile-time bound (64/128/192/256)
//   and guarded at run time, so D need not be a power of two.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "tf32_tma.cuh"

namespace {

constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bfloat16: wgmma on tiles that TMA brings into a ring of stages
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;        // query rows of a warpgroup: wgmma's M
constexpr int Q_ROWS = 128;        // query rows of a block: two warpgroups
constexpr int KEYS = 64;           // keys of a tile
constexpr int WG_THREADS = 256;
constexpr int BOX = 64;            // bf16 columns of a TMA box: a 128-byte row
constexpr uint32_t Q_BOX_BYTES = Q_ROWS * 128;
constexpr uint32_t KV_BOX_BYTES = KEYS * 128;
constexpr uint32_t ATOM_BYTES = 1024;   // 8 rows of 128 B: the swizzle pattern

// ring depth by head-width template: as many stages as fit beside Q
__host__ __device__ constexpr int fwd_stages(int dmax) {
    return dmax <= 128 ? 4 : dmax <= 192 ? 3 : 2;
}

// Q, the ring, a full and an empty barrier a stage and Q's, and one atom to
// align the tiles to the swizzle pattern: 197,688 B at D 192
__host__ __device__ constexpr size_t wgmma_smem_bytes(int dmax) {
    return ATOM_BYTES + (size_t)(dmax / BOX) * Q_BOX_BYTES
        + (size_t)fwd_stages(dmax) * 2 * (dmax / BOX) * KV_BOX_BYTES
        + 8 * (1 + 2 * fwd_stages(dmax));
}

// wgmma's shared-memory matrix descriptor for a tile under the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units)
// and the swizzle mode (1: 128 B) in bits 62-63. The tiles sit on 1024-byte
// boundaries, so the base offset is 0.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
        | (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// K-major (rows of 64 k values, 128 B): 8-row groups 1024 B apart; a k16
// step inside the atom advances the start address by 32 B
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
    return sw128_desc(addr, 16, ATOM_BYTES);
}

// MN-major (V: key rows of 64 columns): 8-key groups 1024 B apart, 64-column
// boxes KV_BOX_BYTES apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
    return sw128_desc(addr, KV_BOX_BYTES, ATOM_BYTES);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous product that owns it
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WGMMA_ACC32(d)                                                                 \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
    "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
    "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
    "+f"(d[31])
#define WGMMA_D32                                                                     \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
    "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, f32) = [d +] A (64 x 16) B (16 x 64), A and B K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}"
        : WGMMA_ACC32(d) : "l"(a), "l"(b), "r"(accumulate));
}

// d += A (64 x 16, bf16 pairs in registers) B (16 x 64), B MN-major in shared
// memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
        : WGMMA_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WGMMA_ACC32
#undef WGMMA_D32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Thread 0: key tile i's K and V, nb boxes of `cols` columns each, into its
// stage of the ring, once the stage's previous tile has been released by
// every warp. Both kernels' boxes have 128-byte rows.
template <int TILE, int STAGES, uint32_t KV_BYTES>
__device__ __forceinline__ void load_kv_tile(int i, int nb, int cols, int bh, uint32_t ring,
                                             uint32_t full_bar, uint32_t empty_bar,
                                             const CUtensorMap* kmap, const CUtensorMap* vmap) {
    constexpr uint32_t BOX_BYTES = TILE * 128;
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(empty_bar + 8 * s, (i / STAGES - 1) & 1);
    mbar_expect_tx(full_bar + 8 * s, 2 * nb * BOX_BYTES);
    const uint32_t dst = ring + s * 2 * KV_BYTES;
    for (int j = 0; j < nb; ++j) {
        tma_load(dst + j * BOX_BYTES, kmap, j * cols, i * TILE, bh, full_bar + 8 * s);
        tma_load(dst + KV_BYTES + j * BOX_BYTES, vmap, j * cols, i * TILE, bh,
                 full_bar + 8 * s);
    }
}

// Layouts (PTX ISA, wgmma .m64nNk16), warp w of a warpgroup, lane = 4 g + t:
//   accumulator d[4n + e]: row 16 w + g + 8 (e >> 1), column 8 n + 2 t + (e & 1)
//   register A a[r] (bf16 pair): row 16 w + g + 8 (r & 1), k 2 t + 8 (r >> 1) + {0, 1}
// so the A fragment of k16 step kk of P.V is the accumulator pairs
// d[8 kk + 2 r], d[8 kk + 2 r + 1]: a[i] = pack(d[2 i], d[2 i + 1]).
template <int DMAX, bool TRAIN>
__global__ void __launch_bounds__(WG_THREADS, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int H, int Tq, int Tk, int D, int n_qblocks,
                      int causal, float scale, uint32_t key, uint32_t thr,
                      float keep_scale) {
    constexpr int NB = DMAX / BOX;              // 64-column boxes of a row
    constexpr int STAGES = fwd_stages(DMAX);
    constexpr uint32_t KV_BYTES = NB * KV_BOX_BYTES;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t q_smem = (smem_u32(smem_raw) + ATOM_BYTES - 1) & ~(ATOM_BYTES - 1);
    const uint32_t ring = q_smem + NB * Q_BOX_BYTES;          // stage s: K, then V
    const uint32_t q_bar = ring + STAGES * 2 * KV_BYTES;
    const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * STAGES;

    const int tid = threadIdx.x;
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int bh = blockIdx.x / n_qblocks, b = bh / H;
    const int q0 = (blockIdx.x % n_qblocks) * Q_ROWS;
    const int n_tiles = (Tk + KEYS - 1) / KEYS;

    if (tid == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_bar + 8 * s, 1);
            mbar_init(empty_bar + 8 * s, WG_THREADS / 32);   // one arrival a warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(q_bar, NB * Q_BOX_BYTES);
        for (int j = 0; j < NB; ++j)
            tma_load(q_smem + j * Q_BOX_BYTES, &qmap, j * BOX, q0, bh, q_bar);
        for (int i = 0; i < STAGES - 1 && i < n_tiles; ++i)
            load_kv_tile<KEYS, STAGES, KV_BYTES>(i, NB, BOX, bh, ring, full_bar, empty_bar,
                                                 &kmap, &vmap);
    }

    const int row0 = q0 + wg * WG_ROWS + warp * 16 + g;   // rows row0, row0 + 8
    const float* biasb = bias + (long long)b * Tk;
    const bool drop = TRAIN && thr != 0u;
    uint32_t hr[2] = {0u, 0u};
    if (drop) {
        uint32_t hb = dropout_bh_hash(key, bh);
        hr[0] = dropout_row_hash(hb, row0);
        hr[1] = dropout_row_hash(hb, row0 + 8);
    }
    float o[NB][32];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_wg = q_smem + wg * WG_ROWS * 128;   // this warpgroup's A rows
    mbar_wait(q_bar, 0);

    for (int i = 0; i < n_tiles; ++i) {
        if (tid == 0 && i + STAGES - 1 < n_tiles)
            load_kv_tile<KEYS, STAGES, KV_BYTES>(i + STAGES - 1, NB, BOX, bh, ring, full_bar,
                                                 empty_bar, &kmap, &vmap);
        const int stage = i % STAGES, k0 = i * KEYS;
        // the bias of this thread's 16 keys, read while the tile lands
        float bk[16];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                int col = k0 + 8 * n + 2 * t + e;
                bk[2 * n + e] = col < Tk ? __ldg(biasb + col) : 0.f;
            }
        mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);
        const uint32_t k_smem = ring + stage * 2 * KV_BYTES, v_smem = k_smem + KV_BYTES;

        // S = Q K^T over DP / 16 k16 steps
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < DMAX / 16; ++kd)
            wgmma_ss(s, kmajor_desc(q_wg + (kd / 4) * Q_BOX_BYTES + (kd % 4) * 32),
                     kmajor_desc(k_smem + (kd / 4) * KV_BOX_BYTES + (kd % 4) * 32), kd > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(s);

        // scale, mask, online softmax; row half h: rows row0 (h 0), row0 + 8 (h 1)
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int col = k0 + 8 * n + 2 * t + (e & 1), row = row0 + (e >> 1) * 8;
                float x = fmaf(s[4 * n + e], scale, bk[2 * n + (e & 1)]);
                if (causal && col > row) x = NEG_INF;
                if (col >= Tk) x = -INFINITY;
                s[4 * n + e] = x;
                tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            // the 4 lanes of a quad (same g) hold one row between them
            tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
            tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
            float m_new = fmaxf(m[h], tmax[h]);   // finite: every tile holds a key < Tk
            alpha[h] = exp2f((m[h] - m_new) * LOG2E);
            m[h] = m_new;
            l[h] *= alpha[h];
        }
        uint32_t pa[16];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float p = exp2f((s[4 * n + e] - m[e >> 1]) * LOG2E);
                l[e >> 1] += p;   // this lane's part of the row sum
                if (drop)
                    p = dropout_keep(hr[e >> 1], k0 + 8 * n + 2 * t + (e & 1), thr)
                        ? p * keep_scale : 0.f;
                s[4 * n + e] = p;
            }
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) pa[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                o[j][4 * n] *= alpha[0]; o[j][4 * n + 1] *= alpha[0];
                o[j][4 * n + 2] *= alpha[1]; o[j][4 * n + 3] *= alpha[1];
            }

        // O += P V: k16 step kk takes keys 16 kk.., 2048 B into each V box
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
            for (int j = 0; j < NB; ++j)
                wgmma_rs_mn(o[j], pa + 4 * kk,
                            mnmajor_desc(v_smem + j * KV_BOX_BYTES + kk * 2 * ATOM_BYTES));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int j = 0; j < NB; ++j) fence_acc(o[j]);
        if (lane == 0) mbar_arrive(empty_bar + 8 * stage);   // this warp is done with it
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    __nv_bfloat16* ob = out + (long long)bh * Tq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int row = row0 + h * 8;
        if (row >= Tq) continue;
        if (TRAIN && t == 0)
            reinterpret_cast<float2*>(lse)[(long long)bh * Tq + row] =
                make_float2(m[h], logf(l[h]));
        float inv = 1.f / l[h];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                int col = j * BOX + 8 * n + 2 * t;
                if (col < D)
                    *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * D + col) =
                        __floats2bfloat162_rn(o[j][4 * n + 2 * h] * inv,
                                              o[j][4 * n + 2 * h + 1] * inv);
            }
    }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync m16n8k8, K/V tiles that TMA brings into a ring
// ---------------------------------------------------------------------------

constexpr int F32_WARPS = 4;
constexpr int F32_THREADS = 32 * F32_WARPS;
constexpr int F32_ROWS = 16 * F32_WARPS;   // query rows of a block: 16 a warp

// keys of a tile and stages of the ring by head-width template: two blocks
// an SM at D <= 128 (81 KB and 97 KB), one above (145 KB with three stages
// at D 192, 193 KB at D 256)
__host__ __device__ constexpr int f32_keys(int dmax) { return dmax <= 64 ? 64 : 32; }
__host__ __device__ constexpr int f32_stages(int dmax) { return dmax == 192 ? 3 : 2; }

// Q, the ring, a full and an empty barrier a stage and Q's, one atom of alignment
__host__ __device__ constexpr size_t f32_smem_bytes(int dmax) {
    return ATOM_BYTES + (size_t)F32_ROWS * dmax * 4
        + (size_t)f32_stages(dmax) * 2 * f32_keys(dmax) * dmax * 4
        + 8 * (1 + 2 * f32_stages(dmax));
}

// Layouts (PTX ISA, mma .m16n8k8 .tf32), warp lane = 4 g + t:
//   A a[r]: row g + 8 (r & 1), k t + 4 (r >> 1)
//   B b[r]: k t + 4 r, column g
//   C d[e]: row g + 8 (e >> 1), column 2 t + (e & 1)
// A's k runs over columns t, t + 4 and C's over 2 t, 2 t + 1, so P (in S's C
// registers) cannot be A as it is. The sum over keys does not depend on
// their order, so the P.V step of keys 8 kk.. reads A's k = t as key 2 t and
// k = t + 4 as key 2 t + 1: a = (d[0], d[2], d[1], d[3]), and V's B fragment
// reads the same keys, b[r] = V[8 kk + 2 t + r][column g].
template <int DMAX, bool TRAIN>
__global__ void __launch_bounds__(F32_THREADS, 1)
attn_fwd_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Tq, int Tk, int D, int n_qblocks,
                     int causal, float scale, uint32_t key, uint32_t thr, float keep_scale) {
    constexpr int TILE = f32_keys(DMAX), STAGES = f32_stages(DMAX);
    constexpr int NS = TILE / 8;      // 8-key blocks of a tile
    constexpr int ND = DMAX / 8;      // 8-column blocks of a row
    constexpr uint32_t Q_BOX = F32_ROWS * 128, KV_BOX = TILE * 128;
    constexpr uint32_t KV_BYTES = (DMAX / F32_BOX) * KV_BOX;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* q_smem =
        smem_raw + ((ATOM_BYTES - (smem_u32(smem_raw) & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1));
    unsigned char* ring = q_smem + (DMAX / F32_BOX) * Q_BOX;   // stage s: K, then V
    const uint32_t q_bar = smem_u32(ring + STAGES * 2 * KV_BYTES);
    const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * STAGES;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // the heaviest query blocks first: a causal block's keys grow with its rows
    const int BH = gridDim.x / n_qblocks, bh = blockIdx.x % BH, b = bh / H;
    const int q0 = (n_qblocks - 1 - blockIdx.x / BH) * F32_ROWS;
    const int nb = (D + F32_BOX - 1) / F32_BOX;   // the boxes that hold columns < D
    const int n_tiles = (Tk + TILE - 1) / TILE;
    // A causal block's keys past its last query row are all look-ahead
    // masked: their logits are exactly NEG_INF, so their weights
    // exp(NEG_INF - m) are exactly 0 and their tiles are not loaded, unless a
    // row's max lies within 128 of NEG_INF (every earlier key masked), where
    // a fully masked row must still average v over all Tk keys.
    int n_load = causal ? min(n_tiles, (q0 + F32_ROWS + TILE - 1) / TILE) : n_tiles;
    int issued = 0;   // thread 0's count of tiles issued

    if (tid == 0) {
        mbar_init(q_bar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full_bar + 8 * s, 1);
            mbar_init(empty_bar + 8 * s, F32_WARPS);   // one arrival a warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        mbar_expect_tx(q_bar, nb * Q_BOX);
        for (int j = 0; j < nb; ++j)
            tma_load(smem_u32(q_smem) + j * Q_BOX, &qmap, j * F32_BOX, q0, bh, q_bar);
        for (; issued < min(n_load, STAGES - 1); ++issued)
            load_kv_tile<TILE, STAGES, KV_BYTES>(issued, nb, F32_BOX, bh, smem_u32(ring),
                                                 full_bar, empty_bar, &kmap, &vmap);
    }

    const int qr = warp * 16 + g, row0 = q0 + qr;   // rows row0, row0 + 8; qr in the Q tile
    const float* biasb = bias + (long long)b * Tk;
    const bool drop = TRAIN && thr != 0u;
    uint32_t hr[2] = {0u, 0u};
    if (drop) {
        uint32_t hb = dropout_bh_hash(key, bh);
        hr[0] = dropout_row_hash(hb, row0);
        hr[1] = dropout_row_hash(hb, row0 + 8);
    }
    float o[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);

    for (int i = 0; i < n_load; ++i) {
        if (tid == 0)
            for (; issued < min(n_load, i + STAGES); ++issued)
                load_kv_tile<TILE, STAGES, KV_BYTES>(issued, nb, F32_BOX, bh, smem_u32(ring),
                                                     full_bar, empty_bar, &kmap, &vmap);
        const int stage = i % STAGES, k0 = i * TILE;
        // the bias of this thread's keys, read while the tile lands
        float bk[NS][2];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                int col = k0 + 8 * n + 2 * t + e;
                bk[n][e] = col < Tk ? __ldg(biasb + col) : 0.f;
            }
        mbar_wait(full_bar + 8 * stage, (i / STAGES) & 1);
        const unsigned char* k_smem = ring + stage * 2 * KV_BYTES;
        const unsigned char* v_smem = k_smem + KV_BYTES;

        // S = Q K^T over the 8-column steps that hold columns < D
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        // a loop at run time: unrolled, the compiler hoists every step's
        // loads and runs out of registers
#pragma unroll 2
        for (int kd = 0; kd < D / 8; ++kd) {
            const int c = 8 * kd + t;
            uint32_t ab[4], as[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                split_tf32(lds(q_smem, sw_off(qr + 8 * (r & 1), c + 4 * (r >> 1), F32_ROWS)), ab[r],
                           as[r]);
#pragma unroll
            for (int n = 0; n < NS; ++n) {
                uint32_t bb[2], bs[2];
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    split_tf32(lds(k_smem, sw_off(8 * n + g, c + 4 * r, TILE)), bb[r], bs[r]);
                mma_3xtf32(s[n], ab, as, bb, bs);
            }
        }

        // scale, mask, online softmax; row half h: rows row0 (h 0), row0 + 8 (h 1)
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int col = k0 + 8 * n + 2 * t + (e & 1), row = row0 + (e >> 1) * 8;
                float x = fmaf(s[n][e], scale, bk[n][e & 1]);
                if (causal && col > row) x = NEG_INF;
                if (col >= Tk) x = -INFINITY;
                s[n][e] = x;
                tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
            }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            // the 4 lanes of a quad (same g) hold one row between them
            tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
            tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
            float m_new = fmaxf(m[h], tmax[h]);   // finite: every tile holds a key < Tk
            alpha[h] = exp2f((m[h] - m_new) * LOG2E);
            m[h] = m_new;
            l[h] *= alpha[h];
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float p = exp2f((s[n][e] - m[e >> 1]) * LOG2E);
                l[e >> 1] += p;   // this lane's part of the row sum
                if (drop)
                    p = dropout_keep(hr[e >> 1], k0 + 8 * n + 2 * t + (e & 1), thr)
                        ? p * keep_scale : 0.f;
                s[n][e] = p;
            }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
            o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
        }

        // O += P V, keys 8 kk.. in the order 2 t, 2 t + 1 (see the layouts).
        // Column blocks go in groups of 8 with no branch inside a group, so
        // that its accumulators' products interleave (a branch between
        // blocks would leave each block's 3 dependent products exposed).
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {
            uint32_t ab[4], as[4];
            split_tf32(s[kk][0], ab[0], as[0]);
            split_tf32(s[kk][2], ab[1], as[1]);
            split_tf32(s[kk][1], ab[2], as[2]);
            split_tf32(s[kk][3], ab[3], as[3]);
#pragma unroll
            for (int j0 = 0; j0 < ND; j0 += 8) {
                if (8 * j0 >= D) break;
#pragma unroll
                for (int j = j0; j < j0 + 8; ++j) {
                    uint32_t bb[2], bs[2];
#pragma unroll
                    for (int r = 0; r < 2; ++r)
                        split_tf32(lds(v_smem, sw_off(8 * kk + 2 * t + r, 8 * j + g, TILE)),
                                   bb[r], bs[r]);
                    mma_3xtf32(o[j], ab, as, bb, bs);
                }
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * stage);   // this warp is done with it

        if (i == n_load - 1 && n_load < n_tiles) {
            bool low = (row0 < Tq && m[0] < NEG_INF + 128.f)
                       || (row0 + 8 < Tq && m[1] < NEG_INF + 128.f);
            if (__syncthreads_or(low)) n_load = n_tiles;
        }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    float* ob = out + (long long)bh * Tq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int row = row0 + h * 8;
        if (row >= Tq) continue;
        if (TRAIN && t == 0)
            reinterpret_cast<float2*>(lse)[(long long)bh * Tq + row] =
                make_float2(m[h], logf(l[h]));
        float inv = 1.f / l[h];
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            int col = 8 * j + 2 * t;
            if (col < D)
                *reinterpret_cast<float2*>(ob + (long long)row * D + col) =
                    make_float2(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
        }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

#define ATTN_ARGS q, k, v, bias, out, lse, B, H, Tq, Tk, D, causal, scale, key, thr, \
                  keep_scale, stream
#define ATTN_PARAMS const void* q, const void* k, const void* v, const float* bias, \
                    void* out, float* lse, int B, int H, int Tq, int Tk, int D, \
                    int causal, float scale, uint32_t key, uint32_t thr, \
                    float keep_scale, cudaStream_t stream

// the instance of KERNEL for head width D
#define PICK_D(KERNEL, TRAIN)                                                  \
    (D <= 64 ? KERNEL<64, TRAIN> : D <= 128 ? KERNEL<128, TRAIN>               \
     : D <= 192 ? KERNEL<192, TRAIN> : KERNEL<256, TRAIN>)

// One dtype's design: block size, query rows and key rows of a block's
// tiles, shared memory, ring stages and element bytes.
struct Design {
    int threads, q_rows, keys, stages, elem_bytes;
    size_t smem;
};

Design design(int dtype, int D) {
    const int dmax = dmax_of(D);
    if (dtype == 0)
        return {F32_THREADS, F32_ROWS, f32_keys(dmax), f32_stages(dmax), 4,
                f32_smem_bytes(dmax)};
    return {WG_THREADS, Q_ROWS, KEYS, fwd_stages(dmax), 2, wgmma_smem_bytes(dmax)};
}

template <bool TRAIN>
int launch(int dtype, ATTN_PARAMS) {
    const Design ds = design(dtype, D);
    const int n_qblocks = (Tq + ds.q_rows - 1) / ds.q_rows;
    if ((long long)B * H * n_qblocks > INT_MAX) return -1;
    CUtensorMap qmap, kmap, vmap;
    if (!tensor_map(&qmap, q, B * H, Tq, D, ds.q_rows, ds.elem_bytes)
        || !tensor_map(&kmap, k, B * H, Tk, D, ds.keys, ds.elem_bytes)
        || !tensor_map(&vmap, v, B * H, Tk, D, ds.keys, ds.elem_bytes))
        return -2;
    auto start = [&](auto kernel, auto* typed_out) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ds.smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<B * H * n_qblocks, ds.threads, ds.smem, stream>>>(
            qmap, kmap, vmap, bias, typed_out, lse, H, Tq, Tk, D, n_qblocks, causal, scale,
            key, thr, keep_scale);
        return (int)cudaGetLastError();
    };
    return dtype == 0 ? start(PICK_D(attn_fwd_tf32_kernel, TRAIN), static_cast<float*>(out))
                      : start(PICK_D(attn_fwd_wgmma_kernel, TRAIN),
                              static_cast<__nv_bfloat16*>(out));
}

bool bad_width(int D) { return D < 8 || D > 256 || D % 8 != 0; }

template <bool TRAIN>
int dispatch(int dtype, ATTN_PARAMS) {
    if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || bad_width(D) || (dtype != 0 && dtype != 1))
        return -1;
    return launch<TRAIN>(dtype, ATTN_ARGS);
}

// What a kernel uses, as the card reports it: out = {registers a thread,
// local (spill) bytes a thread, static and dynamic shared memory a block,
// blocks an SM, threads a block, stages of the K/V ring, keys of a tile}.
template <typename Kernel>
int kernel_resources(Kernel kernel, const Design& ds, int* out) {
    int blocks = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ds.smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, ds.threads,
                                                            ds.smem);
    if (err != cudaSuccess) return (int)err;
    const int values[8] = {attr.numRegs, (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                           (int)ds.smem, blocks, ds.threads, ds.stages, ds.keys};
    for (int i = 0; i < 8; ++i) out[i] = values[i];
    return 0;
}

template <bool TRAIN>
int resources(int dtype, int D, int* out) {
    const Design ds = design(dtype, D);
    return dtype == 0 ? kernel_resources(PICK_D(attn_fwd_tf32_kernel, TRAIN), ds, out)
                      : kernel_resources(PICK_D(attn_fwd_wgmma_kernel, TRAIN), ds, out);
}

#undef ATTN_ARGS
#undef ATTN_PARAMS

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; bias is float32).
// Tensors are contiguous and 16-byte aligned: q, out (B, H, Tq, D);
// k, v (B, H, Tk, D); bias (B, Tk). Returns 0, or the cudaError_t of a
// refused launch; -1 for arguments the kernel does not take (the Python
// wrapper checks them first), -2 when the tensor maps cannot be made
// (cuTensorMapEncodeTiled not found, or a map it refuses).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const float* bias, void* out, int B, int H,
                                   int Tq, int Tk, int D, int causal, int dtype,
                                   float scale, void* stream) {
    return dispatch<false>(dtype, q, k, v, bias, out, nullptr, B, H, Tq, Tk, D,
                           causal, scale, 0u, 0u, 1.f,
                           static_cast<cudaStream_t>(stream));
}

// K2: as flash_attention_fwd, plus lse (B, H, Tq, 2) float32, the (m, log l)
// of each row's softmax, and dropout on the weights: key from the host
// (ops/flash_attention.py::_dropout_key), thr = floor(rate * 2^32) (0 = no
// dropout), keep_scale = 1 / (1 - rate).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                                       const float* bias, void* out, float* lse,
                                       int B, int H, int Tq, int Tk, int D,
                                       int causal, int dtype, float scale,
                                       uint32_t key, uint32_t thr, float keep_scale,
                                       void* stream) {
    return dispatch<true>(dtype, q, k, v, bias, out, lse, B, H, Tq, Tk, D, causal,
                          scale, key, thr, keep_scale,
                          static_cast<cudaStream_t>(stream));
}

// The resources (see kernel_resources) of the kernel for dtype (0 float32,
// 1 bfloat16) at head width D, K1's instance for train = 0, K2's for
// train = 1: 0, a cudaError_t, or -1 for a width or dtype it does not take.
extern "C" int flash_attention_fwd_resources(int D, int train, int dtype, int* out) {
    if (bad_width(D) || (dtype != 0 && dtype != 1)) return -1;
    return train ? resources<true>(dtype, D, out) : resources<false>(dtype, D, out);
}
