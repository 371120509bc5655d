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
//   known, no online rescaling is needed: K3 streams 64-key tiles past a
//   64-query block, K4 streams 32-query tiles past a 64-key block, and each
//   block owns its output rows, so there are no atomics.
// - K4's accumulators at D = 192 are 2 x 64 x 192 float32 = 96 KB a block,
//   more than the registers of 4 warps hold beside the score tiles. dV stays
//   in registers (each warp owns 16 keys: 96 floats a thread at D = 192) and
//   dK accumulates in shared memory (48 KB), one mma n-tile at a time.
// - bfloat16 runs all four products on the tensor cores with mma.sync
//   m16n8k16 (float32 accumulate); P and dS go back to them in bfloat16.
//   Operands needed transposed (K^T in K3; Q^T and dO^T in K4) are stored
//   transposed in shared memory as the tiles arrive.
// - float32 runs SIMT kernels on the CUDA cores (TF32 would not hold float32
//   parity): 256 threads, K3 with 64 queries x 32-key tiles, K4 with 32 keys x
//   32-query tiles.

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
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 rows
constexpr int TILE = 64;           // K3: queries a block and keys a tile; K4: keys a block
constexpr int QTILE = 32;          // K4: queries a tile
constexpr int T64_STRIDE = TILE + 8;    // row strides of transposed tiles (bf16);
constexpr int T32_STRIDE = QTILE + 8;   // the pad keeps fragment loads conflict free

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

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

// Rows [r0, r0 + n) of a (T, D) bf16 matrix into smem: row-major with stride
// rs (if rm) and transposed [d][row] with stride ts (if tr); zero outside.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* src, int r0, int n,
                                          int T, int D, int DP,
                                          __nv_bfloat16* rm, int rs,
                                          __nv_bfloat16* tr, int ts) {
    const int C8 = DP / 8;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int idx = threadIdx.x; idx < n * C8; idx += blockDim.x) {
        // rows fastest, so the transposed 2-byte stores of a warp land on
        // consecutive addresses of one transposed row
        int r = idx % n, d = (idx / n) * 8;
        uint4 x = (r0 + r < T && d < D)
            ? *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * D + d) : zero;
        if (rm) *reinterpret_cast<uint4*>(rm + r * rs + d) = x;
        if (tr) {
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
            for (int i = 0; i < 8; ++i) tr[(d + i) * ts + r] = e[i];
        }
    }
}

// acc(16 x 8*nt) += A(16 x DP, row-major smem, this warp's rows) . B^T where B
// is (8*nt x DP) row-major smem: the score products Q K^T, dO V^T, K Q^T, V dO^T
template <int NT>
__device__ __forceinline__ void scores(float (*acc)[4], const __nv_bfloat16* a,
                                       const __nv_bfloat16* b, int stride, int DP,
                                       int g, int t) {
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const __nv_bfloat16* aw = a + g * stride + 2 * t;
    for (int kd = 0; kd < DP; kd += 16) {
        uint32_t a0 = ld32(aw + kd), a1 = ld32(aw + 8 * stride + kd);
        uint32_t a2 = ld32(aw + kd + 8), a3 = ld32(aw + 8 * stride + kd + 8);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            const __nv_bfloat16* bp = b + (n * 8 + g) * stride + kd + 2 * t;
            mma_bf16(acc[n], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
        }
    }
}

size_t dq_mma_smem_bytes(int d) {
    int dp = (d + 15) / 16 * 16;
    // Q, dO, K, V row-major [64][dp + 8]; K^T [dp][72]; bias [64]
    return ((size_t)4 * TILE * (dp + 8) + (size_t)dp * T64_STRIDE)
        * sizeof(__nv_bfloat16) + TILE * sizeof(float);
}

// K3: grid (B*H, ceil(Tq / 64)); warp w owns query rows q0 + 16 w .. + 15.
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
attn_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk, int D,
                   int causal, float scale, Drop drop) {
    constexpr int NT = DMAX / 8;
    const int DP = (D + 15) / 16 * 16;
    const int RS = DP + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][RS]
    __nv_bfloat16* dos = qs + TILE * RS;                                // [64][RS]
    __nv_bfloat16* ks = dos + TILE * RS;                                // [64][RS]
    __nv_bfloat16* vs = ks + TILE * RS;                                 // [64][RS]
    __nv_bfloat16* kt = vs + TILE * RS;                                 // [DP][72]
    float* bs = reinterpret_cast<float*>(kt + DP * T64_STRIDE);         // [64]

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int bh = blockIdx.x, b = bh / H;
    const int q0 = blockIdx.y * TILE;
    const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
    const float* biasb = bias + (long long)b * Tk;

    load_tile(q + qoff, q0, TILE, Tq, D, DP, qs, RS, nullptr, 0);
    load_tile(dout + qoff, q0, TILE, Tq, D, DP, dos, RS, nullptr, 0);

    const int row0 = q0 + warp * 16 + g;   // rows row0 and row0 + 8
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

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int k0 = 0; k0 < Tk; k0 += TILE) {
        __syncthreads();   // the previous tile's reads are done
        load_tile(k + koff, k0, TILE, Tk, D, DP, ks, RS, kt, T64_STRIDE);
        load_tile(v + koff, k0, TILE, Tk, D, DP, vs, RS, nullptr, 0);
        if (tid < TILE) bs[tid] = (k0 + tid < Tk) ? biasb[k0 + tid] : 0.f;
        __syncthreads();

        float s[TILE / 8][4], dp[TILE / 8][4];
        scores<TILE / 8>(s, qs + warp * 16 * RS, ks, RS, DP, g, t);
        scores<TILE / 8>(dp, dos + warp * 16 * RS, vs, RS, DP, g, t);
#pragma unroll
        for (int n = 0; n < TILE / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int h = e >> 1, key = n * 8 + 2 * t + (e & 1);
                float p = recompute_p(s[n][e], scale, bs[key], row0 + 8 * h, k0 + key,
                                      Tq, Tk, causal, row_lse[h]);
                float dpd = dp[n][e];
                if (dropping)
                    dpd = dropout_keep(hr[h], k0 + key, drop.thr) ? dpd * drop.keep_scale : 0.f;
                s[n][e] = recompute_ds(p, dpd, row_d[h], row0 + 8 * h, k0 + key, causal);
            }
        }
        // dQ += dS K: dS accumulators of n-tiles 2kk, 2kk+1 are the A
        // fragment of k-step kk; K^T in smem gives the B fragments
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
            uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                if (n * 8 < D) {
                    const __nv_bfloat16* bp = kt + (n * 8 + g) * T64_STRIDE + kk * 16 + 2 * t;
                    mma_bf16(acc[n], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
                }
            }
        }
    }

    __nv_bfloat16* dqb = dq + qoff;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int row = row0 + 8 * h;
        if (row >= Tq) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            int col = n * 8 + 2 * t;
            if (col < D)
                *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)row * D + col) =
                    __floats2bfloat162_rn(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
        }
    }
}

size_t dkv_mma_smem_bytes(int d) {
    int dp = (d + 15) / 16 * 16;
    // K, V [64][dp + 8]; Q, dO [32][dp + 8]; Q^T, dO^T [dp][40] (bf16);
    // dK [64][dp + 8], lse [32][2] and D [32] (float32)
    return ((size_t)2 * TILE * (dp + 8) + (size_t)2 * QTILE * (dp + 8)
            + (size_t)2 * dp * T32_STRIDE) * sizeof(__nv_bfloat16)
        + ((size_t)TILE * (dp + 8) + 3 * QTILE) * sizeof(float);
}

// K4: grid (B*H, ceil(Tk / 64)); warp w owns key rows k0 + 16 w .. + 15. The
// score tiles are transposed (keys x queries): S^T = K Q^T, dP^T = V dO^T.
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
attn_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                    int H, int Tq, int Tk, int D, int causal, float scale, Drop drop) {
    constexpr int NT = DMAX / 8;
    constexpr int SN = QTILE / 8;          // score n-tiles a warp
    const int DP = (D + 15) / 16 * 16;
    const int RS = DP + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [64][RS]
    __nv_bfloat16* vs = ks + TILE * RS;                                 // [64][RS]
    __nv_bfloat16* qs = vs + TILE * RS;                                 // [32][RS]
    __nv_bfloat16* dos = qs + QTILE * RS;                               // [32][RS]
    __nv_bfloat16* qt = dos + QTILE * RS;                               // [DP][40]
    __nv_bfloat16* dot = qt + DP * T32_STRIDE;                          // [DP][40]
    float* dks = reinterpret_cast<float*>(dot + DP * T32_STRIDE);       // [64][RS]
    float2* lse_s = reinterpret_cast<float2*>(dks + TILE * RS);         // [32]
    float* d_s = reinterpret_cast<float*>(lse_s + QTILE);               // [32]

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int bh = blockIdx.x, b = bh / H;
    const int kb0 = blockIdx.y * TILE;
    const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;

    load_tile(k + koff, kb0, TILE, Tk, D, DP, ks, RS, nullptr, 0);
    load_tile(v + koff, kb0, TILE, Tk, D, DP, vs, RS, nullptr, 0);
    for (int idx = tid; idx < TILE * RS; idx += MMA_THREADS) dks[idx] = 0.f;

    const int key0 = kb0 + warp * 16 + g;   // keys key0 and key0 + 8
    float key_bias[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
        key_bias[h] = key0 + 8 * h < Tk ? bias[(long long)b * Tk + key0 + 8 * h] : 0.f;
    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;

    float acc_v[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
    float* dkw = dks + (warp * 16 + g) * RS + 2 * t;

    for (int q0 = 0; q0 < Tq; q0 += QTILE) {
        __syncthreads();   // the previous tile's reads are done
        load_tile(q + qoff, q0, QTILE, Tq, D, DP, qs, RS, qt, T32_STRIDE);
        load_tile(dout + qoff, q0, QTILE, Tq, D, DP, dos, RS, dot, T32_STRIDE);
        if (tid < QTILE) {
            bool in = q0 + tid < Tq;
            lse_s[tid] = in ? row_lse_at(lse, (long long)bh * Tq + q0 + tid)
                            : make_float2(0.f, 0.f);
            d_s[tid] = in ? dsum[(long long)bh * Tq + q0 + tid] : 0.f;
        }
        __syncthreads();

        float s[SN][4], dp[SN][4];
        scores<SN>(s, ks + warp * 16 * RS, qs, RS, DP, g, t);
        scores<SN>(dp, vs + warp * 16 * RS, dos, RS, DP, g, t);
        float pd[SN][4];   // P o M, then s holds dS
#pragma unroll
        for (int n = 0; n < SN; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int h = e >> 1, qi = n * 8 + 2 * t + (e & 1);
                int row = q0 + qi, col = key0 + 8 * h;
                float p = recompute_p(s[n][e], scale, key_bias[h], row, col, Tq, Tk,
                                      causal, lse_s[qi]);
                float m = 1.f;
                if (dropping)
                    m = dropout_keep(dropout_row_hash(hb, row), col, drop.thr)
                        ? drop.keep_scale : 0.f;
                pd[n][e] = p * m;
                s[n][e] = recompute_ds(p, dp[n][e] * m, d_s[qi], row, col, causal);
            }
        }
        // dV += (P o M)^T dO and dK += dS^T Q: the (keys x queries) score
        // accumulators are the A fragments; dO^T and Q^T give the B fragments
#pragma unroll
        for (int kk = 0; kk < QTILE / 16; ++kk) {
            uint32_t p0 = pack_bf16(pd[2 * kk][0], pd[2 * kk][1]);
            uint32_t p1 = pack_bf16(pd[2 * kk][2], pd[2 * kk][3]);
            uint32_t p2 = pack_bf16(pd[2 * kk + 1][0], pd[2 * kk + 1][1]);
            uint32_t p3 = pack_bf16(pd[2 * kk + 1][2], pd[2 * kk + 1][3]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                if (n * 8 < D) {
                    const __nv_bfloat16* bp = dot + (n * 8 + g) * T32_STRIDE + kk * 16 + 2 * t;
                    mma_bf16(acc_v[n], p0, p1, p2, p3, ld32(bp), ld32(bp + 8));
                }
            }
        }
        uint32_t a[QTILE / 16][4];
#pragma unroll
        for (int kk = 0; kk < QTILE / 16; ++kk) {
            a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
        for (int n = 0; n * 8 < D; ++n) {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < QTILE / 16; ++kk) {
                const __nv_bfloat16* bp = qt + (n * 8 + g) * T32_STRIDE + kk * 16 + 2 * t;
                mma_bf16(c, a[kk][0], a[kk][1], a[kk][2], a[kk][3], ld32(bp), ld32(bp + 8));
            }
            // this warp's own rows: no other warp touches them
            float2* r0 = reinterpret_cast<float2*>(dkw + n * 8);
            float2* r1 = reinterpret_cast<float2*>(dkw + 8 * RS + n * 8);
            float2 x0 = *r0, x1 = *r1;
            x0.x += c[0]; x0.y += c[1]; x1.x += c[2]; x1.y += c[3];
            *r0 = x0; *r1 = x1;
        }
    }

    __nv_bfloat16* dkb = dk + koff;
    __nv_bfloat16* dvb = dv + koff;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        int key = key0 + 8 * h;
        if (key >= Tk) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            int col = n * 8 + 2 * t;
            if (col < D) {
                const float* src = dkw + 8 * h * RS + n * 8;
                *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)key * D + col) =
                    __floats2bfloat162_rn(src[0] * scale, src[1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)key * D + col) =
                    __floats2bfloat162_rn(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores (SIMT), 256 threads as 16 x 16
// ---------------------------------------------------------------------------

constexpr int SIMT_THREADS = 256;
constexpr int S64 = 64 + 1;   // strides of transposed 64- and 32-wide tiles
constexpr int S32 = 32 + 1;

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

size_t dq_simt_smem_bytes(int d) {
    // Q^T, dO^T [D][65]; K^T, V^T [D][33]; K [32][D]; dS^T [32][65]; bias [32]
    return ((size_t)2 * d * S64 + (size_t)2 * d * S32 + (size_t)32 * d + 32 * S64 + 32)
        * sizeof(float);
}

// K3: grid (B*H, ceil(Tq / 64)); a thread owns query rows ty + 16 i (i < 4).
template <int DMAX>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_dq_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dsum, float* __restrict__ dq, int H,
                    int Tq, int Tk, int D, int causal, float scale, Drop drop) {
    constexpr int NC = DMAX / 16;
    extern __shared__ float smem[];
    float* qt = smem;                 // [D][65]
    float* dot = qt + D * S64;        // [D][65]
    float* kt = dot + D * S64;        // [D][33]
    float* vt = kt + D * S32;         // [D][33]
    float* ks = vt + D * S32;         // [32][D]
    float* dst = ks + 32 * D;         // [32][65]
    float* bs = dst + 32 * S64;       // [32]

    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int bh = blockIdx.x, b = bh / H;
    const int q0 = blockIdx.y * 64;
    const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
    const float* biasb = bias + (long long)b * Tk;

    load_tile_f32(q + qoff, q0, 64, Tq, D, nullptr, qt, S64);
    load_tile_f32(dout + qoff, q0, 64, Tq, D, nullptr, dot, S64);

    const bool dropping = drop.thr != 0u;
    const uint32_t hb = dropping ? dropout_bh_hash(drop.key, bh) : 0u;
    float2 row_lse[4];
    float row_d[4], acc[4][NC];
    uint32_t hr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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

        float s[4][2] = {}, dp[4][2] = {};
        for (int d = 0; d < D; ++d) {
            const float* qrow = qt + d * S64 + ty;
            const float* orow = dot + d * S64 + ty;
            float k0v = kt[d * S32 + tx], k1v = kt[d * S32 + tx + 16];
            float v0v = vt[d * S32 + tx], v1v = vt[d * S32 + tx + 16];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float qv = qrow[16 * i], ov = orow[16 * i];
                s[i][0] = fmaf(qv, k0v, s[i][0]);
                s[i][1] = fmaf(qv, k1v, s[i][1]);
                dp[i][0] = fmaf(ov, v0v, dp[i][0]);
                dp[i][1] = fmaf(ov, v1v, dp[i][1]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            int row = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                int kk = tx + 16 * j, col = k0 + kk;
                float p = recompute_p(s[i][j], scale, bs[kk], row, col, Tq, Tk, causal,
                                      row_lse[i]);
                float dpd = dp[i][j];
                if (dropping)
                    dpd = dropout_keep(hr[i], col, drop.thr) ? dpd * drop.keep_scale : 0.f;
                dst[kk * S64 + ty + 16 * i] = recompute_ds(p, dpd, row_d[i], row, col, causal);
            }
        }
        __syncthreads();   // dS tile complete

        for (int kk = 0; kk < 32; ++kk) {
            const float* srow = dst + kk * S64 + ty;
            const float* krow = ks + kk * D + tx;
            float sv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) sv[i] = srow[16 * i];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                if (tx + 16 * c < D) {
                    float kv = krow[16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
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

bool bad_shape(int B, int H, int Tq, int Tk, int D) {
    return B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 8 || D > 256 || D % 8 != 0
        || (Tq + 63) / 64 > 65535 || (Tk + 31) / 32 > 65535;
}

}  // namespace

#define DISPATCH_D(KERNEL, T, ...)                                                   \
    (D <= 64 ? launch(KERNEL<64>, __VA_ARGS__)                                        \
     : D <= 128 ? launch(KERNEL<128>, __VA_ARGS__)                                    \
     : D <= 192 ? launch(KERNEL<192>, __VA_ARGS__)                                    \
                : launch(KERNEL<256>, __VA_ARGS__))

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
    dim3 grid(B * H, (Tq + 63) / 64);
    if (dtype == 0) {
        using T = float;
        return DISPATCH_D(attn_dq_simt_kernel, T, grid, SIMT_THREADS,
                          dq_simt_smem_bytes(D), s, (const T*)q, (const T*)k,
                          (const T*)v, bias, (const T*)dout, lse, dsum, (T*)dq, H, Tq,
                          Tk, D, causal, scale, drop);
    }
    if (dtype == 1) {
        using T = __nv_bfloat16;
        return DISPATCH_D(attn_dq_mma_kernel, T, grid, MMA_THREADS,
                          dq_mma_smem_bytes(D), s, (const T*)q, (const T*)k,
                          (const T*)v, bias, (const T*)dout, lse, dsum, (T*)dq, H, Tq,
                          Tk, D, causal, scale, drop);
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
        return DISPATCH_D(attn_dkv_simt_kernel, T, dim3(B * H, (Tk + 31) / 32),
                          SIMT_THREADS, dkv_simt_smem_bytes(D), s, (const T*)q,
                          (const T*)k, (const T*)v, bias, (const T*)dout, lse, dsum,
                          (T*)dk, (T*)dv, H, Tq, Tk, D, causal, scale, drop);
    }
    if (dtype == 1) {
        using T = __nv_bfloat16;
        return DISPATCH_D(attn_dkv_mma_kernel, T, dim3(B * H, (Tk + 63) / 64),
                          MMA_THREADS, dkv_mma_smem_bytes(D), s, (const T*)q,
                          (const T*)k, (const T*)v, bias, (const T*)dout, lse, dsum,
                          (T*)dk, (T*)dv, H, Tq, Tk, D, causal, scale, drop);
    }
    return -1;
}
