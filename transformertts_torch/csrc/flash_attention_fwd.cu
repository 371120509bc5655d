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
//   in tiles with an online softmax (running max, running sum, float32
//   accumulator in registers), and queries are tiled too:
//   grid = (B*H, ceil(Tq / 64)). Each Q/K/V element is read from device
//   memory once per query tile, so at the synthesis shapes the kernel is
//   bound by arithmetic, not by the 3.35 TB/s of HBM.
// - bfloat16 (the synthesis path) runs both products on the tensor cores
//   with mma.sync m16n8k16 (float32 accumulate): each of 4 warps owns 16
//   query rows, the scores never leave registers, and the probabilities are
//   fed back as the A operand of P.V in bfloat16. wgmma and TMA are the
//   next step.
// - float32 has no tensor-core path at float32 precision (TF32 keeps 10
//   mantissa bits), so it runs a SIMT kernel on the CUDA cores: 256 threads,
//   a 4x2 score tile and a 4x(D/16) output tile per thread, 32-key tiles.
// - D (the head width) is any multiple of 8 up to 256: 192 at the published
//   width. Register tiles are sized by a compile-time bound (64/128/192/256)
//   and guarded at run time, so D need not be a power of two.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"

namespace {

constexpr float NEG_INF = -1e9f;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MQ = 64;            // queries per block: 4 warps x 16 rows
constexpr int MK = 64;            // keys per tile
constexpr int MMA_THREADS = 128;
constexpr int VT_STRIDE = MK + 8; // row stride of V^T in smem (bf16); the pad
                                  // makes fragment loads bank-conflict free

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

size_t mma_smem_bytes(int d) {
    int dp = (d + 15) / 16 * 16;
    return ((size_t)MQ * (dp + 8) + (size_t)MK * (dp + 8) + (size_t)dp * VT_STRIDE)
        * sizeof(__nv_bfloat16) + MK * sizeof(float);
}

// Fragment layouts of m16n8k16 (PTX ISA), lane = 4 g + t:
//   A regs: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..)
//   B regs: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g)
//   C:      (row g, col 2t..2t+1), (row g+8, col 2t..2t+1)
template <int DMAX, bool TRAIN>
__global__ void __launch_bounds__(MMA_THREADS)
attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int H, int Tq, int Tk, int D,
                    int causal, float scale, uint32_t key, uint32_t thr,
                    float keep_scale) {
    constexpr int NT = DMAX / 8;           // output n-tiles per warp
    const int DP = (D + 15) / 16 * 16;     // head width padded to the mma depth
    const int QS = DP + 8;                 // row stride of the Q and K tiles
    const int C8 = DP / 8;                 // 16-byte chunks per padded row
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MQ][QS]
    __nv_bfloat16* ks = qs + MQ * QS;                                  // [MK][QS]
    __nv_bfloat16* vt = ks + MK * QS;                                  // [DP][VT_STRIDE]
    float* bs = reinterpret_cast<float*>(vt + DP * VT_STRIDE);         // [MK]

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int q0 = blockIdx.y * MQ;

    const __nv_bfloat16* qb = q + (long long)bh * Tq * D;
    const __nv_bfloat16* kb = k + (long long)bh * Tk * D;
    const __nv_bfloat16* vb = v + (long long)bh * Tk * D;
    const float* biasb = bias + (long long)b * Tk;
    const uint4 zero = make_uint4(0, 0, 0, 0);

    for (int idx = tid; idx < MQ * C8; idx += MMA_THREADS) {
        int r = idx / C8, d = (idx % C8) * 8;
        uint4 x = (q0 + r < Tq && d < D)
            ? *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * D + d) : zero;
        *reinterpret_cast<uint4*>(qs + r * QS + d) = x;
    }

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const int row0 = q0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8
    const __nv_bfloat16* qw = qs + (warp * 16 + g) * QS + 2 * t;
    const bool drop = TRAIN && thr != 0u;
    uint32_t hr[2] = {0u, 0u};
    if (drop) {
        uint32_t hb = dropout_bh_hash(key, bh);
        hr[0] = dropout_row_hash(hb, row0);
        hr[1] = dropout_row_hash(hb, row0 + 8);
    }

    for (int k0 = 0; k0 < Tk; k0 += MK) {
        __syncthreads();   // the previous tile's K/V reads are done
        for (int idx = tid; idx < MK * C8; idx += MMA_THREADS) {
            int kk = idx / C8, d = (idx % C8) * 8;   // d fastest: coalesced rows
            uint4 x = (k0 + kk < Tk && d < D)
                ? *reinterpret_cast<const uint4*>(kb + (long long)(k0 + kk) * D + d) : zero;
            *reinterpret_cast<uint4*>(ks + kk * QS + d) = x;
        }
        for (int idx = tid; idx < MK * C8; idx += MMA_THREADS) {
            // keys fastest, so the transposed 2-byte stores of a warp land on
            // consecutive addresses of one V^T row (no bank conflicts)
            int kk = idx % MK, d = (idx / MK) * 8;
            uint4 x = (k0 + kk < Tk && d < D)
                ? *reinterpret_cast<const uint4*>(vb + (long long)(k0 + kk) * D + d) : zero;
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
            for (int i = 0; i < 8; ++i) vt[(d + i) * VT_STRIDE + kk] = e[i];
        }
        if (tid < MK) bs[tid] = (k0 + tid < Tk) ? biasb[k0 + tid] : 0.f;
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[MK / 8][4];
#pragma unroll
        for (int n = 0; n < MK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        for (int kd = 0; kd < DP; kd += 16) {
            uint32_t a0 = ld32(qw + kd), a1 = ld32(qw + 8 * QS + kd);
            uint32_t a2 = ld32(qw + kd + 8), a3 = ld32(qw + 8 * QS + kd + 8);
#pragma unroll
            for (int n = 0; n < MK / 8; ++n) {
                const __nv_bfloat16* kp = ks + (n * 8 + g) * QS + kd + 2 * t;
                mma_bf16(s[n], a0, a1, a2, a3, ld32(kp), ld32(kp + 8));
            }
        }

        // scale, mask, online softmax; row half h: rows row0 (h=0), row0+8 (h=1)
        float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < MK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                int key = n * 8 + 2 * t + (e & 1);
                int col = k0 + key, row = row0 + (e >> 1) * 8;
                float x = s[n][e] * scale + bs[key];
                if (causal && col > row) x = NEG_INF;
                if (col >= Tk) x = -INFINITY;
                s[n][e] = x;
                tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            // the 4 lanes of a group (same g) hold one row between them
            tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
            tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
            float m_new = fmaxf(m[h], tmax[h]);  // finite: every tile holds a key < Tk
            alpha[h] = expf(m[h] - m_new);
            m[h] = m_new;
            l[h] *= alpha[h];
        }
#pragma unroll
        for (int n = 0; n < MK / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float p = expf(s[n][e] - m[e >> 1]);
                l[e >> 1] += p;   // this lane's part of the row sum
                if (drop)
                    p = dropout_keep(hr[e >> 1], k0 + n * 8 + 2 * t + (e & 1), thr)
                        ? p * keep_scale : 0.f;
                s[n][e] = p;
            }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
            o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
        }

        // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
        // fragment of k-step kk; V^T in smem gives the B fragments
#pragma unroll
        for (int kk = 0; kk < MK / 16; ++kk) {
            uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                if (n * 8 < D) {
                    const __nv_bfloat16* vp = vt + (n * 8 + g) * VT_STRIDE + kk * 16 + 2 * t;
                    mma_bf16(o[n], a0, a1, a2, a3, ld32(vp), ld32(vp + 8));
                }
            }
        }
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
        for (int n = 0; n < NT; ++n) {
            int col = n * 8 + 2 * t;
            if (col < D)
                *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * D + col) =
                    __floats2bfloat162_rn(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
        }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores (SIMT)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // queries per block, as MQ
constexpr int BK = 32;          // keys per tile
constexpr int SIMT_THREADS = 256;   // 16 x 16 threads
constexpr int QT_STRIDE = BQ + 1;
constexpr int KT_STRIDE = BK + 1;
constexpr int PT_STRIDE = BQ + 1;

// Q^T D*(64+1), K^T D*(32+1), V 32*D, P^T 32*(64+1), bias 32 floats:
// 108 KB at D = 192, two blocks an SM
size_t simt_smem_bytes(int d) {
    return ((size_t)d * QT_STRIDE + (size_t)d * KT_STRIDE + (size_t)BK * d
            + (size_t)BK * PT_STRIDE + BK) * sizeof(float);
}

template <int DMAX, bool TRAIN>
__global__ void __launch_bounds__(SIMT_THREADS)
attn_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ lse, int H,
                     int Tq, int Tk, int D, int causal, float scale, uint32_t key,
                     uint32_t thr, float keep_scale) {
    constexpr int NC = DMAX / 16;   // output columns per thread
    extern __shared__ float smem[];
    float* qt = smem;                         // [D][QT_STRIDE]
    float* kt = qt + D * QT_STRIDE;           // [D][KT_STRIDE]
    float* vs = kt + D * KT_STRIDE;           // [BK][D]
    float* pt = vs + BK * D;                  // [BK][PT_STRIDE]
    float* bs = pt + BK * PT_STRIDE;          // [BK]

    const int tid = threadIdx.x;
    const int ty = tid / 16;                  // rows ty + 16 i
    const int tx = tid % 16;                  // score cols tx + 16 j, out cols tx + 16 c
    const int bh = blockIdx.x;
    const int b = bh / H;
    const int q0 = blockIdx.y * BQ;

    const float* qb = q + ((long long)bh * Tq) * D;
    const float* kb = k + ((long long)bh * Tk) * D;
    const float* vb = v + ((long long)bh * Tk) * D;
    const float* biasb = bias + (long long)b * Tk;

    for (int idx = tid; idx < BQ * D; idx += SIMT_THREADS) {
        int r = idx / D, d = idx % D;
        qt[d * QT_STRIDE + r] = (q0 + r < Tq) ? qb[(long long)(q0 + r) * D + d] : 0.f;
    }

    const bool drop = TRAIN && thr != 0u;
    const uint32_t hb = drop ? dropout_bh_hash(key, bh) : 0u;
    float m[4], l[4], acc[4][NC];
    uint32_t hr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        hr[i] = drop ? dropout_row_hash(hb, q0 + ty + 16 * i) : 0u;
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = 0; k0 < Tk; k0 += BK) {
        __syncthreads();   // previous tile's K/V/P reads are done
        for (int idx = tid; idx < BK * D; idx += SIMT_THREADS) {
            int kk = idx / D, d = idx % D;
            bool in = k0 + kk < Tk;
            long long gi = (long long)(k0 + kk) * D + d;
            kt[d * KT_STRIDE + kk] = in ? kb[gi] : 0.f;
            vs[kk * D + d] = in ? vb[gi] : 0.f;
        }
        if (tid < BK) bs[tid] = (k0 + tid < Tk) ? biasb[k0 + tid] : 0.f;
        __syncthreads();

        float s[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) { s[i][0] = 0.f; s[i][1] = 0.f; }
        for (int d = 0; d < D; ++d) {
            const float* qrow = qt + d * QT_STRIDE + ty;
            const float* krow = kt + d * KT_STRIDE + tx;
            float kv0 = krow[0], kv1 = krow[16];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float qv = qrow[16 * i];
                s[i][0] = fmaf(qv, kv0, s[i][0]);
                s[i][1] = fmaf(qv, kv1, s[i][1]);
            }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            int row = q0 + ty + 16 * i;
            float tmax = -INFINITY;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                int kk = tx + 16 * j;
                int col = k0 + kk;
                float x = s[i][j] * scale + bs[kk];
                if (causal && col > row) x = NEG_INF;
                if (col >= Tk) x = -INFINITY;
                s[i][j] = x;
                tmax = fmaxf(tmax, x);
            }
            // the 16 threads holding one row are lanes tx = 0..15 of a half-warp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
            float m_new = fmaxf(m[i], tmax);   // finite: every tile holds a key < Tk
            float alpha = expf(m[i] - m_new);
            float tsum = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                float p = expf(s[i][j] - m_new);
                tsum += p;
                if (drop)
                    p = dropout_keep(hr[i], k0 + tx + 16 * j, thr) ? p * keep_scale : 0.f;
                pt[(tx + 16 * j) * PT_STRIDE + ty + 16 * i] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
            l[i] = l[i] * alpha + tsum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();   // P tile complete

        for (int kk = 0; kk < BK; ++kk) {
            const float* prow = pt + kk * PT_STRIDE + ty;
            const float* vrow = vs + kk * D + tx;
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = prow[16 * i];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                if (tx + 16 * c < D) {
                    float vv = vrow[16 * c];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
                }
            }
        }
    }

    float* ob = out + ((long long)bh * Tq) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        int row = q0 + ty + 16 * i;
        if (row >= Tq) continue;
        if (TRAIN && tx == 0)
            reinterpret_cast<float2*>(lse)[(long long)bh * Tq + row] =
                make_float2(m[i], logf(l[i]));
        float inv = 1.f / l[i];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            int col = tx + 16 * c;
            if (col < D) ob[(long long)row * D + col] = acc[i][c] * inv;
        }
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, size_t bytes, const void* q, const void* k,
           const void* v, const float* bias, void* out, float* lse, int B, int H,
           int Tq, int Tk, int D, int causal, float scale, uint32_t key,
           uint32_t thr, float keep_scale, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B * H, (Tq + 63) / 64);   // both kernels take 64 queries a block
    kernel<<<grid, threads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        bias, static_cast<T*>(out), lse, H, Tq, Tk, D, causal, scale, key, thr,
        keep_scale);
    return (int)cudaGetLastError();
}

#define ATTN_ARGS q, k, v, bias, out, lse, B, H, Tq, Tk, D, causal, scale, key, thr, \
                  keep_scale, stream
#define ATTN_PARAMS const void* q, const void* k, const void* v, const float* bias, \
                    void* out, float* lse, int B, int H, int Tq, int Tk, int D, \
                    int causal, float scale, uint32_t key, uint32_t thr, \
                    float keep_scale, cudaStream_t stream

template <bool TRAIN>
int launch_bf16(ATTN_PARAMS) {
    using T = __nv_bfloat16;
    size_t bytes = mma_smem_bytes(D);
    if (D <= 64) return launch<T>(attn_fwd_mma_kernel<64, TRAIN>, MMA_THREADS, bytes, ATTN_ARGS);
    if (D <= 128) return launch<T>(attn_fwd_mma_kernel<128, TRAIN>, MMA_THREADS, bytes, ATTN_ARGS);
    if (D <= 192) return launch<T>(attn_fwd_mma_kernel<192, TRAIN>, MMA_THREADS, bytes, ATTN_ARGS);
    return launch<T>(attn_fwd_mma_kernel<256, TRAIN>, MMA_THREADS, bytes, ATTN_ARGS);
}

template <bool TRAIN>
int launch_f32(ATTN_PARAMS) {
    size_t bytes = simt_smem_bytes(D);
    if (D <= 64) return launch<float>(attn_fwd_simt_kernel<64, TRAIN>, SIMT_THREADS, bytes, ATTN_ARGS);
    if (D <= 128) return launch<float>(attn_fwd_simt_kernel<128, TRAIN>, SIMT_THREADS, bytes, ATTN_ARGS);
    if (D <= 192) return launch<float>(attn_fwd_simt_kernel<192, TRAIN>, SIMT_THREADS, bytes, ATTN_ARGS);
    return launch<float>(attn_fwd_simt_kernel<256, TRAIN>, SIMT_THREADS, bytes, ATTN_ARGS);
}

template <bool TRAIN>
int dispatch(int dtype, ATTN_PARAMS) {
    if (B < 1 || H < 1 || Tq < 1 || Tk < 1 || D < 8 || D > 256 || D % 8 != 0)
        return -1;
    if ((Tq + 63) / 64 > 65535) return -1;
    if (dtype == 0) return launch_f32<TRAIN>(ATTN_ARGS);
    if (dtype == 1) return launch_bf16<TRAIN>(ATTN_ARGS);
    return -1;
}

#undef ATTN_ARGS
#undef ATTN_PARAMS

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it; bias is float32).
// Tensors are contiguous and 16-byte aligned: q, out (B, H, Tq, D);
// k, v (B, H, Tk, D); bias (B, Tk). Returns 0, or the cudaError_t of a
// refused launch; -1 for arguments the kernel does not take (the Python
// wrapper checks them first).
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
