// Float32 complex FFTs of M points (M a power of two, 16 to 1024) in Stockham
// passes through shared memory, shared by K5 (fused_log_mel.cu) and the
// Griffin-Lim kernel (griffin_lim.cu).
//
// - M / 8 threads own a frame, 8 points a thread in registers: thread t holds
//   points t + s M / 8, s < 8.
// - Passes are radix 8 while 8 divides what is left of M, then one pass of
//   radix 4 or 2 (M 128: 8 8 2; 256: 8 8 4; 512: 8 8 8; 1024: 8 8 8 2). A pass
//   of radix R with stride Ns reads points j + r M / R, multiplies by
//   exp(-2 pi i (j mod Ns) r / (Ns R)) from its table (entry
//   (j mod Ns) (R - 1) + r - 1), does the R-point DFT and writes point r to
//   ((j - j mod Ns) R + j mod Ns + r Ns): the output is in natural order.
// - Passes exchange points through one shared buffer a frame, whose index i
//   is stored at swz(i) = i ^ ((i >> 3) & 15): every load and store of every
//   pass is free of bank conflicts (float2, half-warps).
#pragma once

#include <cuda_runtime.h>

namespace stockham {

constexpr int PTS = 8;  // complex points a thread holds

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// where point i of a frame's buffer is stored
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 15); }

// In-place R-point DFTs of v[0], v[S], ..., v[(R - 1) S], natural order in and out.
template <int S>
__device__ __forceinline__ void dft2(float2* v) {
    const float2 a = v[0], b = v[S];
    v[0] = cadd(a, b);
    v[S] = csub(a, b);
}

template <int S>
__device__ __forceinline__ void dft4(float2* v) {
    const float2 a0 = cadd(v[0], v[2 * S]), a1 = csub(v[0], v[2 * S]);
    const float2 a2 = cadd(v[S], v[3 * S]), a3 = mul_neg_i(csub(v[S], v[3 * S]));
    v[0] = cadd(a0, a2);
    v[2 * S] = csub(a0, a2);
    v[S] = cadd(a1, a3);
    v[3 * S] = csub(a1, a3);
}

__device__ __forceinline__ void dft8(float2* v) {
    constexpr float H = 0.70710678118654752f;  // sqrt(1/2)
    dft4<2>(v);      // the even points' DFT, at v[0], v[2], v[4], v[6]
    dft4<2>(v + 1);  // the odd points', at v[1], v[3], v[5], v[7]
    const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    const float2 o0 = v[1];
    const float2 o1 = make_float2(H * (v[3].x + v[3].y), H * (v[3].y - v[3].x));  // exp(-i pi/4)
    const float2 o2 = mul_neg_i(v[5]);                                            // exp(-i pi/2)
    const float2 o3 = make_float2(H * (v[7].y - v[7].x), -H * (v[7].x + v[7].y)); // exp(-3i pi/4)
    v[0] = cadd(e0, o0); v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1); v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2); v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3); v[7] = csub(e3, o3);
}

// One Stockham pass of radix R and stride NS over an M-point frame. A thread
// holds points t + s M / 8, s < 8: butterfly b < 8 / R takes j = t + b M / 8
// and its points v[b + r (8 / R)]. The first pass takes them from registers.
template <int M, int R, int NS>
__device__ __forceinline__ void fft_pass(float2 (&v)[PTS], float2* buf, const float2* tw,
                                         int t) {
    constexpr int TPF = M / PTS, S = PTS / R;
    if constexpr (NS > 1) {
#pragma unroll
        for (int s = 0; s < PTS; ++s) v[s] = buf[swz(t + s * TPF)];
    }
#pragma unroll
    for (int b = 0; b < S; ++b) {
        if constexpr (NS > 1) {
            const float2* w = tw + ((t + b * TPF) & (NS - 1)) * (R - 1);
#pragma unroll
            for (int r = 1; r < R; ++r) v[b + r * S] = cmul(v[b + r * S], w[r - 1]);
        }
        if constexpr (R == 8) dft8(v + b);
        else if constexpr (R == 4) dft4<S>(v + b);
        else dft2<S>(v + b);
    }
    __syncthreads();  // every point of the previous pass is read
#pragma unroll
    for (int b = 0; b < S; ++b) {
        const int j = t + b * TPF, k = j & (NS - 1);
        const int base = (j - k) * R + k;
#pragma unroll
        for (int r = 0; r < R; ++r) buf[swz(base + r * NS)] = v[b + r * S];
    }
    __syncthreads();
}

// The passes from stride NS on; pass tables start at NS - 1 in ``tw``. The
// transform of the points in ``v`` ends in ``buf``, in natural order, every
// thread past the last barrier.
template <int M, int NS>
__device__ __forceinline__ void fft_passes(float2 (&v)[PTS], float2* buf, const float2* tw,
                                           int t) {
    if constexpr (NS < M) {
        constexpr int R = (M / NS >= 8) ? 8 : M / NS;
        fft_pass<M, R, NS>(v, buf, tw + (NS - 1), t);
        fft_passes<M, NS * R>(v, buf, tw, t);
    }
}

}  // namespace stockham
