// Griffin-Lim for Hopper (sm_90a), float32: one launch a phase iteration,
// the inverse STFT, its overlap-add, the division by the squared-window
// envelope, the STFT of the rebuilt signal and the momentum update, fused.
//
// Replaces no Pallas kernel: the JAX package writes Griffin-Lim
// (transformertts_tpu/audio/griffinlim.py::griffin_lim) as matmuls against
// DFT bases that XLA lowers to the TPU's matrix unit. On the card those
// float32 products ran on the CUDA cores, 2 * n_fft * (n_fft / 2 + 1) FLOPs a
// frame and transform, about 80 times a real FFT's, and were the serving
// path's largest device time. This kernel does the same iteration with real
// FFTs, so what bounds it is memory: a frame slot's magnitude, its phase-times-
// magnitude and its previous rebuild are read and the last two written each
// iteration, about 18.5 KB at n_fft 1024, while its FFTs take some 60 kFLOP.
//
// Semantics (the padded signal domain of the JAX package's fast path, hop
// dividing n_fft, K = n_fft / hop): frame f of the (B, F, n_fft / 2 + 1)
// spectrum X lies at samples [f hop, f hop + n_fft) of a signal of
// n_fft + hop (F - 1) samples. The inverse STFT windows each frame's inverse
// real FFT and adds it in; the signal is divided by the squared-window
// envelope of the frames that exist, floored at 1e-10. The STFT re-frames
// the signal at the same offsets, windowed. Then, m = momentum / (1 +
// momentum): upd = new - m prev, phase = upd / (|upd| + 1e-16), prev = new,
// X = S phase.
//
// Design:
// - One block per (row, tile of T frames), 256 threads; the host picks T
//   (32, or fewer where the grid would leave SMs without a block). It takes
//   the inverse real FFTs of frames f0 - (K - 1) ... f0 + T + K - 2 and
//   overlap-adds them into the signal segment [f0 hop, (f0 + T + K - 1) hop)
//   held in shared memory: the halo of K - 1 frames on each side is
//   recomputed, not exchanged, so the signal never touches device memory,
//   blocks do not depend on each other and no atomics are needed. It divides
//   the segment by the envelope, computed here in float64 from the squared
//   window for the frames that exist, takes the forward real FFTs of its T
//   frames out of the segment and writes X and prev for them. X is
//   double-buffered across launches (neighbours read this launch's input as
//   halo); prev is the block's own.
// - A real FFT of N = n_fft points is one complex FFT of M = N / 2 points
//   (stockham_fft.cuh). Forward: z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], then
//   X[k] = (Z[k] + Z*[M - k]) / 2 - i exp(-2 pi i k / N) (Z[k] - Z*[M - k]) / 2
//   for k = 0 ... M. Inverse: Z[n] = E + i O with E = (X[n] + X*[M - n]) / 2,
//   O = exp(2 pi i n / N) (X[n] - X*[M - n]) / 2, the imaginary parts of X[0]
//   and X[M] dropped as an inverse real DFT drops them; the forward passes
//   run on conj(Z) / M and give conj(z), z[n] = x[2n] + i x[2n+1].
// - The overlap-add adds a position's frames in ascending order, whichever
//   group of frames the block is transforming, so the sum is the same for
//   any tile size; the plain version (ops/griffin_lim.py) does the same
//   float32 operations in the same order. The library is built with
//   -fmad=false (ops/build.py) so that no product and sum fuse into one
//   rounding the plain version does not make.
// - Variants: FROM_S reads X = (S, 0) and prev = 0 (the first iteration, or
//   the final inverse at zero iterations); FINAL takes the inverse of frames
//   f0 - (K - 1) ... f0 + T - 1 alone and writes the centre of the signal,
//   n_fft / 2 ... n_fft / 2 + hop (F - 1), to the (B, hop (F - 1)) wav.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham_fft.cuh"

namespace {

using namespace stockham;

constexpr int THREADS = 256;
constexpr int BUF_POINTS = THREADS * PTS;  // the FFT buffer: 2048 / M frames of M points

// Shared memory a block, in bytes: the signal segment, the FFT buffer, the
// window pairs, the pass twiddles (M - 1, rounded to M) and the split
// twiddles (M + 1).
size_t smem_bytes(int m, int hop, int k_strips, int tile, int* seg_pad) {
    *seg_pad = ((tile + k_strips - 1) * hop + 3) / 4 * 4;
    return (size_t)*seg_pad * sizeof(float) + (size_t)(BUF_POINTS + 3 * m + 1) * sizeof(float2);
}

// at most 80 registers a thread, so that three blocks share an SM where
// their shared memory allows (on an H100 at n_fft 1024 hop 256: 15-26 %
// faster than two blocks at 95 registers, the same bits)
template <int LOG_M, bool FROM_S, bool FINAL>
__global__ void __launch_bounds__(THREADS, 3)
griffin_lim_kernel(const float* __restrict__ S, const float2* __restrict__ x_in,
                   float2* __restrict__ x_out, float2* __restrict__ prev,
                   float* __restrict__ wav, int n_frames, int hop, int k_strips, int tile,
                   int seg_pad, float m, const float2* __restrict__ window,
                   const float2* __restrict__ fft_tw, const float2* __restrict__ split_tw,
                   const double* __restrict__ wsq) {
    constexpr int M = 1 << LOG_M;        // complex points: n_fft / 2
    constexpr int NB = M + 1;            // one-sided bins
    constexpr int TPF = M / PTS;         // threads a frame
    constexpr int FPG = THREADS / TPF;   // frames transformed at once
    constexpr float H = 0.5f / M;        // the inverse's 1/2 and 1/M, exact
    extern __shared__ float4 smem4[];
    float* seg = reinterpret_cast<float*>(smem4);                // seg_pad
    float2* buf = reinterpret_cast<float2*>(seg + seg_pad);      // FPG x M
    float2* win_s = buf + BUF_POINTS;                            // M pairs
    float2* tw_s = win_s + M;                                    // M - 1
    float2* split_s = tw_s + M;                                  // M + 1
    const float* win = reinterpret_cast<const float*>(win_s);    // w[j]

    const int tid = threadIdx.x;
    const size_t row = (size_t)blockIdx.y * n_frames;
    const int f0 = blockIdx.x * tile;
    const int halo = k_strips - 1;
    const int seg_len = (tile + halo) * hop;
    for (int i = tid; i < seg_pad; i += THREADS) seg[i] = 0.f;
    for (int i = tid; i < M; i += THREADS) win_s[i] = window[i];
    for (int i = tid; i < M - 1; i += THREADS) tw_s[i] = fft_tw[i];
    for (int i = tid; i <= M; i += THREADS) split_s[i] = split_tw[i];
    __syncthreads();

    const int g = tid / TPF, t = tid % TPF;  // frame slot, thread in the frame
    float2* fbuf = buf + g * M;

    // inverse: frame i of the block is frame f0 - halo + i of the row, and
    // starts at segment position (i - halo) hop
    const int n_inv = FINAL ? tile + halo : tile + 2 * halo;
    for (int i0 = 0; i0 < n_inv; i0 += FPG) {
        const int fr = f0 - halo + i0 + g;
        float2 v[PTS];
        if (i0 + g < n_inv && fr >= 0 && fr < n_frames) {
            const size_t base = (row + fr) * NB;
#pragma unroll
            for (int s = 0; s < PTS; ++s) {
                const int n = t + s * TPF;
                float2 a, c;
                if constexpr (FROM_S) {
                    a = make_float2(S[base + n], 0.f);
                    c = make_float2(S[base + M - n], 0.f);
                } else {
                    a = x_in[base + n];
                    c = x_in[base + M - n];
                    if (n == 0) a.y = c.y = 0.f;
                }
                const float2 e = make_float2((a.x + c.x) * H, (a.y - c.y) * H);
                const float2 d = make_float2((a.x - c.x) * H, (a.y + c.y) * H);
                const float2 w = split_s[n];
                const float2 o = make_float2(d.x * w.x + d.y * w.y, d.y * w.x - d.x * w.y);
                v[s] = make_float2(e.x - o.y, -(e.y + o.x));  // conj(Z) / M
            }
        } else {
#pragma unroll
            for (int s = 0; s < PTS; ++s) v[s] = make_float2(0.f, 0.f);
        }
        fft_passes<M, 1>(v, fbuf, tw_s, t);  // buf: conj(z) of each frame

        // overlap-add: position p takes frames q ... q + halo (q = p / hop),
        // those of this group here, in ascending order
        const int lo = max(0, (i0 - halo) * hop), hi = min(seg_len, (i0 + FPG) * hop);
        for (int p = lo + tid; p < hi; p += THREADS) {
            const int q = p / hop;
            const int first = max(max(i0, q), halo - f0);
            const int last = min(min(min(i0 + FPG, n_inv) - 1, q + halo), n_frames - 1 - f0 + halo);
            float acc = seg[p];
            for (int i = first; i <= last; ++i) {
                const int j = p - (i - halo) * hop;
                const float2 z = buf[(i - i0) * M + swz(j >> 1)];
                acc = acc + win[j] * ((j & 1) ? -z.y : z.x);
            }
            seg[p] = acc;
        }
        // the next group's first buffer store comes after a barrier in its
        // first pass; its overlap-add after the passes' barriers
    }
    __syncthreads();

    // the squared-window envelope of the frames that exist, in float64 as the
    // host computes it, floored at 1e-10
    for (int p = tid; p < seg_len; p += THREADS) {
        const int q = f0 + p / hop, r = p % hop;
        double env = 0.0;
        for (int d = 0; d <= halo; ++d) {
            const int fr = q - halo + d;
            if (fr >= 0 && fr < n_frames) env += wsq[(halo - d) * hop + r];
        }
        seg[p] = seg[p] / fmaxf((float)env, 1e-10f);
    }
    __syncthreads();

    if constexpr (FINAL) {
        // this tile's positions, and the signal's tail for the last tile
        const int end = (f0 + tile >= n_frames) ? seg_len : tile * hop;
        const long long start = (long long)f0 * hop;
        const long long len = (long long)(n_frames - 1) * hop;  // the wav: [M, M + len)
        for (int p = tid; p < end; p += THREADS) {
            const long long pos = start + p;
            if (pos >= M && pos < M + len) wav[blockIdx.y * len + pos - M] = seg[p];
        }
        return;
    }

    // forward: the block's frames out of the segment, then the update
    const int n_fwd = min(tile, n_frames - f0);
    for (int i0 = 0; i0 < n_fwd; i0 += FPG) {
        const int i = i0 + g;
        float2 v[PTS];
        if (i < n_fwd) {
            const float* x = seg + i * hop;
#pragma unroll
            for (int s = 0; s < PTS; ++s) {
                const int n = t + s * TPF;
                const float2 w = win_s[n];
                v[s] = make_float2(w.x * x[2 * n], w.y * x[2 * n + 1]);
            }
        } else {
#pragma unroll
            for (int s = 0; s < PTS; ++s) v[s] = make_float2(0.f, 0.f);
        }
        fft_passes<M, 1>(v, fbuf, tw_s, t);

        if (i < n_fwd) {
            const size_t base = (row + f0 + i) * NB;
            for (int k = t; k <= M; k += TPF) {
                // split step: Z[k] and Z*[M - k] (Z[M] = Z[0]) give bin k
                const float2 a = fbuf[swz(k & (M - 1))];
                const float2 c = fbuf[swz((M - k) & (M - 1))];
                const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
                const float2 o = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
                const float2 w = split_s[k];
                const float re = e.x + (w.x * o.x - w.y * o.y);
                const float im = e.y + (w.x * o.y + w.y * o.x);
                const float2 pv = FROM_S ? make_float2(0.f, 0.f) : prev[base + k];
                const float ur = re - m * pv.x, ui = im - m * pv.y;
                const float mag = sqrtf(ur * ur + ui * ui) + 1e-16f;
                const float s = S[base + k];
                x_out[base + k] = make_float2(s * (ur / mag), s * (ui / mag));
                prev[base + k] = make_float2(re, im);
            }
        }
        // the next group's first buffer store comes after a barrier in its
        // first pass, which every thread reaches only once done here
    }
}

template <int LOG_M, bool FROM_S, bool FINAL>
int launch(const float* S, const float* x_in, float* x_out, float* prev, float* wav, int B,
           int n_frames, int hop, int tile, float m, const float* window, const float* fft_tw,
           const float* split_tw, const double* wsq, cudaStream_t stream) {
    const int k_strips = (2 << LOG_M) / hop;
    int seg_pad = 0;
    const size_t smem = smem_bytes(1 << LOG_M, hop, k_strips, tile, &seg_pad);
    auto kernel = griffin_lim_kernel<LOG_M, FROM_S, FINAL>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n_frames + tile - 1) / tile, B);
    kernel<<<grid, THREADS, smem, stream>>>(
        S, reinterpret_cast<const float2*>(x_in), reinterpret_cast<float2*>(x_out),
        reinterpret_cast<float2*>(prev), wav, n_frames, hop, k_strips, tile, seg_pad, m,
        reinterpret_cast<const float2*>(window), reinterpret_cast<const float2*>(fft_tw),
        reinterpret_cast<const float2*>(split_tw), wsq);
    return (int)cudaGetLastError();
}

template <int LOG_M>
int launch_mode(int mode, const float* S, const float* x_in, float* x_out, float* prev,
                float* wav, int B, int n_frames, int hop, int tile, float m,
                const float* window, const float* fft_tw, const float* split_tw,
                const double* wsq, cudaStream_t s) {
    switch (mode) {
        case 0: return launch<LOG_M, true, false>(S, x_in, x_out, prev, wav, B, n_frames, hop,
                                                  tile, m, window, fft_tw, split_tw, wsq, s);
        case 1: return launch<LOG_M, false, false>(S, x_in, x_out, prev, wav, B, n_frames, hop,
                                                   tile, m, window, fft_tw, split_tw, wsq, s);
        case 2: return launch<LOG_M, false, true>(S, x_in, x_out, prev, wav, B, n_frames, hop,
                                                  tile, m, window, fft_tw, split_tw, wsq, s);
        case 3: return launch<LOG_M, true, true>(S, x_in, x_out, prev, wav, B, n_frames, hop,
                                                 tile, m, window, fft_tw, split_tw, wsq, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int LOG_M>
int resources(int hop, int tile, int* out) {
    const int k_strips = (2 << LOG_M) / hop;
    int seg_pad = 0, blocks = 0;
    const size_t smem = smem_bytes(1 << LOG_M, hop, k_strips, tile, &seg_pad);
    auto kernel = griffin_lim_kernel<LOG_M, false, false>;
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    const int values[6] = {attr.numRegs, (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                           (int)smem, blocks, THREADS};
    for (int i = 0; i < 6; ++i) out[i] = values[i];
    return 0;
}

}  // namespace

extern "C" {

// One Griffin-Lim launch over B rows of n_frames frames. S (B, n_frames,
// n_fft/2 + 1) float32 magnitudes; x_in, x_out (B, n_frames, n_fft/2 + 1, 2)
// S times the phase, read and written (distinct buffers); prev the same shape,
// the last rebuild, read and written in place; wav (B, hop (n_frames - 1)).
// mode 0: the first iteration (X = S, prev = 0; x_in unread); 1: an
// iteration; 2: the final inverse into wav; 3: the final inverse of X = S.
// window (n_fft,) the padded window; fft_tw (n_fft/2 - 1, 2) the pass
// twiddles; split_tw (n_fft/2 + 1, 2) exp(-2 pi i k / n_fft); wsq (n_fft,)
// float64 the squared window. n_fft is 256, 512, 1024 or 2048 and hop divides
// it; tile frames a block. Returns the CUDA error: cudaFuncSetAttribute's
// when the block's shared memory, (tile + n_fft / hop - 1) hop floats of
// signal and 16-40 KB of FFT buffer and tables, is over the card's limit.
int griffin_lim_iteration(int mode, const float* S, const float* x_in, float* x_out,
                          float* prev, float* wav, int B, int n_frames, int n_fft, int hop,
                          int tile, float m, const float* window, const float* fft_tw,
                          const float* split_tw, const double* wsq, void* stream) {
    if (B < 1 || n_frames < 1 || tile < 1 || hop < 1 || hop > n_fft || n_fft % hop != 0)
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    switch (n_fft) {
        case 256: return launch_mode<7>(mode, S, x_in, x_out, prev, wav, B, n_frames, hop, tile,
                                        m, window, fft_tw, split_tw, wsq, s);
        case 512: return launch_mode<8>(mode, S, x_in, x_out, prev, wav, B, n_frames, hop, tile,
                                        m, window, fft_tw, split_tw, wsq, s);
        case 1024: return launch_mode<9>(mode, S, x_in, x_out, prev, wav, B, n_frames, hop,
                                         tile, m, window, fft_tw, split_tw, wsq, s);
        case 2048: return launch_mode<10>(mode, S, x_in, x_out, prev, wav, B, n_frames, hop,
                                          tile, m, window, fft_tw, split_tw, wsq, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// What an iteration's kernel of this n_fft uses at this hop and tile, as the
// card reports it: out = {registers a thread, local (spill) bytes a thread,
// static and dynamic shared memory a block, blocks an SM, threads a block}.
int griffin_lim_resources(int n_fft, int hop, int tile, int* out) {
    if (hop < 1 || hop > n_fft || n_fft % hop != 0 || tile < 1)
        return (int)cudaErrorInvalidValue;
    switch (n_fft) {
        case 256: return resources<7>(hop, tile, out);
        case 512: return resources<8>(hop, tile, out);
        case 1024: return resources<9>(hop, tile, out);
        case 2048: return resources<10>(hop, tile, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
