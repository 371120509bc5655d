// K5: the fused log-mel frontend for Hopper (sm_90a), float32, in FFT form.
//
// Replaces the Pallas TPU kernel transformertts_tpu/ops/stft_pallas.py::_kernel
// (called through fused_log_mel -> _fused_log_mel, :69-126): framing, the
// windowed one-sided DFT, the magnitude sqrt(re^2 + im^2 + 1e-30), the mel
// projection and log(max(mel, clip_min)), (B, T) centre-padded wav ->
// (B, F, n_mels), F = 1 + (T - n_fft) / hop. n_fft is a power of two from 256
// to 2048.
//
// Its bound on the card: some 7 us at B16 x 262,144 samples. The function
// needs a real FFT a frame (2.5 * n_fft * log2(n_fft) FLOPs) and the sparse
// mel product, about 20 FLOPs for each of the 1 KB of new wav and 320 B of
// log-mel a frame at the published settings (n_fft 1024, hop 256, 80 mels up
// to 8 kHz): the float32 ridge, where bytes and operations come out even.
// The TPU kernel computed the transform as GEMMs against DFT bases, as the
// port's first kernel did (4 * n_fft * 371 FLOPs a frame, some 40 times an
// FFT's). This one does an FFT, so what bounds it is shared memory: each pass
// moves a frame's points through it once.
//
// Design:
// - One block per (clip, 64-frame tile) of 256 threads. The block copies its
//   wav span, (63 * hop + n_fft) floats (68.6 KB at hop 256, 77.5 KB at
//   n_fft 2048 and hop 275), into shared memory once, with the window, the
//   twiddle tables and the split-step twiddles the wrapper builds on the host
//   in float64 and rounds to float32 once. Frames are read out of the span at
//   hop-strided offsets: the frame matrix exists nowhere.
// - The real FFT of N = n_fft points is one complex FFT of M = N / 2 points
//   on z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], the window applied as the
//   frame is loaded. M / 8 threads own a frame, 8 points a thread in
//   registers, and 256 threads transform 2048 / M frames at once.
// - The complex FFT runs the Stockham passes of stockham_fft.cuh (radix 8
//   while 8 divides what is left of M, then one pass of radix 4 or 2),
//   exchanging points through one swizzled shared buffer a frame.
// - The split step gives the bins that carry mel weight, [k_lo, k_hi):
//   X[k] = (Z[k] + Z*[M - k]) / 2 - i exp(-2 pi i k / N) (Z[k] - Z*[M - k]) / 2.
//   Their magnitudes go to shared memory, and each mel folds over its
//   filterbank's nonzero band (each bin lies in at most two Slaney bands):
//   some 2 FLOPs a bin instead of 2 * n_mels. The log goes straight to the
//   unpadded (B, F, n_mels) output; the ragged last tile is masked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "stockham_fft.cuh"

namespace {

using namespace stockham;

constexpr int TILE_F = 64;   // frames a block
constexpr int THREADS = 256;
constexpr int BUF_POINTS = THREADS * PTS;  // the FFT buffer: 2048 / M frames of M points

// Shared memory a block, in bytes: the wav span, the FFT buffer, the window
// pairs, the pass twiddles (M - 1, rounded to M), the split twiddles and the
// magnitudes of the frames transformed at once.
size_t smem_bytes(int m, int hop, int n_bins, int* span_pad) {
    const int span = (TILE_F - 1) * hop + 2 * m;
    *span_pad = (span + 3) / 4 * 4;
    return (size_t)*span_pad * sizeof(float)
        + (size_t)(BUF_POINTS + 2 * m + n_bins) * sizeof(float2)
        + (size_t)(BUF_POINTS / m) * n_bins * sizeof(float);
}

template <int LOG_M>
__global__ void __launch_bounds__(THREADS)
fused_log_mel_kernel(const float* __restrict__ wav, int T, int n_frames, int hop,
                     const float2* __restrict__ window, const float2* __restrict__ fft_tw,
                     const float2* __restrict__ split_tw, int k_lo, int k_hi,
                     const float* __restrict__ fb, const int* __restrict__ bands, int n_mels,
                     float clip_min, float* __restrict__ out, int span_pad) {
    constexpr int M = 1 << LOG_M;        // complex points: n_fft / 2
    constexpr int TPF = M / PTS;         // threads a frame
    constexpr int FPG = THREADS / TPF;   // frames transformed at once
    const int n_bins = k_hi - k_lo;
    extern __shared__ float4 smem4[];
    float* wav_s = reinterpret_cast<float*>(smem4);                  // span_pad
    float2* buf = reinterpret_cast<float2*>(wav_s + span_pad);       // FPG x M
    float2* win_s = buf + BUF_POINTS;                                // M pairs
    float2* tw_s = win_s + M;                                        // M - 1
    float2* split_s = tw_s + M;                                      // n_bins
    float* mag_s = reinterpret_cast<float*>(split_s + n_bins);       // FPG x n_bins

    const int tid = threadIdx.x, b = blockIdx.y;
    const int f0 = blockIdx.x * TILE_F;
    const int span = (TILE_F - 1) * hop + 2 * M;
    const float* row = wav + (size_t)b * T;
    const long long start = (long long)f0 * hop;
    for (int i = tid; i < span_pad; i += THREADS) {
        const long long j = start + i;
        wav_s[i] = (i < span && j < T) ? row[j] : 0.f;
    }
    for (int i = tid; i < M; i += THREADS) win_s[i] = window[i];
    for (int i = tid; i < M - 1; i += THREADS) tw_s[i] = fft_tw[i];
    for (int i = tid; i < n_bins; i += THREADS) split_s[i] = split_tw[i];
    __syncthreads();

    const int g = tid / TPF, t = tid % TPF;  // frame slot, thread in the frame
    float2* fbuf = buf + g * M;
    float* mag = mag_s + g * n_bins;  // bins k_lo on
    const int tile_frames = min(TILE_F, n_frames - f0);
    for (int fg = 0; fg < tile_frames; fg += FPG) {
        const float* x = wav_s + (fg + g) * hop;
        float2 v[PTS];
#pragma unroll
        for (int s = 0; s < PTS; ++s) {
            const int n = t + s * TPF;
            const float2 w = win_s[n];
            v[s] = make_float2(w.x * x[2 * n], w.y * x[2 * n + 1]);
        }
        fft_passes<M, 1>(v, fbuf, tw_s, t);

        // split step: Z[k] and Z*[M - k] (Z[M] = Z[0]) give bin k
        for (int k = k_lo + t; k < k_hi; k += TPF) {
            const float2 a = fbuf[swz(k & (M - 1))];
            const float2 c = fbuf[swz((M - k) & (M - 1))];
            const float2 e = make_float2(0.5f * (a.x + c.x), 0.5f * (a.y - c.y));
            const float2 o = make_float2(0.5f * (a.y + c.y), -0.5f * (a.x - c.x));
            const float2 w = split_s[k - k_lo];
            const float re = e.x + (w.x * o.x - w.y * o.y);
            const float im = e.y + (w.x * o.y + w.y * o.x);
            mag[k - k_lo] = sqrtf(re * re + im * im + 1e-30f);
        }
        __syncthreads();

        const int f = f0 + fg + g;
        if (f < n_frames) {
            float* o = out + ((size_t)b * n_frames + f) * n_mels;
            for (int m = t; m < n_mels; m += TPF) {
                const int lo = __ldg(bands + 2 * m), hi = __ldg(bands + 2 * m + 1);
                const float* w = fb + (size_t)m * (M + 1);
                float acc = 0.f;
                for (int k = lo; k < hi; ++k) acc = fmaf(mag[k - k_lo], __ldg(w + k), acc);
                o[m] = logf(fmaxf(acc, clip_min));
            }
        }
        // the next group's first buffer store and magnitude write come after
        // barriers that every thread reaches only once done here
    }
}

template <int LOG_M>
int launch(const float* wav, int B, int T, int n_frames, int hop, const float* window,
           const float* fft_tw, const float* split_tw, int k_lo, int k_hi, const float* fb,
           const int* bands, int n_mels, float clip_min, float* out, cudaStream_t stream) {
    int span_pad = 0;
    const size_t smem = smem_bytes(1 << LOG_M, hop, k_hi - k_lo, &span_pad);
    cudaError_t err = cudaFuncSetAttribute(fused_log_mel_kernel<LOG_M>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n_frames + TILE_F - 1) / TILE_F, B);
    fused_log_mel_kernel<LOG_M><<<grid, THREADS, smem, stream>>>(
        wav, T, n_frames, hop, reinterpret_cast<const float2*>(window),
        reinterpret_cast<const float2*>(fft_tw), reinterpret_cast<const float2*>(split_tw),
        k_lo, k_hi, fb, bands, n_mels, clip_min, out, span_pad);
    return (int)cudaGetLastError();
}

template <int LOG_M>
int resources(int hop, int n_bins, int* out) {
    int span_pad = 0, blocks = 0;
    const size_t smem = smem_bytes(1 << LOG_M, hop, n_bins, &span_pad);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncSetAttribute(fused_log_mel_kernel<LOG_M>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fused_log_mel_kernel<LOG_M>);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fused_log_mel_kernel<LOG_M>, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    const int values[6] = {attr.numRegs, (int)attr.localSizeBytes, (int)attr.sharedSizeBytes,
                           (int)smem, blocks, THREADS};
    for (int i = 0; i < 6; ++i) out[i] = values[i];
    return 0;
}

}  // namespace

extern "C" {

// wav (B, T) float32; window (n_fft,) the padded window; fft_tw (n_fft/2 - 1,
// 2) the pass twiddles; split_tw (k_hi - k_lo, 2) exp(-2 pi i k / n_fft); fb
// (n_mels, 1 + n_fft/2); bands (n_mels, 2) int32 [lo, hi) of each mel's
// nonzero weights, inside [k_lo, k_hi); out (B, n_frames, n_mels). n_fft is
// 256, 512, 1024 or 2048. Returns the CUDA error: cudaFuncSetAttribute's when
// the block's shared memory, the wav span of 63 * hop + n_fft floats and some
// 20-30 KB of FFT buffer and tables, is over the card's limit.
int fused_log_mel(const float* wav, int B, int T, int n_frames, int hop, int n_fft,
                  const float* window, const float* fft_tw, const float* split_tw, int k_lo,
                  int k_hi, const float* fb, const int* bands, int n_mels, float clip_min,
                  float* out, void* stream) {
    if (n_mels < 1 || k_lo < 0 || k_hi < k_lo || k_hi > n_fft / 2 + 1)
        return (int)cudaErrorInvalidValue;
    auto s = static_cast<cudaStream_t>(stream);
    switch (n_fft) {
        case 256: return launch<7>(wav, B, T, n_frames, hop, window, fft_tw, split_tw, k_lo,
                                   k_hi, fb, bands, n_mels, clip_min, out, s);
        case 512: return launch<8>(wav, B, T, n_frames, hop, window, fft_tw, split_tw, k_lo,
                                   k_hi, fb, bands, n_mels, clip_min, out, s);
        case 1024: return launch<9>(wav, B, T, n_frames, hop, window, fft_tw, split_tw, k_lo,
                                    k_hi, fb, bands, n_mels, clip_min, out, s);
        case 2048: return launch<10>(wav, B, T, n_frames, hop, window, fft_tw, split_tw, k_lo,
                                     k_hi, fb, bands, n_mels, clip_min, out, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// What the kernel of this n_fft uses at this hop and count of bins, as the
// card reports it: out = {registers a thread, local (spill) bytes a thread,
// static and dynamic shared memory a block, blocks an SM, threads a block}.
int fused_log_mel_resources(int n_fft, int hop, int n_bins, int* out) {
    switch (n_fft) {
        case 256: return resources<7>(hop, n_bins, out);
        case 512: return resources<8>(hop, n_bins, out);
        case 1024: return resources<9>(hop, n_bins, out);
        case 2048: return resources<10>(hop, n_bins, out);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
