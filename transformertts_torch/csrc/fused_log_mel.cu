// K5: the fused log-mel frontend for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel transformertts_tpu/ops/stft_pallas.py::_kernel
// (called through fused_log_mel -> _fused_log_mel, :69-126): framing, the
// windowed one-sided DFT as two GEMMs against cos/-sin bases, the magnitude
// sqrt(re^2 + im^2 + 1e-30), the mel projection and log(max(mel, clip_min)),
// (B, T) centre-padded wav -> (B, F, n_mels), F = 1 + (T - n_fft) / hop.
//
// Its bound on the card: some 7 us at B16 x 262,144 samples. The function
// needs a real FFT a frame (2.5 * n_fft * log2(n_fft) FLOPs) and the sparse
// mel product, about 20 FLOPs for each of the 1 KB of new wav and 320 B of
// log-mel a frame at the published settings (n_fft 1024, hop 256, 80 mels up
// to 8 kHz): the float32 ridge, where bytes and operations come out even.
// This design does not reach it. It computes the DFT as GEMMs over the 371
// bins that carry mel weight, 4 * 1024 * 371 FLOPs a frame, some 40 times
// the FFT's, so its own float32 FMAs bound it (67 TFLOP/s on the SIMT
// cores; the parity bar, atol 2e-4 and rtol 1e-3 on the log, rules out plain
// TF32). An FFT-form kernel is the way to the bound.
//
// Design, and how it differs from the TPU kernel:
// - One block per (clip, 64-frame tile). The block copies its wav span,
//   (63 * hop + n_fft) floats (68.6 KB at hop 256), from the padded wav into
//   shared memory once; frames are read out of it at hop-strided offsets,
//   so the 4x-redundant frame matrix never exists anywhere. The TPU pre-cut
//   overlapping chunks with an XLA gather and padded bins and mels to 128
//   (its lane layout); here the block reads the wav directly, masks the
//   ragged last frame tile, and writes (B, F, n_mels) unpadded.
// - Only the bins that carry mel weight are transformed: the wrapper passes
//   the windowed bases for bins [k_lo, k_lo + 128 * n_tiles) as tiles of
//   128 bins, (tile, n_fft, cos 128 | sin 128), zero past the last needed
//   bin. A bin without mel weight adds exactly 0 to every mel, so the result
//   is the full transform's.
// - Each tile's bases stream through shared memory in chunks of 16 rows,
//   double-buffered with cp.async. A thread owns 8 frames x 4 bins of Re and
//   Im (64 registers); per row it reads its 8 frame samples (one address a
//   warp: broadcasts) and a float4 each of cos and sin.
// - The tile's magnitudes go to shared memory (over the spent basis
//   buffers) and fold into the mel accumulator through the filterbank's
//   nonzero band of each mel (each bin lies in at most two Slaney bands), so
//   the mel product costs some 2 FLOPs a bin instead of 2 * n_mels. A thread
//   owns one frame and every fourth mel, in registers, to the end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_F = 64;     // frames a block
constexpr int TILE_BINS = 128; // bins a basis tile
constexpr int K_CHUNK = 16;    // basis rows staged a step
constexpr int THREADS = 256;
constexpr int FRAMES_PER_WARP = TILE_F / (THREADS / 32);  // 8
constexpr int MAG_ROW = TILE_BINS + 4;  // magnitude tile row, float4-aligned
constexpr int CHUNK_FLOATS = K_CHUNK * 2 * TILE_BINS;     // cos | sin rows
constexpr int STAGE_FLOATS = (2 * CHUNK_FLOATS > TILE_F * MAG_ROW)
                             ? 2 * CHUNK_FLOATS : TILE_F * MAG_ROW;
constexpr int MAX_MELS = 80;
constexpr int MELS_PER_THREAD = MAX_MELS / 4;  // every fourth mel of a frame

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy basis chunk c of a tile (CHUNK_FLOATS contiguous floats) to shared memory.
__device__ __forceinline__ void stage_chunk(float* dst, const float* tile, int c) {
    const float4* src = reinterpret_cast<const float4*>(tile + (size_t)c * CHUNK_FLOATS);
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int r = 0; r < CHUNK_FLOATS / 4 / THREADS; ++r)
        cp_async16(d + threadIdx.x + r * THREADS, src + threadIdx.x + r * THREADS);
    cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 2)
fused_log_mel_kernel(const float* __restrict__ wav, int T, int n_frames, int hop, int n_fft,
                     const float* __restrict__ basis, int n_tiles, int k_lo,
                     const float* __restrict__ fb, int n_bins,
                     const int* __restrict__ bands, int n_mels, float clip_min,
                     float* __restrict__ out, int span_pad) {
    extern __shared__ float4 smem4[];
    float* wav_s = reinterpret_cast<float*>(smem4);  // span_pad floats
    float* stage = wav_s + span_pad;                 // basis chunks, then magnitudes
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * TILE_F;
    const int span = (TILE_F - 1) * hop + n_fft;
    const float* row = wav + (size_t)b * T;
    const long long start = (long long)f0 * hop;
    for (int i = tid; i < span_pad; i += THREADS) {
        const long long j = start + i;
        wav_s[i] = (i < span && j < T) ? row[j] : 0.f;
    }

    const int mf = tid >> 2, mg = tid & 3;  // mel step: frame, mel phase
    float mel[MELS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < MELS_PER_THREAD; ++j) mel[j] = 0.f;

    const int n_chunks = n_fft / K_CHUNK;
    const int fw = warp * FRAMES_PER_WARP;
    for (int t = 0; t < n_tiles; ++t) {
        const float* tile = basis + (size_t)t * n_fft * 2 * TILE_BINS;
        float re[FRAMES_PER_WARP][4], im[FRAMES_PER_WARP][4];
#pragma unroll
        for (int i = 0; i < FRAMES_PER_WARP; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u) re[i][u] = im[i][u] = 0.f;

        __syncthreads();  // the previous tile's magnitudes are read, the wav is in
        stage_chunk(stage, tile, 0);
        for (int c = 0; c < n_chunks; ++c) {
            if (c + 1 < n_chunks) {
                stage_chunk(stage + ((c + 1) & 1) * CHUNK_FLOATS, tile, c + 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const float* buf = stage + (c & 1) * CHUNK_FLOATS;
            const float* x = wav_s + fw * hop + c * K_CHUNK;
#pragma unroll
            for (int kk = 0; kk < K_CHUNK; ++kk) {
                const float4 cs = *reinterpret_cast<const float4*>(
                    buf + kk * 2 * TILE_BINS + lane * 4);
                const float4 sn = *reinterpret_cast<const float4*>(
                    buf + kk * 2 * TILE_BINS + TILE_BINS + lane * 4);
#pragma unroll
                for (int i = 0; i < FRAMES_PER_WARP; ++i) {
                    const float a = x[i * hop + kk];
                    re[i][0] = fmaf(a, cs.x, re[i][0]);
                    re[i][1] = fmaf(a, cs.y, re[i][1]);
                    re[i][2] = fmaf(a, cs.z, re[i][2]);
                    re[i][3] = fmaf(a, cs.w, re[i][3]);
                    im[i][0] = fmaf(a, sn.x, im[i][0]);
                    im[i][1] = fmaf(a, sn.y, im[i][1]);
                    im[i][2] = fmaf(a, sn.z, im[i][2]);
                    im[i][3] = fmaf(a, sn.w, im[i][3]);
                }
            }
            __syncthreads();  // this buffer is refilled two chunks on
        }

        // magnitudes over the spent basis buffers
#pragma unroll
        for (int i = 0; i < FRAMES_PER_WARP; ++i) {
            float4 m;
            m.x = sqrtf(re[i][0] * re[i][0] + im[i][0] * im[i][0] + 1e-30f);
            m.y = sqrtf(re[i][1] * re[i][1] + im[i][1] * im[i][1] + 1e-30f);
            m.z = sqrtf(re[i][2] * re[i][2] + im[i][2] * im[i][2] + 1e-30f);
            m.w = sqrtf(re[i][3] * re[i][3] + im[i][3] * im[i][3] + 1e-30f);
            *reinterpret_cast<float4*>(stage + (fw + i) * MAG_ROW + lane * 4) = m;
        }
        __syncthreads();

        // each mel's nonzero filterbank band, within this tile's bins
        const int k0 = k_lo + t * TILE_BINS;
        const float* mag = stage + mf * MAG_ROW;
#pragma unroll
        for (int j = 0; j < MELS_PER_THREAD; ++j) {
            const int m = mg + 4 * j;
            if (m < n_mels) {
                const int lo = max(__ldg(bands + 2 * m), k0);
                const int hi = min(__ldg(bands + 2 * m + 1), k0 + TILE_BINS);
                const float* w = fb + (size_t)m * n_bins;
                float acc = mel[j];
                for (int k = lo; k < hi; ++k) acc = fmaf(mag[k - k0], __ldg(w + k), acc);
                mel[j] = acc;
            }
        }
    }

    const int f = f0 + mf;
    if (f < n_frames) {
        float* o = out + ((size_t)b * n_frames + f) * n_mels;
#pragma unroll
        for (int j = 0; j < MELS_PER_THREAD; ++j) {
            const int m = mg + 4 * j;
            if (m < n_mels) o[m] = logf(fmaxf(mel[j], clip_min));
        }
    }
}

}  // namespace

extern "C" {

// wav (B, T) float32; basis (n_tiles, n_fft, 2 * 128); fb (n_mels, n_bins);
// bands (n_mels, 2) int32 [lo, hi) of each mel's nonzero weights; out
// (B, n_frames, n_mels). n_fft % 16 == 0, n_mels <= 80. Returns the CUDA
// error: cudaFuncSetAttribute's when the block's shared memory, the wav span
// of 63 * hop + n_fft floats plus the basis stage, is over the card's limit.
int fused_log_mel(const float* wav, int B, int T, int n_frames, int hop, int n_fft,
                  const float* basis, int n_tiles, int k_lo, const float* fb, int n_bins,
                  const int* bands, int n_mels, float clip_min, float* out, void* stream) {
    if (n_mels < 1 || n_mels > MAX_MELS || n_fft % K_CHUNK != 0)
        return (int)cudaErrorInvalidValue;
    const int span = (TILE_F - 1) * hop + n_fft;
    const int span_pad = (span + 3) / 4 * 4;
    const size_t smem = (size_t)(span_pad + STAGE_FLOATS) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(fused_log_mel_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n_frames + TILE_F - 1) / TILE_F, B);
    fused_log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        wav, T, n_frames, hop, n_fft, basis, n_tiles, k_lo, fb, n_bins, bands, n_mels,
        clip_min, out, span_pad);
    return (int)cudaGetLastError();
}

}  // extern "C"
