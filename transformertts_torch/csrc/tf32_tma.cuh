// Hopper building blocks shared by the float32 attention kernels
// (flash_attention_fwd.cu's attn_fwd_tf32_kernel, flash_attention_bwd.cu's
// attn_dkv_tf32_kernel): mbarriers, TMA loads and the tensor maps that feed
// them, the 128-byte swizzled tile layout, and 3xTF32 products on mma.sync.
//
// 3xTF32: each float32 operand x is split in registers into big = tf32(x)
// and small = tf32(x - big) (cvt.rna's rounding, done with integer
// operations), and each product is big.big + big.small + small.big, summed
// in float32 (small.small, 2^-22 of it, is dropped). One TF32 product keeps
// 10 mantissa bits and misses the float32 bar.
#pragma once
#include <cuda.h>           // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait of
// more than ~2^32 cycles (seconds) traps, so a fault in the ring ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    long long start = 0;
    while (true) {
        uint32_t done;
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        long long now = clock64();
        if (start == 0) start = now;
        else if (now - start > (1LL << 32)) __trap();
    }
}

// TMA: the box at (c0, c1, c2) of `map` into shared memory at dst, counted
// on the barrier bar in bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0,
                                         int c1, int c2, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4}], [%5];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
           "r"(bar)
        : "memory");
}

// ---------------------------------------------------------------------------
// float32 tiles under the 128-byte swizzle, and 3xTF32 on mma.sync m16n8k8
// ---------------------------------------------------------------------------

constexpr int F32_BOX = 32;        // f32 columns of a TMA box: a 128-byte row

// the head-width template that serves head width D
inline int dmax_of(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256; }

// Byte offset of element (r, c) of a tile stored as 32-column boxes of
// `rows` rows under the 128-byte swizzle (TMA's layout): the 16-byte chunk
// of a 128-byte row is XORed with the row's low three bits. The fragment
// loads of the float32 kernels then read 32 distinct banks.
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
    return (uint32_t)((c >> 5) * rows * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4)
                      + ((c & 3) << 2));
}

__device__ __forceinline__ float lds(const unsigned char* tile, uint32_t off) {
    return *reinterpret_cast<const float*>(tile + off);
}

// cvt.rna.tf32.f32 (to nearest, ties away from zero) on the bits of a finite
// float: add half a unit of the 13 dropped bits to the magnitude, clear
// them. Two integer operations, where the cvt instruction is markedly
// slower on this card (each element is split where it is loaded, by every
// warp that reads it).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small with both TF32; x - big is exact in float32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
    big = tf32_rna(x);
    small = tf32_rna(x - __uint_as_float(big));
}

// Layouts (PTX ISA, mma .m16n8k8 .tf32), warp lane = 4 g + t:
//   A a[r]: row g + 8 (r & 1), k t + 4 (r >> 1)
//   B b[r]: k t + 4 r, column g
//   C d[e]: row g + 8 (e >> 1), column 2 t + (e & 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B at float32 accuracy from three TF32 products: the small terms
// first, then big x big; small x small (2^-22 of the product) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
    mma_tf32(d, ab, bs[0], bs[1]);
    mma_tf32(d, as, bb[0], bb[1]);
    mma_tf32(d, ab, bb[0], bb[1]);
}

// ---------------------------------------------------------------------------
// tensor maps, encoded on the host for each call
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPoint), so the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = []() -> EncodeTiled {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
        return reinterpret_cast<EncodeTiled>(p);
    }();
    return fn;
}

// A (B*H, T, D) tensor of bf16 (elem_bytes 2) or float32 (4) as a 3-D map
// (D, T, B*H) of boxes of one 128-byte row (64 or 32 columns) by `rows`
// rows under the 128-byte swizzle, zeros outside the tensor.
bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int T, int D, int rows,
                int elem_bytes) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
    const cuuint64_t strides[2] = {(cuuint64_t)D * elem_bytes,
                                   (cuuint64_t)T * D * elem_bytes};
    const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode(map, elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  3, const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
