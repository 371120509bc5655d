// Counter-based dropout mask shared by the attention kernels.
//
// keep(i, j) for row i, column j of the (Tq, Tk) weights of batch*head bh is
//
//     hb = fmix32(key + bh * 0x9E3779B9)
//     hr = fmix32(hb + i * 0x85EBCA77)
//     keep = fmix32(hr + j * 0x27D4EB2F) >= thr
//
// in uint32 arithmetic, where fmix32 is MurmurHash3's finalizer, key mixes the
// call's (seed, offset) on the host and thr = floor(rate * 2^32). The mask is
// a pure function of its coordinates, so the backward kernels regenerate the
// forward's mask instead of storing it. ops/flash_attention.py computes the
// same function in int64 torch ops (dropout_keep_mask) for the plain versions.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

__device__ __forceinline__ uint32_t dropout_bh_hash(uint32_t key, int bh) {
    return fmix32(key + (uint32_t)bh * 0x9E3779B9u);
}

__device__ __forceinline__ uint32_t dropout_row_hash(uint32_t hb, int row) {
    return fmix32(hb + (uint32_t)row * 0x85EBCA77u);
}

__device__ __forceinline__ bool dropout_keep(uint32_t hr, int col, uint32_t thr) {
    return fmix32(hr + (uint32_t)col * 0x27D4EB2Fu) >= thr;
}
