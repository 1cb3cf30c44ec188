// Helpers shared by the four kernels of faiss_tpu_torch: bf16 unpacking,
// NaN-propagating max, and warp/block reductions. Plain C interface only
// (no PyTorch headers), so nvcc builds the library in seconds.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace ft {

constexpr int GROUP = 128;      // rows per candidate group (faiss_tpu GROUP)
constexpr int BIG = 1 << 30;    // "no column" (faiss_tpu's big sentinel)

// Two bf16 values packed in one 32-bit word, element 0 in the low half.
// A bf16 is the high half of an fp32, so widening is a shift: exact.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// The eight bf16 of a 16-byte row chunk, widened to fp32.
__device__ __forceinline__ void unpack8(const uint4 w, float (&x)[8]) {
  x[0] = bf16_lo(w.x); x[1] = bf16_hi(w.x);
  x[2] = bf16_lo(w.y); x[3] = bf16_hi(w.y);
  x[4] = bf16_lo(w.z); x[5] = bf16_hi(w.z);
  x[6] = bf16_lo(w.w); x[7] = bf16_hi(w.w);
}

// max that propagates NaN, like jnp.max and torch.amax (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions over NT threads (NT a multiple of 32, ≤ 1024);
// every thread gets the result. `scratch` holds ≥ NT/32 entries of shared
// memory and is free again when the call returns.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = nan_max(r, scratch[i]);
  __syncthreads();
  return r;
}

template <int NT>
__device__ __forceinline__ int block_min(int v, int* scratch) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = scratch[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = min(r, scratch[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ bool bit_set(const uint32_t* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

// One max-extraction step of the select kernels (faiss_tpu _select_kernel
// and _final_select_kernel), over the row x[0, n) with the extracted set in
// the shared bitmask `excl`:
//   m   = max over xm, where xm = -inf on extracted columns, else x
//   col = the lowest column with xm == m; with SKIP_EXTRACTED it must also
//         not be extracted yet (the final select's `& ~excl`), without it
//         an already-extracted column may win a tie at -inf (the group
//         select's rule). BIG when no column matches (m is NaN).
// Two block reductions per step; each thread walks its columns in
// ascending order, so its first match is its lowest.
template <int NT, bool SKIP_EXTRACTED>
__device__ __forceinline__ void extract_step(
    const float* __restrict__ x, int n, const uint32_t* excl,
    float* fscratch, int* iscratch, float& m_out, int& col_out) {
  float m = -INFINITY;
  for (int c = threadIdx.x; c < n; c += NT)
    m = nan_max(m, bit_set(excl, c) ? -INFINITY : __ldg(x + c));
  m = block_max<NT>(m, fscratch);
  int col = BIG;
  for (int c = threadIdx.x; c < n; c += NT) {
    const bool ex = bit_set(excl, c);
    const float xm = ex ? -INFINITY : __ldg(x + c);
    if (xm == m && !(SKIP_EXTRACTED && ex)) {
      col = c;
      break;
    }
  }
  col_out = block_min<NT>(col, iscratch);
  m_out = m;
}

}  // namespace ft
