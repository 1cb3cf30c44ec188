// Helpers shared by the kernels of faiss_tpu_torch: bf16, f16 and int8
// unpacking, NaN-propagating max, warp/block reductions, and the sm_90
// mbarrier and bulk-copy wrappers. Plain C interface only (no PyTorch
// headers), so nvcc builds the library in seconds.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace ft {

constexpr int GROUP = 128;      // rows per candidate group (faiss_tpu GROUP)
constexpr int BIG = 1 << 30;    // "no column" (faiss_tpu's big sentinel)
// The NaN the final selects emit on a row holding a NaN: torch's and
// numpy's float('nan') as fp32 bits, what fused.final_select_plain writes
constexpr uint32_t QNAN = 0x7fc00000u;

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

// An f16 bit pattern (low 16 bits of h) widened to its EXACT fp32 value,
// with every e=31 pattern, NaN included, mapped to ±inf by its sign bit:
// the contract of faiss_tpu.storage.decode_f16_bits (__half2float would
// keep NaN as NaN). Normal values rebias the exponent (15 → 127) in the
// integer domain; zero and subnormals are the mantissa (an integer
// < 1024, exact in fp32) times 2^-24, exact and normal in fp32.
__device__ __forceinline__ float f16_to_f32(uint32_t h) {
  const uint32_t m = h & 0x7FFFu;
  float f = m < 0x400u ? static_cast<float>(m) * 5.9604644775390625e-8f
                       : __uint_as_float((m << 13) + (112u << 23));
  if (m >= 0x7C00u) f = __uint_as_float(0x7F800000u);   // +inf
  return __uint_as_float(__float_as_uint(f) | ((h & 0x8000u) << 16));
}

// The eight f16 of a 16-byte row chunk, decoded to fp32.
__device__ __forceinline__ void unpack8_f16(const uint4 w, float (&x)[8]) {
  x[0] = f16_to_f32(w.x); x[1] = f16_to_f32(w.x >> 16);
  x[2] = f16_to_f32(w.y); x[3] = f16_to_f32(w.y >> 16);
  x[4] = f16_to_f32(w.z); x[5] = f16_to_f32(w.z >> 16);
  x[6] = f16_to_f32(w.w); x[7] = f16_to_f32(w.w >> 16);
}

// The sixteen int8 codes of a 16-byte row chunk, widened to fp32 (exact).
__device__ __forceinline__ void unpack16_i8(const uint4 w, float (&x)[16]) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      x[4 * k + b] = static_cast<float>(
          static_cast<int8_t>((ws[k] >> (8 * b)) & 0xFFu));
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

// max(*addr, v) stored at addr, atomically, for fp32 values: the sweeps'
// supergroup-max output, whose buffer the wrapper fills with -inf. A value
// with the sign bit clear wins by a signed-integer max of the bits, one with
// it set by an unsigned min; both orders agree with the fp32 order on
// non-NaN values, -0.0 and +0.0 included, so the result is the exact max
// in any order of arrival. NaN is not propagated as torch.amax does: a NaN
// with the sign bit clear wins over every value, one with it set loses to
// every value (garbage in; the phase-2 sort keeps its ids in range).
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_uint(v) >> 31)
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  else
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

// One max-extraction step of the rescore-select kernel (K11's extraction in
// _final_select_kernel's order), over the row x[0, n) in shared memory with
// the extracted set in the shared bitmask `excl`:
//   m   = max over xm, where xm = -inf on extracted columns, else x
//   col = the lowest column with xm == m that is not extracted yet (the
//         final select's `& ~excl`); BIG when no column matches (m is NaN).
// Two block reductions per step; each thread walks its columns in
// ascending order, so its first match is its lowest.
template <int NT>
__device__ __forceinline__ void extract_step(
    const float* x, int n, const uint32_t* excl, float* fscratch,
    int* iscratch, float& m_out, int& col_out) {
  float m = -INFINITY;
  for (int c = threadIdx.x; c < n; c += NT)
    m = nan_max(m, bit_set(excl, c) ? -INFINITY : x[c]);
  m = block_max<NT>(m, fscratch);
  int col = BIG;
  for (int c = threadIdx.x; c < n; c += NT) {
    if (!bit_set(excl, c) && x[c] == m) {
      col = c;
      break;
    }
  }
  col_out = block_min<NT>(col, iscratch);
  m_out = m;
}

// -- mbarriers and bulk copies (sm_90) -----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace ft
