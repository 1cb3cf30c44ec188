// Helpers shared by the kernels of faiss_tpu_torch: bf16, f16 and int8
// unpacking, NaN-propagating max, a warp max, and the sm_90
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

// The eight f16 bit patterns of a 16-byte row chunk decoded to their EXACT
// fp32 values, with every e=31 pattern, NaN included, mapped to ±inf by its
// sign bit: the contract of faiss_tpu.storage.decode_f16_bits (cvt alone
// would keep NaN as NaN). An e=31 pattern loses its mantissa first (±inf);
// then cvt.f32.f16, exact on every pattern, subnormals included (the
// decode of sweep_split_mma.cu's split_f16x2).
__device__ __forceinline__ void unpack8_f16(const uint4 w, float (&x)[8]) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t e31 = __vcmpeq2(ws[k] & 0x7C007C00u, 0x7C007C00u);
    const uint32_t v = ws[k] & ~(e31 & 0x03FF03FFu);
    asm("{\n .reg .b16 l, h;\n mov.b32 {l, h}, %2;\n"
        " cvt.f32.f16 %0, l;\n cvt.f32.f16 %1, h;\n}\n"
        : "=f"(x[2 * k]), "=f"(x[2 * k + 1]) : "r"(v));
  }
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
