// Tensor maps and TMA tile loads (sm_90), shared by the tensor-core sweeps
// (sweep_split_mma.cu) and the pair rescore (rescore_groups.cu). The
// descriptors come from cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point, so the library needs no -lcuda.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)

#include "common.cuh"

namespace ft {

constexpr int TMA_ROW_BYTES = 128;   // a tile row: one 128-byte swizzle span

// One 2-D tile of a tensor map into shared memory; completion is counted
// in bytes on `bar`. c0: the element along d, c1: the row.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(c0),
         "r"(c1)
      : "memory");
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// A (rows, d) row-major plane of `type` (2 or 1 bytes an element) as a
// tensor map of one 128-byte row × box_rows tiles, 128-byte swizzled (in a
// tile at a 1024-byte aligned address, 16-byte unit u of row r lies at
// r·128 + 16·(u ^ (r % 8))); out-of-bounds elements read as zero.
inline bool plane_map(EncodeTiled enc, CUtensorMap* map,
                      CUtensorMapDataType type, const void* base, int d,
                      int rows, int box_rows) {
  const int ew = type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * ew};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(TMA_ROW_BYTES / ew),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ft
