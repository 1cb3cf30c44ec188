// Final top-k: the last step of the fused bf16 search.
//
// Replaces faiss_tpu/ops/pallas_fused.py _final_select_kernel, as launched
// by final_select_pallas. Per row of the (nq, ncand) rescored candidate
// scores: k max-extractions emitting the values in DESCENDING order with
// their columns, ties to the lowest column. A tie may only go to a column
// not yet extracted (`& ~excl`), so a row of all -inf yields columns
// 0, 1, 2, ... as lax.top_k does. A NaN maximum matches no column: the
// value is NaN and the column clamps to ncand-1, keeping gathers in bounds.
//
// What bounds it on an H100: latency of 2·k block reductions per row over
// ncand floats (1792 at k=10; L1/L2-resident); a few µs in all. Design: the
// extraction core of select_groups.cu (ft::extract_step), one block of 256
// threads per row, the extracted set as a shared-memory bitmask.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_COLS = 16384;   // faiss_tpu SELECT_MAX_GROUPS

__global__ void __launch_bounds__(NT)
final_select_kernel(const float* __restrict__ s, float* __restrict__ vals,
                    int32_t* __restrict__ pos, int ncand, int k) {
  __shared__ uint32_t excl[MAX_COLS / 32];
  __shared__ float fs[NT / 32];
  __shared__ int is[NT / 32];

  const float* x = s + static_cast<size_t>(blockIdx.x) * ncand;
  for (int i = threadIdx.x; i < (ncand + 31) / 32; i += NT) excl[i] = 0u;
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float m;
    int col;
    ft::extract_step<NT, true>(x, ncand, excl, fs, is, m, col);
    if (threadIdx.x == 0) {
      const size_t o = static_cast<size_t>(blockIdx.x) * k + j;
      vals[o] = m;
      pos[o] = min(col, ncand - 1);
      if (col < ncand) excl[col >> 5] |= 1u << (col & 31);
    }
    __syncthreads();
  }
}

}  // namespace

// s: (nq, ncand) f32; vals: (nq, k) f32 out; pos: (nq, k) int32 out.
// 1 ≤ k ≤ ncand ≤ 16384.
extern "C" int ft_final_select(const void* s, void* vals, void* pos, int nq,
                               int ncand, int k, void* stream) {
  if (nq <= 0 || ncand <= 0 || ncand > MAX_COLS || k <= 0 || k > ncand)
    return static_cast<int>(cudaErrorInvalidValue);
  final_select_kernel<<<nq, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<float*>(vals),
      static_cast<int32_t*>(pos), ncand, k);
  return static_cast<int>(cudaGetLastError());
}
