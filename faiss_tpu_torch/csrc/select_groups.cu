// Group nomination: phase 2 of the fused bf16 search.
//
// Replaces faiss_tpu/ops/pallas_fused.py _select_kernel, as launched by
// select_groups_pallas. Per query row of the (nq, ngroups) group-max array:
//   1. kg max-extractions, ties to the lowest column, marking the
//      nominated set (an all -inf remainder may re-pick an already marked
//      column, exactly as the Pallas kernel does, leaving fewer than kg);
//   2. t = max over the non-nominated columns (-inf if every column is
//      nominated): the certificate threshold;
//   3. the nominated columns re-enumerated in ASCENDING order; slots past
//      the nominated count hold ngroups-1, so every id stays in bounds
//      even on NaN input (the rescore gathers by these ids).
//
// What bounds it on an H100: latency of 2·kg block reductions per row over
// ≤ 16384 floats (64 KB, L2-resident after the first pass); the work is a
// few µs. Design: one block of 256 threads per query row; the nominated set
// is a bitmask in shared memory (≤ 2 KB); each extraction is a block max
// followed by a block min of the matching column (ft::extract_step).
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_COLS = 16384;   // faiss_tpu SELECT_MAX_GROUPS

__global__ void __launch_bounds__(NT)
select_groups_kernel(const float* __restrict__ gm, int32_t* __restrict__ gidx,
                     float* __restrict__ t, int ngroups, int kg) {
  __shared__ uint32_t excl[MAX_COLS / 32];
  __shared__ float fs[NT / 32];
  __shared__ int is[NT / 32];

  const float* x = gm + static_cast<size_t>(blockIdx.x) * ngroups;
  const int nw = (ngroups + 31) / 32;
  for (int i = threadIdx.x; i < nw; i += NT) excl[i] = 0u;
  __syncthreads();

  for (int it = 0; it < kg; ++it) {
    float m;
    int col;
    ft::extract_step<NT, false>(x, ngroups, excl, fs, is, m, col);
    if (threadIdx.x == 0 && col < ngroups) excl[col >> 5] |= 1u << (col & 31);
    __syncthreads();
  }

  float tv = -INFINITY;
  for (int c = threadIdx.x; c < ngroups; c += NT)
    if (!ft::bit_set(excl, c)) tv = ft::nan_max(tv, __ldg(x + c));
  tv = ft::block_max<NT>(tv, fs);

  if (threadIdx.x == 0) {
    t[blockIdx.x] = tv;
    int32_t* out = gidx + static_cast<size_t>(blockIdx.x) * kg;
    int j = 0;
    for (int w = 0; w < nw && j < kg; ++w) {
      uint32_t bits = excl[w];
      while (bits != 0u && j < kg) {
        out[j++] = w * 32 + __ffs(static_cast<int>(bits)) - 1;
        bits &= bits - 1u;
      }
    }
    for (; j < kg; ++j) out[j] = ngroups - 1;
  }
}

}  // namespace

// gm: (nq, ngroups) f32; gidx: (nq, kg) int32 out; t: (nq,) f32 out.
// 1 ≤ kg ≤ ngroups ≤ 16384.
extern "C" int ft_select_groups(const void* gm, void* gidx, void* t, int nq,
                                int ngroups, int kg, void* stream) {
  if (nq <= 0 || ngroups <= 0 || ngroups > MAX_COLS || kg <= 0 ||
      kg > ngroups)
    return static_cast<int>(cudaErrorInvalidValue);
  select_groups_kernel<<<nq, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gm), static_cast<int32_t*>(gidx),
      static_cast<float*>(t), ngroups, kg);
  return static_cast<int>(cudaGetLastError());
}
