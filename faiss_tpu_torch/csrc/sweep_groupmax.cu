// Group-max sweep with one query plane over the f32 rows' bf16 planes, on
// the CUDA cores: phase 1 of the fused search, K4.
//
// Replaces faiss_tpu/ops/pallas_fused.py _kernel_split2 (:204), launched by
// _sweep_call from groupmax_scores, with its share of the _epilogue:
//     acc = q1·dh + q1·dl      (v ≈ dh + dl, the f32 rows' bf16 planes)
// (q1: the query rounded to bf16, RNE). Every other sweep runs on the
// tensor cores in sweep_split_mma.cu. For every query q and every 128-row
// group g it writes
//     gm[q, g] = max over rows r of g of  s(q, r),
//     s = 2·acc − vn[r]  (L2)   or   acc − vn[r]  (IP),
// where vn is the pre-masked norm stream (+inf on rows past ntotal, so
// their score is −inf). The nq×nv score matrix never reaches memory.
//
// Second output (with a non-null bmax; _sweep_call(block_max=True) and the
// shared _epilogue's second out_ref, pallas_fused.py:155-171, :360-370):
//     bmax[q, b] = max over the SUPERGROUP of groups 8b … 8b+7 of gm[q, ·],
// (nq, ngroups/8), written by the same launch. A block owns one group, so
// a supergroup spans 8 blocks: each block folds its group max into bmax
// with common.cuh atomic_max_f32, into a buffer the wrapper fills with
// −inf. A max is exact, so bmax equals the plain amax over the
// (nq, ngroups/8, 8) view of gm bit for bit, whatever the order of the
// atomics; only a NaN group max behaves otherwise (see atomic_max_f32).
// Phase 2 reads it from HIER_MIN_GROUPS groups on (ops/fused.py
// _top_groups_from_bmax); ngroups % 8 == 0 there.
//
// Arithmetic (what the certificate ops/fused._sweep_eps assumes with its
// default accum="fmaf"): each product term has its own fp32 accumulator,
// summed over d by sequential fmaf (CUDA-core FMA, round to nearest), and
// the terms add once at the end, left to right in the order above (as the
// dot_generals of the Pallas kernels do). bf16×bf16 products are exact in
// fp32, so a term a·b errs ≤ d·u·‖a‖·‖b‖ (u = 2^-24). With ‖q1‖ ≤ Q + R,
// ‖dh‖ ≤ V, ‖dl‖ ≤ s0 the terms err ≤ d·u·(Q+R)·(V+s0) and the final add
// ≤ u·(the same sum), within the (d+2)·u·[(Q+R)·(V+s0) + L·V] that
// _sweep_eps charges (one plane: L = 0). One accumulator over the 2·d
// interleaved terms would exceed that budget.
//
// What bounds it on an H100: fp32 FMA throughput. At nq=104, 1M×128 one
// product term is 13.3 G FMA (2 terms against 512 MB of f32 planes); the
// rows are read once from device memory and then from L2 by the other
// query tiles of the same group.
// Design: one block per (group, QT-query tile), blocks of one group
// adjacent in launch order so the group's 32 KB per plane stays in L2; one
// thread per row keeps QT accumulators per term in registers and reads each
// 16-byte row chunk once for all QT queries; the query tile is staged in
// shared memory (fp32, d in chunks of 64) and read as broadcast float4s.
// The 128-row max is a warp shuffle max plus one shared-memory step.
// QT 32: 64 accumulators, 138 registers (nvcc -Xptxas -v for sm_90a, no
// spills).
#include "common.cuh"

namespace {

constexpr int DT = 64;   // d chunk staged in shared memory

__device__ __forceinline__ float dot8(const float* a, const float (&x)[8],
                                      float s) {
  const float4 a0 = *reinterpret_cast<const float4*>(a);
  const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
  s = fmaf(a0.x, x[0], s); s = fmaf(a0.y, x[1], s);
  s = fmaf(a0.z, x[2], s); s = fmaf(a0.w, x[3], s);
  s = fmaf(a1.x, x[4], s); s = fmaf(a1.y, x[5], s);
  s = fmaf(a1.z, x[6], s); s = fmaf(a1.w, x[7], s);
  return s;
}

template <int QT, bool L2>
__global__ void __launch_bounds__(ft::GROUP)
sweep_groupmax_kernel(const uint16_t* __restrict__ q1,
                      const uint16_t* __restrict__ db,
                      const uint16_t* __restrict__ db_lo,
                      const float* __restrict__ vn,
                      float* __restrict__ gm, float* __restrict__ bmax,
                      int nq, int d, int ngroups, int nqt) {
  __shared__ __align__(16) float qs[QT][DT];
  __shared__ float red[ft::GROUP / 32][QT];

  const int g = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * QT;
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v0 = reinterpret_cast<const uint4*>(db + row * d);
  const uint4* v1 = reinterpret_cast<const uint4*>(db_lo + row * d);

  float acc[2][QT];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[p][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += DT) {
    const int dn = min(DT, d - d0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < QT * DT; i += ft::GROUP) {
      const int j = i / DT, e = i % DT;
      qs[j][e] = q0 + j < nq && e < dn
                     ? ft::bf16_to_f32(
                           q1[static_cast<size_t>(q0 + j) * d + d0 + e])
                     : 0.f;
    }
    __syncthreads();
    for (int e = 0; e < dn; e += 8) {
      float x0[8], x1[8];
      ft::unpack8(__ldg(v0 + (d0 + e) / 8), x0);
      ft::unpack8(__ldg(v1 + (d0 + e) / 8), x1);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        // terms in the order of the Pallas kernels: q1·v0, then q1·v1
        acc[0][j] = dot8(&qs[j][e], x0, acc[0][j]);
        acc[1][j] = dot8(&qs[j][e], x1, acc[1][j]);
      }
    }
  }

  const float vr = vn[row];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    const float a = acc[0][j] + acc[1][j];
    const float s = ft::warp_max((L2 ? 2.f * a : a) - vr);
    if (lane == 0) red[w][j] = s;
  }
  __syncthreads();
  const int j = threadIdx.x;
  if (j < QT && q0 + j < nq) {
    float m = red[0][j];
#pragma unroll
    for (int i = 1; i < ft::GROUP / 32; ++i) m = ft::nan_max(m, red[i][j]);
    gm[static_cast<size_t>(q0 + j) * ngroups + g] = m;
    if (bmax != nullptr)
      ft::atomic_max_f32(
          bmax + static_cast<size_t>(q0 + j) * (ngroups / 8) + g / 8, m);
  }
}

template <int QT>
void launch(const void* q1, const void* db, const void* db_lo,
            const void* vn, void* gm, void* bmax, int nq, int d, int ngroups,
            int l2, cudaStream_t stream) {
  const int nqt = (nq + QT - 1) / QT;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(ngroups) * nqt));
  auto* q = static_cast<const uint16_t*>(q1);
  auto* v = static_cast<const uint16_t*>(db);
  auto* vl = static_cast<const uint16_t*>(db_lo);
  auto* n = static_cast<const float*>(vn);
  auto* out = static_cast<float*>(gm);
  auto* bm = static_cast<float*>(bmax);
  if (l2)
    sweep_groupmax_kernel<QT, true><<<grid, ft::GROUP, 0, stream>>>(
        q, v, vl, n, out, bm, nq, d, ngroups, nqt);
  else
    sweep_groupmax_kernel<QT, false><<<grid, ft::GROUP, 0, stream>>>(
        q, v, vl, n, out, bm, nq, d, ngroups, nqt);
}

}  // namespace

// q1: (nq, d) bf16, the one query plane (two planes go to ft_sweep_mma);
// db, db_lo: (≥ ngroups·128, d) the f32 rows' bf16 hi and lo planes; vn:
// (ngroups·128,) pre-masked norms; gm: (nq, ngroups) f32 out; bmax: null,
// or the (nq, ngroups/8) supergroup maxes, filled with -inf by the caller
// (ngroups % 8 == 0). d % 8 == 0, 16-byte aligned. (bf16 rows with one
// query plane: ft_sweep_mma.)
extern "C" int ft_sweep_groupmax(const void* q1, const void* db,
                                 const void* db_lo, const void* vn, void* gm,
                                 void* bmax, int nq, int d, int ngroups,
                                 int l2, void* stream) {
  if (nq <= 0 || ngroups <= 0 || d <= 0 || d % 8 != 0 || db_lo == nullptr
      || (bmax != nullptr && ngroups % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  launch<32>(q1, db, db_lo, vn, gm, bmax, nq, d, ngroups, l2,
             static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
