// Group-max sweep: phase 1 of the fused search, bf16, f32 and f16 storage.
//
// Replaces four Pallas kernel bodies of faiss_tpu/ops/pallas_fused.py, all
// launched by _sweep_call from groupmax_scores, with their shared _epilogue:
//   bf16 rows v:                _kernel_q1     acc = q1·v
//   f32 rows as bf16 planes     _kernel_split2 acc = q1·dh + q1·dl
//   (v ≈ dh + dl):
//   f16 bits, decoded in-       _kernel_f16_pair  acc = qh·dh + qh·dl + ql·dh
//   register to the exact       _kernel_f16_1     acc = q1·dh + q1·dl
//   pair (v == dh + dl):
// (qh, ql: the bit-mask split of the fp32 query; q1: the query rounded to
// bf16, RNE). The sweeps with two query planes over bf16 rows
// (_kernel_qpair) and over the f32 planes (_kernel_split) run on the
// tensor cores in sweep_split_mma.cu. For every query q and every
// 128-row group g it writes
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
// f16 rows (ft_sweep_f16): each 16-byte chunk holds 8 f16 patterns; each
// decodes to its exact fp32 value f (e=31 → ±inf, common.cuh f16_to_f32)
// and splits into dh = f truncated to bf16 and dl = f − dh (exact, ≤ 3
// bits; 0 where f is ±inf), the pair that faiss_tpu.storage.split_f16_bits
// forms. From there the arithmetic is the f32 pair sweep's, term for term,
// so _sweep_eps(pair_sweep=True) with the f16 split statistics (s1 = 0 on
// finite data: dh + dl == f) holds as derived below. The kernel reads
// 2 bytes per element where the f32 planes take 4.
//
// Arithmetic (what the certificate ops/fused._sweep_eps assumes with its
// default accum="fmaf"): each product term has its own fp32 accumulator,
// summed over d by sequential fmaf (CUDA-core FMA, round to nearest), and
// the terms add once at the end, left to right in the order above (as the
// dot_generals of the Pallas kernels do). bf16×bf16 products are exact in
// fp32, so a term a·b errs ≤ d·u·‖a‖·‖b‖ (u = 2^-24). With ‖qh‖, ‖q1‖ ≤
// Q + R, ‖ql‖ = L, ‖dh‖ ≤ V, ‖dl‖ ≤ s0 the three terms err
// ≤ d·u·[(Q+R)·(V+s0) + L·V] and the two final adds ≤ 2·u·(the same sum),
// which is the (d+2)·u·[(Q+R)·(V+s0) + L·V] that _sweep_eps charges (bf16:
// s0 = 0). One accumulator over the 2·d or 3·d interleaved terms would
// exceed that budget.
//
// What bounds it on an H100: fp32 FMA throughput. At nq=104, 1M×128 one
// product term is 13.3 G FMA (bf16: 1 term against 256 MB of rows; f32:
// 2 terms against 512 MB of planes); the rows are read once from device
// memory and then from L2 by the other query tiles of the same group.
// Design: one block per (group, QT-query tile), blocks of one group
// adjacent in launch order so the group's 32 KB per plane stays in L2; one
// thread per row keeps QT accumulators per term in registers and reads each
// 16-byte row chunk once for all QT queries; the query tile is staged in
// shared memory (fp32, d in chunks of 64) and read as broadcast float4s.
// The 128-row max is a warp shuffle max plus one shared-memory step.
// QT per route: 32 for bf16 (32 accumulators; 77 registers) and for
// _kernel_split2 / _kernel_f16_1 (64 accumulators; 138 / 128 registers);
// 16 for _kernel_f16_pair (48 accumulators; 122 registers).
// nvcc -Xptxas -v for sm_90a reports no spills but 8 bytes for
// _kernel_f16_1. At this shape the f16 rows, with half the bytes and the
// decode, ran 2.87 ms (pair) and 2.05 ms (one plane) against 3.07 and 2.12
// for the f32 planes on this template (CUDA events, NVIDIA H100 80GB HBM3,
// 700.00 W).
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

// Row formats: bf16 rows (one db plane), the f32 rows' bf16 (hi, lo)
// planes, or f16 bits decoded to the (hi, lo) pair in-register.
enum Rows { ROWS = 0, PAIR = 1, F16 = 2 };

// QP query planes (1, 2), DB the row format; NT product terms: QP for one
// db plane, QP + 1 for two (DP = 2: the pair formats).
template <int QP, int DB, int QT, bool L2>
__global__ void __launch_bounds__(ft::GROUP)
sweep_groupmax_kernel(const uint16_t* __restrict__ q_hi,
                      const uint16_t* __restrict__ q_lo,
                      const uint16_t* __restrict__ db,
                      const uint16_t* __restrict__ db_lo,
                      const float* __restrict__ vn,
                      float* __restrict__ gm, float* __restrict__ bmax,
                      int nq, int d, int ngroups, int nqt) {
  constexpr int DP = DB == ROWS ? 1 : 2;
  constexpr int NT = DP == 1 ? QP : QP + 1;
  __shared__ __align__(16) float qs[QP][QT][DT];
  __shared__ float red[ft::GROUP / 32][QT];

  const int g = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * QT;
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v0 = reinterpret_cast<const uint4*>(db + row * d);
  const uint4* v1 =
      DB == PAIR ? reinterpret_cast<const uint4*>(db_lo + row * d) : nullptr;

  float acc[NT][QT];
#pragma unroll
  for (int p = 0; p < NT; ++p)
#pragma unroll
    for (int j = 0; j < QT; ++j) acc[p][j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += DT) {
    const int dn = min(DT, d - d0);
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < QT * DT; i += ft::GROUP) {
      const int j = i / DT, e = i % DT;
      float a = 0.f, b = 0.f;
      if (q0 + j < nq && e < dn) {
        const size_t off = static_cast<size_t>(q0 + j) * d + d0 + e;
        a = ft::bf16_to_f32(q_hi[off]);
        if constexpr (QP == 2) b = ft::bf16_to_f32(q_lo[off]);
      }
      qs[0][j][e] = a;
      if constexpr (QP == 2) qs[QP - 1][j][e] = b;
    }
    __syncthreads();
    for (int e = 0; e < dn; e += 8) {
      float x0[8], x1[8];
      if constexpr (DB == F16) {
        ft::unpack8_f16(__ldg(v0 + (d0 + e) / 8), x0);
#pragma unroll
        for (int i = 0; i < 8; ++i) ft::split_pair(x0[i], x0[i], x1[i]);
      } else {
        ft::unpack8(__ldg(v0 + (d0 + e) / 8), x0);
        if constexpr (DB == PAIR) ft::unpack8(__ldg(v1 + (d0 + e) / 8), x1);
      }
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        // terms in the order of the Pallas kernels: q0·v0, then q0·v1
        // (two db planes) or q1·v0 (one), then q1·v0 (two db planes)
        acc[0][j] = dot8(&qs[0][j][e], x0, acc[0][j]);
        if constexpr (DP == 2)
          acc[1][j] = dot8(&qs[0][j][e], x1, acc[1][j]);
        if constexpr (QP == 2)
          acc[NT - 1][j] = dot8(&qs[QP - 1][j][e], x0, acc[NT - 1][j]);
      }
    }
  }

  const float vr = vn[row];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    float a = acc[0][j];
#pragma unroll
    for (int p = 1; p < NT; ++p) a = a + acc[p][j];
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

template <int QP, int DB, int QT>
void launch(const void* q_hi, const void* q_lo, const void* db,
            const void* db_lo, const void* vn, void* gm, void* bmax, int nq,
            int d, int ngroups, int l2, cudaStream_t stream) {
  const int nqt = (nq + QT - 1) / QT;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(ngroups) * nqt));
  auto* qh = static_cast<const uint16_t*>(q_hi);
  auto* ql = static_cast<const uint16_t*>(q_lo);
  auto* v = static_cast<const uint16_t*>(db);
  auto* vl = static_cast<const uint16_t*>(db_lo);
  auto* n = static_cast<const float*>(vn);
  auto* out = static_cast<float*>(gm);
  auto* bm = static_cast<float*>(bmax);
  if (l2)
    sweep_groupmax_kernel<QP, DB, QT, true><<<grid, ft::GROUP, 0, stream>>>(
        qh, ql, v, vl, n, out, bm, nq, d, ngroups, nqt);
  else
    sweep_groupmax_kernel<QP, DB, QT, false><<<grid, ft::GROUP, 0, stream>>>(
        qh, ql, v, vl, n, out, bm, nq, d, ngroups, nqt);
}

}  // namespace

// q_hi: (nq, d) bf16, the one query plane (two planes, over bf16 rows or
// the f32 planes, go to ft_sweep_split_mma; q_lo is unread); db:
// (≥ ngroups·128, d) bf16 rows, or the hi plane when db_lo is given; db_lo:
// the lo plane, or null for bf16 rows; vn: (ngroups·128,) pre-masked
// norms; gm: (nq, ngroups) f32 out; bmax: null, or the (nq, ngroups/8)
// supergroup maxes, filled with -inf by the caller (ngroups % 8 == 0).
// d % 8 == 0, 16-byte aligned.
extern "C" int ft_sweep_groupmax(const void* q_hi, const void* q_lo,
                                 int planes, const void* db, const void* db_lo,
                                 const void* vn, void* gm, void* bmax, int nq,
                                 int d, int ngroups, int l2, void* stream) {
  if (nq <= 0 || ngroups <= 0 || d <= 0 || d % 8 != 0
      || (bmax != nullptr && ngroups % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (planes == 1 && db_lo == nullptr)
    launch<1, ROWS, 32>(q_hi, q_lo, db, db_lo, vn, gm, bmax, nq, d, ngroups,
                        l2, s);
  else if (planes == 1)
    launch<1, PAIR, 32>(q_hi, q_lo, db, db_lo, vn, gm, bmax, nq, d, ngroups,
                        l2, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// As ft_sweep_groupmax, over f16 rows: db (≥ ngroups·128, d) f16 bit
// patterns, decoded in-register; 3 product terms with two query planes
// (_kernel_f16_pair), 2 with one (_kernel_f16_1).
extern "C" int ft_sweep_f16(const void* q_hi, const void* q_lo, int planes,
                            const void* db, const void* vn, void* gm,
                            void* bmax, int nq, int d, int ngroups, int l2,
                            void* stream) {
  if (nq <= 0 || ngroups <= 0 || d <= 0 || d % 8 != 0
      || (bmax != nullptr && ngroups % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (planes == 1)
    launch<1, F16, 32>(q_hi, q_lo, db, nullptr, vn, gm, bmax, nq, d, ngroups,
                       l2, s);
  else if (planes == 2)
    launch<2, F16, 16>(q_hi, q_lo, db, nullptr, vn, gm, bmax, nq, d, ngroups,
                       l2, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
