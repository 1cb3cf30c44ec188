// Rescore-select: phase 3 and the final top-k of the fused search in one
// kernel, for bf16 rows, int8 codes and f16 bits.
//
// Replaces faiss_tpu/ops/pallas_fused.py _rescore_select_kernel, as launched
// by rescore_select_groups_pallas (fused_search(rescore_select=True),
// k ≤ RESCORE_SELECT_MAX_K = 32). For query q with nominated groups
// gidx[q, 0 … kg), ascending, the candidates are c = j·128 + lane with row
// r = gidx[q, j]·128 + lane; it scores each one as rescore_groups.cu does,
//     s[c] = 2·(q·v_r) − vn[r]  (L2)   or   (q·v_r) − vn[r]  (IP),
// −inf where r ≥ ntotal or where group j repeats group j − 1 (the
// caller's candidate_drop mask: the group select pads with copies of its
// last group when fewer than kg groups score finitely), then extracts
// the k largest as final_select.cu does: descending, ties to the lowest
// candidate column not yet extracted, the column clamped to kg·128 − 1.
// Out: vals[q, i] and ids[q, i] = the row id of the i-th column.
//
// Arithmetic: the score of a row is the same fmaf chain as K10's format in
// rescore_groups.cu (q fp32 in shared memory, the row widened exactly,
// e ascending over d, one rounding per step), and the extraction
// (ft::extract_step, k block-wide steps) picks what K9's one-pass select
// picks: descending, ties to the lowest column not yet extracted, each
// column's own score emitted (ft::QNAN on a row holding a NaN). So the
// result equals rescore_groups → mask → final_select → gather of the row
// ids bit for bit, in values and in ids. Padding and filtered rows score −inf through vn (+inf there).
// The Pallas body carries a running top-k across rank steps and emits id
// 1 << 30 in lanes that find only −inf; here all kg·128 scores sit in
// shared memory at once and a −inf lane takes the lowest column not yet
// extracted, as K9 does, so such a lane carries a real row id: the index
// maps every −inf lane to label −1 either way.
//
// What bounds it on an H100: the gather, as K10 (nq·kg·128·d row elements,
// 46 MB at nq=104, kg=14, d=128 for bf16 and f16, 23 MB for int8), plus k
// block-wide extractions. Design: one block of 512 threads per query; the
// query (d ≤ 2048 fp32, 8 KB) and the kg·128 ≤ 4608 scores (18 KB) sit in
// shared memory; thread t scores candidates t, t + 512, …, reading each
// row as 16-byte vectors. Only nq blocks run (104 at the main shape), so
// fewer rows are in flight than in K10's nq·kg blocks.
#include "common.cuh"

namespace {

constexpr int NT = 512;
constexpr int MAX_D = 2048;       // the gate's largest d_pad for these rows
constexpr int MAX_CAND = 36 * ft::GROUP;   // kg ≤ k + 4 ≤ 36

enum Rows { BF16 = 0, INT8 = 2, F16 = 3 };   // rescore_groups.cu's formats

template <bool L2, int FMT>
__global__ void __launch_bounds__(NT)
rescore_select_kernel(const float* __restrict__ q, const void* __restrict__ db,
                      const float* __restrict__ vn,
                      const int32_t* __restrict__ gidx,
                      float* __restrict__ vals, int32_t* __restrict__ ids,
                      int d, int kg, int ngroups, int ntotal, int k) {
  constexpr int EPC = FMT == INT8 ? 16 : 8;   // elements per 16-byte chunk
  constexpr int ESZ = FMT == INT8 ? 1 : 2;    // bytes per element
  __shared__ __align__(16) float qs[MAX_D];
  __shared__ float s[MAX_CAND];
  __shared__ int32_t g[MAX_CAND / ft::GROUP];
  __shared__ uint32_t excl[MAX_CAND / 32];
  __shared__ float fs[NT / 32];
  __shared__ int is[NT / 32];

  const int qi = blockIdx.x;
  const int ncand = kg * ft::GROUP;
  for (int e = threadIdx.x; e < d; e += NT)
    qs[e] = q[static_cast<size_t>(qi) * d + e];
  for (int j = threadIdx.x; j < kg; j += NT)
    g[j] = min(max(gidx[static_cast<size_t>(qi) * kg + j], 0), ngroups - 1);
  for (int i = threadIdx.x; i < (ncand + 31) / 32; i += NT) excl[i] = 0u;
  __syncthreads();

  for (int c = threadIdx.x; c < ncand; c += NT) {
    const size_t row = static_cast<size_t>(g[c / ft::GROUP]) * ft::GROUP
                       + c % ft::GROUP;
    const uint4* v = reinterpret_cast<const uint4*>(
        static_cast<const char*>(db) + row * d * ESZ);
    float acc = 0.f;
    for (int e = 0; e < d; e += EPC) {
      float x[EPC];
      const uint4 w = __ldg(v + e / EPC);
      if constexpr (FMT == INT8) {
        ft::unpack16_i8(w, x);
      } else if constexpr (FMT == F16) {
        ft::unpack8_f16(w, x);
      } else {
        ft::unpack8(w, x);
      }
#pragma unroll
      for (int i = 0; i < EPC; i += 4) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[e + i]);
        acc = fmaf(a.x, x[i], acc);
        acc = fmaf(a.y, x[i + 1], acc);
        acc = fmaf(a.z, x[i + 2], acc);
        acc = fmaf(a.w, x[i + 3], acc);
      }
    }
    const float sc = (L2 ? 2.f * acc : acc) - vn[row];
    const int j = c / ft::GROUP;
    const bool drop = row >= static_cast<size_t>(ntotal)
                      || (j > 0 && g[j] == g[j - 1]);
    s[c] = drop ? -INFINITY : sc;
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float m;
    int col;
    ft::extract_step<NT>(s, ncand, excl, fs, is, m, col);
    if (threadIdx.x == 0) {
      const int c = min(col, ncand - 1);
      const size_t o = static_cast<size_t>(qi) * k + j;
      // the column's own score (m's bits but on a -0.0 / +0.0 tie), as K9
      vals[o] = col < ncand ? s[col] : __uint_as_float(ft::QNAN);
      ids[o] = g[c / ft::GROUP] * ft::GROUP + c % ft::GROUP;
      if (col < ncand) excl[col >> 5] |= 1u << (col & 31);
    }
    __syncthreads();
  }
}

template <int FMT>
void launch(const float* q, const void* db, const float* vn,
            const int32_t* gidx, float* vals, int32_t* ids, int nq, int d,
            int kg, int ngroups, int ntotal, int k, int l2, cudaStream_t s) {
  if (l2)
    rescore_select_kernel<true, FMT><<<nq, NT, 0, s>>>(
        q, db, vn, gidx, vals, ids, d, kg, ngroups, ntotal, k);
  else
    rescore_select_kernel<false, FMT><<<nq, NT, 0, s>>>(
        q, db, vn, gidx, vals, ids, d, kg, ngroups, ntotal, k);
}

}  // namespace

// q: (nq, d) f32 (q∘s for int8 codes); db: (≥ ngroups·128, d) rows in
// format fmt (0 bf16, 2 int8 codes, 3 f16 bits); vn: (ngroups·128,) f32
// pre-masked norms; gidx: (nq, kg) int32; vals: (nq, k) f32 out; ids:
// (nq, k) int32 out. 16-byte aligned, d % 8 == 0 (d % 16 == 0 for int8),
// d ≤ 2048, 1 ≤ k ≤ kg·128, kg·128 ≤ 4608.
extern "C" int ft_rescore_select(const void* q, const void* db, const void* vn,
                                 const void* gidx, void* vals, void* ids,
                                 int nq, int d, int kg, int ngroups,
                                 int ntotal, int k, int l2, int fmt,
                                 void* stream) {
  const int align = fmt == INT8 ? 16 : 8;
  if (nq <= 0 || kg <= 0 || ngroups <= 0 || d <= 0 || d % align != 0
      || d > MAX_D || kg * ft::GROUP > MAX_CAND || k <= 0
      || k > kg * ft::GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* n = static_cast<const float*>(vn);
  auto* gi = static_cast<const int32_t*>(gidx);
  auto* v = static_cast<float*>(vals);
  auto* o = static_cast<int32_t*>(ids);
  switch (fmt) {
    case BF16: launch<BF16>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2, s); break;
    case INT8: launch<INT8>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2, s); break;
    case F16: launch<F16>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
