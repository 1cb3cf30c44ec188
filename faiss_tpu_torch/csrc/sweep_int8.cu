// Group-max sweep over int8 rows: phase 1 of the fused search, int8 storage.
//
// Replaces faiss_tpu/ops/pallas_fused.py _kernel_int8 (launched by
// _sweep_call from groupmax_scores' int8 branch) with its _epilogue. The
// query qs = q∘s (s the per-dimension scales) arrives as its residual
// expansion qs ≈ β₁·q₁ + β₂·q₂ (ops/fused.int8_query_pair: q₁, q₂ int8,
// β₁, β₂ f32 per query). For every query q and 128-row group g it writes
//     gm[q, g] = max over rows r of g of  s(q, r),
//     a_i = q_i·v_r  (int8 × int8, summed in int32: EXACT, since
//                     |a_i| ≤ 127²·d < 2³¹ for every d the gate admits)
//     dot = fl(fl(β₁·f32(a₁)) + fl(β₂·f32(a₂)))
//     s   = 2·dot − vn[r]  (L2)   or   dot − vn[r]  (IP),
// with vn the pre-masked stream of the stored decoded norms (+inf past
// ntotal), as in sweep_groupmax.cu, and, with a non-null bmax, the
// supergroup maxes bmax[q, b] = max of gm[q, 8b … 8b+7] (the _epilogue's
// second output), folded in with common.cuh atomic_max_f32 exactly as
// sweep_groupmax.cu does.
//
// Arithmetic (what ops/fused._sweep_eps_int8 charges). The dots are exact;
// the combine is written with __fmul_rn / __fadd_rn so that nvcc cannot
// contract it into an FMA: three roundings, each ≤ u·|operand| (u = 2^-24),
// the 3·u·(Qs + 2·R1 + Rs)·Vq of term (2), since ‖β₁q₁‖ ≤ Qs + R1,
// ‖β₂q₂‖ ≤ R1 + Rs and |a_i| ≤ ‖q_i‖·Vq. The conversions f32(a_i) are exact
// while |a_i| ≤ 2²⁴, i.e. while 127²·d < 2²⁴ (d ≤ 1040). Past that each
// rounds too: ≤ u·|a_i|, times β_i ≤ u·‖β_i q_i‖·Vq, together
// ≤ u·(Qs + 2·R1 + Rs)·Vq, which _sweep_eps_int8 adds when
// 127²·d_pad ≥ 2²⁴ (the JAX bound assumes exact conversions and misses
// it). The plain version (ops/fused.sweep_int8_plain) makes the same three
// roundings in the same order, so the two agree bit for bit.
//
// What bounds it on an H100: integer dot products. At nq=104, 1M×128 the
// two passes are 26.6 G int8 MACs against 128 MB of codes. __dp4a does 4
// MACs per instruction on the CUDA cores (integer tensor-core MMA would
// be exact too, and faster: a later PR's work). Design, as
// sweep_groupmax.cu: one block per (group, QT-query tile), blocks of one
// group adjacent in launch order so the group's 16 KB of codes stays in
// L2; one thread per row, reading 16 codes per 16-byte load and keeping
// two int32 accumulators per query; the tile's q₁ and q₂ are staged in
// shared memory as packed 32-bit words (d in chunks of 256) and read as
// broadcast 16-byte vectors. The 128-row max is a warp shuffle max plus
// one shared-memory step. nvcc -Xptxas -v for sm_90a: 128 registers, 8
// bytes spilled; at this shape it ran 0.83 ms, against 2.72 ms for the bf16
// two-plane sweep's same MAC count (CUDA events, NVIDIA H100 80GB HBM3,
// 700.00 W).
#include "common.cuh"

namespace {

constexpr int DT = 256;   // d chunk (codes) staged in shared memory
constexpr int QT = 32;    // queries per block

template <bool L2>
__global__ void __launch_bounds__(ft::GROUP)
sweep_int8_kernel(const int8_t* __restrict__ q1, const int8_t* __restrict__ q2,
                  const int8_t* __restrict__ db, const float* __restrict__ vn,
                  const float* __restrict__ beta, float* __restrict__ gm,
                  float* __restrict__ bmax, int nq, int d, int ngroups,
                  int nqt) {
  __shared__ __align__(16) int qs[2][QT][DT / 4];
  __shared__ float red[ft::GROUP / 32][QT];

  const int g = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * QT;
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v = reinterpret_cast<const uint4*>(db + row * d);

  int a1[QT], a2[QT];
#pragma unroll
  for (int j = 0; j < QT; ++j) a1[j] = a2[j] = 0;

  for (int d0 = 0; d0 < d; d0 += DT) {
    const int dn = min(DT, d - d0);   // a multiple of 16
    __syncthreads();  // previous chunk fully consumed
    for (int i = threadIdx.x; i < QT * (DT / 4); i += ft::GROUP) {
      const int j = i / (DT / 4), e = i % (DT / 4);
      int w1 = 0, w2 = 0;
      if (q0 + j < nq && 4 * e < dn) {
        const size_t off = static_cast<size_t>(q0 + j) * d + d0 + 4 * e;
        w1 = *reinterpret_cast<const int*>(q1 + off);
        w2 = *reinterpret_cast<const int*>(q2 + off);
      }
      qs[0][j][e] = w1;
      qs[1][j][e] = w2;
    }
    __syncthreads();
    for (int e = 0; e < dn; e += 16) {
      const uint4 w = __ldg(v + (d0 + e) / 16);
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        const int4 x = *reinterpret_cast<const int4*>(&qs[0][j][e / 4]);
        const int4 y = *reinterpret_cast<const int4*>(&qs[1][j][e / 4]);
        a1[j] = __dp4a(static_cast<int>(w.x), x.x, a1[j]);
        a1[j] = __dp4a(static_cast<int>(w.y), x.y, a1[j]);
        a1[j] = __dp4a(static_cast<int>(w.z), x.z, a1[j]);
        a1[j] = __dp4a(static_cast<int>(w.w), x.w, a1[j]);
        a2[j] = __dp4a(static_cast<int>(w.x), y.x, a2[j]);
        a2[j] = __dp4a(static_cast<int>(w.y), y.y, a2[j]);
        a2[j] = __dp4a(static_cast<int>(w.z), y.z, a2[j]);
        a2[j] = __dp4a(static_cast<int>(w.w), y.w, a2[j]);
      }
    }
  }

  const float vr = vn[row];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    float b1 = 0.f, b2 = 0.f;
    if (q0 + j < nq) {
      b1 = beta[2 * (q0 + j)];
      b2 = beta[2 * (q0 + j) + 1];
    }
    // the Pallas kernel's f32(a₁)·β₁ + f32(a₂)·β₂, three roundings
    const float dot = __fadd_rn(__fmul_rn(__int2float_rn(a1[j]), b1),
                                __fmul_rn(__int2float_rn(a2[j]), b2));
    const float s = ft::warp_max((L2 ? 2.f * dot : dot) - vr);
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

}  // namespace

// q1, q2: (nq, d) int8 query planes; db: (≥ ngroups·128, d) int8 codes;
// vn: (ngroups·128,) pre-masked norms; beta: (nq, 2) f32 (β₁, β₂);
// gm: (nq, ngroups) f32 out; bmax: null, or the (nq, ngroups/8)
// supergroup maxes, filled with -inf by the caller (ngroups % 8 == 0).
// d % 16 == 0, 16-byte aligned.
extern "C" int ft_sweep_int8(const void* q1, const void* q2, const void* db,
                             const void* vn, const void* beta, void* gm,
                             void* bmax, int nq, int d, int ngroups, int l2,
                             void* stream) {
  if (nq <= 0 || ngroups <= 0 || d <= 0 || d % 16 != 0
      || (bmax != nullptr && ngroups % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nqt = (nq + QT - 1) / QT;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(ngroups) * nqt));
  auto s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<const int8_t*>(q1);
  auto* b = static_cast<const int8_t*>(q2);
  auto* v = static_cast<const int8_t*>(db);
  auto* n = static_cast<const float*>(vn);
  auto* be = static_cast<const float*>(beta);
  auto* out = static_cast<float*>(gm);
  auto* bm = static_cast<float*>(bmax);
  if (l2)
    sweep_int8_kernel<true><<<grid, ft::GROUP, 0, s>>>(
        a, b, v, n, be, out, bm, nq, d, ngroups, nqt);
  else
    sweep_int8_kernel<false><<<grid, ft::GROUP, 0, s>>>(
        a, b, v, n, be, out, bm, nq, d, ngroups, nqt);
  return static_cast<int>(cudaGetLastError());
}
