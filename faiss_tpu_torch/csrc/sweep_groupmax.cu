// Group-max sweep: phase 1 of the fused bf16 search.
//
// Replaces faiss_tpu/ops/pallas_fused.py _kernel_qpair (2 query planes) and
// _kernel_q1 (1 plane), with their shared _epilogue, as launched by
// _sweep_call from groupmax_scores. For every query q and every 128-row
// group g of the database it writes
//     gm[q, g] = max over rows r of g of  s(q, r),
//     s = 2·acc − vn[r]  (L2)   or   acc − vn[r]  (IP),
//     acc = Σ_p (q_p · v_r)     over the bf16 query planes p,
// where vn is the pre-masked norm stream (+inf on rows past ntotal, so
// their score is −inf). The nq×nv score matrix never reaches memory.
//
// Arithmetic (what the certificate ops/fused._sweep_eps assumes): each
// plane has its own fp32 accumulator, summed over d by sequential fmaf
// (CUDA-core FMA, round to nearest). bf16×bf16 products are exact in fp32,
// so a plane errs ≤ d·u·‖q_p‖·‖v‖; the planes add once at the end, as the
// two dot_generals of _kernel_qpair do. One accumulator over 2·d
// interleaved terms would exceed the (d+2)·u budget. No tensor cores: their
// fp32 accumulation is not proven round-to-nearest.
//
// What bounds it on an H100: fp32 FMA throughput. At nq=104, 1M×128 one plane
// is 13.3 G FMA against 256 MB of rows; the rows are read once from device
// memory and then from L2 by the other query tiles of the same group.
// Design: one block per (group, 32-query tile), blocks of one group
// adjacent in launch order so the group's 32 KB stays in L2; one thread per
// row keeps 32 (or 64) accumulators in registers and reads each 16-byte row
// chunk once for all 32 queries; the query tile is staged in shared memory
// (fp32, d in chunks of 64, ≤ 16 KB) and read as broadcast float4s. The
// 128-row max is a warp shuffle max plus one shared-memory step.
#include "common.cuh"

namespace {

constexpr int QT = 32;   // queries per block
constexpr int DT = 64;   // d chunk staged in shared memory

template <int PLANES, bool L2>
__global__ void __launch_bounds__(ft::GROUP)
sweep_groupmax_kernel(const uint16_t* __restrict__ q_hi,
                      const uint16_t* __restrict__ q_lo,
                      const uint16_t* __restrict__ db,
                      const float* __restrict__ vn,
                      float* __restrict__ gm,
                      int nq, int d, int ngroups, int nqt) {
  __shared__ __align__(16) float qs[PLANES][QT][DT];
  __shared__ float red[ft::GROUP / 32][QT];

  const int g = blockIdx.x / nqt;
  const int q0 = (blockIdx.x % nqt) * QT;
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v = reinterpret_cast<const uint4*>(db + row * d);

  float acc[PLANES][QT];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
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
        if (PLANES == 2) b = ft::bf16_to_f32(q_lo[off]);
      }
      qs[0][j][e] = a;
      if (PLANES == 2) qs[PLANES - 1][j][e] = b;
    }
    __syncthreads();
    for (int e = 0; e < dn; e += 8) {
      float x[8];
      ft::unpack8(__ldg(v + (d0 + e) / 8), x);
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
#pragma unroll
        for (int j = 0; j < QT; ++j) {
          const float4 a0 = *reinterpret_cast<const float4*>(&qs[p][j][e]);
          const float4 a1 = *reinterpret_cast<const float4*>(&qs[p][j][e + 4]);
          float s = acc[p][j];
          s = fmaf(a0.x, x[0], s); s = fmaf(a0.y, x[1], s);
          s = fmaf(a0.z, x[2], s); s = fmaf(a0.w, x[3], s);
          s = fmaf(a1.x, x[4], s); s = fmaf(a1.y, x[5], s);
          s = fmaf(a1.z, x[6], s); s = fmaf(a1.w, x[7], s);
          acc[p][j] = s;
        }
      }
    }
  }

  const float vr = vn[row];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < QT; ++j) {
    float a = acc[0][j];
    if (PLANES == 2) a = a + acc[PLANES - 1][j];
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
  }
}

template <int PLANES>
void launch(const void* q_hi, const void* q_lo, const void* db,
            const void* vn, void* gm, int nq, int d, int ngroups, int l2,
            cudaStream_t stream) {
  const int nqt = (nq + QT - 1) / QT;
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(ngroups) * nqt));
  auto* qh = static_cast<const uint16_t*>(q_hi);
  auto* ql = static_cast<const uint16_t*>(q_lo);
  auto* v = static_cast<const uint16_t*>(db);
  auto* n = static_cast<const float*>(vn);
  auto* out = static_cast<float*>(gm);
  if (l2)
    sweep_groupmax_kernel<PLANES, true><<<grid, ft::GROUP, 0, stream>>>(
        qh, ql, v, n, out, nq, d, ngroups, nqt);
  else
    sweep_groupmax_kernel<PLANES, false><<<grid, ft::GROUP, 0, stream>>>(
        qh, ql, v, n, out, nq, d, ngroups, nqt);
}

}  // namespace

// q_hi, q_lo: (nq, d) bf16 query planes (q_lo unread when planes == 1);
// db: (≥ ngroups·128, d) bf16 rows; vn: (ngroups·128,) pre-masked norms;
// gm: (nq, ngroups) f32 out. d % 8 == 0, 16-byte aligned pointers.
extern "C" int ft_sweep_groupmax(const void* q_hi, const void* q_lo,
                                 int planes, const void* db, const void* vn,
                                 void* gm, int nq, int d, int ngroups, int l2,
                                 void* stream) {
  if (nq <= 0 || ngroups <= 0 || d <= 0 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (planes == 1)
    launch<1>(q_hi, q_lo, db, vn, gm, nq, d, ngroups, l2, s);
  else if (planes == 2)
    launch<2>(q_hi, q_lo, db, vn, gm, nq, d, ngroups, l2, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
