// Gather-rescore: phase 3 of the fused bf16 search.
//
// Replaces faiss_tpu/ops/pallas_fused.py _rescore_kernel (bf16 rows, with
// _rescore_dots), as launched by rescore_groups_pallas. For query q and its
// j-th nominated group g = gidx[q, j] it writes, for the 128 rows r of g,
//     out[q, j·128 + (r − 128·g)] = 2·(q·v_r) − vn[r]  (L2)
//                                   or (q·v_r) − vn[r]  (IP)
// with the same pre-masked vn as the sweep (−inf past ntotal).
//
// Arithmetic: q stays fp32 and each row widens exactly from bf16; the dot
// is a sequential fmaf chain over d (one rounding per step, round to
// nearest), so it errs ≤ d·u·‖q‖·‖v‖. The certificate (ops/fused._sweep_eps)
// charges the rescore 2·d·u·‖q‖·‖v‖, which covers it. The JAX kernel splits
// q three ways only because the MXU multiplies bf16.
//
// What bounds it on an H100: the gather, nq·kg·32 KB at d=128 (46 MB at
// nq=104, kg=14), of rows read by id in 256-byte runs. Design: one block of
// 128 threads per (query, rank); thread r owns row r of the group and reads
// it as 16-byte vectors; q is staged in shared memory (fp32, d in chunks of
// 1024, 4 KB) and read as a broadcast. A group id past the end is clamped
// into range, so a bad id cannot read out of bounds.
#include "common.cuh"

namespace {

constexpr int DT = 1024;   // d chunk of the query staged in shared memory

template <bool L2>
__global__ void __launch_bounds__(ft::GROUP)
rescore_groups_kernel(const float* __restrict__ q,
                      const uint16_t* __restrict__ db,
                      const float* __restrict__ vn,
                      const int32_t* __restrict__ gidx,
                      float* __restrict__ out, int d, int kg, int ngroups) {
  __shared__ __align__(16) float qs[DT];

  const int qi = blockIdx.x / kg, j = blockIdx.x % kg;
  const int g = min(max(gidx[static_cast<size_t>(qi) * kg + j], 0), ngroups - 1);
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v = reinterpret_cast<const uint4*>(db + row * d);
  const float* qrow = q + static_cast<size_t>(qi) * d;

  float acc = 0.f;
  for (int d0 = 0; d0 < d; d0 += DT) {
    const int dn = min(DT, d - d0);
    __syncthreads();
    for (int e = threadIdx.x; e < dn; e += ft::GROUP) qs[e] = qrow[d0 + e];
    __syncthreads();
    for (int e = 0; e < dn; e += 8) {
      float x[8];
      ft::unpack8(__ldg(v + (d0 + e) / 8), x);
      const float4 a0 = *reinterpret_cast<const float4*>(&qs[e]);
      const float4 a1 = *reinterpret_cast<const float4*>(&qs[e + 4]);
      acc = fmaf(a0.x, x[0], acc); acc = fmaf(a0.y, x[1], acc);
      acc = fmaf(a0.z, x[2], acc); acc = fmaf(a0.w, x[3], acc);
      acc = fmaf(a1.x, x[4], acc); acc = fmaf(a1.y, x[5], acc);
      acc = fmaf(a1.z, x[6], acc); acc = fmaf(a1.w, x[7], acc);
    }
  }
  out[static_cast<size_t>(blockIdx.x) * ft::GROUP + threadIdx.x] =
      (L2 ? 2.f * acc : acc) - vn[row];
}

}  // namespace

// q: (nq, d) f32; db: (≥ ngroups·128, d) bf16; vn: (ngroups·128,) f32;
// gidx: (nq, kg) int32; out: (nq, kg·128) f32. d % 8 == 0, 16-byte aligned.
extern "C" int ft_rescore_groups(const void* q, const void* db, const void* vn,
                                 const void* gidx, void* out, int nq, int d,
                                 int kg, int ngroups, int l2, void* stream) {
  if (nq <= 0 || kg <= 0 || ngroups <= 0 || d <= 0 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(nq) * kg));
  auto s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* v = static_cast<const uint16_t*>(db);
  auto* n = static_cast<const float*>(vn);
  auto* gi = static_cast<const int32_t*>(gidx);
  auto* o = static_cast<float*>(out);
  if (l2)
    rescore_groups_kernel<true><<<grid, ft::GROUP, 0, s>>>(qq, v, n, gi, o, d,
                                                           kg, ngroups);
  else
    rescore_groups_kernel<false><<<grid, ft::GROUP, 0, s>>>(qq, v, n, gi, o, d,
                                                            kg, ngroups);
  return static_cast<int>(cudaGetLastError());
}
