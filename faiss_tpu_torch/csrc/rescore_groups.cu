// Gather-rescore: phase 3 of the fused search (stage 3a for f32 storage).
//
// Replaces faiss_tpu/ops/pallas_fused.py _rescore_kernel (with
// _rescore_dots), as launched by rescore_groups_pallas, in all five of its
// modes, one row format each:
//   BF16  bf16 rows (db2=None)
//   PAIR  the f32 pair mode, db2 = the lo plane (body :1074-1076)
//   INT8  int8 codes (_rescore_dots :1045-1047, fused route :1720-1731),
//         scored against qs = q∘s (the caller passes qs)
//   F16   f16 bit patterns (the int16 mode, _rescore_dots :1035-1039)
//   F32   f32 rows (_rescore_dots :1040-1044), the IVF fine scan
//         (faiss_tpu/ivf.py :397-426): gidx holds pool chunk ids, one
//         128-row chunk per group, ngroups = the pool's chunk capacity
// For query q and its j-th nominated group g = gidx[q, j] it writes, for
// the 128 rows r of g,
//     out[q, j·128 + (r − 128·g)] = 2·(q·v_r) − vn[r]  (L2)
//                                   or (q·v_r) − vn[r]  (IP)
// with the same pre-masked vn as the sweep (−inf past ntotal), where v_r is
// the bf16 row, hi_r + lo_r, the int8 codes, or the decoded f16 row.
//
// Arithmetic: q stays fp32 and each row element widens EXACTLY to fp32
// (bf16 and int8 by conversion, f16 by common.cuh f16_to_f32, e=31 → ±inf);
// the dot is a sequential fmaf chain over d (one rounding per step, round
// to nearest), so it errs ≤ d·u·‖q‖·‖v‖. BF16 / F16: the certificate
// (ops/fused._sweep_eps) charges the rescore 2·d·u·Q·V, which covers it;
// an f16 row scores as the JAX kernel scores its exact (hi, lo) pair, and
// a ±inf element as hi = ±inf, lo = 0 would. INT8: the chain over qs and
// the codes errs ≤ d·u·Qs·Vq, inside _sweep_eps_int8's 2·d·u·Qs·Vq; both
// sides subtract the same stored decoded norm. The JAX kernel splits q
// three ways only because the MXU multiplies bf16. PAIR: ONE chain over
// hi_r + lo_r, formed in fp32 per element. That sum is exact (hi is the
// truncation of the f32 master x, lo the RNE rounding of the exact
// remainder x − hi to 8 bits; both lie on the grid of x's last bit, and
// |hi + lo| ≤ 2^(e+1) for x's exponent e), so the chain is fp32-true
// against the stored pair and errs ≤ d·u·Q·‖hi + lo‖ ≤ d·u·Q·(V + s1),
// inside the (d+6)·u·Q·(V + s0 + s1) that _pair_rescore_eps charges the
// pair rescore (Q = ‖q‖, V ≥ max‖v‖, s0 ≥ max‖lo‖, s1 ≥ max‖v − hi − lo‖).
// F32: ONE chain over the stored fp32 row, erring ≤ d·u·Q·V, where the JAX
// kernel splits q and v three ways into bf16 and sums nine exact-product
// passes; both are fp32-true to the stored row within d·u·Q·V, so two rows
// that score within that bound may order differently in the two packages.
// The IVF gather routes carry no certificate, so no ε changes.
//
// What bounds it on an H100: the gather, nq·kg·128·d elements of rows read
// by id in 256-byte runs (d=128: 46 MB at nq=104, kg=14 for bf16 and f16,
// 93 MB for the pair, 23 MB for int8; for F32 the IVF fine scan's
// nq·nbudget·128·d·4 bytes, 436 MB at nq=104, nbudget=64). Design: one
// block of 128 threads per (query, rank); thread r owns row r of the group
// and reads it as 16-byte vectors (8 elements, 16 int8 codes or 4 fp32, per
// plane and step); q is
// staged in shared memory (fp32, d in chunks of 1024, 4 KB) and read as a
// broadcast. A group id past the end is clamped into range, so a bad id
// cannot read out of bounds.
#include "common.cuh"

namespace {

constexpr int DT = 1024;   // d chunk of the query staged in shared memory

enum Rows { BF16 = 0, PAIR = 1, INT8 = 2, F16 = 3, F32 = 4 };

template <bool L2, int FMT>
__global__ void __launch_bounds__(ft::GROUP)
rescore_groups_kernel(const float* __restrict__ q,
                      const void* __restrict__ db,
                      const uint16_t* __restrict__ db2,
                      const float* __restrict__ vn,
                      const int32_t* __restrict__ gidx,
                      float* __restrict__ out, int d, int kg, int ngroups) {
  // elements per 16-byte chunk, bytes per element
  constexpr int EPC = FMT == INT8 ? 16 : FMT == F32 ? 4 : 8;
  constexpr int ESZ = FMT == INT8 ? 1 : FMT == F32 ? 4 : 2;
  __shared__ __align__(16) float qs[DT];

  const int qi = blockIdx.x / kg, j = blockIdx.x % kg;
  const int g = min(max(gidx[static_cast<size_t>(qi) * kg + j], 0), ngroups - 1);
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v = reinterpret_cast<const uint4*>(
      static_cast<const char*>(db) + row * d * ESZ);
  const uint4* v2 =
      FMT == PAIR ? reinterpret_cast<const uint4*>(db2 + row * d) : nullptr;
  const float* qrow = q + static_cast<size_t>(qi) * d;

  float acc = 0.f;
  for (int d0 = 0; d0 < d; d0 += DT) {
    const int dn = min(DT, d - d0);
    __syncthreads();
    for (int e = threadIdx.x; e < dn; e += ft::GROUP) qs[e] = qrow[d0 + e];
    __syncthreads();
    for (int e = 0; e < dn; e += EPC) {
      float x[EPC];
      const uint4 w = __ldg(v + (d0 + e) / EPC);
      if constexpr (FMT == INT8) {
        ft::unpack16_i8(w, x);
      } else if constexpr (FMT == F32) {
        x[0] = __uint_as_float(w.x);
        x[1] = __uint_as_float(w.y);
        x[2] = __uint_as_float(w.z);
        x[3] = __uint_as_float(w.w);
      } else if constexpr (FMT == F16) {
        ft::unpack8_f16(w, x);
      } else {
        ft::unpack8(w, x);
        if constexpr (FMT == PAIR) {
          float y[8];
          ft::unpack8(__ldg(v2 + (d0 + e) / 8), y);
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] += y[i];   // exact: hi + lo
        }
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
  }
  out[static_cast<size_t>(blockIdx.x) * ft::GROUP + threadIdx.x] =
      (L2 ? 2.f * acc : acc) - vn[row];
}

template <int FMT>
void launch(const float* q, const void* db, const uint16_t* db2,
            const float* vn, const int32_t* gidx, float* out, int nq, int d,
            int kg, int ngroups, int l2, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(nq) * kg));
  if (l2)
    rescore_groups_kernel<true, FMT><<<grid, ft::GROUP, 0, s>>>(
        q, db, db2, vn, gidx, out, d, kg, ngroups);
  else
    rescore_groups_kernel<false, FMT><<<grid, ft::GROUP, 0, s>>>(
        q, db, db2, vn, gidx, out, d, kg, ngroups);
}

}  // namespace

// q: (nq, d) f32; db: (≥ ngroups·128, d) rows in format fmt (0 bf16 rows,
// 1 the bf16 hi plane with db2 = the lo plane, 2 int8 codes, 3 f16 bits,
// 4 f32 rows); db2: the lo plane (fmt 1) or null; vn: (ngroups·128,) f32;
// gidx: (nq, kg) int32; out: (nq, kg·128) f32. 16-byte aligned, and
// d % 8 == 0 (d % 16 == 0 for int8, d % 4 == 0 for f32).
extern "C" int ft_rescore_groups(const void* q, const void* db, const void* db2,
                                 const void* vn, const void* gidx, void* out,
                                 int nq, int d, int kg, int ngroups, int l2,
                                 int fmt, void* stream) {
  const int align = fmt == INT8 ? 16 : fmt == F32 ? 4 : 8;
  if (nq <= 0 || kg <= 0 || ngroups <= 0 || d <= 0 || d % align != 0
      || (fmt == PAIR) != (db2 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* v2 = static_cast<const uint16_t*>(db2);
  auto* n = static_cast<const float*>(vn);
  auto* gi = static_cast<const int32_t*>(gidx);
  auto* o = static_cast<float*>(out);
  switch (fmt) {
    case BF16: launch<BF16>(qq, db, v2, n, gi, o, nq, d, kg, ngroups, l2, s); break;
    case PAIR: launch<PAIR>(qq, db, v2, n, gi, o, nq, d, kg, ngroups, l2, s); break;
    case INT8: launch<INT8>(qq, db, v2, n, gi, o, nq, d, kg, ngroups, l2, s); break;
    case F16: launch<F16>(qq, db, v2, n, gi, o, nq, d, kg, ngroups, l2, s); break;
    case F32: launch<F32>(qq, db, v2, n, gi, o, nq, d, kg, ngroups, l2, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
