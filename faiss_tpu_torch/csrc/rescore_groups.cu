// Gather-rescore: phase 3 of the fused search (stage 3a for f32 storage).
//
// Replaces faiss_tpu/ops/pallas_fused.py _rescore_kernel (with
// _rescore_dots), as launched by rescore_groups_pallas, in all five of its
// modes, one row format each:
//   BF16  bf16 rows (db2=None)
//   PAIR  the f32 pair mode, db2 = the lo plane (body :1074-1076),
//         streamed (rescore_stream_kernel, below)
//   INT8  int8 codes (_rescore_dots :1045-1047, fused route :1720-1731),
//         scored against qs = q∘s (the caller passes qs)
//   F16   f16 bit patterns (the int16 mode, _rescore_dots :1035-1039),
//         streamed as the pair is (rescore_stream_kernel, below)
//   F32   f32 rows (_rescore_dots :1040-1044), the IVF fine scan
//         (faiss_tpu/ivf.py :397-426): gidx holds pool chunk ids, one
//         128-row chunk per group, ngroups = the pool's chunk capacity,
//         in a kernel of its own (rescore_f32_kernel, below)
// For query q and its j-th nominated group g = gidx[q, j] it writes, for
// the 128 rows r of g,
//     out[q, j·128 + (r − 128·g)] = 2·(q·v_r) − vn[r]  (L2)
//                                   or (q·v_r) − vn[r]  (IP)
// with the same pre-masked vn as the sweep (−inf past ntotal), where v_r is
// the bf16 row, hi_r + lo_r, the int8 codes, or the decoded f16 row.
//
// Arithmetic: q stays fp32 and each row element widens EXACTLY to fp32
// (bf16 and int8 by conversion, f16 by common.cuh unpack8_f16, e=31 →
// ±inf);
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
// F32: ONE chain over the stored fp32 row in index order, erring ≤
// d·u·Q·V, where the JAX kernel splits q and v three ways into bf16 and
// sums nine exact-product passes; both are fp32-true to the stored row
// within d·u·Q·V, so two rows that score within that bound may order
// differently in the two packages. The IVF gather routes carry no
// certificate, so no ε changes.
//
// What bounds it on an H100: the gather, nq·kg·128·d elements of rows read
// by id in 256-byte runs (d=128: 46 MB at nq=104, kg=14 for bf16 and f16,
// 93 MB for the pair, 23 MB for int8). Design (BF16, INT8, the
// thread-per-row kernel, rescore_groups_kernel): one block of 128 threads
// per (query, rank); thread r owns row r of the group and reads it as
// 16-byte vectors (8 elements or 16 int8 codes a step); q is staged in
// shared memory (fp32, d in chunks of 1024, 4 KB) and read as a broadcast.
// A group id past the end is clamped into range, so a bad id cannot read
// out of bounds.
//
// PAIR (stage 3a of every f32 search) and F16 (phase 3 of every f16
// search) stream (rescore_stream_kernel, on rescore_stream.cuh): the
// thread-per-row design read a row per thread, 16 bytes a step from rows
// 2·d bytes apart, so each warp load touched 32 lines, with little in
// flight (on an H100 at the main paths' shape 0.0978 ms for the pair, 3.8×
// its bytes bound, and 0.0289 ms for f16, 2.2×; PERF.md). Here persistent
// blocks (the SMs times the blocks an SM holds) walk the nq·kg positions
// in order, a contiguous run each, so q is staged once a query for its kg
// groups. In each plane a group's rows are one contiguous run (128·d·2
// bytes); one producer warp brings each (position, 64-element d slice) in
// by TMA, a 16 KB tile of 128 rows × 128 bytes a plane (two for the pair,
// the f16 bits as one plane of 16-bit elements), 128-byte swizzled, into a
// ring of stream_stages<FMT>() stages on full / empty mbarriers, ahead of
// the products. Four consumer warps score: thread r reads row r's 16-byte
// unit u at r·128 + 16·(u ^ r % 8), so the 8 rows of a quarter-warp's
// reads lie in 8 different bank groups, widens it (hi + lo, or the f16
// decode, on the consumer's ALUs) and keeps one fmaf chain over d in index
// order, slice after slice: the thread-per-row kernel's arithmetic, so its
// scores bit for bit. Each position writes its 128 contiguous scores.
// scripts/k10_variants.py --mode pair and --mode f16 time it against the
// thread-per-row kernel (legacy), ring depths, no swizzle, and for the
// pair a grouping pass that reads each distinct group once (PERF.md has
// the numbers).
//
// F32, the IVF fine scan, is chunk-major: nq·nbudget positions (6,656 at
// nq 104, nbudget 64) name about a quarter as many distinct chunks (each
// probed list's chunks come once per query that probes it, and every dead
// budget position names chunk 0), so the rows of each distinct chunk, 64 KB
// at d = 128, are read once a launch where a block per position read them
// once per query (436 MB in place of 107 MB). A grouping pass on the card
// (ids clamped as above; three small kernels over the positions, atomics
// and no scan, no host sync) lists the distinct chunks, places each
// chunk's positions together and cuts them into pieces of ≤ F32_CAP (16)
// positions, so the long run of chunk 0 does not serialize the launch; then
// persistent blocks walk the pieces (rescore_f32_kernel): a piece's 128
// rows stream through shared memory by cp.async.bulk, a row at a time, in
// d slices of 128 (padded to an odd number of 16-byte units a row: a
// row-major f32 tile read a row a thread would put a warp on one bank),
// and thread r scores row r against each query of the piece with one
// sequential fmaf chain over d in index order, as the thread-per-row
// kernel did: the same bits. Each (query, rank) writes its 128 contiguous
// scores once.
#include "rescore_stream.cuh"

namespace {

using ft::clamp_group;
using ft::BF16;
using ft::PAIR;
using ft::INT8;
using ft::F16;
using ft::F32;

constexpr int DT = 1024;   // d chunk of the query staged in shared memory

// BF16 and INT8: a block per (query, rank), thread r row r.
template <bool L2, int FMT>
__global__ void __launch_bounds__(ft::GROUP)
rescore_groups_kernel(const float* __restrict__ q,
                      const void* __restrict__ db,
                      const float* __restrict__ vn,
                      const int32_t* __restrict__ gidx,
                      float* __restrict__ out, int d, int kg, int ngroups) {
  // elements per 16-byte chunk, bytes per element
  constexpr int EPC = FMT == INT8 ? 16 : 8;
  constexpr int ESZ = FMT == INT8 ? 1 : 2;
  __shared__ __align__(16) float qs[DT];

  const int qi = blockIdx.x / kg, j = blockIdx.x % kg;
  const int g = clamp_group(gidx[static_cast<size_t>(qi) * kg + j], ngroups);
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v = reinterpret_cast<const uint4*>(
      static_cast<const char*>(db) + row * d * ESZ);
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
  }
  out[static_cast<size_t>(blockIdx.x) * ft::GROUP + threadIdx.x] =
      (L2 ? 2.f * acc : acc) - vn[row];
}

template <int FMT>
void launch(const float* q, const void* db, const float* vn,
            const int32_t* gidx, float* out, int nq, int d, int kg,
            int ngroups, int l2, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(static_cast<long long>(nq) * kg));
  if (l2)
    rescore_groups_kernel<true, FMT><<<grid, ft::GROUP, 0, s>>>(
        q, db, vn, gidx, out, d, kg, ngroups);
  else
    rescore_groups_kernel<false, FMT><<<grid, ft::GROUP, 0, s>>>(
        q, db, vn, gidx, out, d, kg, ngroups);
}


// -- F32 rows: chunk-major -------------------------------------------------

constexpr int F32_CAP = 16;   // positions a piece: one block, one chunk read
constexpr int F32_DK = 128;   // d slice of a chunk's rows in shared memory
constexpr int F32_GT = 256;   // threads a block of the grouping kernels

// The grouping pass's int32 scratch, for P = nq·kg positions over ngroups
// chunks (the wrapper allocates ft_rescore_f32_work ints; meta and cnt are
// zeroed on the stream before the pass):
//   meta[4]        distinct chunks, positions placed, pieces, (unused)
//   cnt[ngroups]   the positions of each chunk
//   pieces[P]      (first index in order, positions, chunk id, 0), ≤ P
//   base[ngroups]  each listed chunk's first index in order
//   rank[P]        a position's index among its chunk's
//   chunks[P]      the distinct chunk ids, in no order
//   order[P]       the positions, each chunk's together
struct F32Work {
  int* meta;
  int* cnt;
  int4* pieces;
  int* base;
  int* rank;
  int* chunks;
  int* order;

  static long long pieces_at(int ngroups) {   // 16-byte aligned
    return (4LL + ngroups + 3) / 4 * 4;
  }
  static long long ints(int P, int ngroups) {
    return pieces_at(ngroups) + 4LL * P + ngroups + 3LL * P;
  }
  F32Work(int* w, int P, int ngroups)
      : meta(w), cnt(w + 4),
        pieces(reinterpret_cast<int4*>(w + pieces_at(ngroups))),
        base(w + pieces_at(ngroups) + 4LL * P), rank(base + ngroups),
        chunks(rank + P), order(chunks + P) {}
};

// Each position's rank among its chunk's positions; the first to arrive
// at a chunk lists it.
__global__ void __launch_bounds__(F32_GT)
f32_count(const int32_t* __restrict__ gidx, int P, int ngroups, F32Work w) {
  const int p = blockIdx.x * F32_GT + threadIdx.x;
  if (p >= P) return;
  const int c = clamp_group(gidx[p], ngroups);
  const int r = atomicAdd(w.cnt + c, 1);
  w.rank[p] = r;
  if (r == 0) w.chunks[atomicAdd(w.meta, 1)] = c;
}

// Each listed chunk's run of the order (anywhere, by an atomic: no scan),
// cut into pieces of ≤ F32_CAP positions.
__global__ void __launch_bounds__(F32_GT) f32_runs(F32Work w) {
  const int k = blockIdx.x * F32_GT + threadIdx.x;
  if (k >= w.meta[0]) return;
  const int c = w.chunks[k], n = w.cnt[c];
  const int b = atomicAdd(w.meta + 1, n);
  w.base[c] = b;
  const int np = (n + F32_CAP - 1) / F32_CAP;
  const int first = atomicAdd(w.meta + 2, np);
  for (int i = 0; i < np; ++i)
    w.pieces[first + i] = make_int4(b + i * F32_CAP,
                                    min(F32_CAP, n - i * F32_CAP), c, 0);
}

// The positions in chunk order.
__global__ void __launch_bounds__(F32_GT)
f32_order(const int32_t* __restrict__ gidx, int P, int ngroups, F32Work w) {
  const int p = blockIdx.x * F32_GT + threadIdx.x;
  if (p >= P) return;
  const int c = clamp_group(gidx[p], ngroups);
  w.order[w.base[c] + w.rank[p]] = p;
}

// One piece: the n ≤ NJ positions pos[0, n) of chunk c. Its rows come into
// xs one d slice at a time (a bulk copy a row, on `bar`), row r at r·stride4
// 16-byte units: stride4 odd, so the 8 rows of a quarter-warp's float4
// reads lie in 8 different bank groups; the n queries' slices into qs.
// Thread r scores row r against each of them.
template <bool L2, int NJ>
__device__ __forceinline__ void f32_piece(
    const float* __restrict__ q, const float* __restrict__ db,
    const float* __restrict__ vn, const int* pos, int n, int c,
    float* __restrict__ out, int d, int kg, float* xs, float* qs,
    int stride4, uint64_t* bar, uint32_t& phase) {
  const int t = threadIdx.x;
  const int dk4 = min(d, F32_DK) / 4;
  const float* rows = db + static_cast<size_t>(c) * ft::GROUP * d;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += F32_DK) {
    const int dn4 = min(F32_DK, d - d0) / 4;
    __syncthreads();   // xs, qs and pos read to the end; pos written
    if (t < 32) {
      if (t == 0) ft::mbar_expect_tx(bar, ft::GROUP * dn4 * 16);
      __syncwarp();
      for (int r = t; r < ft::GROUP; r += 32)
        ft::bulk_load(xs + 4 * r * stride4, rows + static_cast<size_t>(r) * d
                                                 + d0, dn4 * 16, bar);
    }
    for (int i = t; i < n * dn4; i += ft::GROUP) {
      const int j = i / dn4, e4 = i - j * dn4;
      reinterpret_cast<float4*>(qs)[j * dk4 + e4] = __ldg(
          reinterpret_cast<const float4*>(
              q + static_cast<size_t>(pos[j] / kg) * d + d0) + e4);
    }
    ft::mbar_wait(bar, phase);
    phase ^= 1u;
    __syncthreads();   // qs written
    const float4* x = reinterpret_cast<const float4*>(xs) + t * stride4;
    const float4* qv = reinterpret_cast<const float4*>(qs);
    for (int e4 = 0; e4 < dn4; ++e4) {
      const float4 v = x[e4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < n) {   // block-uniform
          const float4 a = qv[j * dk4 + e4];
          acc[j] = fmaf(a.x, v.x, acc[j]);
          acc[j] = fmaf(a.y, v.y, acc[j]);
          acc[j] = fmaf(a.z, v.z, acc[j]);
          acc[j] = fmaf(a.w, v.w, acc[j]);
        }
      }
    }
  }
  const float vr = vn[static_cast<size_t>(c) * ft::GROUP + t];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < n)
      out[static_cast<size_t>(pos[j]) * ft::GROUP + t] =
          (L2 ? 2.f * acc[j] : acc[j]) - vr;
}

// The pieces, grid-stride (the grid is fixed on the host: no wait for the
// grouping pass's count). Three blocks an SM, as the shared memory of a
// d ≤ 128 slice allows; declared so, ptxas keeps 118 registers where it
// kept 64 and spilled (4-6 % slower, scripts/k10_variants.py lb1).
template <bool L2>
__global__ void __launch_bounds__(ft::GROUP, 3)
rescore_f32_kernel(const float* __restrict__ q, const float* __restrict__ db,
                   const float* __restrict__ vn, F32Work w,
                   float* __restrict__ out, int d, int kg) {
  extern __shared__ float4 f32_smem[];
  __shared__ uint64_t bar;
  __shared__ int pos[F32_CAP];
  const int stride4 = (min(d, F32_DK) / 4) | 1;
  float* xs = reinterpret_cast<float*>(f32_smem);
  float* qs = xs + 4 * ft::GROUP * stride4;
  if (threadIdx.x == 0) {
    ft::mbar_init(&bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  uint32_t phase = 0;
  const int npieces = w.meta[2];
  for (int k = blockIdx.x; k < npieces; k += gridDim.x) {
    const int4 pc = w.pieces[k];
    __syncthreads();   // the previous piece's reads of pos have ended
    if (threadIdx.x < pc.y) pos[threadIdx.x] = w.order[pc.x + threadIdx.x];
    if (pc.y <= 4)
      f32_piece<L2, 4>(q, db, vn, pos, pc.y, pc.z, out, d, kg, xs, qs,
                       stride4, &bar, phase);
    else if (pc.y <= 8)
      f32_piece<L2, 8>(q, db, vn, pos, pc.y, pc.z, out, d, kg, xs, qs,
                       stride4, &bar, phase);
    else
      f32_piece<L2, F32_CAP>(q, db, vn, pos, pc.y, pc.z, out, d, kg, xs, qs,
                             stride4, &bar, phase);
  }
}

// Per device: SM count, and whether the kernel may take the shared memory
// of its widest slice (set once, before any graph capture can reach it).
struct F32Device {
  int sms = 0;
  bool attr_set = false;
};

size_t f32_smem_bytes(int d) {
  const int dk = min(d, F32_DK);
  return static_cast<size_t>(ft::GROUP) * ((dk / 4) | 1) * 16
         + static_cast<size_t>(F32_CAP) * dk * 4;
}

template <bool L2>
cudaError_t launch_f32(const float* q, const float* db, const float* vn,
                       const int32_t* gidx, float* out, int nq, int d, int kg,
                       int ngroups, int* work, cudaStream_t s) {
  static F32Device info[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  F32Device& di = info[dev];
  if (di.sms == 0) {
    e = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      di.sms = 0;
      return e;
    }
  }
  if (!di.attr_set) {
    e = cudaFuncSetAttribute(rescore_f32_kernel<L2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(f32_smem_bytes(F32_DK)));
    if (e != cudaSuccess) return e;
    di.attr_set = true;
  }
  const size_t smem = f32_smem_bytes(d);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rescore_f32_kernel<L2>, ft::GROUP, smem);
  if (e != cudaSuccess) return e;
  const int P = nq * kg;
  const F32Work w(work, P, ngroups);
  e = cudaMemsetAsync(work, 0, (4 + static_cast<size_t>(ngroups)) * 4, s);
  if (e != cudaSuccess) return e;
  const int gb = (P + F32_GT - 1) / F32_GT;
  f32_count<<<gb, F32_GT, 0, s>>>(gidx, P, ngroups, w);
  f32_runs<<<gb, F32_GT, 0, s>>>(w);
  f32_order<<<gb, F32_GT, 0, s>>>(gidx, P, ngroups, w);
  rescore_f32_kernel<L2><<<min(P, di.sms * max(per_sm, 1)), ft::GROUP, smem,
                           s>>>(q, db, vn, w, out, d, kg);
  return cudaGetLastError();
}

// -- PAIR and F16: streaming ------------------------------------------------

// Ring depth by format (rescore_stream.cuh). PAIR: 3 × 32 KB, two blocks
// an SM (one to six stages move it ≤ 10 %). F16: 2 × 16 KB, six blocks an
// SM: its decode binds it, so more consumer warps an SM beat a deeper ring
// (scripts/k10_variants.py --mode f16; PERF.md has both).
template <int FMT>
__host__ __device__ constexpr int stream_stages() {
  return FMT == ft::PAIR ? 3 : 2;
}

// the dynamic shared memory at width d (the kernel has no static shared
// memory, so it may take all the opt-in): the ring, q
template <int FMT>
size_t stream_smem_bytes(int d) {
  return ft::Ring<FMT, stream_stages<FMT>()>::BYTES
         + static_cast<size_t>(d) * 4;
}

// Positions [P·b/G, P·(b+1)/G) of block b of G, in order: position p is
// (query p / kg, rank p % kg), its group gidx[p] clamped into range. q is
// staged once a query; the producer warp's one thread brings each
// position's d slices in, the 128 consumers score them.
template <bool L2, int FMT>
__global__ void __launch_bounds__(ft::STREAM_THREADS)
rescore_stream_kernel(const __grid_constant__ CUtensorMap t0,
                      const __grid_constant__ CUtensorMap t1,
                      const float* __restrict__ q,
                      const float* __restrict__ vn,
                      const int32_t* __restrict__ gidx,
                      float* __restrict__ out, int d, int kg, int ngroups,
                      long long P) {
  extern __shared__ uint8_t stream_smem[];
  ft::Ring<FMT, stream_stages<FMT>()> ring(stream_smem);
  float* qs = reinterpret_cast<float*>(ring.after());
  const int p0 = static_cast<int>(P * blockIdx.x / gridDim.x);
  const int p1 = static_cast<int>(P * (blockIdx.x + 1) / gridDim.x);
  const int nkc = (d + ft::Stream<FMT>::KC - 1) / ft::Stream<FMT>::KC;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= ft::STREAM_CONS) {
    // producer: one thread issues every load
    if (t != ft::STREAM_CONS) return;
    for (int p = p0; p < p1; ++p) {
      const int row = ft::clamp_group(gidx[p], ngroups) * ft::GROUP;
      for (int kc = 0; kc < nkc; ++kc) ring.load(&t0, &t1, kc, row);
    }
    return;
  }
  // consumers: thread t scores row t of each position's group
  int qi_staged = -1;
  for (int p = p0; p < p1; ++p) {
    const int qi = p / kg;
    if (qi != qi_staged) {    // block-uniform
      ft::consumers_sync();   // the last query's reads of qs have ended
      const float4* qrow = reinterpret_cast<const float4*>(
          q + static_cast<size_t>(qi) * d);
      for (int e = t; e < d / 4; e += ft::STREAM_CONS)
        reinterpret_cast<float4*>(qs)[e] = __ldg(qrow + e);
      ft::consumers_sync();
      qi_staged = qi;
    }
    float acc = 0.f;
    for (int kc = 0; kc < nkc; ++kc) acc = ring.score(t, qs, kc, d, acc);
    const size_t g = ft::clamp_group(gidx[p], ngroups);
    out[static_cast<size_t>(p) * ft::GROUP + t] =
        (L2 ? 2.f * acc : acc) - vn[g * ft::GROUP + t];
  }
}

template <bool L2, int FMT>
cudaError_t launch_stream(const float* q, const void* db, const void* db2,
                          const float* vn, const int32_t* gidx, float* out,
                          int nq, int d, int kg, int ngroups, cudaStream_t s) {
  static ft::StreamDevice info[64];
  ft::StreamDevice* di = nullptr;
  cudaError_t e =
      ft::stream_device(info, rescore_stream_kernel<L2, FMT>, di);
  if (e != cudaSuccess) return e;
  CUtensorMap maps[2];
  if (!ft::stream_maps<FMT>(maps, db, db2, d, ngroups * ft::GROUP))
    return cudaErrorInvalidValue;
  const size_t smem = stream_smem_bytes<FMT>(d);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rescore_stream_kernel<L2, FMT>, ft::STREAM_THREADS, smem);
  if (e != cudaSuccess) return e;
  const long long P = static_cast<long long>(nq) * kg;
  const long long slots = static_cast<long long>(di->sms) * max(per_sm, 1);
  const int grid = static_cast<int>(P < slots ? P : slots);
  rescore_stream_kernel<L2, FMT><<<grid, ft::STREAM_THREADS, smem, s>>>(
      maps[0], maps[1], q, vn, gidx, out, d, kg, ngroups, P);
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch_stream(const float* q, const void* db, const void* db2,
                          const float* vn, const int32_t* gidx, float* out,
                          int nq, int d, int kg, int ngroups, int l2,
                          cudaStream_t s) {
  return l2 ? launch_stream<true, FMT>(q, db, db2, vn, gidx, out, nq, d, kg,
                                       ngroups, s)
            : launch_stream<false, FMT>(q, db, db2, vn, gidx, out, nq, d, kg,
                                        ngroups, s);
}

}  // namespace

// The int32 scratch ft_rescore_groups takes for f32 rows (fmt 4): the
// grouping pass's, over nq·kg positions and ngroups chunks.
extern "C" long long ft_rescore_f32_work(int nq, int kg, int ngroups) {
  return F32Work::ints(nq * kg, ngroups);
}

// q: (nq, d) f32; db: (≥ ngroups·128, d) rows in format fmt (0 bf16 rows,
// 1 the bf16 hi plane with db2 = the lo plane, 2 int8 codes, 3 f16 bits,
// 4 f32 rows); db2: the lo plane (fmt 1) or null; vn: (ngroups·128,) f32;
// gidx: (nq, kg) int32; out: (nq, kg·128) f32; work: fmt 4's scratch of
// ft_rescore_f32_work ints, else unread (nq·kg < 2^31). 16-byte
// aligned, and d % 8 == 0 (d % 16 == 0 for int8, d % 4 == 0 for f32).
extern "C" int ft_rescore_groups(const void* q, const void* db, const void* db2,
                                 const void* vn, const void* gidx, void* out,
                                 int nq, int d, int kg, int ngroups, int l2,
                                 int fmt, void* work, void* stream) {
  const int align = fmt == INT8 ? 16 : fmt == F32 ? 4 : 8;
  if (nq <= 0 || kg <= 0 || ngroups <= 0 || d <= 0 || d % align != 0
      || (fmt == PAIR) != (db2 != nullptr)
      || static_cast<long long>(nq) * kg >= (1LL << 31)
      || (fmt == F32 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* n = static_cast<const float*>(vn);
  auto* gi = static_cast<const int32_t*>(gidx);
  auto* o = static_cast<float*>(out);
  switch (fmt) {
    case BF16: launch<BF16>(qq, db, n, gi, o, nq, d, kg, ngroups, l2, s); break;
    case PAIR:
      return static_cast<int>(launch_stream<PAIR>(qq, db, db2, n, gi, o, nq,
                                                  d, kg, ngroups, l2, s));
    case INT8: launch<INT8>(qq, db, n, gi, o, nq, d, kg, ngroups, l2, s); break;
    case F16:
      return static_cast<int>(launch_stream<F16>(qq, db, nullptr, n, gi, o,
                                                 nq, d, kg, ngroups, l2, s));
    case F32: {
      auto* x = static_cast<const float*>(db);
      auto* wk = static_cast<int*>(work);
      return static_cast<int>(
          l2 ? launch_f32<true>(qq, x, n, gi, o, nq, d, kg, ngroups, wk, s)
             : launch_f32<false>(qq, x, n, gi, o, nq, d, kg, ngroups, wk, s));
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
