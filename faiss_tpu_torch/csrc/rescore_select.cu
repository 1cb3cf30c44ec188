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
// last group when fewer than kg groups score finitely), then selects the
// k largest as final_select.cu does: descending, ties to the lowest
// candidate column, each column's own score emitted; a row holding a NaN
// gives (ft::QNAN, the column kg·128 − 1) everywhere. Out: vals[q, i] and
// ids[q, i] = the row id of the i-th column. Group ids are clamped into
// range, as K10 clamps them.
//
// Arithmetic: the score of a row is the same fmaf chain as K10's format in
// rescore_groups.cu (q fp32 in shared memory, the row widened exactly, e
// ascending over d, one rounding per step), and the select picks what K9
// picks. So the result equals rescore_groups → mask → final_select →
// gather of the row ids bit for bit, in values and in ids. Padding and
// filtered rows score −inf through vn (+inf there). The Pallas body carries
// a running top-k across rank steps and emits id 1 << 30 in lanes that
// find only −inf; here all kg·128 scores sit in shared memory at once and a
// −inf lane takes the lowest column not yet taken, as K9 does, so such a
// lane carries a real row id: the index maps every −inf lane to label −1
// either way.
//
// What bounds it on an H100: the gather, as K10 (the rows of the nominated
// groups, 46 MB at nq=104, kg=14, d=128 for bf16 and f16, 23 MB for int8).
// The kernel it replaces (PR 4's) ran one block of 512 threads a query
// (104 blocks at the main shape, under the card's 132 SMs), each thread
// scoring candidates t, t + 512, … from rows 256 bytes apart (a warp load
// touched 32 lines), then k serial extractions, two block reductions each.
// Design: a query's kg groups go to a thread-block cluster of CLUSTER
// CTAs; each CTA streams its contiguous share of the ranks through
// rescore_stream.cuh's ring (K10's pair and f16 modes: a producer warp
// brings each group's d slices in by TMA, 128-byte swizzled, thread r
// scores row r at its XOR'd address) and stores each score, masked, into
// the leader CTA's score array through distributed shared memory. One
// cluster barrier follows; then the leader's five warps select over the
// kg·128 ≤ 4608 scores in one pass on row_select.cuh (the NaN vote,
// load_keys, kth_key, collect) and order the k slots by counting: no
// barrier runs inside a loop over k. scripts/k10_variants.py --mode k11
// times it against PR 4's kernel (legacy), cluster sizes and ring depths.
#include "rescore_stream.cuh"
#include "row_select.cuh"

namespace {

using ft::BF16;
using ft::INT8;
using ft::F16;

constexpr int MAX_D = 2048;       // the gate's largest d_pad for these rows
constexpr int MAX_CAND = 36 * ft::GROUP;   // kg ≤ k + 4 ≤ 36
constexpr int NT = ft::STREAM_THREADS;     // 128 consumers + the producer
constexpr int WPR = NT / 32;               // the select's warps
constexpr int CLUSTER = 2;                 // CTAs a query (PERF.md)
constexpr int STAGES = 4;                  // ring depth (PERF.md)

// one 16 KB tile a stage in every format: one layout
using Ring = ft::Ring<BF16, STAGES>;
static_assert(ft::Ring<INT8, STAGES>::BYTES == Ring::BYTES
              && ft::Ring<F16, STAGES>::BYTES == Ring::BYTES,
              "one ring layout for the three formats");

// the dynamic shared memory: the ring, q, the scores, the group ids, k
// slots of columns and keys, the select's exchange words
size_t select_smem_bytes(int d, int kg, int k) {
  return Ring::BYTES
         + 4 * (static_cast<size_t>(d) + kg * ft::GROUP + kg + 2 * k
                + 4 * WPR);
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of the cluster's CTAs: arrive (release, or relaxed where
// only the start of the CTAs matters), then wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (this CTA's shared memory) in CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_shared(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(ft::smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void store_shared_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(a), "f"(v)
               : "memory");
}

// The leader's select over the scores s[0, ncand) (every thread): the k
// slots by row_select.cuh, then slot i goes to its rank among them (key
// descending, column ascending), the column's own score and row id.
template <int PER>
__device__ __forceinline__ void select_top(const uint32_t* s, int ncand,
                                           int c0, int c1, int lane, int sub,
                                           uint32_t* xch, int& half, int k,
                                           uint32_t* skey, uint32_t* scol,
                                           const int32_t* g, float* vo,
                                           int32_t* io) {
  uint32_t key[PER];
  rs::load_keys(s, c0, c1, lane, key);
  bool exact;
  const uint32_t t =
      rs::kth_key<PER, WPR>(key, c0, c1, lane, sub, xch, half, k, exact);
  rs::collect<PER, WPR>(key, t, exact, c0, lane, sub, xch, half, k, skey,
                        scol);
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += NT) {
    const uint32_t ki = skey[i], ci = scol[i];
    int rank = 0;
    for (int j = 0; j < k; ++j)
      rank += skey[j] > ki || (skey[j] == ki && scol[j] < ci);
    vo[rank] = __uint_as_float(s[ci]);
    io[rank] = g[ci / ft::GROUP] * ft::GROUP + ci % ft::GROUP;
  }
}

// (declared for 3 blocks an SM, as the shared memory of d ≤ 128 allows:
// ptxas then keeps the select's keys in registers, where it kept 64 and
// spilled)
template <bool L2, int FMT>
__global__ void __launch_bounds__(NT, 3)
rescore_select_kernel(const __grid_constant__ CUtensorMap tmap,
                      const float* __restrict__ q,
                      const float* __restrict__ vn,
                      const int32_t* __restrict__ gidx,
                      float* __restrict__ vals, int32_t* __restrict__ ids,
                      int d, int kg, int ngroups, int ntotal, int k) {
  extern __shared__ uint8_t select_smem[];
  ft::Ring<FMT, STAGES> ring(select_smem);
  float* qs = reinterpret_cast<float*>(ring.after());
  float* s = qs + d;
  const int ncand = kg * ft::GROUP;
  int32_t* g = reinterpret_cast<int32_t*>(s + ncand);
  uint32_t* scol = reinterpret_cast<uint32_t*>(g + kg);
  uint32_t* skey = scol + k;
  uint32_t* xch = skey + k;

  const uint32_t cr = cluster_ctarank(), nc = cluster_nctarank();
  const int qi = blockIdx.x / nc;
  const int j0 = kg * cr / nc, j1 = kg * (cr + 1) / nc;
  const int t = threadIdx.x;
  if (t == 0) ring.init();
  const float4* qrow = reinterpret_cast<const float4*>(
      q + static_cast<size_t>(qi) * d);
  for (int e = t; e < d / 4; e += NT)
    reinterpret_cast<float4*>(qs)[e] = __ldg(qrow + e);
  for (int j = t; j < kg; j += NT)
    g[j] = ft::clamp_group(gidx[static_cast<size_t>(qi) * kg + j], ngroups);
  __syncthreads();
  cluster_arrive_relaxed();   // this CTA runs: the others may store into it

  const int nkc = (d + ft::Stream<FMT>::KC - 1) / ft::Stream<FMT>::KC;
  if (t >= ft::STREAM_CONS) {
    // producer: one thread issues every load of this CTA's ranks
    if (t == ft::STREAM_CONS)
      for (int j = j0; j < j1; ++j)
        for (int kc = 0; kc < nkc; ++kc)
          ring.load(&tmap, &tmap, kc, g[j] * ft::GROUP);
    __syncwarp();
    cluster_wait();
  } else {
    // consumers: thread t scores row t of each of this CTA's groups into
    // the leader's s, once every CTA of the cluster runs
    cluster_wait();
    const uint32_t s0 = map_shared(s, 0);
    for (int j = j0; j < j1; ++j) {
      float acc = 0.f;
      for (int kc = 0; kc < nkc; ++kc) acc = ring.score(t, qs, kc, d, acc);
      const int row = g[j] * ft::GROUP + t;
      const bool drop = row >= ntotal || (j > 0 && g[j] == g[j - 1]);
      store_shared_cluster(
          s0 + 4u * (j * ft::GROUP + t),
          drop ? -INFINITY : (L2 ? 2.f * acc : acc) - vn[row]);
    }
  }
  cluster_arrive();   // every score is in the leader's s
  cluster_wait();
  if (cr != 0) return;

  // the leader: a NaN anywhere → (QNAN, column ncand − 1) everywhere, as K9
  const int lane = t & 31, sub = t >> 5;
  const int cw = ((ncand + WPR - 1) / WPR + 31) / 32 * 32;
  const int c0 = sub * cw;
  const int c1 = max(c0, min(c0 + cw, ncand));
  const uint32_t* sb = reinterpret_cast<const uint32_t*>(s);
  bool nan = false;
  for (int c = c0 + lane; c < c1; c += 32) nan |= rs::is_nan_bits(sb[c]);
  int half = 0;
  const uint32_t any_nan = rs::row_reduce<WPR>(
      static_cast<uint32_t>(__any_sync(rs::FULL, nan)), xch, sub, lane, half,
      [](uint32_t a, uint32_t b) { return a | b; });
  float* vo = vals + static_cast<size_t>(qi) * k;
  int32_t* io = ids + static_cast<size_t>(qi) * k;
  if (any_nan) {
    for (int j = t; j < k; j += NT) {
      vo[j] = __uint_as_float(ft::QNAN);
      io[j] = g[kg - 1] * ft::GROUP + ft::GROUP - 1;
    }
    return;
  }
  const int per = cw / 32;   // keys a lane: ≤ 29 at 4608 columns
  if (per <= 4)
    select_top<4>(sb, ncand, c0, c1, lane, sub, xch, half, k, skey, scol, g,
                  vo, io);
  else if (per <= 8)
    select_top<8>(sb, ncand, c0, c1, lane, sub, xch, half, k, skey, scol, g,
                  vo, io);
  else if (per <= 16)
    select_top<16>(sb, ncand, c0, c1, lane, sub, xch, half, k, skey, scol, g,
                   vo, io);
  else
    select_top<32>(sb, ncand, c0, c1, lane, sub, xch, half, k, skey, scol, g,
                   vo, io);
}

template <bool L2, int FMT>
cudaError_t launch(const float* q, const void* db, const float* vn,
                   const int32_t* gidx, float* vals, int32_t* ids, int nq,
                   int d, int kg, int ngroups, int ntotal, int k,
                   cudaStream_t s) {
  static ft::StreamDevice info[64];
  ft::StreamDevice* di = nullptr;
  cudaError_t e = ft::stream_device(info, rescore_select_kernel<L2, FMT>, di);
  if (e != cudaSuccess) return e;
  const size_t smem = select_smem_bytes(d, kg, k);
  if (smem > static_cast<size_t>(di->smem_optin))
    return cudaErrorInvalidValue;
  CUtensorMap maps[2];
  if (!ft::stream_maps<FMT>(maps, db, nullptr, d, ngroups * ft::GROUP))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nq) * CLUSTER);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, rescore_select_kernel<L2, FMT>, maps[0], q,
                         vn, gidx, vals, ids, d, kg, ngroups, ntotal, k);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int FMT>
cudaError_t launch(const float* q, const void* db, const float* vn,
                   const int32_t* gidx, float* vals, int32_t* ids, int nq,
                   int d, int kg, int ngroups, int ntotal, int k, int l2,
                   cudaStream_t s) {
  return l2 ? launch<true, FMT>(q, db, vn, gidx, vals, ids, nq, d, kg,
                                ngroups, ntotal, k, s)
            : launch<false, FMT>(q, db, vn, gidx, vals, ids, nq, d, kg,
                                 ngroups, ntotal, k, s);
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
      || k > kg * ft::GROUP
      || static_cast<long long>(nq) * CLUSTER >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* n = static_cast<const float*>(vn);
  auto* gi = static_cast<const int32_t*>(gidx);
  auto* v = static_cast<float*>(vals);
  auto* o = static_cast<int32_t*>(ids);
  cudaError_t e;
  switch (fmt) {
    case BF16:
      e = launch<BF16>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2,
                       s);
      break;
    case INT8:
      e = launch<INT8>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2,
                       s);
      break;
    case F16:
      e = launch<F16>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2,
                      s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
