// Group nomination: phase 2 of the fused search (K8), and the f32 path's
// stage-3a candidate select.
//
// Replaces faiss_tpu/ops/pallas_fused.py _select_kernel, as launched by
// select_groups_pallas. Per row of the (nq, ngroups) group-max array, with
// fused.select_groups_plain as the definition:
//   - the nominated set is what kg max-extractions mark, each taking the
//     max with ties to the lowest column. With f < kg entries above -inf,
//     every extraction after the f-th picks column 0 (marked or not): the
//     set is {entries > -inf} ∪ {0}, fewer than kg. With a NaN in the row no
//     column is ever marked;
//   - t = the max over the columns not nominated, as the bits of the lowest
//     such column holding it (a -0.0 / +0.0 tie has no other sign); -inf
//     when every column is nominated, NaN on a NaN row;
//   - gidx = the nominated columns in ASCENDING order, padded with
//     ngroups-1, so every id stays in bounds (the rescore gathers by them).
//
// What bounds it on an H100: latency, not bytes (104 × 7816 floats, 3.25 MB,
// is 1 µs of device memory). The kernel it replaces ran kg extractions, each
// a block max and a block min with two barriers. Design: row_select.cuh's
// one pass, as the final select (K9) takes it: a row is read once (16-byte
// loads) into shared memory by one warp (up to 512 columns, four rows a
// block), four (up to 2048) or eight (up to 16384); its keys go to
// registers; the kg-th key T is found bit by bit below the row's shared
// prefix. Then one ballot pass in column order decides membership: a key
// above T, or equal to T among the first `need` = kg − count(key > T) such
// columns (when the search ended with exactly kg keys ≥ T, every key ≥ T).
// A member's prefix count over the lower columns is its output slot, so the
// ids come out ascending without a sort. When T is -inf's key (f < kg), the
// members are the keys above it and column 0. The same pass keeps each
// lane's largest non-member key (at its lowest column) for t. No barrier
// runs inside a loop over kg.
#include "row_select.cuh"

namespace {

using rs::FULL;

constexpr int MAX_COLS = 16384;   // faiss_tpu SELECT_MAX_GROUPS
constexpr int MAX_KG = 40;        // faiss_tpu SELECT_MAX_KG

// One row per WPR warps (PER keys a lane each), four rows a block when WPR
// is 1. Shared memory of a row: its bits (ncp words: ngroups rounded up to
// 4) and 4·WPR exchange words.
template <int PER, int WPR>
__global__ void select_groups_kernel(const float* __restrict__ gm,
                                     int32_t* __restrict__ gidx,
                                     float* __restrict__ t_out, int nq,
                                     int ngroups, int ncp, int cw, int kg) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp % WPR;
  const int row = blockIdx.x * (blockDim.x / (32 * WPR)) + warp / WPR;
  if (row >= nq) return;   // only with WPR 1: no block barrier follows
  uint32_t* x = smem + static_cast<size_t>(warp / WPR) * (ncp + 4 * WPR);
  uint32_t* xch = x + ncp;
  const int c0 = sub * cw;
  const int c1 = max(c0, min(c0 + cw, ngroups));
  int32_t* out = gidx + static_cast<size_t>(row) * kg;
  int half = 0;

  const bool nan = rs::load_row(gm + static_cast<size_t>(row) * ngroups, x,
                                ngroups, c0, c1, lane);
  const uint32_t any_nan = rs::row_reduce<WPR>(
      static_cast<uint32_t>(__any_sync(FULL, nan)), xch, sub, lane, half,
      [](uint32_t a, uint32_t b) { return a | b; });
  if (any_nan) {   // nothing marked: every slot ngroups-1, t NaN
    for (int j = lane; sub == 0 && j < kg; j += 32) out[j] = ngroups - 1;
    if (sub == 0 && lane == 0) t_out[row] = __uint_as_float(ft::QNAN);
    return;
  }
  __syncwarp();

  uint32_t key[PER];
  rs::load_keys(x, c0, c1, lane, key);
  bool exact;
  const uint32_t T =
      rs::kth_key<PER, WPR>(key, c0, c1, lane, sub, xch, half, kg, exact);

  // membership: key ≥ up (and, below -inf's key, column 0 too), or key == T
  // within the first `need` such columns
  const bool inf = T <= rs::NEG_INF_KEY;
  const bool use_eq = !inf && !exact;
  const uint32_t up = inf ? rs::NEG_INF_KEY + 1u : (exact ? T : T + 1u);
  uint32_t cu = 0, ce = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    cu += key[j] >= up || (inf && c0 + 32 * j + lane == 0);
    ce += use_eq && key[j] == T;
  }
  cu = __reduce_add_sync(FULL, cu);
  ce = __reduce_add_sync(FULL, ce);
  int n_up = 0, n_eq = 0, up_all = static_cast<int>(cu);
  if constexpr (WPR > 1) {
    uint32_t* buf = xch + half * 2 * WPR;
    half ^= 1;
    if (lane == 0) {
      buf[sub] = cu;
      buf[WPR + sub] = ce;
    }
    __syncthreads();
    up_all = 0;
#pragma unroll
    for (int i = 0; i < WPR; ++i) {
      if (i < sub) {
        n_up += static_cast<int>(buf[i]);
        n_eq += static_cast<int>(buf[WPR + i]);
      }
      up_all += static_cast<int>(buf[i]);
    }
  }
  const int need = use_eq ? kg - up_all : 0;
  const int members = use_eq ? kg : up_all;

  // one pass in column order: a member's slot is the count of members at
  // lower columns; the lane's best non-member (largest key, lowest column)
  const unsigned lower = (1u << lane) - 1u;
  uint32_t best = 0u, bcol = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = c0 + 32 * j + lane;
    const bool u = key[j] >= up || (inf && c == 0);
    const bool e = use_eq && key[j] == T;
    const unsigned bu = __ballot_sync(FULL, u);
    const unsigned be = __ballot_sync(FULL, e);
    const int pu = n_up + __popc(bu & lower);
    const int pe = n_eq + __popc(be & lower);
    if (u || (e && pe < need))
      out[pu + min(pe, need)] = c;
    else if (key[j] > best) {
      best = key[j];
      bcol = static_cast<uint32_t>(c);
    }
    n_up += __popc(bu);
    n_eq += __popc(be);
  }
  for (int j = members + lane; sub == 0 && j < kg; j += 32)
    out[j] = ngroups - 1;

  // t: the row's best non-member, the lowest column among equal keys (the
  // warps hold the columns in order)
  const uint32_t wbest = __reduce_max_sync(FULL, best);
  const uint32_t wcol =
      __reduce_min_sync(FULL, best == wbest ? bcol : 0xffffffffu);
  uint32_t tb = wbest, tc = wcol;
  if constexpr (WPR > 1) {
    uint32_t* buf = xch + half * 2 * WPR;
    if (lane == 0) {
      buf[sub] = wbest;
      buf[WPR + sub] = wcol;
    }
    __syncthreads();
    tb = buf[0];
    tc = buf[WPR];
#pragma unroll
    for (int i = 1; i < WPR; ++i)
      if (buf[i] > tb) {
        tb = buf[i];
        tc = buf[WPR + i];
      }
  }
  if (sub == 0 && lane == 0)
    t_out[row] = tb == 0u ? -INFINITY : __uint_as_float(x[tc]);
}

template <int PER, int WPR>
cudaError_t launch(const float* gm, int32_t* gidx, float* t, int nq,
                   int ngroups, int kg, cudaStream_t stream) {
  const int ncp = (ngroups + 3) & ~3;
  const int cw = ((ngroups + WPR - 1) / WPR + 31) / 32 * 32;
  const int rows = WPR == 1 ? 4 : 1;   // rows a block
  const size_t smem = static_cast<size_t>(rows) * (ncp + 4 * WPR) * 4;
  const cudaError_t e = rs::set_smem(select_groups_kernel<PER, WPR>, smem);
  if (e != cudaSuccess) return e;
  select_groups_kernel<PER, WPR>
      <<<(nq + rows - 1) / rows, 32 * WPR * rows, smem, stream>>>(
          gm, gidx, t, nq, ngroups, ncp, cw, kg);
  return cudaGetLastError();
}

}  // namespace

// gm: (nq, ngroups) f32, 16-byte aligned; gidx: (nq, kg) int32 out; t: (nq,)
// f32 out. 1 ≤ kg ≤ 40, kg ≤ ngroups ≤ 16384.
extern "C" int ft_select_groups(const void* gm, void* gidx, void* t, int nq,
                                int ngroups, int kg, void* stream) {
  if (nq <= 0 || ngroups <= 0 || ngroups > MAX_COLS || kg <= 0
      || kg > MAX_KG || kg > ngroups)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* x = static_cast<const float*>(gm);
  auto* g = static_cast<int32_t*>(gidx);
  auto* tv = static_cast<float*>(t);
  auto st = static_cast<cudaStream_t>(stream);
  // one warp a row up to 512 columns, 4 up to 2048, 8 beyond; ≤ 64 keys a
  // lane
  const cudaError_t e =
      ngroups <= 32     ? launch<1, 1>(x, g, tv, nq, ngroups, kg, st)
      : ngroups <= 128  ? launch<4, 1>(x, g, tv, nq, ngroups, kg, st)
      : ngroups <= 512  ? launch<16, 1>(x, g, tv, nq, ngroups, kg, st)
      : ngroups <= 2048 ? launch<16, 4>(x, g, tv, nq, ngroups, kg, st)
      : ngroups <= 8192 ? launch<32, 8>(x, g, tv, nq, ngroups, kg, st)
                        : launch<64, 8>(x, g, tv, nq, ngroups, kg, st);
  return static_cast<int>(e);
}
