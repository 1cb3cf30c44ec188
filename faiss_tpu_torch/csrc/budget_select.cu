// The IVF fine scan's top-k over its budget scores (budget_select).
//
// Replaces no TPU kernel: faiss_tpu's fine scan masks the dead budget
// positions with jnp.where and ranks with lax.top_k (faiss_tpu/ivf.py
// 414-420), and the port stable-sorted every budget score
// (ops/topk.py topk_scores). Per row of the (nq, nbudget·128) fp32 scores
// that K10's f32 mode writes, okc (nq, nbudget) marking the live budget
// chunks: the k largest in descending fp32 TOTAL order (-0.0 below +0.0,
// +NaN above +inf, -NaN below -inf), ties to the lowest column, each value
// its column's own bits and -inf on a dead chunk's columns, so a row with
// fewer than k live columns ends in -inf at the lowest such columns.
// ops/kernels.budget_select_plain, topk_scores of the masked scores, is the
// definition.
//
// What bounds it on an H100: bytes (104 × 131,072 scores, 54.5 MB, is 16 µs
// of device memory, the dead chunks' share unread), and the latency of a
// row eight times wider than K9's one block a row holds (16,384 columns).
// Design: one kernel, launched two or more times:
//   1. a block of 8 warps takes one tile of 4,096 columns (32 chunks) of
//      one row: 104 × 32 blocks at the IVF cell, the last tile of a row
//      ragged. Lanes 0-3 of a warp read the okc of its 4 chunks and vote;
//      a dead chunk's columns take -inf's key and are never read. Each lane
//      loads its 16 columns, 32 apart (a warp reads 128 contiguous bytes a
//      load), straight into registers as total-order keys. Tiles of 16,384
//      and 8,192 columns ran 1.5× and 1.04× as long at the IVF cell's
//      shape: four times fewer blocks, more registers a thread, fewer
//      blocks an SM to hide each one's barriers;
//   2. the k-th largest of the block's 256 lane maxima, L, bounds the
//      tile's k-th key from below (k lanes hold a key ≥ L). When at most
//      CAP keys are ≥ L, they go to shared memory in column order and each
//      takes its rank by (key, column) among them: the top k, in order,
//      without a pass per bit.
//      Else (ties, -inf, a tile of fewer than k lanes) row_select.cuh's
//      kth_key and collect (its WIDE keys: every 32-bit value is some
//      score's key) pick the k, which keeps equal keys in column order;
//   3. the same kernel, reading the tiles' (key, column) pairs, reduces
//      them, a block as small as a row's pairs allow (one warp at the IVF
//      cell's 320), in tiles of ⌊4,096 / k⌋·k pairs while more are left,
//      until one tile is left: its block orders the k slots by (key,
//      column) and writes the values, the keys' own bits turned back, and
//      the columns. The second launch is the last for rows up to
//      ⌊4,096 / k⌋ tiles (418K columns at k 40, 1.7M at k 10; the fine
//      scan's gather budget allows 16.8M).
// Key 0 (the bits 0xffffffff, a -NaN) is also row_select.cuh's "no
// column", the key of the positions past a tile's end. They come after
// every real position and a tile holds at least k real ones (128 columns,
// or a multiple of k pairs), so collect, which takes equal keys lowest
// position first, never takes one, and step 2 never takes the fast way
// when L is 0.
#include <climits>

#include "row_select.cuh"

namespace {

using rs::FULL;

constexpr int PER = 16;                 // keys a lane of a tile's block
constexpr int WPR = 8;                  // warps a tile's block
constexpr int TILE = 32 * PER * WPR;    // positions a tile: 4,096
constexpr int MAX_K = 40;               // faiss_tpu SELECT_MAX_KG
constexpr int CAP = 256;                // keys ≥ L that step 2 ranks
constexpr int MAX_TILES = 65535;        // gridDim.y

// The fp32 total order as an unsigned key (topk_scores' key, its sign bit
// flipped): larger value, larger key; every bit pattern its own key.
__device__ __forceinline__ uint32_t total_key(uint32_t b) {
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint32_t key_bits(uint32_t key) {
  return (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
}

// Step 2's fast way, for a block of 8 warps: the slots skey, scol in rank
// order when at most CAP keys of the tile are ≥ L; false, with nothing
// written, otherwise.
template <int PER, int WPR>
__device__ __forceinline__ bool rank_above_bound(
    const uint32_t (&key)[PER], int c0, int lane, int sub, int k,
    uint32_t* lmax, uint32_t* wcnt, uint32_t* fkey, uint32_t* fpos,
    uint32_t* skey, uint32_t* scol) {
  constexpr int NT = 32 * WPR;
  uint32_t m = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j) m = max(m, key[j]);
  lmax[threadIdx.x] = m;
  __syncthreads();
  if (sub == 0) {
    uint32_t mk[WPR];
#pragma unroll
    for (int r = 0; r < WPR; ++r) mk[r] = lmax[lane + 32 * r];
    int half = 0;
    bool exact;
    const uint32_t lb = rs::kth_key<WPR, 1>(mk, 0, NT, lane, 0, nullptr,
                                           half, k, exact);
    if (lane == 0) wcnt[WPR] = lb;
  }
  __syncthreads();
  const uint32_t lb = wcnt[WPR];
  const uint32_t wc = __reduce_add_sync(FULL, rs::count_ge(key, lb));
  if (lane == 0) wcnt[sub] = wc;
  __syncthreads();
  int off = 0, c = 0;
#pragma unroll
  for (int i = 0; i < WPR; ++i) {
    off += i < sub ? static_cast<int>(wcnt[i]) : 0;
    c += static_cast<int>(wcnt[i]);
  }
  if (lb == 0u || c > CAP) return false;   // uniform over the block
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool up = key[j] >= lb;
    const unsigned b = __ballot_sync(FULL, up);
    if (up) {
      const int p = off + __popc(b & lower);
      fkey[p] = key[j];
      fpos[p] = static_cast<uint32_t>(c0 + 32 * j + lane);
    }
    off += __popc(b);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c; i += NT) {
    const uint32_t ki = fkey[i], pi = fpos[i];
    int rank = 0;
    for (int j = 0; j < c; ++j)
      rank += fkey[j] > ki || (fkey[j] == ki && fpos[j] < pi);
    if (rank < k) {
      skey[rank] = ki;
      scol[rank] = pi;
    }
  }
  return true;
}

// Block (row, tile): positions [p0, p0 + tw) ∩ [p0, width) of one row,
// WPR warps of PER keys a lane. SCORES: the positions are the columns of s
// (width = nbudget·128), read where okc holds; else the (key, column)
// pairs of the previous launch. A grid of one tile a row writes the row's
// k values and columns in order; else each block writes its tile's k
// candidates, equal keys in column order.
template <int PER, int WPR, bool SCORES>
__global__ void __launch_bounds__(32 * WPR)
budget_select_kernel(const float* __restrict__ s,
                     const uint8_t* __restrict__ okc,
                     const uint32_t* __restrict__ key_in,
                     const int32_t* __restrict__ col_in, int width, int tw,
                     uint32_t* __restrict__ key_out,
                     int32_t* __restrict__ col_out, float* __restrict__ vals,
                     int32_t* __restrict__ pos, int k) {
  constexpr int NT = 32 * WPR;
  constexpr bool BOUND = WPR == 8;   // step 2's fast way
  __shared__ uint32_t skey[MAX_K], scol[MAX_K], xch[4 * WPR];
  __shared__ uint32_t lmax[BOUND ? NT : 1], wcnt[WPR + 1];
  __shared__ uint32_t fkey[BOUND ? CAP : 1], fpos[BOUND ? CAP : 1];
  const int lane = threadIdx.x & 31;
  const int sub = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int p0 = blockIdx.y * tw;
  const int c0 = sub * 32 * PER;
  const int c1 = max(c0, min(c0 + 32 * PER, min(tw, width - p0)));
  const size_t base = static_cast<size_t>(row) * width + p0;

  // 1. the warp's keys, into registers
  uint32_t key[PER];
  if constexpr (SCORES) {
    // bit i: the warp's chunk i is live (p0 and c0 are multiples of 128)
    const bool live =
        lane < PER / 4 && c0 + lane * ft::GROUP < c1
        && okc[static_cast<size_t>(row) * (width / ft::GROUP)
               + (p0 + c0) / ft::GROUP + lane];
    const unsigned lm = __ballot_sync(FULL, live);
    const float* src = s + base;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = c0 + 32 * j + lane;
      key[j] = c >= c1 ? 0u
               : (lm >> (j / 4)) & 1u
                   ? total_key(__float_as_uint(__ldg(src + c)))
                   : rs::NEG_INF_KEY;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int c = c0 + 32 * j + lane;
      key[j] = c < c1 ? __ldg(key_in + base + c) : 0u;
    }
  }

  // 2. the tile's k candidates into the slots
  bool ranked = false;
  if constexpr (BOUND)
    ranked = rank_above_bound<PER, WPR>(key, c0, lane, sub, k, lmax, wcnt,
                                        fkey, fpos, skey, scol);
  if (!ranked) {
    int half = 0;
    bool exact;
    const uint32_t t =
        rs::kth_key<PER, WPR>(key, c0, c1, lane, sub, xch, half, k, exact);
    rs::collect<PER, WPR, true>(key, t, exact, c0, lane, sub, xch, half, k,
                                skey, scol);
  }
  __syncthreads();
  if (gridDim.y > 1) {
    for (int i = threadIdx.x; i < k; i += NT) {
      const size_t o =
          (static_cast<size_t>(row) * gridDim.y + blockIdx.y) * k + i;
      key_out[o] = skey[i];
      col_out[o] = SCORES ? p0 + static_cast<int32_t>(scol[i])
                          : col_in[base + scol[i]];
    }
    return;
  }

  // 3. the last tile: slot i goes to its rank by (key descending, column
  // ascending), its value the key's own bits
  for (int i = threadIdx.x; i < k; i += NT)
    scol[i] = SCORES ? p0 + scol[i]
                     : static_cast<uint32_t>(col_in[base + scol[i]]);
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += NT) {
    const uint32_t ki = skey[i], ci = scol[i];
    int rank = 0;
    for (int j = 0; j < k; ++j)
      rank += skey[j] > ki || (skey[j] == ki && scol[j] < ci);
    vals[static_cast<size_t>(row) * k + rank] = __uint_as_float(key_bits(ki));
    pos[static_cast<size_t>(row) * k + rank] = static_cast<int32_t>(ci);
  }
}

int ntiles(int width, int tw) { return (width + tw - 1) / tw; }

struct Round {
  const float* s;
  const uint8_t* okc;
  const uint32_t* key_in;
  const int32_t* col_in;
  uint32_t* key_out;
  int32_t* col_out;
  float* vals;
  int32_t* pos;
  int nq, k;
  cudaStream_t stream;
};

template <int PER, int WPR, bool SCORES>
cudaError_t launch(const Round& r, int width, int tw) {
  budget_select_kernel<PER, WPR, SCORES>
      <<<dim3(r.nq, ntiles(width, tw)), 32 * WPR, 0, r.stream>>>(
          r.s, r.okc, r.key_in, r.col_in, width, tw, r.key_out, r.col_out,
          r.vals, r.pos, r.k);
  return cudaGetLastError();
}

// A round over (key, column) pairs, `width` a row: one block as small as
// holds them, else tiles of ⌊TILE / k⌋·k pairs. Returns the tiles a row.
cudaError_t pairs_round(const Round& r, int width, int& tiles) {
  tiles = 1;
  if (width <= 128) return launch<4, 1, false>(r, width, width);
  if (width <= 512) return launch<16, 1, false>(r, width, width);
  if (width <= 2048) return launch<16, 4, false>(r, width, width);
  const int tw = TILE / r.k * r.k;
  tiles = ntiles(width, tw);
  return launch<PER, WPR, false>(r, width, tw);
}

}  // namespace

// int32 words of scratch that ft_budget_select needs: two buffers of
// (key, column) pairs for a row's tiles (none for a row of one tile).
extern "C" long long ft_budget_select_work(int nq, int nbudget, int k) {
  if (nq <= 0 || nbudget <= 0 || nbudget > INT_MAX / ft::GROUP || k <= 0)
    return 0;
  const int tiles = ntiles(nbudget * ft::GROUP, TILE);
  return tiles > 1 ? 4LL * nq * tiles * k : 0;
}

// s: (nq, nbudget·128) f32; okc: (nq, nbudget) bool (one byte each); vals:
// (nq, k) f32 out; pos: (nq, k) int32 out; work: ft_budget_select_work
// words. 1 ≤ k ≤ 40.
extern "C" int ft_budget_select(const void* s, const void* okc, void* vals,
                                void* pos, void* work, int nq, int nbudget,
                                int k, void* stream) {
  if (nq <= 0 || nbudget <= 0 || nbudget > INT_MAX / ft::GROUP || k <= 0
      || k > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width = nbudget * ft::GROUP;
  int tiles = ntiles(width, TILE);
  if (tiles > MAX_TILES) return static_cast<int>(cudaErrorInvalidValue);
  const size_t cap = static_cast<size_t>(nq) * tiles * k;
  auto* w = static_cast<uint32_t*>(work);
  uint32_t* keys[2] = {w, w + 2 * cap};
  int32_t* cols[2] = {reinterpret_cast<int32_t*>(w + cap),
                      reinterpret_cast<int32_t*>(w + 3 * cap)};
  Round r{static_cast<const float*>(s), static_cast<const uint8_t*>(okc),
          nullptr, nullptr, keys[0], cols[0], static_cast<float*>(vals),
          static_cast<int32_t*>(pos), nq, k, static_cast<cudaStream_t>(stream)};
  cudaError_t e = launch<PER, WPR, true>(r, width, TILE);
  for (int b = 0; tiles > 1 && e == cudaSuccess; b ^= 1) {
    r.key_in = keys[b];
    r.col_in = cols[b];
    r.key_out = keys[b ^ 1];
    r.col_out = cols[b ^ 1];
    e = pairs_round(r, tiles * k, tiles);
  }
  return static_cast<int>(e);
}
