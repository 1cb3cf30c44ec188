// Final top-k: the last step of the fused search (K9).
//
// Replaces faiss_tpu/ops/pallas_fused.py _final_select_kernel, as launched
// by final_select_pallas. Per row of the (nq, ncand) rescored candidate
// scores: the k largest in DESCENDING order with their columns, ties to the
// lowest column, so a row of all -inf yields columns 0, 1, 2, ... as
// lax.top_k does. A NaN anywhere in a row makes every output of that row
// (NaN, ncand - 1): the Pallas kernel's max propagates NaN and no column
// matches it; the clamp keeps the caller's gathers in bounds. The value
// emitted for a column is that column's own score, bit for bit: -0.0 and
// +0.0 compare equal, so on such a tie the lower column wins and keeps its
// own sign (the NaN of a NaN row is the canonical ft::QNAN).
// fused.final_select_plain is the definition.
//
// What bounds it on an H100: latency, not bytes (104 × 1792 floats, 0.75 MB,
// is 0.2 µs of device memory). The kernel it replaces ran k extractions,
// each re-reading the row with two block-wide reductions. Design: a row is
// read once and selected in one pass over registers, by one warp (up to 512
// columns, four rows a block), four (up to 2048) or eight (up to 16384);
// steps 1-3 are row_select.cuh's, shared with the group select (K8):
//   1. each warp reads its share of the row once from device memory
//      (16-byte loads, eight in flight a lane, when the row is 16-byte
//      aligned) into the row's shared memory, and a NaN flag is voted;
//   2. each lane takes the order-preserving 32-bit keys of its columns
//      (-0.0 given +0.0's key) into registers, at most 64;
//   3. the k-th largest key T is found bit by bit from the top, starting
//      below the leading bits that every key shares: a step counts the keys
//      ≥ prefix | bit (compares into four partial counts, a warp reduction
//      __reduce_add_sync, and across a row's warps one exchange through
//      shared memory and one barrier) and keeps the bit while the count
//      stays ≥ k; it stops as soon as exactly k keys are ≥ the prefix;
//   4. one pass in column order, 32 columns at a time, collects the keys
//      above T and the lowest-column ones equal to it (ballots and prefix
//      counts; a warp's slots follow those of the warps before it) into k
//      slots;
//   5. a bitonic sort of 64 slots (two a lane, shuffles) in the row's first
//      warp orders them by (key descending, column ascending).
// No barrier runs inside a loop over k. A 256-bin radix select over shared
// histograms (__match_any_sync, atomics) was tried first and ran behind
// torch.topk at (104, 1792): each element's chain of shared loads, matches
// and atomics left the warp waiting, where the bitwise search compares
// registers side by side (PERF.md has the times).
#include "row_select.cuh"

namespace {

using rs::FULL;

constexpr int MAX_COLS = 16384;   // faiss_tpu SELECT_MAX_GROUPS
constexpr int MAX_K = 40;         // faiss_tpu SELECT_MAX_KG (≤ 64 sort slots)
constexpr int SLOTS = 64;

// One row per WPR warps (PER keys a lane each), several rows a block when
// WPR is 1. Shared memory of a row: its bits (ncp words: ncand rounded up
// to 4), SLOTS keys, SLOTS columns, 4·WPR exchange words. Warp `sub` of a
// row owns the columns [sub·cw, sub·cw + cw) (cw a multiple of 32); its key
// j in lane l is column sub·cw + 32j + l (0 past the row).
template <int PER, int WPR>
__global__ void final_select_kernel(const float* __restrict__ s,
                                    float* __restrict__ vals,
                                    int32_t* __restrict__ pos, int nq,
                                    int ncand, int ncp, int cw, int k) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp % WPR;
  const int row = blockIdx.x * (blockDim.x / (32 * WPR)) + warp / WPR;
  if (row >= nq) return;   // only with WPR 1: no block barrier follows
  uint32_t* x = smem + static_cast<size_t>(warp / WPR)
                           * (ncp + 2 * SLOTS + 4 * WPR);
  uint32_t* skey = x + ncp;
  uint32_t* scol = skey + SLOTS;
  uint32_t* xch = scol + SLOTS;
  const float* src = s + static_cast<size_t>(row) * ncand;
  const int c0 = sub * cw;
  const int c1 = max(c0, min(c0 + cw, ncand));
  int half = 0;

  // 1. the warp's columns, once, into shared memory
  const bool nan = rs::load_row(src, x, ncand, c0, c1, lane);
  float* vo = vals + static_cast<size_t>(row) * k;
  int32_t* po = pos + static_cast<size_t>(row) * k;
  const uint32_t any_nan = rs::row_reduce<WPR>(
      static_cast<uint32_t>(__any_sync(FULL, nan)), xch, sub, lane, half,
      [](uint32_t a, uint32_t b) { return a | b; });
  if (any_nan) {
    for (int j = lane; sub == 0 && j < k; j += 32) {
      vo[j] = __uint_as_float(ft::QNAN);
      po[j] = ncand - 1;
    }
    return;
  }
  __syncwarp();

  // 2. the keys, into registers; 3. T (`exact`: every key ≥ t is taken)
  uint32_t key[PER];
  rs::load_keys(x, c0, c1, lane, key);
  bool exact;
  const uint32_t t =
      rs::kth_key<PER, WPR>(key, c0, c1, lane, sub, xch, half, k, exact);

  // 4. collect the k columns into the slots, in column order
  rs::collect<PER, WPR>(key, t, exact, c0, lane, sub, xch, half, k, skey,
                        scol);
  rs::row_sync<WPR>();
  if (sub != 0) return;

  // 5. bitonic sort, descending, of (key << 32 | ~column): larger key
  // first, then lower column; empty slots are 0 and sort last
  uint64_t v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int slot = lane + 32 * r;
    v[r] = slot < k ? (static_cast<uint64_t>(skey[slot]) << 32)
                          | static_cast<uint32_t>(~scol[slot])
                    : 0ull;
  }
#pragma unroll
  for (int size = 2; size <= SLOTS; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {   // the pair (lane, lane + 32): one lane's two
        const uint64_t hi = v[0] > v[1] ? v[0] : v[1];
        const uint64_t lo = v[0] > v[1] ? v[1] : v[0];
        v[0] = hi;
        v[1] = lo;
      } else {
        const bool low = (lane & stride) == 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint64_t p = __shfl_xor_sync(FULL, v[r], stride);
          const bool desc = ((lane + 32 * r) & size) == 0;
          v[r] = low == desc ? (v[r] > p ? v[r] : p) : (v[r] < p ? v[r] : p);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int slot = lane + 32 * r;
    if (slot < k) {
      const uint32_t col = ~static_cast<uint32_t>(v[r]);
      vo[slot] = __uint_as_float(x[col]);
      po[slot] = static_cast<int32_t>(col);
    }
  }
}

template <int PER, int WPR>
cudaError_t launch(const float* s, float* vals, int32_t* pos, int nq,
                   int ncand, int k, cudaStream_t stream) {
  const int ncp = (ncand + 3) & ~3;
  const int cw = ((ncand + WPR - 1) / WPR + 31) / 32 * 32;
  const int rows = WPR == 1 ? 4 : 1;   // rows a block
  const size_t smem =
      static_cast<size_t>(rows) * (ncp + 2 * SLOTS + 4 * WPR) * 4;
  const cudaError_t e = rs::set_smem(final_select_kernel<PER, WPR>, smem);
  if (e != cudaSuccess) return e;
  final_select_kernel<PER, WPR>
      <<<(nq + rows - 1) / rows, 32 * WPR * rows, smem, stream>>>(
          s, vals, pos, nq, ncand, ncp, cw, k);
  return cudaGetLastError();
}

}  // namespace

// s: (nq, ncand) f32, 16-byte aligned; vals: (nq, k) f32 out; pos: (nq, k)
// int32 out. 1 ≤ k ≤ 40, k ≤ ncand ≤ 16384.
extern "C" int ft_final_select(const void* s, void* vals, void* pos, int nq,
                               int ncand, int k, void* stream) {
  if (nq <= 0 || ncand <= 0 || ncand > MAX_COLS || k <= 0 || k > MAX_K
      || k > ncand)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* x = static_cast<const float*>(s);
  auto* v = static_cast<float*>(vals);
  auto* p = static_cast<int32_t*>(pos);
  auto st = static_cast<cudaStream_t>(stream);
  // one warp a row up to 512 columns, 4 up to 2048, 8 beyond; ≤ 64 keys a
  // lane
  const cudaError_t e =
      ncand <= 32    ? launch<1, 1>(x, v, p, nq, ncand, k, st)
      : ncand <= 128 ? launch<4, 1>(x, v, p, nq, ncand, k, st)
      : ncand <= 512 ? launch<16, 1>(x, v, p, nq, ncand, k, st)
      : ncand <= 2048 ? launch<16, 4>(x, v, p, nq, ncand, k, st)
                      : launch<64, 8>(x, v, p, nq, ncand, k, st);
  return static_cast<int>(e);
}
