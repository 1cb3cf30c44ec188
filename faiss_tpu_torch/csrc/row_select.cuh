// The one-pass row select shared by the group select (K8, select_groups.cu),
// the final top-k (K9, final_select.cu), the rescore-select (K11,
// rescore_select.cu; steps 2-4 over its scores in shared memory) and the
// IVF budget select (budget_select.cu; steps 3-4 over keys of its own).
//
// A row of fp32 scores is held by WPR warps (one warp, or a block of WPR
// warps for one row); warp `sub` of a row owns the columns [c0, c1) =
// [sub·cw, sub·cw + cw) ∩ [0, ncols), cw a multiple of 32, and holds its
// column c0 + 32j + l as key j of lane l (0 past the row). The steps:
//   1. load_row: the warp's columns, once, from device memory into the
//      row's shared memory (16-byte loads, LOADS in flight a lane, when the
//      row length is a multiple of 4), with a NaN flag;
//   2. load_keys: each lane's order-preserving 32-bit keys into registers;
//   3. kth_key: the k-th largest key T, bit by bit from the top, starting
//      below the leading bits that every key shares (a step counts the keys
//      ≥ prefix | bit in four partial counts, reduces over the warp with
//      __reduce_add_sync and across the row's warps through shared memory
//      with one barrier, and keeps the bit while the count stays ≥ k); it
//      stops early once exactly k keys are ≥ the prefix.
//   4. collect: the k selected columns into k slots, in column order, by
//      ballots and prefix counts.
// Each kernel then orders the slots its own way: no barrier runs inside a
// loop over k.
#pragma once

#include "common.cuh"

namespace rs {

constexpr int LOADS = 8;             // 16-byte loads in flight a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NEG_INF_KEY = 0x007fffffu;   // order_key(-inf)

// Order-preserving key of an fp32 bit pattern (NaN excluded): larger value,
// larger key; -0.0 takes +0.0's key, since the two compare equal. The least
// key of a value, -inf's, is 0x007fffff: 0 marks "no column".
__device__ __forceinline__ uint32_t order_key(uint32_t b) {
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool is_nan_bits(uint32_t b) {
  return (b & 0x7fffffffu) > 0x7f800000u;
}

// A lane's count of its keys ≥ thr, in four partial counts so that the
// compares run side by side.
template <int PER>
__device__ __forceinline__ uint32_t count_ge(const uint32_t (&key)[PER],
                                             uint32_t thr) {
  uint32_t c[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < PER; ++j) c[j & 3] += key[j] >= thr;
  return (c[0] + c[1]) + (c[2] + c[3]);
}

// The barrier of a row's warps: the warp itself, or the block, which then
// holds one row.
template <int WPR>
__device__ __forceinline__ void row_sync() {
  if constexpr (WPR == 1)
    __syncwarp();
  else
    __syncthreads();
}

// op over the row's WPR warps of one value a warp (each already reduced
// over its lanes). The exchange words (4·WPR of them) alternate between two
// halves, so one barrier a call suffices.
template <int WPR, typename Op>
__device__ __forceinline__ uint32_t row_reduce(uint32_t v, uint32_t* xch,
                                               int sub, int lane, int& half,
                                               Op op) {
  if constexpr (WPR == 1) {
    return v;
  } else {
    uint32_t* buf = xch + half * 2 * WPR;
    half ^= 1;
    if (lane == 0) buf[sub] = v;
    __syncthreads();
    uint32_t r = buf[0];
#pragma unroll
    for (int i = 1; i < WPR; ++i) r = op(r, buf[i]);
    return r;
  }
}

// Step 1: the warp's columns [c0, c1) of the row src into x (the row's
// shared memory, column for column), LOADS 16-byte loads in flight a lane
// before the first store when ncols is a multiple of 4 (c0 is a multiple of
// 32). Returns whether any of this lane's columns is NaN.
__device__ __forceinline__ bool load_row(const float* __restrict__ src,
                                         uint32_t* x, int ncols, int c0,
                                         int c1, int lane) {
  bool nan = false;
  if ((ncols & 3) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + c0);
    uint4* x4 = reinterpret_cast<uint4*>(x + c0);
    const int n4 = (c1 - c0) / 4;
    for (int i0 = lane; i0 < n4; i0 += 32 * LOADS) {
      uint4 v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (i0 + 32 * u < n4) v[u] = __ldg(s4 + i0 + 32 * u);
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (i0 + 32 * u < n4) {
          x4[i0 + 32 * u] = v[u];
          nan |= is_nan_bits(v[u].x) | is_nan_bits(v[u].y)
                 | is_nan_bits(v[u].z) | is_nan_bits(v[u].w);
        }
    }
  } else {
    for (int i = c0 + lane; i < c1; i += 32) {
      const uint32_t b = __float_as_uint(__ldg(src + i));
      x[i] = b;
      nan |= is_nan_bits(b);
    }
  }
  return nan;
}

// Step 2: key j of lane l is column c0 + 32j + l's key (0 past c1).
template <int PER>
__device__ __forceinline__ void load_keys(const uint32_t* x, int c0, int c1,
                                          int lane, uint32_t (&key)[PER]) {
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = c0 + 32 * j + lane;
    key[j] = c < c1 ? order_key(x[c]) : 0u;
  }
}

// Step 3: T, the largest t with count(key ≥ t) ≥ k over the row; `exact`
// once that count is k itself, and then every key ≥ the returned t is among
// the k largest (a padding key, 0, never is). The leading bits that every
// key of the row shares are T's: the search starts below them (scores of
// one query share sign and most exponent bits).
template <int PER, int WPR>
__device__ __forceinline__ uint32_t kth_key(const uint32_t (&key)[PER],
                                            int c0, int c1, int lane,
                                            int sub, uint32_t* xch, int& half,
                                            int k, bool& exact) {
  uint32_t all = 0xffffffffu, any = 0u;
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (c0 + 32 * j + lane < c1) {
      all &= key[j];
      any |= key[j];
    }
  all = row_reduce<WPR>(__reduce_and_sync(FULL, all), xch, sub, lane, half,
                        [](uint32_t a, uint32_t b) { return a & b; });
  any = row_reduce<WPR>(__reduce_or_sync(FULL, any), xch, sub, lane, half,
                        [](uint32_t a, uint32_t b) { return a | b; });
  const uint32_t differ = all ^ any;   // 0 where every key agrees
  const int top = differ == 0u ? -1 : 31 - __clz(differ);
  // (2u << 31 wraps to 0: no bit is shared)
  uint32_t t = top < 0 ? all : all & ~((2u << top) - 1u);
  exact = false;
  for (int b = top; b >= 0; --b) {
    const uint32_t cand = t | (1u << b);
    const uint32_t c = row_reduce<WPR>(
        __reduce_add_sync(FULL, count_ge(key, cand)), xch, sub, lane, half,
        [](uint32_t a, uint32_t b) { return a + b; });
    if (c >= static_cast<uint32_t>(k)) {
      t = cand;
      if (c == static_cast<uint32_t>(k)) {
        exact = true;
        break;
      }
    }
  }
  return t;
}

// Step 4: the k selected columns into k slots (skey, scol: the row's shared
// memory), in column order by ballots and prefix counts: slots [0, k - need)
// take the keys above t (or, when exact, ≥ t), slots [k - need, k) the
// lowest-column keys equal to t; a warp's first slots follow those of the
// warps before it. The slots are in no order of key: the caller orders
// them. t + 1 does not wrap for order_key's keys (t ≤ +inf's key
// 0xff800000); WIDE keys take every 32-bit value, and none is above
// 0xffffffff.
template <int PER, int WPR, bool WIDE = false>
__device__ __forceinline__ void collect(const uint32_t (&key)[PER],
                                        uint32_t t, bool exact, int c0,
                                        int lane, int sub, uint32_t* xch,
                                        int half, int k, uint32_t* skey,
                                        uint32_t* scol) {
  const uint32_t n_above =
      WIDE && t == FULL ? 0u : __reduce_add_sync(FULL, count_ge(key, t + 1u));
  const uint32_t n_from_t = __reduce_add_sync(FULL, count_ge(key, t));
  const uint32_t w_up = exact ? n_from_t : n_above;
  const uint32_t w_eq = exact ? 0u : n_from_t - n_above;
  int n_up = 0, n_eq = 0, need = 0;
  if constexpr (WPR == 1) {
    need = k - static_cast<int>(w_up);
  } else {
    uint32_t* buf = xch + half * 2 * WPR;
    if (lane == 0) {
      buf[sub] = w_up;
      buf[WPR + sub] = w_eq;
    }
    __syncthreads();
    int up_all = 0;
#pragma unroll
    for (int i = 0; i < WPR; ++i) {
      if (i < sub) {
        n_up += static_cast<int>(buf[i]);
        n_eq += static_cast<int>(buf[WPR + i]);
      }
      up_all += static_cast<int>(buf[i]);
    }
    need = k - up_all;
  }
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const bool up = exact ? key[j] >= t : key[j] > t;
    const bool eq = !exact && key[j] == t;
    const unsigned bu = __ballot_sync(FULL, up);
    const unsigned be = __ballot_sync(FULL, eq);
    const int pu = n_up + __popc(bu & lower);
    const int pe = n_eq + __popc(be & lower);
    const uint32_t col = static_cast<uint32_t>(c0 + 32 * j + lane);
    if (up) {
      skey[pu] = key[j];
      scol[pu] = col;
    }
    if (eq && pe < need) {
      skey[k - need + pe] = key[j];
      scol[k - need + pe] = col;
    }
    n_up += __popc(bu);
    n_eq += __popc(be);
  }
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory where that is
// past the default 48 KB.
template <typename Kernel>
__host__ cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace rs
