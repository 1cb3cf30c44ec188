"""K10's streamed and chunk-major modes (csrc/rescore_groups.cu,
``ft_rescore_groups``) and the rescore-select kernel K11
(csrc/rescore_select.cu, ``ft_rescore_select``) against variants of
themselves, on one CUDA card.

    python scripts/k10_variants.py [--mode f32|pair|f16|k11] [--only a,b]
                                   [--nprobe 16] [--nv 1000000,10000000]
                                   [--reps 20]

--mode f32 (the default): K10's f32 rows, the IVF fine scan (fmt 4), on
the ivf_1m main path's inputs (chip_smoke.py): IVF4096,Flat over
1,000,000 mixture rows of chip_smoke.ivf_data(), f32 lists, L2, 100
queries padded to 104, at each --nprobe: the index's own probe, chunk
budget and pre-masked norms.
--mode pair: K10's pair mode (fmt 1), stage 3a of the f32 flat search:
TorchIndexFlat() over the --nv rows (1M: default_rng(42) as chip_smoke.py
makes them; 10M: those and 9M from default_rng(44), as its f32_10m), L2,
the same 100 queries: the search's one stage-3a call (nq_pad 104, kg 14),
caught as the search makes it.
--mode f16: K10's f16 mode (fmt 3), phase 3 of the f16 flat search:
TorchIndexFlat(storage="f16") over the 1M rows, L2, the search's phase-3
call (nq_pad 104, kg 14), caught as it is made.
--mode k11: the rescore-select kernel in its three row formats, on the
phase-3 call of the bf16, int8 and f16 flat searches over the 1M rows (L2,
nq_pad 104, kg 14), with k = chip_smoke.K.

Each variant is a patched copy of the sources, built with nvcc into its
own library and called through the C entry point:

  kernel        the sources as they are
  legacy        the earlier kernel: for K10 the thread-per-row kernel (one
                block per (query, rank), thread r reading row r in 16-byte
                steps, every position's group read again) in its f32 rows
                (PRs 5-8), pair (PRs 2-9) and f16 (PRs 3-10) modes; for
                K11 PR 10's kernel (one block of 512 threads a query, k
                serial block-wide extractions)
  f32 rows:
  pregrouped    the chunk-major kernel alone, on a grouping made beforehand
                by the kernel for the same ids: what the grouping costs
  query_major   the chunk-major kernel with one piece per position (no
                grouping, no dedup): the rows come into shared memory by
                bulk copies, coalesced, but each position reads its chunk:
                what the dedup buys
  cap32         pieces of up to 32 positions (two blocks an SM, not three)
  no_pad        the rows in shared memory without their 16-byte pad: a
                quarter-warp's float4 reads of 8 rows on one bank group
  lb1           the kernel declared __launch_bounds__(128) alone, not for
                3 blocks an SM: ptxas keeps 64 registers and spills
  pair:
  one_stage     a ring of one stage (32 KB): no load in flight under a
                block's products (six blocks an SM)
  stages6       a ring of six stages (192 KB): one block an SM
  no_swizzle    the tiles unswizzled: a quarter-warp's 16-byte reads of 8
                rows 128 bytes apart on one bank group
  f16:
  stagesN       a ring of N 16 KB stages (N = 1, 3, 4, 6; the kernel's is
                stream_stages<F16>())
  no_swizzle    as the pair's
  no_decode     each unit widened as bf16 (a shift) in place of the f16
                decode: the stream without the decode's ALU work (other
                scores: timed, not compared)
  int_decode    PR 10's decode (the exponent rebiased in the integer
                domain, subnormals by a multiply) in place of
                cvt.f32.f16
  k11:
  clusterN      N CTAs a query (N = 1, 3, 4; the kernel's is CLUSTER)
  stagesN       a ring of N 16 KB stages (N = 2, 3, 6, 8; the kernel's is
                STAGES)
  late_wait     the consumers wait for every CTA's start before their
                first store, not before their first chain
  no_select     the leader returns after the cluster barrier: the
                scoring alone (no output: timed, not compared)

Every variant but no_decode and no_select must give the kernel's results
bit for bit
(one that does not is reported, left untimed, and makes the script exit
1). Times are graph replays (chip_smoke.graph_ms) in two rounds. Prints
the card's name and power limit first, then for each input the positions,
the distinct groups (chunks), the longest run and the reads in pieces.
Last, in --mode f32, the other four K10 modes (bf16 rows, the pair, int8
codes, f16 bits) through the kernel's library and the legacy one on the
same random rows and group ids: equal bit for bit, or the script exits 1.

``legacy_sources()``, ``start_build`` and ``finish_build`` build the two
legacy libraries for chip_smoke.py and tests/test_torch_cuda.py, which
hold K10's f16 mode and K11 against them bit for bit. Imports nothing of
jax or faiss_tpu; exits 1 without a card.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "faiss_tpu_torch" / "csrc"
SRC = CSRC / "rescore_groups.cu"
SRC_K11 = CSRC / "rescore_select.cu"
STREAM_H = "rescore_stream.cuh"

EPC = """  constexpr int EPC = FMT == INT8 ? 16 : 8;
  constexpr int ESZ = FMT == INT8 ? 1 : 2;"""
EPC_F32 = """  constexpr int EPC = FMT == INT8 ? 16 : FMT == F32 ? 4 : 8;
  constexpr int ESZ = FMT == INT8 ? 1 : FMT == F32 ? 4 : 2;"""
UNPACK = """      if constexpr (FMT == INT8) {
        ft::unpack16_i8(w, x);
      } else {"""
# the thread-per-row kernel with its f32 rows (PRs 5-8) and f16 bits (PRs
# 3-10)
UNPACK_LEGACY = """      if constexpr (FMT == INT8) {
        ft::unpack16_i8(w, x);
      } else if constexpr (FMT == F32) {
        x[0] = __uint_as_float(w.x);
        x[1] = __uint_as_float(w.y);
        x[2] = __uint_as_float(w.z);
        x[3] = __uint_as_float(w.w);
      } else if constexpr (FMT == F16) {
        legacy_unpack8_f16(w, x);
      } else {"""
TPR_AT = "// BF16 and INT8: a block per (query, rank), thread r row r."
LEGACY_DECODE = """// the f16 decode of PRs 3-10 (common.cuh then), integer rebias
// An f16 bit pattern (low 16 bits of h) widened to its EXACT fp32 value,
// with every e=31 pattern, NaN included, mapped to ±inf by its sign bit:
// the contract of faiss_tpu.storage.decode_f16_bits (__half2float would
// keep NaN as NaN). Normal values rebias the exponent (15 → 127) in the
// integer domain; zero and subnormals are the mantissa (an integer
// < 1024, exact in fp32) times 2^-24, exact and normal in fp32.
__device__ __forceinline__ float legacy_f16_to_f32(uint32_t h) {
  const uint32_t m = h & 0x7FFFu;
  float f = m < 0x400u ? static_cast<float>(m) * 5.9604644775390625e-8f
                       : __uint_as_float((m << 13) + (112u << 23));
  if (m >= 0x7C00u) f = __uint_as_float(0x7F800000u);   // +inf
  return __uint_as_float(__float_as_uint(f) | ((h & 0x8000u) << 16));
}

// The eight f16 of a 16-byte row chunk, decoded to fp32.
__device__ __forceinline__ void legacy_unpack8_f16(const uint4 w, float (&x)[8]) {
  x[0] = legacy_f16_to_f32(w.x); x[1] = legacy_f16_to_f32(w.x >> 16);
  x[2] = legacy_f16_to_f32(w.y); x[3] = legacy_f16_to_f32(w.y >> 16);
  x[4] = legacy_f16_to_f32(w.z); x[5] = legacy_f16_to_f32(w.z >> 16);
  x[6] = legacy_f16_to_f32(w.w); x[7] = legacy_f16_to_f32(w.w >> 16);
}

"""
CASE = """    case F32: {
      auto* x = static_cast<const float*>(db);
      auto* wk = static_cast<int*>(work);
      return static_cast<int>(
          l2 ? launch_f32<true>(qq, x, n, gi, o, nq, d, kg, ngroups, wk, s)
             : launch_f32<false>(qq, x, n, gi, o, nq, d, kg, ngroups, wk, s));
    }"""
CASE_LEGACY = """    case F32: launch<F32>(qq, db, n, gi, o, nq, d, kg, ngroups, l2, s); break;"""
GROUPING = """  e = cudaMemsetAsync(work, 0, (4 + static_cast<size_t>(ngroups)) * 4, s);
  if (e != cudaSuccess) return e;
  const int gb = (P + F32_GT - 1) / F32_GT;
  f32_count<<<gb, F32_GT, 0, s>>>(gidx, P, ngroups, w);
  f32_runs<<<gb, F32_GT, 0, s>>>(w);
  f32_order<<<gb, F32_GT, 0, s>>>(gidx, P, ngroups, w);
"""
IDENTITY_LAUNCH = """  f32_identity<<<(P + F32_GT - 1) / F32_GT, F32_GT, 0, s>>>(gidx, P,
                                                          ngroups, w);
"""
PIECE_AT = "// One piece: the n ≤ NJ positions"
IDENTITY = """// query_major: one piece per position, in position order.
__global__ void f32_identity(const int32_t* __restrict__ gidx, int P,
                             int ngroups, F32Work w) {
  const int p = blockIdx.x * F32_GT + threadIdx.x;
  if (p == 0) w.meta[2] = P;
  if (p >= P) return;
  w.order[p] = p;
  w.pieces[p] = make_int4(p, 1, clamp_group(gidx[p], ngroups), 0);
}

"""
CAP = "constexpr int F32_CAP = 16;"
STRIDE = "  const int stride4 = (min(d, F32_DK) / 4) | 1;"
BOUNDS = """__global__ void __launch_bounds__(ft::GROUP, 3)
rescore_f32_kernel("""




# -- the streamed modes' variants (pair, f16) -------------------------------

PAIR_CASE = """    case PAIR:
      return static_cast<int>(launch_stream<PAIR>(qq, db, db2, n, gi, o, nq,
                                                  d, kg, ngroups, l2, s));"""
PAIR_CASE_LEGACY = """    case PAIR: {
      const dim3 grid(static_cast<unsigned>(static_cast<long long>(nq) * kg));
      auto* h = static_cast<const uint16_t*>(db);
      auto* l = static_cast<const uint16_t*>(db2);
      if (l2)
        rescore_pair_legacy<true><<<grid, ft::GROUP, 0, s>>>(
            qq, h, l, n, gi, o, d, kg, ngroups);
      else
        rescore_pair_legacy<false><<<grid, ft::GROUP, 0, s>>>(
            qq, h, l, n, gi, o, d, kg, ngroups);
      break;
    }"""
F16_CASE = """    case F16:
      return static_cast<int>(launch_stream<F16>(qq, db, nullptr, n, gi, o,
                                                 nq, d, kg, ngroups, l2, s));"""
F16_CASE_LEGACY = """    case F16: launch<F16>(qq, db, n, gi, o, nq, d, kg, ngroups, l2, s); break;"""
PAIR_AT = "// -- PAIR and F16: streaming"
# the thread-per-row kernel's pair mode (rescore_groups_kernel<L2, PAIR>)
PAIR_LEGACY = """// legacy: the pair on the thread-per-row kernel, a block per position
template <bool L2>
__global__ void __launch_bounds__(ft::GROUP)
rescore_pair_legacy(const float* __restrict__ q,
                    const uint16_t* __restrict__ db,
                    const uint16_t* __restrict__ db2,
                    const float* __restrict__ vn,
                    const int32_t* __restrict__ gidx,
                    float* __restrict__ out, int d, int kg, int ngroups) {
  __shared__ __align__(16) float qs[DT];
  const int qi = blockIdx.x / kg, j = blockIdx.x % kg;
  const int g = clamp_group(gidx[static_cast<size_t>(qi) * kg + j], ngroups);
  const size_t row = static_cast<size_t>(g) * ft::GROUP + threadIdx.x;
  const uint4* v = reinterpret_cast<const uint4*>(db + row * d);
  const uint4* v2 = reinterpret_cast<const uint4*>(db2 + row * d);
  const float* qrow = q + static_cast<size_t>(qi) * d;
  float acc = 0.f;
  for (int d0 = 0; d0 < d; d0 += DT) {
    const int dn = min(DT, d - d0);
    __syncthreads();
    for (int e = threadIdx.x; e < dn; e += ft::GROUP) qs[e] = qrow[d0 + e];
    __syncthreads();
    for (int e = 0; e < dn; e += 8) {
      float x[8], y[8];
      ft::unpack8(__ldg(v + (d0 + e) / 8), x);
      ft::unpack8(__ldg(v2 + (d0 + e) / 8), y);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] += y[i];
#pragma unroll
      for (int i = 0; i < 8; i += 4) {
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

"""
STAGES_K10 = "  return FMT == ft::PAIR ? 3 : 2;"
SWIZZLED = "  const int off = 16 * (u ^ (r & 7));"
MAPS_AT = "// The tensor maps of a format's planes"
STREAM_AT = "// A row format of the stream"
DECODE = """  } else if constexpr (FMT == F16) {
    unpack8_f16(w, x);"""


def _plane_map_flat():
    """tma.cuh's plane_map as plane_map_flat, without the swizzle."""
    text = (CSRC / "tma.cuh").read_text()
    a = text.index("inline bool plane_map(")
    b = text.index("\n}\n", a) + 3
    return (text[a:b].replace("inline bool plane_map(",
                              "inline bool plane_map_flat(")
            .replace("EncodeTiled enc", "ft::EncodeTiled enc")
            .replace("TMA_ROW_BYTES", "ft::TMA_ROW_BYTES")
            .replace("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_NONE")
            + "\n")


def _patch(text, pairs):
    for a, b in pairs:
        if a not in text:
            raise RuntimeError(f"k10_variants: the source no longer holds "
                               f"{a.strip()[:60]!r}")
        text = text.replace(a, b)
    return text


def _stream_h(pairs):
    """{the stream header: its patched text}"""
    return {STREAM_H: _patch((CSRC / STREAM_H).read_text(), pairs)}


def _no_swizzle():
    return _stream_h([(SWIZZLED, "  const int off = 16 * u;"),
                      ("plane_map(enc,", "plane_map_flat(enc,"),
                      (MAPS_AT, _plane_map_flat() + MAPS_AT)])


# -- K11's variants ---------------------------------------------------------

CLUSTER = "constexpr int CLUSTER = 2;"
STAGES_K11 = "constexpr int STAGES = 4;"
# late_wait: the consumers' wait for the cluster's start deferred to
# their first store
LATE_WAIT = [
    ("    cluster_wait();\n    const uint32_t s0 = map_shared(s, 0);\n",
     "    const uint32_t s0 = map_shared(s, 0);\n    bool started = false;\n"),
    ("      store_shared_cluster(\n",
     "      if (!started) {\n        cluster_wait();\n        started = true;\n"
     "      }\n      store_shared_cluster(\n"),
    ("vn[row]);\n    }\n", "vn[row]);\n    }\n    if (!started) cluster_wait();\n")]
LEADER = "  if (cr != 0) return;"
# variants whose results differ from the kernel's: timed, not compared
DIAGNOSTIC = ("no_decode", "no_select")
# PR 10's rescore_select.cu, and the helpers of common.cuh that only it used
LEGACY_K11 = r"""// PR 10's rescore-select kernel (PR 4's design): one block of 512 threads
// a query, thread t scoring candidates t, t + 512, … from rows read
// 16 bytes a step, then k serial block-wide extractions.
#include "common.cuh"

// the block reductions and the extraction step it ran on (common.cuh, PR 10)
namespace ft {

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions over NT threads (NT a multiple of 32, ≤ 1024);
// every thread gets the result. `scratch` holds ≥ NT/32 entries of shared
// memory and is free again when the call returns.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = nan_max(r, scratch[i]);
  __syncthreads();
  return r;
}

template <int NT>
__device__ __forceinline__ int block_min(int v, int* scratch) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = scratch[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = min(r, scratch[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ bool bit_set(const uint32_t* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

// One max-extraction step of the rescore-select kernel (K11's extraction in
// _final_select_kernel's order), over the row x[0, n) in shared memory with
// the extracted set in the shared bitmask `excl`:
//   m   = max over xm, where xm = -inf on extracted columns, else x
//   col = the lowest column with xm == m that is not extracted yet (the
//         final select's `& ~excl`); BIG when no column matches (m is NaN).
// Two block reductions per step; each thread walks its columns in
// ascending order, so its first match is its lowest.
template <int NT>
__device__ __forceinline__ void extract_step(
    const float* x, int n, const uint32_t* excl, float* fscratch,
    int* iscratch, float& m_out, int& col_out) {
  float m = -INFINITY;
  for (int c = threadIdx.x; c < n; c += NT)
    m = nan_max(m, bit_set(excl, c) ? -INFINITY : x[c]);
  m = block_max<NT>(m, fscratch);
  int col = BIG;
  for (int c = threadIdx.x; c < n; c += NT) {
    if (!bit_set(excl, c) && x[c] == m) {
      col = c;
      break;
    }
  }
  col_out = block_min<NT>(col, iscratch);
  m_out = m;
}

}  // namespace ft

namespace {

constexpr int NT = 512;
constexpr int MAX_D = 2048;       // the gate's largest d_pad for these rows
constexpr int MAX_CAND = 36 * ft::GROUP;   // kg ≤ k + 4 ≤ 36

enum Rows { BF16 = 0, INT8 = 2, F16 = 3 };   // rescore_groups.cu's formats

template <bool L2, int FMT>
__global__ void __launch_bounds__(NT)
rescore_select_kernel(const float* __restrict__ q, const void* __restrict__ db,
                      const float* __restrict__ vn,
                      const int32_t* __restrict__ gidx,
                      float* __restrict__ vals, int32_t* __restrict__ ids,
                      int d, int kg, int ngroups, int ntotal, int k) {
  constexpr int EPC = FMT == INT8 ? 16 : 8;   // elements per 16-byte chunk
  constexpr int ESZ = FMT == INT8 ? 1 : 2;    // bytes per element
  __shared__ __align__(16) float qs[MAX_D];
  __shared__ float s[MAX_CAND];
  __shared__ int32_t g[MAX_CAND / ft::GROUP];
  __shared__ uint32_t excl[MAX_CAND / 32];
  __shared__ float fs[NT / 32];
  __shared__ int is[NT / 32];

  const int qi = blockIdx.x;
  const int ncand = kg * ft::GROUP;
  for (int e = threadIdx.x; e < d; e += NT)
    qs[e] = q[static_cast<size_t>(qi) * d + e];
  for (int j = threadIdx.x; j < kg; j += NT)
    g[j] = min(max(gidx[static_cast<size_t>(qi) * kg + j], 0), ngroups - 1);
  for (int i = threadIdx.x; i < (ncand + 31) / 32; i += NT) excl[i] = 0u;
  __syncthreads();

  for (int c = threadIdx.x; c < ncand; c += NT) {
    const size_t row = static_cast<size_t>(g[c / ft::GROUP]) * ft::GROUP
                       + c % ft::GROUP;
    const uint4* v = reinterpret_cast<const uint4*>(
        static_cast<const char*>(db) + row * d * ESZ);
    float acc = 0.f;
    for (int e = 0; e < d; e += EPC) {
      float x[EPC];
      const uint4 w = __ldg(v + e / EPC);
      if constexpr (FMT == INT8) {
        ft::unpack16_i8(w, x);
      } else if constexpr (FMT == F16) {
        ft::unpack8_f16(w, x);
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
    const float sc = (L2 ? 2.f * acc : acc) - vn[row];
    const int j = c / ft::GROUP;
    const bool drop = row >= static_cast<size_t>(ntotal)
                      || (j > 0 && g[j] == g[j - 1]);
    s[c] = drop ? -INFINITY : sc;
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float m;
    int col;
    ft::extract_step<NT>(s, ncand, excl, fs, is, m, col);
    if (threadIdx.x == 0) {
      const int c = min(col, ncand - 1);
      const size_t o = static_cast<size_t>(qi) * k + j;
      // the column's own score (m's bits but on a -0.0 / +0.0 tie), as K9
      vals[o] = col < ncand ? s[col] : __uint_as_float(ft::QNAN);
      ids[o] = g[c / ft::GROUP] * ft::GROUP + c % ft::GROUP;
      if (col < ncand) excl[col >> 5] |= 1u << (col & 31);
    }
    __syncthreads();
  }
}

template <int FMT>
void launch(const float* q, const void* db, const float* vn,
            const int32_t* gidx, float* vals, int32_t* ids, int nq, int d,
            int kg, int ngroups, int ntotal, int k, int l2, cudaStream_t s) {
  if (l2)
    rescore_select_kernel<true, FMT><<<nq, NT, 0, s>>>(
        q, db, vn, gidx, vals, ids, d, kg, ngroups, ntotal, k);
  else
    rescore_select_kernel<false, FMT><<<nq, NT, 0, s>>>(
        q, db, vn, gidx, vals, ids, d, kg, ngroups, ntotal, k);
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
      || k > kg * ft::GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const float*>(q);
  auto* n = static_cast<const float*>(vn);
  auto* gi = static_cast<const int32_t*>(gidx);
  auto* v = static_cast<float*>(vals);
  auto* o = static_cast<int32_t*>(ids);
  switch (fmt) {
    case BF16: launch<BF16>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2, s); break;
    case INT8: launch<INT8>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2, s); break;
    case F16: launch<F16>(qq, db, n, gi, v, o, nq, d, kg, ngroups, ntotal, k, l2, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def _k10_legacy(text):
    """rescore_groups.cu with the thread-per-row kernel in the f32, pair
    and f16 modes (the f16 rows by PR 10's decode)."""
    return _patch(text, [(EPC, EPC_F32), (UNPACK, UNPACK_LEGACY),
                         (CASE, CASE_LEGACY), (PAIR_CASE, PAIR_CASE_LEGACY),
                         (F16_CASE, F16_CASE_LEGACY),
                         (TPR_AT, LEGACY_DECODE + TPR_AT),
                         (PAIR_AT, PAIR_LEGACY + PAIR_AT)])


def _k11_legacy():
    """PR 10's rescore_select.cu, its f16 rows by PR 10's decode."""
    return _patch(LEGACY_K11, [
        ("ft::unpack8_f16(w, x);", "legacy_unpack8_f16(w, x);"),
        ("\nnamespace {\n", "\nnamespace {\n\n" + LEGACY_DECODE)])


def legacy_sources():
    """{name: (source, header overrides)}: the two earlier kernels that
    chip_smoke.py and the card tests hold K10's f16 mode (fmt 3 of
    ``ft_rescore_groups``) and K11 (``ft_rescore_select``) against."""
    return {"k10_legacy": (_k10_legacy(SRC.read_text()), {}),
            "k11_legacy": (_k11_legacy(), {})}


def variants(mode):
    """{name: (source, {header: text})}: the variants of ``mode``."""
    if mode == "k11":
        text = SRC_K11.read_text()
        out = {"kernel": (text, {}), "legacy": (_k11_legacy(), {})}
        for n in (1, 3, 4):
            out[f"cluster{n}"] = (_patch(text, [(CLUSTER, CLUSTER.replace(
                "2", str(n)))]), {})
        out["late_wait"] = (_patch(text, LATE_WAIT), {})
        out["no_select"] = (_patch(text, [(LEADER, LEADER.replace(
            "cr != 0", "cr != 0 || k > 0"))]), {})
        for n in (2, 3, 6, 8):
            out[f"stages{n}"] = (_patch(text, [(STAGES_K11, STAGES_K11.replace(
                "4", str(n)))]), {})
        return out
    text = SRC.read_text()
    legacy = _k10_legacy(text)
    if mode == "f16":
        out = {"kernel": (text, {}), "legacy": (legacy, {})}
        for n in (1, 3, 4, 6):
            out[f"stages{n}"] = (_patch(text, [(STAGES_K10, STAGES_K10.replace(
                "2;", f"{n};"))]), {})
        out["no_swizzle"] = (text, _no_swizzle())
        out["no_decode"] = (text, _stream_h([(DECODE, DECODE.replace(
            "unpack8_f16", "unpack8"))]))
        out["int_decode"] = (text, _stream_h([
            (DECODE, DECODE.replace("unpack8_f16", "legacy_unpack8_f16")),
            (STREAM_AT, LEGACY_DECODE + STREAM_AT)]))
        return out
    if mode == "pair":
        return {
            "kernel": (text, {}),
            "legacy": (legacy, {}),
            "one_stage": (_patch(text, [(STAGES_K10, STAGES_K10.replace(
                "? 3", "? 1"))]), {}),
            "stages6": (_patch(text, [(STAGES_K10, STAGES_K10.replace(
                "? 3", "? 6"))]), {}),
            "no_swizzle": (text, _no_swizzle()),
        }
    return {
        "kernel": (text, {}),
        "legacy": (legacy, {}),
        "pregrouped": (_patch(text, [(GROUPING, "")]), {}),
        "query_major": (_patch(text, [(GROUPING, IDENTITY_LAUNCH),
                                      (PIECE_AT, IDENTITY + PIECE_AT)]), {}),
        "cap32": (_patch(text, [(CAP, "constexpr int F32_CAP = 32;")]), {}),
        "no_pad": (_patch(text, [(STRIDE, STRIDE.replace(" | 1", ""))]), {}),
        "lb1": (_patch(text, [(BOUNDS, BOUNDS.replace(
            "(ft::GROUP, 3)", "(ft::GROUP)"))]), {}),
    }


def start_build(nvcc, flags, tmp, srcs):
    """Start one nvcc a variant, side by side, each into its own library
    under ``tmp``: {name: (process, library path)}."""
    procs = {}
    for name, (text, headers) in srcs.items():
        d = Path(tmp) / name
        d.mkdir()
        (d / "k.cu").write_text(text)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(headers.get(h.name, h.read_text()))
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-shared", "-Xptxas", "-v", "-o", str(d / "lib.so"),
             str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            d / "lib.so")
    return procs


def finish_build(procs, verbose=True):
    """{name: ctypes library} once every build has ended; raises on the
    first that failed."""
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (p, path) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"k10_variants: {name} did not build:\n{err}")
        regs = [line.split("Used ")[1].split(",")[0]
                for line in err.splitlines() if "Used " in line]
        if verbose:
            print(f"{name}: built ({', '.join(sorted(set(regs)))})",
                  flush=True)
        lib = ctypes.CDLL(str(path))
        if hasattr(lib, "ft_rescore_groups"):
            lib.ft_rescore_groups.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                              I, P, P]
            lib.ft_rescore_groups.restype = I
            lib.ft_rescore_f32_work.argtypes = [I, I, I]
            lib.ft_rescore_f32_work.restype = ctypes.c_longlong
        if hasattr(lib, "ft_rescore_select"):
            lib.ft_rescore_select.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                              I, I, I, P]
            lib.ft_rescore_select.restype = I
        libs[name] = lib
    return libs


def call_rescore(torch, lib, fmt, q, db, db2, vn, gidx, out, metric_l2=True,
                 work=None):
    """One ``ft_rescore_groups`` launch of ``lib`` on the current stream."""
    nq, d = q.shape
    kg = gidx.shape[1]
    rc = lib.ft_rescore_groups(
        q.data_ptr(), db.data_ptr(), None if db2 is None else db2.data_ptr(),
        vn.data_ptr(), gidx.data_ptr(), out.data_ptr(), nq, d, kg,
        vn.shape[0] // 128, int(metric_l2), fmt,
        None if work is None else work.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ft_rescore_groups fmt {fmt}: launch failed ({rc})")


def call_select(torch, lib, fmt, q, db, vn, gidx, ntotal, k, vals, ids,
                metric_l2=True):
    """One ``ft_rescore_select`` launch of ``lib`` on the current stream."""
    nq, d = q.shape
    kg = gidx.shape[1]
    nv = vn.shape[0]
    rc = lib.ft_rescore_select(
        q.data_ptr(), db.data_ptr(), vn.data_ptr(), gidx.data_ptr(),
        vals.data_ptr(), ids.data_ptr(), nq, d, kg, nv // 128,
        max(0, min(ntotal, nv)), k, int(metric_l2), fmt,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ft_rescore_select fmt {fmt}: launch failed ({rc})")


def ivf_inputs(torch, chip_smoke, ft, nprobes):
    """[(label, fmt, q, rows, None, vn, cidx)] of the ivf_1m f32 index's
    fine scan at each nprobe."""
    from faiss_tpu_torch import ivf as ivf_mod
    from faiss_tpu_torch.ops import fused

    xb, xq = chip_smoke.ivf_data()
    idx = ft.TorchIndexIVFFlat(chip_smoke.D, chip_smoke.NLIST, device="cuda")
    idx.train(xb)
    idx.add(xb)
    nv = idx._data.shape[0]
    vn = fused._premask_norms(idx._norms, nv, nv, idx.metric, idx._ids >= 0)
    out = []
    for nprobe in nprobes:
        idx.nprobe = nprobe
        q, _, _, npb, nbudget, _ = idx._prep_search(xq, None)
        cidx, _ = ivf_mod._chunk_ids(idx._probe(q, npb), idx._counts_dev,
                                     idx._ctable, nbudget)
        out.append((f"nprobe {nprobe}", 4, q, idx._data, None, vn, cidx))
    return out


def _data(chip_smoke):
    import numpy as np

    rng = np.random.default_rng(chip_smoke.SEED)
    xb = rng.standard_normal((chip_smoke.NV, chip_smoke.D), dtype=np.float32)
    xq = rng.standard_normal((chip_smoke.NQ, chip_smoke.D), dtype=np.float32)
    return xb, xq


def _caught(ft, idx, xq, k, want):
    """The arguments of the search's rescore_groups calls that ``want``
    accepts, caught as fused_search makes them."""
    from faiss_tpu_torch.ops import fused

    seen = []
    real = fused.rescore_groups

    def catch(queries, db, vn, gidx, *, metric, db2=None):
        if want(db, db2):
            seen.append((queries, db, db2, vn, gidx))
        return real(queries, db, vn, gidx, metric=metric, db2=db2)

    fused.rescore_groups = catch
    try:
        idx.search(xq, k)
    finally:
        fused.rescore_groups = real
    return seen


def pair_inputs(torch, chip_smoke, ft, nvs):
    """[(label, fmt, q, hi, lo, vn, gidx, None)]: the one stage-3a call of an
    f32 L2 search over each --nv rows (chip_smoke.py's data: its 1M rows,
    then rows from default_rng(SEED + 2) in 1M batches, as its f32_10m)."""
    import numpy as np

    from faiss_tpu_torch import MetricType

    xb, xq = _data(chip_smoke)
    more = np.random.default_rng(chip_smoke.SEED + 2)
    out = []
    for nv in nvs:
        idx = ft.TorchIndexFlat(chip_smoke.D, metric=MetricType.L2,
                                device="cuda")
        idx.add(xb[:nv])
        while idx.ntotal < nv:
            idx.add(more.standard_normal(
                (min(chip_smoke.NV, nv - idx.ntotal), chip_smoke.D),
                dtype=np.float32))
        seen = _caught(ft, idx, xq, chip_smoke.K,
                       lambda db, db2: db2 is not None)
        if len(seen) != 1:
            raise RuntimeError(f"k10_variants: {len(seen)} stage-3a calls")
        q, hi, lo, vn, gidx = seen[0]
        out.append((f"nv {nv}", 1, q, hi, lo, vn, gidx, None))
        del idx
    return out


def flat_inputs(torch, chip_smoke, ft, storages):
    """[(label, fmt, q, rows, None, vn, gidx, ntotal)]: the phase-3 call of
    an L2 search over chip_smoke.py's 1M rows in each storage (bf16: the
    two-plane search after the first, which pins it)."""
    from faiss_tpu_torch import MetricType

    fmts = {"bf16": 0, "int8": 2, "f16": 3}
    xb, xq = _data(chip_smoke)
    out = []
    for st in storages:
        idx = ft.TorchIndexFlat(chip_smoke.D, metric=MetricType.L2,
                                storage=st, device="cuda")
        idx.add(xb)
        idx.search(xq, chip_smoke.K)   # the one-plane certificate's pin
        seen = _caught(ft, idx, xq, chip_smoke.K,
                       lambda db, db2: db2 is None)
        if not seen:
            raise RuntimeError(f"k10_variants: no phase-3 call ({st})")
        q, db, _, vn, gidx = seen[0]
        out.append((f"{st} 1M", fmts[st], q, db, None, vn, gidx, idx.ntotal))
    return out


def _describe(label, gidx, ngroups):
    from faiss_tpu_torch.ops import kernels

    _, run = gidx.clamp(0, ngroups - 1).unique(return_counts=True)
    cap = kernels.RESCORE_F32_CAP
    pieces = int(((run + cap - 1) // cap).sum())
    print(f"{label}: nq {gidx.shape[0]}, kg {gidx.shape[1]}, positions "
          f"{gidx.numel()}; distinct groups {run.numel()}, the longest run "
          f"{int(run.max())}; group reads: {pieces} in pieces of ≤ {cap}, "
          f"{gidx.numel()} one per position", flush=True)


def _timed(torch, chip_smoke, libs, label, reps, run, result):
    """Each variant bit for bit against the kernel (``result(name)``: its
    outputs as int32 views after ``run(lib, name)``), then timed by graph
    replay in two rounds. Returns the names that differed (untimed)."""
    bad = set()
    for rnd in range(2):
        for name, lib in libs.items():
            if name in bad:
                continue

            def run_it(lib=lib, name=name):
                run(lib, name)
            run_it()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       zip(result(name), result("kernel")))
            if not same and name not in DIAGNOSTIC:
                print(f"{label} {name}: DIFFERS from the kernel; not timed",
                      flush=True)
                bad.add(name)
                continue
            ms = chip_smoke.graph_ms(torch, run_it, reps)
            tag = "bit for bit" if same else "other scores"
            print(f"{label} round {rnd} {name}: {ms:.4f} ms ({tag})",
                  flush=True)
    return bad


def time_rescore(torch, chip_smoke, libs, case, reps):
    label, fmt, q, db, db2, vn, gidx, _ = case
    nq = q.shape[0]
    kg = gidx.shape[1]
    ngroups = vn.shape[0] // 128
    _describe(label, gidx, ngroups)
    nwork = libs["kernel"].ft_rescore_f32_work(nq, kg, ngroups)
    work = {name: torch.empty((nwork,), dtype=torch.int32, device="cuda")
            for name in libs}
    out = {name: torch.empty((nq, kg * 128), device="cuda") for name in libs}

    def run(lib, name, w=None):
        call_rescore(torch, lib, fmt, q, db, db2, vn, gidx, out[name],
                     work=work[name] if w is None else w)

    if "pregrouped" in libs:   # its grouping, made by the kernel
        run(libs["kernel"], "pregrouped", work["pregrouped"])
    return _timed(torch, chip_smoke, libs, label, reps, run,
                  lambda name: (out[name].view(torch.int32),))


def time_select(torch, chip_smoke, libs, case, reps):
    label, fmt, q, db, _, vn, gidx, ntotal = case
    nq = q.shape[0]
    k = chip_smoke.K
    _describe(label, gidx, vn.shape[0] // 128)
    vals = {name: torch.empty((nq, k), device="cuda") for name in libs}
    ids = {name: torch.empty((nq, k), dtype=torch.int32, device="cuda")
           for name in libs}

    def run(lib, name):
        call_select(torch, lib, fmt, q, db, vn, gidx, ntotal, k, vals[name],
                    ids[name])

    return _timed(torch, chip_smoke, libs, label, reps, run,
                  lambda name: (vals[name].view(torch.int32), ids[name]))


def other_modes_bitwise(torch, libs) -> bool:
    """The bf16, pair, int8 and f16 modes (fmt 0-3) through the kernel's
    library and the legacy one, at nq 104, kg 14, d 128 over 8192 groups
    of random rows: True when every mode's scores are equal bit for bit."""
    from faiss_tpu_torch.storage import encode_f16_bits, split_f32_bf16

    gen = torch.Generator(device="cuda").manual_seed(1)
    nq, d, kg, ng = 104, 128, 14, 8192
    x = torch.randn((ng * 128, d), device="cuda", generator=gen)
    q = torch.randn((nq, d), device="cuda", generator=gen)
    vn = (x * x).sum(-1)
    gidx = torch.randint(0, ng, (nq, kg), device="cuda", generator=gen,
                         dtype=torch.int32)
    hi, lo = split_f32_bf16(x)
    codes = torch.randint(-127, 128, (ng * 128, d), device="cuda",
                          generator=gen, dtype=torch.int8)
    modes = {0: (x.to(torch.bfloat16), None), 1: (hi, lo), 2: (codes, None),
             3: (encode_f16_bits(x), None)}
    same = True
    for fmt, (db, db2) in modes.items():
        outs = []
        for name in ("kernel", "legacy"):
            out = torch.empty((nq, kg * 128), device="cuda")
            call_rescore(torch, libs[name], fmt, q, db, db2, vn, gidx, out)
            outs.append(out)
        torch.cuda.synchronize()
        eq = torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
        print(f"fmt {fmt}: the kernel's library and the legacy one "
              f"{'agree bit for bit' if eq else 'DIFFER'}", flush=True)
        same &= eq
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("f32", "pair", "f16", "k11"),
                    default="f32")
    ap.add_argument("--only", default="",
                    help="build and time only these variants (comma list)")
    ap.add_argument("--nprobe", default="16", help="--mode f32")
    ap.add_argument("--nv", default="1000000,10000000", help="--mode pair")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k10_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import faiss_tpu_torch as ft
    from faiss_tpu_torch.ops import kernels

    print(ft.gpu_name_and_power_limit(), flush=True)
    only = set(args.only.split(",")) - {""}
    bad = set()
    with tempfile.TemporaryDirectory() as tmp:
        srcs = {name: v for name, v in variants(args.mode).items()
                if not only or name in only or name == "kernel"}
        libs = finish_build(start_build(kernels._nvcc(), kernels.NVCC_FLAGS,
                                        tmp, srcs))
        if args.mode == "pair":
            cases = pair_inputs(torch, chip_smoke, ft,
                                [int(x) for x in args.nv.split(",")])
        elif args.mode == "f16":
            cases = flat_inputs(torch, chip_smoke, ft, ["f16"])
        elif args.mode == "k11":
            cases = flat_inputs(torch, chip_smoke, ft, ["bf16", "int8", "f16"])
        else:
            cases = [(*c, None) for c in ivf_inputs(
                torch, chip_smoke, ft, [int(x) for x in args.nprobe.split(",")])]
        for case in cases:
            timer = time_select if args.mode == "k11" else time_rescore
            bad |= timer(torch, chip_smoke, libs, case, args.reps)
        if (args.mode == "f32" and "legacy" in libs
                and not other_modes_bitwise(torch, libs)):
            bad.add("other modes")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
