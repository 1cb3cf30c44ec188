// The streamed gather-rescore, shared by K10's pair and f16 modes
// (rescore_groups.cu) and by the rescore-select kernel (K11,
// rescore_select.cu): the row formats, the ring of TMA tiles on full /
// empty mbarriers, and the chain that scores a row.
//
// A nominated group's 128 rows are one contiguous run of each plane. A d
// slice of them, one 128-byte row each (64 bf16 / f16 elements, or 128
// int8 codes), is one TMA tile of 128 rows × 128 bytes, 16 KB, 128-byte
// swizzled: 16-byte unit u of row r lies at r·128 + 16·(u ^ r % 8), so the
// 8 rows of a quarter-warp's 16-byte reads fall in 8 different bank groups.
// One producer thread keeps a ring of STAGES stages full (a stage is a
// slice of every plane of the format); 128 consumer threads read it, thread
// r row r, unit by unit in index order, and keep one fmaf chain over d on
// the fp32 query staged in shared memory: the thread-per-row kernel's
// arithmetic, so its scores bit for bit.
#pragma once

#include "common.cuh"
#include "tma.cuh"

namespace ft {

// ft_rescore_groups' row formats (ft_rescore_select takes BF16, INT8, F16)
enum Rows { BF16 = 0, PAIR = 1, INT8 = 2, F16 = 3, F32 = 4 };

// A group id past either end, clamped into range as every mode clamps it.
__device__ __forceinline__ int clamp_group(int g, int ngroups) {
  return min(max(g, 0), ngroups - 1);
}

constexpr int STREAM_TILE = GROUP * TMA_ROW_BYTES;   // 16 KB: a slice, a plane
constexpr int STREAM_CONS = GROUP;   // consumer threads: thread r scores row r
constexpr int STREAM_THREADS = STREAM_CONS + 32;   // and one producer warp

// A row format of the stream: its planes (tiles a stage), the elements of a
// 16-byte unit and of a slice, and the TMA element type.
template <int FMT>
struct Stream {
  static_assert(FMT == BF16 || FMT == PAIR || FMT == INT8 || FMT == F16,
                "a streamed row format");
  static constexpr int PLANES = FMT == PAIR ? 2 : 1;
  static constexpr int EPU = FMT == INT8 ? 16 : 8;
  static constexpr int KC = EPU * TMA_ROW_BYTES / 16;
  static constexpr int STAGE = PLANES * STREAM_TILE;
  static constexpr CUtensorMapDataType TYPE =
      FMT == INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_UINT16;   // TMA converts nothing
};

// Unit u of row r's slice in a stage (`row` = the stage + r·128), widened
// exactly to fp32: bf16 by a shift, the pair as hi + lo (exact), f16 by
// unpack8_f16 (e=31 → ±inf), int8 by conversion.
template <int FMT>
__device__ __forceinline__ void stream_unit(const uint8_t* row, int u, int r,
                                            float (&x)[Stream<FMT>::EPU]) {
  const int off = 16 * (u ^ (r & 7));
  const uint4 w = *reinterpret_cast<const uint4*>(row + off);
  if constexpr (FMT == INT8) {
    unpack16_i8(w, x);
  } else if constexpr (FMT == F16) {
    unpack8_f16(w, x);
  } else {
    unpack8(w, x);
    if constexpr (FMT == PAIR) {
      float y[8];
      unpack8(*reinterpret_cast<const uint4*>(row + STREAM_TILE + off), y);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] += y[i];   // exact: hi + lo
    }
  }
}

// acc continued over the nu units of row r's slice, q's slice at qk (shared
// memory, 16-byte aligned): fmaf in index order, one rounding a step.
template <int FMT>
__device__ __forceinline__ float stream_chain(const uint8_t* row, int r,
                                              const float* qk, int nu,
                                              float acc) {
  constexpr int EPU = Stream<FMT>::EPU;
#pragma unroll 4
  for (int u = 0; u < nu; ++u) {
    float x[EPU];
    stream_unit<FMT>(row, u, r, x);
#pragma unroll
    for (int i = 0; i < EPU; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qk + EPU * u + i);
      acc = fmaf(a.x, x[i], acc);
      acc = fmaf(a.y, x[i + 1], acc);
      acc = fmaf(a.z, x[i + 2], acc);
      acc = fmaf(a.w, x[i + 3], acc);
    }
  }
  return acc;
}

// The ring: STAGES stages of Stream<FMT>::STAGE bytes at a 1024-byte
// aligned address (the swizzle's span), then the full and empty barriers.
// Producer and consumers each walk it with their own (stage, phase).
template <int FMT, int STAGES>
struct Ring {
  static constexpr int BARS = (2 * STAGES * 8 + 15) / 16 * 16;   // bytes
  static constexpr size_t BYTES =
      1024 + static_cast<size_t>(STAGES) * Stream<FMT>::STAGE + BARS;

  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int stage = 0;
  uint32_t phase = 0;

  // the ring at the start of dynamic shared memory `smem`; what follows it
  // starts at `after()`
  __device__ explicit Ring(uint8_t* smem)
      : base(reinterpret_cast<uint8_t*>(
            (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023))),
        full(reinterpret_cast<uint64_t*>(
            base + STAGES * Stream<FMT>::STAGE)),
        empty(full + STAGES) {}
  __device__ uint8_t* after() const {
    return reinterpret_cast<uint8_t*>(full) + BARS;
  }

  // one thread, before the block's first barrier
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, STREAM_CONS / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
  // producer: slice kc of the group whose first row is `row` into the next
  // stage, once the consumers have released it; m0, m1: the planes' maps
  // (__grid_constant__ kernel parameters: TMA reads a map from there)
  __device__ void load(const CUtensorMap* m0, const CUtensorMap* m1, int kc,
                       int row) {
    mbar_wait(empty + stage, phase ^ 1u);
    uint8_t* st = base + stage * Stream<FMT>::STAGE;
    mbar_expect_tx(full + stage, Stream<FMT>::STAGE);
    tma_load(m0, st, full + stage, kc * Stream<FMT>::KC, row);
    if constexpr (Stream<FMT>::PLANES == 2)
      tma_load(m1, st + STREAM_TILE, full + stage, kc * Stream<FMT>::KC, row);
    advance();
  }
  // consumer thread r: acc continued over slice kc of its row (q staged at
  // qs), the stage released by its warp
  __device__ float score(int r, const float* qs, int kc, int d, float acc) {
    mbar_wait(full + stage, phase);
    const int nu = min(Stream<FMT>::KC, d - kc * Stream<FMT>::KC)
                   / Stream<FMT>::EPU;
    acc = stream_chain<FMT>(base + stage * Stream<FMT>::STAGE
                                + r * TMA_ROW_BYTES,
                            r, qs + kc * Stream<FMT>::KC, nu, acc);
    __syncwarp();   // the warp's reads of the stage have ended
    if ((r & 31) == 0) mbar_arrive(empty + stage);
    advance();
    return acc;
  }
};

// the 128 consumer threads (named barrier 1; the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(STREAM_CONS) : "memory");
}

// The tensor maps of a format's planes (db, and db2 for the pair) over
// rows × d elements, one 128-row × 128-byte tile a load.
template <int FMT>
inline bool stream_maps(CUtensorMap (&maps)[2], const void* db,
                        const void* db2, int d, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const void* planes[2] = {db, FMT == PAIR ? db2 : db};
  for (int p = 0; p < 2; ++p)
    if (!plane_map(enc, &maps[p], Stream<FMT>::TYPE, planes[p], d, rows,
                   GROUP))
      return false;
  return true;
}

// Per device and kernel: SM count and opt-in shared memory, and whether the
// kernel may take it (set once, before any graph capture can reach it).
struct StreamDevice {
  int sms = 0;
  int smem_optin = 0;
  bool attr_set = false;
};

template <typename Kernel>
inline cudaError_t stream_device(StreamDevice (&info)[64], Kernel kernel,
                                 StreamDevice*& out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  StreamDevice& di = info[dev];
  if (di.sms == 0) {
    e = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&di.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) {
      di.sms = 0;
      return e;
    }
  }
  if (!di.attr_set) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             di.smem_optin);
    if (e != cudaSuccess) return e;
    di.attr_set = true;
  }
  out = &di;
  return cudaSuccess;
}

}  // namespace ft
