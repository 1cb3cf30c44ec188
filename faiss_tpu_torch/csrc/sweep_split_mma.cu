// The sweeps with two query planes on the tensor cores: the f32 pair sweep
// (K3) and the bf16 rows' sweep (K1), one kernel template over the number
// of db planes.
//
// Replaces faiss_tpu/ops/pallas_fused.py _kernel_split (:239) and
// _kernel_qpair (:174), launched by _sweep_call (:376) from
// groupmax_scores, with their shared _epilogue. The fp32 query is its
// bit-mask split qh, ql. The f32 rows are stored as bf16 planes dh, dl
// (v ≈ dh + dl); the bf16 rows are v itself. For every query q and 128-row
// group g:
//     K3: acc = (qh·dh + qh·dl) + ql·dh    (three fp32 accumulators, added
//     K1: acc = qh·v + ql·v                 (two)  once at the end, left to
//                                                  right)
//     gm[q, g] = max over the rows r of g of  2·acc − vn[r]  (L2)
//                                         or    acc − vn[r]  (IP)
// with vn the pre-masked norm stream (+inf on padding and filtered rows).
// With a non-null bmax it also writes the supergroup maxes
//     bmax[q, b] = max of gm[q, 8b … 8b+7]
// (_sweep_call(block_max=True), the _epilogue's second output), which equal
// fused.block_max_plain(gm) bit for bit: a block owns whole supergroups and
// folds their 8 group maxes itself, so no atomics are needed.
//
// What bounds it on an H100: at nq 104 (a query tile of 128), 1M×128 K3
// reads 512 MB of planes (0.155 ms at 3.35 TB/s) for 3 × 104 × 1M × 128
// FMAs, 8.0e10 FLOP (0.08 ms at 989 TFLOP/s in bf16); on CUDA cores the
// same work needs 1.19 ms at the 67 TFLOP/s fp32 peak, so the products run
// on the tensor cores (wgmma, bf16 in, fp32 accumulate) and the bytes bound
// it. K1 reads half the bytes (256 MB, 0.079 ms) for two thirds of the
// products. Design:
//   - one block per SM (persistent), 288 threads: two consumer warpgroups,
//     one per 64 queries of the block's 128-query tile (wgmma's M side),
//     and one producer warp;
//   - the block walks a contiguous run of whole supergroups (8 groups);
//     each group is 128 / BN tiles of BN rows (wgmma's N side: 64 for K3,
//     BN for K1); each tile runs over d in chunks of 64;
//   - the producer's TMA loads each (group, tile, chunk) tile of each db
//     plane (BN rows × 64 bf16, 128-byte swizzled) into a ring of stages
//     in shared memory (up to 8 of K3's 16 KB, 16 of K1's 8 KB at BN 64),
//     with full / empty mbarriers; the query planes' chunks (128 × 64 each)
//     stay resident for d ≤ 256, else ride each stage;
//   - a consumer runs its products × 4 k-steps of wgmma m64nBNk16 per
//     chunk, one accumulator set of BN/2 registers per term, and releases
//     a stage once the next chunk's products are issued (wgmma.wait_group
//     1); the tile's norms are loaded before its products; per tile the
//     epilogue runs in registers: 2·((a1 + a2) + a3) − vn (K1: 2·(a1 + a2)
//     − vn), a max over the thread's columns and a 4-lane shuffle; the
//     group max goes to gm, and at a supergroup's end to bmax;
//   - K1: the two warpgroups take turns issuing a tile's products (named
//     barriers), so that one's epilogue runs under the other's products;
//     where d takes two k chunks (64 < d ≤ 128, the main path's 128) its
//     query planes are wgmma A fragments in registers (64 registers, read
//     once from device memory), which halves the shared-memory reads of
//     the products;
//   - a d that is not a multiple of 64 gets its k-tail zero-filled by TMA
//     (out-of-bounds fill); its k-steps add exact zeros.
// scripts/k3_variants.py times the kernels against patched copies of
// themselves (CUDA graph replay, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// has the numbers): at 1M K3 takes ≈ 0.21 ms, its loads and barriers alone
// ≈ 0.19, its products alone ≈ 0.18, so the two overlap and the loads
// bound it; K1 takes ≈ 0.15 ms (1.9× its bound), its loads, barriers and
// epilogues alone ≈ 0.12, its products alone ≈ 0.135: the two overlap
// imperfectly, and a chunk's steps (full-barrier wait, wait_group, the
// tile's epilogue and turn) cost more than its 8 KB take to arrive.
// Slower, and dropped: releasing a stage only
// once its own products end (wgmma.wait_group 0); N = 128 (K3: one
// m64n128k16 a term, 192 accumulators, setmaxnreg 232 / 40, 384 threads;
// K1: 2 × 64 accumulators); an even split by groups with the shared
// supergroups folded by atomics (equal at 1M, slower at 10M); loading the
// norms in the epilogue; for K1, two accumulator sets with a tile's
// epilogue under the next tile's first chunk (ptxas serializes the wgmma
// when accumulator registers are read while another wgmma is pending,
// C7514); for K3, the turns (no gain at 10M). nvcc -Xptxas -v: K3 144
// registers, K1 168 with A in registers (8 bytes of stack), 114 without;
// no spills.
// The TMA descriptors come from cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point, so the library needs no -lcuda.
//
// Arithmetic (what the certificate ops/fused._sweep_eps(accum="mma")
// assumes). Each product term a·b (a a query plane, b a db plane, d long)
// accumulates in one fp32 wgmma accumulator over ⌈d/16⌉ k-steps. A k-step
// adds 16 bf16×bf16 products, each exact in fp32, to the accumulator D;
// the tensor core's sum is not proven round-to-nearest and may lack guard
// bits (Fasi, Higham, Mikaitis, Pranesh, PeerJ CS 2021, on earlier NVIDIA
// tensor cores: alignment to the largest exponent by truncation, then a
// truncating normalisation). The model charges each step j:
//   - every one of its 17 addends (16 products and D) may lose up to
//     2u·M_j, M_j the largest addend magnitude (u = 2^-24; the unit in the
//     last place at M_j's exponent is ≤ 2u·M_j);
//   - the normalisation of the result may lose 2u·|D_j|.
// With |products|, |D_j| ≤ ‖a‖·‖b‖ (Cauchy-Schwarz, to first order), a step
// errs ≤ (17·2u + 2u)·‖a‖·‖b‖ = 36u·‖a‖·‖b‖, a term ≤ 36·⌈d/16⌉·u·‖a‖·‖b‖.
// K3's three terms (‖qh‖·‖dh‖ ≤ (Q+R)·V, ‖qh‖·‖dl‖ ≤ (Q+R)·s0, ‖ql‖·‖dh‖
// ≤ L·V) then add in two round-to-nearest fp32 adds (≤ 2u·the same sum):
//     (36·⌈d/16⌉ + 2)·u·[(Q+R)·(V+s0) + L·V],
// about 2.2× the (d+2)·u of the CUDA-core fmaf chains at d = 128. K1's two
// (‖qh‖·‖v‖ ≤ (Q+R)·V, ‖ql‖·‖v‖ ≤ L·V) add in one (≤ u·the sum): the same
// budget with s0 = 0, as _sweep_eps(accum="mma") charges bf16 rows.
// tests/test_torch_mma_eps.py emulates the model's truncating block sums on
// adversarial rows. A k-step past d adds exact zeros to D, the largest
// addend, and loses nothing: ⌈d/16⌉ steps are charged.
#include <cuda.h>   // CUtensorMap and its enums (types only)

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NCONS = 256;             // two consumer warpgroups
constexpr int NTHREADS = NCONS + 32;   // and one producer warp
constexpr int QTILE = 128;             // queries a block
constexpr int KC = 64;                 // d chunk: 64 bf16 = one 128-byte row
constexpr int A_PLANE = QTILE * KC * 2;            // 16 KB
constexpr int A_BYTES = 2 * A_PLANE;               // both query planes
constexpr int MAX_RESIDENT_KC = 4;     // resident query planes up to d 256
constexpr int MAX_STAGES = 16;
constexpr int K1_BN = 64;              // K1's N side (bf16 rows)

// The shapes of one instance: DBP db planes (2: K3's f32 planes, 1: K1's
// bf16 rows), BN rows a wgmma N side.
template <int DBP, int BN>
struct Shape {
  static constexpr int TERMS = DBP == 2 ? 3 : 2;   // product terms
  static constexpr int ACC = BN / 2;               // accumulators a term
  static constexpr int TILES = ft::GROUP / BN;     // N tiles a group
  static constexpr int B_PLANE = BN * KC * 2;      // one db plane's tile
  static constexpr int B_BYTES = DBP * B_PLANE;
  // stages of ≥ 16 KB: 8 (K3's measured ring); K1's 8 KB tiles: 16
  static constexpr int STAGES = B_BYTES >= 16384 ? 8 : MAX_STAGES;
  // the warpgroups take turns issuing a tile's products (K1)
  static constexpr bool ORDERED = DBP == 1;
};

// -- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// One 2-D tile of a tensor map into shared memory; completion is counted
// in bytes on `bar`. c0: the element along d, c1: the row.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzled as TMA writes it: 8-row atoms 1024 bytes apart (SBO), layout type
// 1 (SWIZZLE_128B). The next 16-element k-step is 32 bytes on: +2.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(1) << 16)       // LBO (unused here)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// D (64×64 fp32, 32 registers a thread) = A·B + (scale_d ? D : 0), A 64×16
// and B 16×64 bf16, both K-major in shared memory.
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The wgmma of an N = BN tile: m64n64k16 (scripts/k3_variants.py's n128
// variant adds m64n128k16 for K1_BN 128).
// D (64×64 fp32) = A·B + (scale_d ? D : 0) with A 64×16 bf16 from
// registers: a warp's 16 rows as mma.m16n8k16's A fragment (a[0] row
// lane/4, columns 2·(lane%4) + {0, 1}; a[1] 8 rows down; a[2], a[3] 8
// columns on), two bf16 a register, the lower column in the low half.
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  static_assert(N == 64, "wgmma: N = 64 only");
  wgmma_64x64(d, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the group committed last have completed
__device__ __forceinline__ void wgmma_wait_prev() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Named barrier `id` (1, 2; 0 is __syncthreads') over the 256 consumer
// threads: sync waits for the other warpgroup's arrive.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// keeps the compiler from moving accumulator reads across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// The score of accumulator entry i: the terms added left to right, then
// the epilogue.
template <bool L2, int TERMS, int ACC>
__device__ __forceinline__ float score(const float (&acc)[TERMS][ACC], int i,
                                       float v) {
  float a = __fadd_rn(acc[0][i], acc[1][i]);
  if constexpr (TERMS == 3) a = __fadd_rn(a, acc[2][i]);
  return __fsub_rn(L2 ? __fmul_rn(2.f, a) : a, v);
}

// -- the kernel ----------------------------------------------------------

// tv_lo: the lo plane's map with DBP 2 (unread with DBP 1). RS (K1 with
// two k chunks, 64 < d ≤ 128): the query planes q_hi, q_lo (nq, d) are
// read once into registers as wgmma's A fragments, not by TMA, and only
// the rows ride the ring (nkc is 2).
template <bool L2, int DBP, int BN, bool RS>
__global__ void __launch_bounds__(NTHREADS, 1)
sweep_split_mma_kernel(const __grid_constant__ CUtensorMap tq_hi,
                       const __grid_constant__ CUtensorMap tq_lo,
                       const __grid_constant__ CUtensorMap tv_hi,
                       const __grid_constant__ CUtensorMap tv_lo,
                       const uint16_t* __restrict__ q_hi,
                       const uint16_t* __restrict__ q_lo,
                       const float* __restrict__ vn, float* __restrict__ gm,
                       float* __restrict__ bmax, int nq, int d, int ngroups,
                       int nkc, int resident, int nstages) {
  static_assert(!RS || (DBP == 1 && BN == 64), "RS: K1 at N = 64");
  using S = Shape<DBP, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = resident ? S::B_BYTES : A_BYTES + S::B_BYTES;
  uint8_t* a_res = smem;
  uint8_t* ring = smem + (resident && !RS ? nkc * A_BYTES : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + nstages * stage_bytes);
  uint64_t* empty = full + nstages;
  uint64_t* a_bar = empty + nstages;

  // this block's run of whole supergroups, and its 128-query tile
  const int nsg = (ngroups + 7) / 8;
  const int sg0 = static_cast<int>(
      static_cast<long long>(blockIdx.x) * nsg / gridDim.x);
  const int sg1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * nsg / gridDim.x);
  const int g0 = 8 * sg0, g1 = min(8 * sg1, ngroups);
  const int q_tile = blockIdx.y * QTILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < nstages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);     // one arrival per consumer warpgroup
    }
    mbar_init(a_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == NCONS / 32) {
    // producer: one thread issues every load
    if (lane != 0) return;
    if (resident && !RS) {
      mbar_expect_tx(a_bar, nkc * A_BYTES);
      for (int kc = 0; kc < nkc; ++kc) {
        tma_load(&tq_hi, a_res + kc * A_BYTES, a_bar, kc * KC, q_tile);
        tma_load(&tq_lo, a_res + kc * A_BYTES + A_PLANE, a_bar, kc * KC,
                 q_tile);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = g0; g < g1; ++g)
      for (int h = 0; h < S::TILES; ++h)
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(empty + stage, phase ^ 1u);
          uint8_t* st = ring + stage * stage_bytes;
          mbar_expect_tx(full + stage, stage_bytes);
          if (!resident) {
            tma_load(&tq_hi, st, full + stage, kc * KC, q_tile);
            tma_load(&tq_lo, st + A_PLANE, full + stage, kc * KC, q_tile);
            st += A_BYTES;
          }
          const int row = g * ft::GROUP + h * BN;
          tma_load(&tv_hi, st, full + stage, kc * KC, row);
          if constexpr (DBP == 2)
            tma_load(&tv_lo, st + S::B_PLANE, full + stage, kc * KC, row);
          if (++stage == nstages) {
            stage = 0;
            phase ^= 1u;
          }
        }
    return;
  }

  // consumers: warpgroup wg owns queries q_tile + 64·wg … +63; a thread
  // holds rows r0 = 16·(warp % 4) + lane / 4 and r0 + 8 of that M tile, and
  // columns 8j + 2·(lane % 4) + {0, 1} (j < BN/8) of each BN-row tile
  const int wg = warp >> 2;
  const int t = threadIdx.x & 127;
  const int q0 = q_tile + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const int q1 = q0 + 8;
  const size_t nsgs = static_cast<size_t>(ngroups / 8);
  if (resident && !RS) mbar_wait(a_bar, 0);

  int stage = 0, prev = -1;
  uint32_t phase = 0;
  float m0 = -INFINITY, m1 = -INFINITY, bm0 = -INFINITY, bm1 = -INFINITY;
  using Acc = float[S::TERMS][S::ACC];   // K3: qh·dh, qh·dl, ql·dh; K1:
                                         // qh·v, ql·v
  using Norms = float2[BN / 8];

  // RS: the warpgroup's 64 rows of both query planes for d ≤ 128 (8 k-steps
  // of 16), as A fragments; zero past nq and d (the rows' k-tail is zero
  // too: TMA's out-of-bounds fill)
  uint32_t aq[2][RS ? 8 : 1][4];
  if constexpr (RS) {
    const int kq = 2 * (lane & 3);
    auto frag = [&](const uint16_t* q, int row, int k) -> uint32_t {
      return row < nq && k < d
                 ? __ldg(reinterpret_cast<const uint32_t*>(
                       q + static_cast<size_t>(row) * d + k))
                 : 0u;
    };
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const uint16_t* q = p == 0 ? q_hi : q_lo;
        aq[p][ks][0] = frag(q, q0, 16 * ks + kq);
        aq[p][ks][1] = frag(q, q1, 16 * ks + kq);
        aq[p][ks][2] = frag(q, q0, 16 * ks + kq + 8);
        aq[p][ks][3] = frag(q, q1, 16 * ks + kq + 8);
      }
  }

  // one chunk's products into acc; then, once the chunk before it has been
  // read (wgmma.wait_group 1), that chunk's stage goes back to the producer
  auto issue = [&](Acc& acc, int kc) {
    mbar_wait(full + stage, phase);
    const uint8_t* st = ring + stage * stage_bytes;
    const uint8_t* a = resident ? a_res + kc * A_BYTES : st;
    const uint8_t* b = resident ? st : st + A_BYTES;
    const uint64_t dqh = sw128_desc(a + wg * (A_PLANE / 2));
    const uint64_t dql = sw128_desc(a + A_PLANE + wg * (A_PLANE / 2));
    const uint64_t dvh = sw128_desc(b);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int on = (kc | ks) != 0;   // step 0 starts from zero
      if constexpr (RS) {
        wgmma_rs_64x64(acc[0], aq[0][4 * kc + ks], dvh + 2 * ks, on);
        wgmma_rs_64x64(acc[1], aq[1][4 * kc + ks], dvh + 2 * ks, on);
        continue;
      }
      wgmma<BN>(acc[0], dqh + 2 * ks, dvh + 2 * ks, on);
      if constexpr (DBP == 2) {
        const uint64_t dvl = sw128_desc(b + S::B_PLANE);
        wgmma<BN>(acc[1], dqh + 2 * ks, dvl + 2 * ks, on);
      }
      wgmma<BN>(acc[S::TERMS - 1], dql + 2 * ks, dvh + 2 * ks, on);
    }
    wgmma_commit();
    wgmma_wait_prev();   // the chunk before this one has been read
    if (prev >= 0 && t == 0) mbar_arrive(empty + prev);
    prev = stage;
    if (++stage == nstages) {
      stage = 0;
      phase ^= 1u;
    }
  };
  // the tile's norms, loaded before its products so that they have arrived
  // by its epilogue
  auto norms = [&](Norms& w, int g, int h) {
    const float* v = vn + static_cast<size_t>(g) * ft::GROUP + h * BN
                     + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      w[j] = __ldg(reinterpret_cast<const float2*>(v + 8 * j));
  };
  // a tile's epilogue into the group's running maxes (its accumulators
  // complete: the compiler may not read them before the wait)
  auto fold = [&](Acc& acc, const Norms& w) {
#pragma unroll
    for (int p = 0; p < S::TERMS; ++p) fence_regs(acc[p]);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int i = 4 * j;
      m0 = ft::nan_max(m0, score<L2>(acc, i, w[j].x));
      m0 = ft::nan_max(m0, score<L2>(acc, i + 1, w[j].y));
      m1 = ft::nan_max(m1, score<L2>(acc, i + 2, w[j].x));
      m1 = ft::nan_max(m1, score<L2>(acc, i + 3, w[j].y));
    }
  };
  // the group's max to gm (the 4 lanes of a row hold its 128 columns
  // between them), and at a supergroup's end the supergroup's to bmax
  auto group_end = [&](int g) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      m0 = ft::nan_max(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = ft::nan_max(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    const bool writer = (lane & 3) == 0;
    if (writer && q0 < nq) gm[static_cast<size_t>(q0) * ngroups + g] = m0;
    if (writer && q1 < nq) gm[static_cast<size_t>(q1) * ngroups + g] = m1;
    if (bmax != nullptr) {
      bm0 = ft::nan_max(bm0, m0);
      bm1 = ft::nan_max(bm1, m1);
      if ((g & 7) == 7) {
        if (writer && q0 < nq) bmax[q0 * nsgs + g / 8] = bm0;
        if (writer && q1 < nq) bmax[q1 * nsgs + g / 8] = bm1;
        bm0 = bm1 = -INFINITY;
      }
    }
    m0 = m1 = -INFINITY;
  };

  // with `ordered`, the two warpgroups take turns issuing a tile's
  // products (named barriers 1 and 2, 256 threads): warpgroup 1 issues
  // tile i once warpgroup 0 has issued it, warpgroup 0 tile i + 1 once
  // warpgroup 1 has issued tile i, so one's epilogue runs while the
  // other's products are on the tensor cores. Only where the ring holds
  // two tiles' chunks: a warpgroup issues a whole tile before it passes
  // the turn.
  const bool ordered = S::ORDERED && 2 * nkc <= nstages;
  const int ntiles = (g1 - g0) * S::TILES;
  Acc acc = {};
  Norms w;
  for (int g = g0, i = 0; g < g1; ++g) {
    for (int h = 0; h < S::TILES; ++h, ++i) {
      norms(w, g, h);
      if (ordered && (wg == 1 || i > 0)) named_sync(1 + wg);
      if constexpr (RS) {   // kc a constant: aq's index
        issue(acc, 0);
        issue(acc, 1);
      } else {
        for (int kc = 0; kc < nkc; ++kc) issue(acc, kc);
      }
      if (ordered && (wg == 0 || i + 1 < ntiles)) named_arrive(2 - wg);
      wgmma_wait_all();   // the tile's last chunk, and its accumulators
      if (t == 0) mbar_arrive(empty + prev);
      prev = -1;
      fold(acc, w);
    }
    group_end(g);
  }
}

// -- host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// A (rows, d) row-major bf16 plane as a tensor map of 64 × box_rows tiles,
// 128-byte swizzled; out-of-bounds elements read as zero.
bool plane_map(EncodeTiled enc, CUtensorMap* map, const void* base, int d,
               int rows, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {KC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per device: SM count, and whether the instantiation may take the opt-in
// shared memory (set once, before any graph capture can reach it).
struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  bool attr_set = false;
};

template <bool L2, int DBP, int BN, bool RS>
cudaError_t launch(const CUtensorMap (&maps)[4], const void* q_hi,
                   const void* q_lo, const float* vn, float* gm,
                   float* bmax, int nq, int d, int ngroups,
                   cudaStream_t stream) {
  using S = Shape<DBP, BN>;
  static DeviceInfo info[64];   // one table per instantiation
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  DeviceInfo& di = info[dev];
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
    e = cudaFuncSetAttribute(sweep_split_mma_kernel<L2, DBP, BN, RS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             di.smem_optin);
    if (e != cudaSuccess) return e;
    di.attr_set = true;
  }
  const int nkc = (d + KC - 1) / KC;
  const int resident = nkc <= MAX_RESIDENT_KC;
  const int a_bytes = resident && !RS ? nkc * A_BYTES : 0;
  const int stage_bytes = resident ? S::B_BYTES : A_BYTES + S::B_BYTES;
  // align, A, barriers
  const int fixed = 1024 + a_bytes + 8 * (2 * MAX_STAGES + 1);
  const int nstages = min(S::STAGES, (di.smem_optin - fixed) / stage_bytes);
  if (nstages < 2) return cudaErrorInvalidConfiguration;
  const size_t smem = fixed + static_cast<size_t>(nstages) * stage_bytes;
  const int nqt = (nq + QTILE - 1) / QTILE;
  const int nsg = (ngroups + 7) / 8;
  const int nbx = max(1, min(nsg, di.sms / nqt));
  sweep_split_mma_kernel<L2, DBP, BN, RS>
      <<<dim3(nbx, nqt), NTHREADS, smem, stream>>>(
          maps[0], maps[1], maps[2], maps[3],
          static_cast<const uint16_t*>(q_hi),
          static_cast<const uint16_t*>(q_lo), vn, gm, bmax, nq, d, ngroups,
          nkc, resident, nstages);
  return cudaGetLastError();
}

// K3 (DBP 2, A from shared memory), or K1 (DBP 1): at N = 64 its A
// fragments from registers where d takes two k chunks (64 < d ≤ 128), else
// from shared memory.
template <int DBP, int BN>
cudaError_t launch_metric(const CUtensorMap (&maps)[4], const void* q_hi,
                          const void* q_lo, const float* vn, float* gm,
                          float* bmax, int nq, int d, int ngroups, int l2,
                          cudaStream_t stream) {
  auto go = [&](auto l2c, auto rsc) {
    return launch<decltype(l2c)::value, DBP, BN, decltype(rsc)::value>(
        maps, q_hi, q_lo, vn, gm, bmax, nq, d, ngroups, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  if constexpr (DBP == 1 && BN == 64)
    if ((d + KC - 1) / KC == 2) return l2 ? go(T{}, T{}) : go(F{}, T{});
  return l2 ? go(T{}, F{}) : go(F{}, F{});
}

}  // namespace

// q_hi, q_lo: (nq, d) bf16 query planes; db_hi: (≥ ngroups·128, d) bf16,
// the f32 rows' hi plane (K3) or, with a null db_lo, the bf16 rows (K1);
// db_lo: the lo plane, or null; vn: (ngroups·128,) pre-masked norms; gm:
// (nq, ngroups) f32 out; bmax: null, or the (nq, ngroups/8) supergroup
// maxes out (ngroups % 8 == 0). d % 8 == 0, 16-byte aligned, ngroups·128 <
// 2^31.
extern "C" int ft_sweep_split_mma(const void* q_hi, const void* q_lo,
                                  const void* db_hi, const void* db_lo,
                                  const void* vn, void* gm, void* bmax,
                                  int nq, int d, int ngroups, int l2,
                                  void* stream) {
  if (nq <= 0 || ngroups <= 0 || d <= 0 || d % 8 != 0
      || static_cast<long long>(ngroups) * ft::GROUP >= (1LL << 31)
      || (bmax != nullptr && ngroups % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bn = db_lo != nullptr ? 64 : K1_BN;
  CUtensorMap maps[4];
  const int rows = ngroups * ft::GROUP;
  if (!plane_map(enc, &maps[0], q_hi, d, nq, QTILE)
      || !plane_map(enc, &maps[1], q_lo, d, nq, QTILE)
      || !plane_map(enc, &maps[2], db_hi, d, rows, bn)
      || !plane_map(enc, &maps[3], db_lo != nullptr ? db_lo : db_hi, d, rows,
                    bn))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* n = static_cast<const float*>(vn);
  auto* out = static_cast<float*>(gm);
  auto* bm = static_cast<float*>(bmax);
  const cudaError_t e =
      db_lo != nullptr
          ? launch_metric<2, 64>(maps, q_hi, q_lo, n, out, bm, nq, d,
                                 ngroups, l2, s)
          : launch_metric<1, K1_BN>(maps, q_hi, q_lo, n, out, bm, nq, d,
                                    ngroups, l2, s);
  return static_cast<int>(e);
}
