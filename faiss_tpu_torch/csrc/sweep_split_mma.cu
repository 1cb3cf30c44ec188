// The group-max sweeps on the tensor cores, one kernel template over four
// row formats (ft_sweep_mma's fmt, enum Fmt) and the query planes (Rows<F,
// QP>):
//   BF16_ROWS   K1, the bf16 rows               acc = qh·v + ql·v
//               K2, the same, one query plane   acc = q1·v
//   F32_PLANES  K3, the f32 rows' bf16 planes   acc = (qh·dh + qh·dl) + ql·dh
//               K4, the same, one query plane   acc = q1·dh + q1·dl
//   F16_BITS    K6, the f16 rows v as stored,   acc = fl(fl(2^-eh·(qh·v))
//               f16 query planes                         + fl(2^-el·(ql·v)))
//               K7, one bf16 query plane, the   acc = q1·dh + q1·dl
//               rows decoded to their exact
//               bf16 pair (dh, dl)
//   INT8_CODES  K5, the int8 codes v            dot = fl(fl(β₁·f32(q₁·v))
//                                                       + fl(β₂·f32(q₂·v)))
// (each product term its own accumulator, the terms added once at the end,
// left to right; K6 and K5 scale each term by its query's factor first).
//
// Replaces faiss_tpu/ops/pallas_fused.py _kernel_qpair (:174), _kernel_q1
// (:190), _kernel_split (:239), _kernel_split2 (:204), _kernel_f16_pair
// (:259), _kernel_f16_1 (:281) and _kernel_int8 (:219), launched by
// _sweep_call (:376) from groupmax_scores, with their shared _epilogue. The
// fp32 query is its bit-mask split qh, ql (bf16), or with one plane (K2, K4,
// K7) its RNE rounding q1 to bf16; K6's its f16 split (storage.split_f32_f16:
// qh·2^-eh holds q's leading 11 bits, ql·2^-el the next 11, each plane
// scaled per query by a power of two into f16's range, both truncated
// toward zero); the int8 route's q∘s its residual expansion β₁·q₁ + β₂·q₂
// (ops/fused.int8_query_pair: q₁, q₂ int8, β₁, β₂ f32 per query). For
// every query q and 128-row group g:
//     gm[q, g] = max over the rows r of g of  2·acc − vn[r]  (L2)
//                                         or    acc − vn[r]  (IP)
// (acc = dot for int8), with vn the pre-masked norm stream (+inf on padding
// and filtered rows). With a non-null bmax it also writes the supergroup
// maxes
//     bmax[q, b] = max of gm[q, 8b … 8b+7]
// (_sweep_call(block_max=True), the _epilogue's second output), which equal
// fused.block_max_plain(gm) bit for bit: a block owns whole supergroups and
// folds their 8 group maxes itself, so no atomics are needed.
//
// What bounds it on an H100, at nq 104 (a query tile of 128) over 1M×128:
// K3 reads 512 MB of planes (0.155 ms at 3.35 TB/s) for 3 × 104 × 1M × 128
// FMAs, 8.0e10 FLOP (0.08 ms at 989 TFLOP/s in bf16); on CUDA cores the
// same work needs 1.19 ms at the 67 TFLOP/s fp32 peak, so the products run
// on the tensor cores (wgmma, bf16 in, fp32 accumulate) and the bytes bound
// it. K1 reads half the bytes (256 MB, 0.079 ms) for two thirds of the
// products. K6 is K1 over f16 rows (f16 in, at the bf16 rate): K1's bytes
// and products. K2 reads K1's bytes for half its products (0.027 ms): bytes
// bind it more than any other. K7 reads K1's bytes for K1's products (two
// terms, 0.054 ms): the bytes bound it, but its decode in shared memory and
// its products bind it (scripts/k3_variants.py no_load). K4 reads K3's bytes
// for two thirds of its products (0.054 ms): the bytes bind it. K5 reads 128 MB of
// codes (0.040 ms) for 2 × 104 × 1M × 128 int8 MACs on the integer tensor
// cores (wgmma s8 × s8, s32 accumulate: 0.027 ms at 1979 TOP/s). Design:
//   - one block per SM (persistent): two consumer warpgroups, one per 64
//     queries of the block's 128-query tile (wgmma's M side), one producer
//     warp (288 threads) and, for K7, four decode warps beside it in the
//     third warpgroup (416 threads: with one query plane its consumers fit
//     128 registers, 52 bytes of spills with q1 in registers; four decode
//     warps ran 13 % faster than three and no slower than seven,
//     scripts/k3_variants.py ndec96, ndec224; PERF.md);
//   - the block walks a contiguous run of whole supergroups (8 groups);
//     each group is 128 / BN tiles of BN rows (wgmma's N side, 64); each
//     tile runs over d in chunks of one 128-byte row (KC: 64 two-byte
//     elements, 128 int8 codes);
//   - the producer's TMA loads each (group, tile, chunk) tile of each db
//     plane (BN rows × 128 bytes, 128-byte swizzled) into a ring of stages
//     in shared memory (8 of 16 KB, or 16 of 8 KB), with full / empty
//     mbarriers; the query planes' chunks (128 × 128 bytes each) stay
//     resident for up to 4 chunks, else ride each stage; a tile's BN norms
//     come with its first chunk (a bulk copy completing on the same full
//     barrier) into a ring of their own beside the stages, so no consumer
//     waits on device memory for them (a per-thread load at each tile's
//     start measured slower, most for K5's one-chunk tiles);
//   - K6: a stored f16 row is an exact f16 wgmma operand, so the f16 tile
//     TMA lands is the B operand as it is, against f16 query planes, and
//     K6 is K1 with f16 inputs: one 2-byte db plane, two query planes; the
//     products (f32.f16.f16) run at the bf16 rate, and each term's
//     accumulator is scaled by its plane's power of two in the epilogue (a
//     decode to the bf16 pair, as K7's, with K3's three terms would cost
//     24 KB of shared-memory traffic and a proxy fence for every 8 KB tile
//     before its first product). Without K1's turns: they made K6 no
//     faster, and with the k-tail skipped (below) ptxas serializes its
//     wgmma under them (C7520; scripts/k3_variants.py ordered, ktail);
//   - K7 (the only decoding sweep): the ring holds the raw f16 tile; the
//     decode warps wait for it, rewrite it in place as the hi tile and
//     write the lo tile beside it (the 128-byte swizzle is a function of
//     the byte address and both types are 2 bytes wide, so element (r, k)
//     has the same offset in all three: element for element, no index
//     arithmetic), fence their generic-proxy writes for the async proxy
//     (fence.proxy.async) and arrive on the stage's decoded mbarrier,
//     which the consumers wait for in place of the full one; from there
//     the products are K4's;
//   - a consumer runs its products × 4 k-steps of wgmma per chunk (bf16
//     m64n64k16, int8 m64n64k32: 32 bytes a step either way, so the
//     shared-memory descriptor advances by 2), one accumulator set of 32
//     registers per term (fp32, or s32 for int8), and releases a stage
//     once the next chunk's products are issued (wgmma.wait_group 1); the
//     tile's norms are read from shared memory with its first chunk; per
//     tile the epilogue runs in registers, a max over the thread's columns
//     and a 4-lane shuffle; the group max goes to gm, and at a supergroup's
//     end to bmax;
//   - K1, K2: the two warpgroups take turns issuing a tile's products
//     (named barriers), so that one's epilogue runs under the other's
//     products;
//   - one db plane in the products (K1, K2, K6, K5), or one query plane
//     (K4, K7): where the query planes fit 8 k-steps (K1, K2, K4, K6, K7 at
//     64 < d ≤ 128, the main path's 128 and Deep's 96; K5 at d ≤ 128, one
//     chunk) they are wgmma A
//     fragments in registers (read once from device memory, used by every
//     term), which halves the shared-memory reads of the products;
//   - one query plane (K2, K4, K7): one A operand, a query tile of 16 KB a
//     chunk in place of 32, and one accumulator set a db plane (K2 one,
//     K4 and K7 two: q1·dh and q1·dl); the rest is K1's, K3's or K6's (K4
//     is K7 without the decode warps: the producer loads both planes);
//   - a d that is not a multiple of KC gets its k-tail zero-filled by TMA
//     (out-of-bounds fill): its k-steps add exact zeros (K7: an f16 zero
//     decodes to the pair (0, 0)); K6 with A in registers does not issue
//     the k-steps wholly past d (at d 96 a quarter of its products: 1.21
//     against 1.36–1.45 ms at the f16 cell's shape, PERF.md §6).
// scripts/k3_variants.py times each kernel against patched copies of
// itself (no products, no loads, the rejected designs; CUDA graph replay,
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md has the numbers and says what
// binds each). Slower, and dropped (K3, K1): releasing a stage only once its
// own products end (wgmma.wait_group 0); N = 128; an even split by groups
// with the shared supergroups folded by atomics; loading the norms from
// device memory (in the epilogue, or before the products); for K1, two
// accumulator sets with a tile's epilogue under the
// next tile's first chunk (ptxas serializes the wgmma when accumulator
// registers are read while another wgmma is pending, C7514); for K3, the
// turns. nvcc -Xptxas -v: PERF.md §6.
// The TMA descriptors and loads are tma.cuh's.
//
// Arithmetic (what the certificate ops/fused._sweep_eps(accum="mma")
// assumes for BF16_ROWS, F32_PLANES and F16_BITS). Each product term a·b (a
// a query plane, b a db plane, d long) accumulates in one fp32 wgmma
// accumulator over ⌈d/16⌉ k-steps. A k-step adds 16 bf16×bf16 (K6:
// f16×f16, 11 + 11 significand bits) products, each exact in fp32, to the
// accumulator D; the tensor core's sum is not
// proven round-to-nearest and may lack guard bits (Fasi, Higham, Mikaitis,
// Pranesh, PeerJ CS 2021, on earlier NVIDIA tensor cores: alignment to the
// largest exponent by truncation, then a truncating normalisation). The
// model charges each step j:
//   - every one of its 17 addends (16 products and D) may lose up to
//     2u·M_j, M_j the largest addend magnitude (u = 2^-24; the unit in the
//     last place at M_j's exponent is ≤ 2u·M_j);
//   - the normalisation of the result may lose 2u·|D_j|.
// With |products|, |D_j| ≤ ‖a‖·‖b‖ (Cauchy-Schwarz, to first order), a step
// errs ≤ (17·2u + 2u)·‖a‖·‖b‖ = 36u·‖a‖·‖b‖, a term ≤ 36·⌈d/16⌉·u·‖a‖·‖b‖.
// The three pair terms (‖qh‖·‖dh‖ ≤ (Q+R)·V, ‖qh‖·‖dl‖ ≤ (Q+R)·s0,
// ‖ql‖·‖dh‖ ≤ L·V) then add in two round-to-nearest fp32 adds (≤ 2u·the
// same sum):
//     (36·⌈d/16⌉ + 2)·u·[(Q+R)·(V+s0) + L·V],
// about 2.2× the (d+2)·u of the CUDA-core fmaf chains at d = 128. K1's two
// (‖qh‖·‖v‖ ≤ (Q+R)·V, ‖ql‖·‖v‖ ≤ L·V) add in one (≤ u·the sum): the same
// budget with s0 = 0, as _sweep_eps(accum="mma") charges bf16 rows. K6 is
// K1's two terms over the stored f16 rows, used whole and exactly (s0 =
// s1 = 0), with R = ‖q − qh·2^-eh − ql·2^-el‖ and L = ‖ql·2^-el‖ of the f16
// split (_sweep_eps(f16_planes=...): R ≈ 2^-22·Q where the bf16 pair
// leaves ≈ 2^-16·Q). The planes are truncations of q toward zero, so
// ‖qh·2^-eh‖ ≤ Q; a term accumulates in the scaled space, where the model
// holds as it does unscaled, and its power of two multiplies it exactly
// (__fmul_rn, barring underflow below fp32's normal range, which no
// bound here charges); the one round-to-nearest add of the two scaled
// terms ≤ u·the sum. K2's
// one term q1·v (‖q1‖ ≤ Q+R, R = ‖q − q1‖; ‖v‖ ≤ V) errs ≤ 36·⌈d/16⌉·u·
// (Q+R)·V and is added to nothing: the same budget with L = 0 and s0 = 0
// (single_pass=True), whose +2u is slack. At d = 128 its term (2) is 290u
// where the fmaf chain's was 130u, in units of (Q+R)·V. K7's two terms
// q1·dh (‖q1‖ ≤ Q+R, ‖dh‖ ≤ V) and q1·dl (‖dl‖ ≤ s0, the f16 split
// statistics) err ≤ 36·⌈d/16⌉·u·(Q+R)·V and ≤ 36·⌈d/16⌉·u·(Q+R)·s0, and
// their one round-to-nearest add ≤ u·(Q+R)·(V+s0): inside
// (36·⌈d/16⌉ + 2)·u·(Q+R)·(V+s0), the budget with L = 0 (single_pass=True,
// pair_sweep=True), s1 = 0 on finite data (the decoded pair is exact,
// dh + dl == v). K4 is the same two
// terms over the f32 rows' planes (‖dl‖ ≤ s0, the f32 split statistics):
// the same budget, each term in its own accumulator and the two added once,
// round to nearest (a single accumulator over both terms would need another
// derivation).
// tests/test_torch_mma_eps.py emulates the model's truncating block sums on
// adversarial rows. A k-step past d adds exact zeros to D, the largest
// addend, and loses nothing: ⌈d/16⌉ steps are charged.
// INT8_CODES: the s32 sums of int8 × int8 products are exact in any order
// (|q_i·v| ≤ 127²·d < 2³¹ for every d the gate admits), and the epilogue
// makes fused.sweep_int8_plain's three roundings in its order, written
// with __fmul_rn / __fadd_rn so that nvcc cannot contract them: K5 equals
// its plain version bit for bit, and _sweep_eps_int8 charges it as it
// charges any exact sweep.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int NCONS = 256;             // two consumer warpgroups
constexpr int QTILE = 128;             // queries a block
constexpr int ROW_BYTES = ft::TMA_ROW_BYTES;   // one swizzled row: a k chunk
constexpr int A_PLANE = QTILE * ROW_BYTES;         // 16 KB a query plane
constexpr int MAX_RESIDENT_KC = 4;     // resident query planes up to 4 chunks
constexpr int MAX_STAGES = 16;
constexpr int K1_BN = 64;              // K1's N side (bf16 rows)

// ft_sweep_mma's row formats
enum Fmt { BF16_ROWS = 0, F32_PLANES = 1, F16_BITS = 2, INT8_CODES = 3 };

// The shapes of one row format, with QP query planes (2; BF16_ROWS and
// F16_BITS also 1: K2, K7).
template <int F, int QP = 2>
struct Rows {
  static constexpr bool INT8 = F == INT8_CODES;
  static constexpr int EW = INT8 ? 1 : 2;          // bytes an element
  static constexpr int KC = ROW_BYTES / EW;        // elements a k chunk
  // K6: the stored f16 tile is the B operand of an f16 wgmma as TMA lands
  // it, against f16 query planes; K7 decodes it to its exact bf16 pair
  static constexpr bool F16_MMA = F == F16_BITS && QP == 2;
  static constexpr bool DECODE = F == F16_BITS && QP == 1;
  // db planes in the products (K3, K7: dh and dl), and of them the ones
  // TMA loads (K7 loads the f16 bits into dh's slot and decodes them)
  static constexpr int PLANES = F == F32_PLANES || DECODE ? 2 : 1;
  static constexpr int LOADS = F == F32_PLANES ? 2 : 1;
  // product terms: each query plane times each db plane, but ql·dl
  static constexpr int TERMS = PLANES == 2 ? QP + 1 : QP;
  // the epilogue scales each term by its query's factor: K5's β, K6's
  // powers of two
  static constexpr bool SCALED = INT8 || F16_MMA;
  static constexpr int A_BYTES = QP * A_PLANE;     // the query planes' chunk
  static constexpr int BN = F == BF16_ROWS ? K1_BN : 64;
  static constexpr int ACC = BN / 2;               // accumulators a term
  static constexpr int TILES = ft::GROUP / BN;     // N tiles a group
  static constexpr int B_PLANE = BN * ROW_BYTES;   // one db plane's tile
  static constexpr int B_BYTES = PLANES * B_PLANE;
  static constexpr int B_TX = LOADS * B_PLANE;     // of them, by TMA
  // stages of ≥ 16 KB: 8 (K3's measured ring); 8 KB tiles: 16
  static constexpr int STAGES = B_BYTES >= 16384 ? 8 : MAX_STAGES;
  // the warpgroups take turns issuing a tile's products (K1, K2; K5 ran
  // faster without, its tiles one chunk long, and K6 no faster with them)
  static constexpr bool ORDERED = F == BF16_ROWS;
  // K7's four decode warps (its one query plane leaves the decode more to
  // bind: scripts/k3_variants.py ndec96, ndec224)
  static constexpr int NDEC = DECODE ? 128 : 0;
  static constexpr int NTHREADS = NCONS + NDEC + 32;
  using acc_t = std::conditional_t<INT8, int, float>;
};

// -- PTX wrappers --------------------------------------------------------

using ft::bulk_load;
using ft::mbar_arrive;
using ft::mbar_expect_tx;
using ft::mbar_init;
using ft::mbar_wait;
using ft::smem_addr;
using ft::tma_load;

// Orders this thread's generic-proxy writes to shared memory before the
// async proxy's reads (wgmma) and writes (TMA) that follow them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzled as TMA writes it: 8-row atoms 1024 bytes apart (SBO), layout type
// 1 (SWIZZLE_128B). The next k-step is 32 bytes on: +2.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFFu) >> 4)
         | (static_cast<uint64_t>(1) << 16)       // LBO (unused here)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// the 32 fp32 accumulator operands of a 64×64 wgmma
#define FT_ACC32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
// m64n64k16 with fp32 accumulators over inputs of type T (bf16, f16): A
// and B from shared memory, or A from registers
#define FT_WGMMA_SS(T)                                                     \
  "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                          \
  " wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " "               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
#define FT_WGMMA_RS(T)                                                     \
  "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                          \
  " wgmma.mma_async.sync.aligned.m64n64k16.f32." T "." T " "               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"

// D (64×64 fp32, 32 registers a thread) = A·B + (scale_d ? D : 0), A 64×16
// and B 16×64 bf16 (F16: f16), both K-major in shared memory.
template <bool F16>
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (F16)
    asm volatile(FT_WGMMA_SS("f16") : FT_ACC32
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile(FT_WGMMA_SS("bf16") : FT_ACC32
                 : "l"(da), "l"(db), "r"(scale_d));
}

// The wgmma of an N = BN tile: m64n64k16 (scripts/k3_variants.py's n128
// variant adds m64n128k16 for K1_BN 128).
// D (64×64 fp32) = A·B + (scale_d ? D : 0) with A 64×16 bf16 (F16: f16)
// from registers: a warp's 16 rows as mma.m16n8k16's A fragment (a[0] row
// lane/4, columns 2·(lane%4) + {0, 1}; a[1] 8 rows down; a[2], a[3] 8
// columns on), two elements a register, the lower column in the low half.
template <bool F16>
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  if constexpr (F16)
    asm volatile(FT_WGMMA_RS("f16") : FT_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(scale_d));
  else
    asm volatile(FT_WGMMA_RS("bf16") : FT_ACC32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                   "r"(scale_d));
}

// D (64×64 s32) = A·B + (scale_d ? D : 0), A 64×32 and B 32×64 int8, both
// K-major in shared memory (the integer form takes no scale or transpose
// operands).
__device__ __forceinline__ void wgmma_s8_64x64(int (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A from registers: mma.m16n8k32's A fragment (a[0] row
// lane/4, columns 4·(lane%4) + {0 … 3}; a[1] 8 rows down; a[2], a[3] 16
// columns on), four int8 a register. In bytes this is the bf16 fragment's
// layout: a register holds the 4 bytes at 4·(lane%4) (+16) of its row.
__device__ __forceinline__ void wgmma_s8_rs_64x64(int (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// F16: f16 inputs (K6), else bf16; the integer forms take int8 alone
template <int N, bool F16>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  static_assert(N == 64, "wgmma: N = 64 only");
  wgmma_64x64<F16>(d, da, db, scale_d);
}
template <int N, bool F16>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d) {
  wgmma_s8_64x64(d, da, db, scale_d);
}
template <bool F16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  wgmma_rs_64x64<F16>(d, a, db, scale_d);
}
template <bool F16>
__device__ __forceinline__ void wgmma_rs(int (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  wgmma_s8_rs_64x64(d, a, db, scale_d);
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
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Two f16 patterns (element 0 in the low half) → their exact bf16 pairs
// (hi, lo), packed the same way: the decode of common.cuh unpack8_f16,
// then the split of faiss_tpu.storage.split_f16_bits, element for
// element. An e=31 pattern
// loses its mantissa, so NaN decodes to ±inf as inf does (the contract of
// faiss_tpu.storage.decode_f16_bits); cvt.f32.f16 is exact on every other
// pattern, subnormals included; hi is the fp32 value's high half (its
// truncation to bf16), lo = f − hi (≤ 3 significant bits: exact, and its
// fp32 value is its bf16 one), 0 where f is ±inf.
__device__ __forceinline__ void split_f16x2(uint32_t w, uint32_t& hi,
                                            uint32_t& lo) {
  const uint32_t e31 = __vcmpeq2(w & 0x7C007C00u, 0x7C007C00u);
  w &= ~(e31 & 0x03FF03FFu);
  const uint32_t b0 = __float_as_uint(
      __half2float(__ushort_as_half(static_cast<unsigned short>(w))));
  const uint32_t b1 = __float_as_uint(
      __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
  hi = __byte_perm(b0, b1, 0x7632);
  const float l0 = __fsub_rn(__uint_as_float(b0),
                             __uint_as_float(b0 & 0xFFFF0000u));
  const float l1 = __fsub_rn(__uint_as_float(b1),
                             __uint_as_float(b1 & 0xFFFF0000u));
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632) & ~e31;
}

// Eight f16 patterns (16 bytes) → the 16 bytes of their hi and lo halves.
__device__ __forceinline__ void split_f16x8(const uint4 w, uint4& hi,
                                            uint4& lo) {
  split_f16x2(w.x, hi.x, lo.x);
  split_f16x2(w.y, hi.y, lo.y);
  split_f16x2(w.z, hi.z, lo.z);
  split_f16x2(w.w, hi.w, lo.w);
}

// The score of accumulator entry i: the terms added left to right, or with
// SCALED each term first times its factor, sc the entry's query's (K6:
// its planes' powers of two 2^-eh, 2^-el, exact products; int8:
// β₁·f32(a₁) + β₂·f32(a₂)); then the epilogue.
template <bool L2, bool SCALED, int TERMS, int ACC>
__device__ __forceinline__ float score(const float (&acc)[TERMS][ACC], int i,
                                       float v, float2 sc) {
  float a;
  if constexpr (SCALED) {
    a = __fadd_rn(__fmul_rn(acc[0][i], sc.x), __fmul_rn(acc[1][i], sc.y));
  } else {
    a = acc[0][i];
    if constexpr (TERMS >= 2) a = __fadd_rn(a, acc[1][i]);
    if constexpr (TERMS == 3) a = __fadd_rn(a, acc[2][i]);
  }
  return __fsub_rn(L2 ? __fmul_rn(2.f, a) : a, v);
}
template <bool L2, bool SCALED, int TERMS, int ACC>
__device__ __forceinline__ float score(const int (&acc)[TERMS][ACC], int i,
                                       float v, float2 beta) {
  const float a = __fadd_rn(__fmul_rn(__int2float_rn(acc[0][i]), beta.x),
                            __fmul_rn(__int2float_rn(acc[1][i]), beta.y));
  return __fsub_rn(L2 ? __fmul_rn(2.f, a) : a, v);
}

// -- the kernel ----------------------------------------------------------

// Maps: tq_hi, tq_lo the query planes (qh, ql; q₁, q₂; with QP = 1 qh
// alone, the q1 of K2, and tq_lo unread), tv_hi the db plane TMA loads
// (the bf16 rows, the hi plane, the f16 bits, the int8 codes), tv_lo the
// f32 rows' lo plane (unread otherwise). beta: (nq, 2) β₁, β₂ (INT8_CODES),
// or the f16 query planes' powers of two 2^-eh, 2^-el (K6); unread
// otherwise. RSK chunks of the query planes (1, 2; 0: none) are read once from
// q_hi, q_lo (nq, d) into registers as wgmma's A fragments, not by TMA,
// and only the rows ride the ring (nkc is RSK).
template <int F, int QP, bool L2, int RSK>
__global__ void __launch_bounds__(Rows<F, QP>::NTHREADS, 1)
sweep_split_mma_kernel(const __grid_constant__ CUtensorMap tq_hi,
                       const __grid_constant__ CUtensorMap tq_lo,
                       const __grid_constant__ CUtensorMap tv_hi,
                       const __grid_constant__ CUtensorMap tv_lo,
                       const uint8_t* __restrict__ q_hi,
                       const uint8_t* __restrict__ q_lo,
                       const float* __restrict__ vn,
                       const float* __restrict__ beta, float* __restrict__ gm,
                       float* __restrict__ bmax, int nq, int d, int ngroups,
                       int nkc, int resident, int nstages) {
  using S = Rows<F, QP>;
  constexpr bool RS = RSK > 0;
  static_assert(!RS || (S::BN == 64 && (S::PLANES == 1 || QP == 1)),
                "RS: every A operand from registers, at N = 64");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = resident ? S::B_BYTES : S::A_BYTES + S::B_BYTES;
  uint8_t* a_res = smem;
  uint8_t* ring = smem + (resident && !RS ? nkc * S::A_BYTES : 0);
  float* nring = reinterpret_cast<float*>(ring + nstages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(nring + nstages * S::BN);
  uint64_t* empty = full + nstages;
  uint64_t* decoded = empty + nstages;   // K7: the decoded tiles
  uint64_t* a_bar = decoded + nstages;
  // the consumers' "stage ready": the decoded tile, or the loaded one
  uint64_t* ready = S::DECODE ? decoded : full;

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
      mbar_init(decoded + s, S::NDEC > 0 ? S::NDEC : 1);
    }
    mbar_init(a_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == (NCONS + S::NDEC) / 32) {
    // producer: one thread issues every load
    if (lane != 0) return;
    if (resident && !RS) {
      mbar_expect_tx(a_bar, nkc * S::A_BYTES);
      for (int kc = 0; kc < nkc; ++kc) {
        tma_load(&tq_hi, a_res + kc * S::A_BYTES, a_bar, kc * S::KC, q_tile);
        if constexpr (QP == 2)
          tma_load(&tq_lo, a_res + kc * S::A_BYTES + A_PLANE, a_bar,
                   kc * S::KC, q_tile);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = g0; g < g1; ++g)
      for (int h = 0; h < S::TILES; ++h)
        for (int kc = 0; kc < nkc; ++kc) {
          mbar_wait(empty + stage, phase ^ 1u);
          uint8_t* st = ring + stage * stage_bytes;
          mbar_expect_tx(full + stage,
                         (resident ? S::B_TX : S::A_BYTES + S::B_TX)
                             + (kc == 0 ? S::BN * 4 : 0));
          if (!resident) {
            tma_load(&tq_hi, st, full + stage, kc * S::KC, q_tile);
            if constexpr (QP == 2)
              tma_load(&tq_lo, st + A_PLANE, full + stage, kc * S::KC,
                       q_tile);
            st += S::A_BYTES;
          }
          const int row = g * ft::GROUP + h * S::BN;
          if (kc == 0)   // the tile's norms, with its first chunk
            bulk_load(nring + stage * S::BN, vn + row, S::BN * 4,
                      full + stage);
          tma_load(&tv_hi, st, full + stage, kc * S::KC, row);
          if constexpr (S::LOADS == 2)
            tma_load(&tv_lo, st + S::B_PLANE, full + stage, kc * S::KC, row);
          if (++stage == nstages) {
            stage = 0;
            phase ^= 1u;
          }
        }
    return;
  }
  if constexpr (S::DECODE) {
    if (warp >= NCONS / 32) {
      // decode warps: each loaded f16 tile becomes the (hi, lo) tiles in
      // place, 16 bytes a thread and step
      const int t = threadIdx.x - NCONS;
      int stage = 0;
      uint32_t phase = 0;
      for (int g = g0; g < g1; ++g)
        for (int h = 0; h < S::TILES; ++h)
          for (int kc = 0; kc < nkc; ++kc) {
            mbar_wait(full + stage, phase);
            uint4* b = reinterpret_cast<uint4*>(
                ring + stage * stage_bytes + (resident ? 0 : S::A_BYTES));
#pragma unroll 2
            for (int i = t; i < S::B_PLANE / 16; i += S::NDEC) {
              uint4 hi, lo;
              split_f16x8(b[i], hi, lo);
              b[i] = hi;
              b[i + S::B_PLANE / 16] = lo;
            }
            // each thread's writes, fenced for the async proxy and released
            // by its own arrival
            fence_proxy_async();
            mbar_arrive(decoded + stage);
            if (++stage == nstages) {
              stage = 0;
              phase ^= 1u;
            }
          }
      return;
    }
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
  using T = typename S::acc_t;
  using Acc = T[S::TERMS][S::ACC];   // K3: qh·dh, qh·dl, ql·dh; K1, K6:
                                     // qh·v, ql·v; K2: q1·v; K4, K7: q1·dh,
                                     // q1·dl; K5: q₁·v, q₂·v
  using Norms = float2[S::BN / 8];
  // the factors of the thread's two queries: (β₁, β₂) (K5), (2^-eh,
  // 2^-el) (K6)
  float2 be0 = make_float2(0.f, 0.f), be1 = be0;
  if constexpr (S::SCALED) {
    if (q0 < nq) be0 = __ldg(reinterpret_cast<const float2*>(beta) + q0);
    if (q1 < nq) be1 = __ldg(reinterpret_cast<const float2*>(beta) + q1);
  }

  // RS: the warpgroup's 64 rows of each query plane for RSK chunks (4
  // k-steps of 32 bytes each), as A fragments; zero past nq and d (the
  // rows' k-tail is zero too: TMA's out-of-bounds fill)
  uint32_t aq[QP][RS ? 4 * RSK : 1][4];
  if constexpr (RS) {
    const int row_bytes = d * S::EW;
    const int kb = 4 * (lane & 3);
    auto frag = [&](const uint8_t* q, int row, int k) -> uint32_t {
      return row < nq && k < row_bytes
                 ? __ldg(reinterpret_cast<const uint32_t*>(
                       q + static_cast<size_t>(row) * row_bytes + k))
                 : 0u;
    };
#pragma unroll
    for (int p = 0; p < QP; ++p)
#pragma unroll
      for (int ks = 0; ks < 4 * RSK; ++ks) {
        const uint8_t* q = p == 0 ? q_hi : q_lo;
        aq[p][ks][0] = frag(q, q0, 32 * ks + kb);
        aq[p][ks][1] = frag(q, q1, 32 * ks + kb);
        aq[p][ks][2] = frag(q, q0, 32 * ks + kb + 16);
        aq[p][ks][3] = frag(q, q1, 32 * ks + kb + 16);
      }
  }

  // K6, A in registers: the last chunk's k-steps that reach d (d 96: 2 of
  // 4); the ones past d would add the zero-filled k-tail's exact zeros
  [[maybe_unused]] const int last_ks = (d - (RSK - 1) * S::KC + 15) / 16;
  // one chunk's products into acc (and, with the tile's first chunk, its
  // norms into w); then, once the chunk before it has been read
  // (wgmma.wait_group 1), that chunk's stage goes back to the producer
  Norms w;
  auto issue = [&](Acc& acc, int kc) {
    mbar_wait(ready + stage, phase);
    if (kc == 0) {
      const float* v = nring + stage * S::BN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < S::BN / 8; ++j)
        w[j] = *reinterpret_cast<const float2*>(v + 8 * j);
    }
    const uint8_t* st = ring + stage * stage_bytes;
    const uint8_t* a = resident ? a_res + kc * S::A_BYTES : st;
    const uint8_t* b = resident ? st : st + S::A_BYTES;
    const uint64_t dqh = sw128_desc(a + wg * (A_PLANE / 2));
    const uint64_t dql = sw128_desc(a + A_PLANE + wg * (A_PLANE / 2));
    const uint64_t dvh = sw128_desc(b);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int on = (kc | ks) != 0;   // step 0 starts from zero
      if constexpr (RS) {
        if constexpr (S::F16_MMA)
          if (kc == RSK - 1 && ks >= last_ks) continue;
        wgmma_rs<S::F16_MMA>(acc[0], aq[0][4 * kc + ks], dvh + 2 * ks, on);
        if constexpr (S::PLANES == 2)
          wgmma_rs<S::F16_MMA>(acc[1], aq[0][4 * kc + ks],
                               sw128_desc(b + S::B_PLANE) + 2 * ks, on);
        if constexpr (QP == 2)
          wgmma_rs<S::F16_MMA>(acc[S::TERMS - 1], aq[1][4 * kc + ks],
                               dvh + 2 * ks, on);
        continue;
      }
      wgmma<S::BN, S::F16_MMA>(acc[0], dqh + 2 * ks, dvh + 2 * ks, on);
      if constexpr (S::PLANES == 2) {
        const uint64_t dvl = sw128_desc(b + S::B_PLANE);
        wgmma<S::BN, S::F16_MMA>(acc[1], dqh + 2 * ks, dvl + 2 * ks, on);
      }
      if constexpr (QP == 2)
        wgmma<S::BN, S::F16_MMA>(acc[S::TERMS - 1], dql + 2 * ks,
                                 dvh + 2 * ks, on);
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
  // a tile's epilogue into the group's running maxes (its accumulators
  // complete: the compiler may not read them before the wait)
  auto fold = [&](Acc& acc, const Norms& w) {
#pragma unroll
    for (int p = 0; p < S::TERMS; ++p) fence_regs(acc[p]);
#pragma unroll
    for (int j = 0; j < S::BN / 8; ++j) {
      const int i = 4 * j;
      m0 = ft::nan_max(m0, score<L2, S::SCALED>(acc, i, w[j].x, be0));
      m0 = ft::nan_max(m0, score<L2, S::SCALED>(acc, i + 1, w[j].y, be0));
      m1 = ft::nan_max(m1, score<L2, S::SCALED>(acc, i + 2, w[j].x, be1));
      m1 = ft::nan_max(m1, score<L2, S::SCALED>(acc, i + 3, w[j].y, be1));
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
  for (int g = g0, i = 0; g < g1; ++g) {
    for (int h = 0; h < S::TILES; ++h, ++i) {
      if (ordered && (wg == 1 || i > 0)) named_sync(1 + wg);
      if constexpr (RS) {   // kc a constant: aq's index
        issue(acc, 0);
        if constexpr (RSK >= 2) issue(acc, 1);
        if constexpr (RSK >= 3) issue(acc, 2);
        if constexpr (RSK >= 4) issue(acc, 3);
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

// Per device: SM count, and whether the instantiation may take the opt-in
// shared memory (set once, before any graph capture can reach it).
struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
  bool attr_set = false;
};

struct Args {
  const void* q_hi;
  const void* q_lo;
  const float* vn;
  const float* beta;
  float* gm;
  float* bmax;
  int nq, d, ngroups;
};

template <int F, int QP, bool L2, int RSK>
cudaError_t launch(const CUtensorMap (&maps)[4], const Args& a,
                   cudaStream_t stream) {
  using S = Rows<F, QP>;
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
    e = cudaFuncSetAttribute(sweep_split_mma_kernel<F, QP, L2, RSK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             di.smem_optin);
    if (e != cudaSuccess) return e;
    di.attr_set = true;
  }
  const int nkc = (a.d + S::KC - 1) / S::KC;
  const int resident = nkc <= MAX_RESIDENT_KC;
  const int a_bytes = resident && RSK == 0 ? nkc * S::A_BYTES : 0;
  const int stage_bytes = resident ? S::B_BYTES : S::A_BYTES + S::B_BYTES;
  // align, A, barriers, the norms' ring
  const int fixed = 1024 + a_bytes + 8 * (3 * MAX_STAGES + 1)
                    + MAX_STAGES * S::BN * 4;
  const int nstages = min(S::STAGES, (di.smem_optin - fixed) / stage_bytes);
  if (nstages < 2) return cudaErrorInvalidConfiguration;
  const size_t smem = fixed + static_cast<size_t>(nstages) * stage_bytes;
  const int nqt = (a.nq + QTILE - 1) / QTILE;
  const int nsg = (a.ngroups + 7) / 8;
  const int nbx = max(1, min(nsg, di.sms / nqt));
  sweep_split_mma_kernel<F, QP, L2, RSK>
      <<<dim3(nbx, nqt), S::NTHREADS, smem, stream>>>(
          maps[0], maps[1], maps[2], maps[3],
          static_cast<const uint8_t*>(a.q_hi),
          static_cast<const uint8_t*>(a.q_lo), a.vn, a.beta, a.gm, a.bmax,
          a.nq, a.d, a.ngroups, nkc, resident, nstages);
  return cudaGetLastError();
}

// The instance for the metric and the query planes' place: A fragments in
// registers where the planes take RS_KC chunks (K1 and K2 at N = 64, K4,
// K6 and K7: two, 64 < d ≤ 128; K5: one, d ≤ 128), else from shared
// memory.
template <int F, int QP = 2>
cudaError_t launch_metric(const CUtensorMap (&maps)[4], const Args& a, int l2,
                          cudaStream_t stream) {
  constexpr int RS_KC = F == BF16_ROWS && K1_BN == 64 ? 2
                        : F == F16_BITS               ? 2
                        : F != INT8_CODES && QP == 1  ? 2
                        : F == INT8_CODES             ? 1
                                                      : 0;
  const int nkc = (a.d + Rows<F, QP>::KC - 1) / Rows<F, QP>::KC;
  if constexpr (RS_KC > 0)
    if (nkc == RS_KC)
      return l2 ? launch<F, QP, true, RS_KC>(maps, a, stream)
                : launch<F, QP, false, RS_KC>(maps, a, stream);
  return l2 ? launch<F, QP, true, 0>(maps, a, stream)
            : launch<F, QP, false, 0>(maps, a, stream);
}

}  // namespace

// fmt (enum Fmt): BF16_ROWS (K1; K2 with q_lo null), F32_PLANES (K3; K4
// with q_lo null), F16_BITS (K6; K7 with q_lo null) or INT8_CODES (K5).
// q_hi, q_lo: (nq, d) query planes, bf16 (qh, ql; q1 and null: one plane),
// f16 (K6: qh, ql) or int8 (q₁, q₂); db: (≥ ngroups·128, d) rows: bf16
// rows, the f32 rows' bf16 hi plane, f16 bit patterns or int8 codes; db_lo:
// the f32 rows' lo plane (F32_PLANES; else unread); beta: (nq, 2) f32 β₁,
// β₂ (INT8_CODES) or 2^-eh, 2^-el (K6), else unread; vn: (ngroups·128,)
// pre-masked norms; gm: (nq, ngroups) f32 out; bmax: null, or the (nq,
// ngroups/8) supergroup maxes out (ngroups % 8 == 0). A row is a multiple
// of 16 bytes (d % 8 == 0; int8: d % 16 == 0), 16-byte aligned,
// ngroups·128 < 2^31.
extern "C" int ft_sweep_mma(int fmt, const void* q_hi, const void* q_lo,
                            const void* db, const void* db_lo, const void* vn,
                            const void* beta, void* gm, void* bmax, int nq,
                            int d, int ngroups, int l2, void* stream) {
  const bool int8 = fmt == INT8_CODES;
  const bool f16_mma = fmt == F16_BITS && q_lo != nullptr;   // K6
  if (fmt < BF16_ROWS || fmt > INT8_CODES || nq <= 0 || ngroups <= 0
      || d <= 0 || d % (int8 ? 16 : 8) != 0
      || static_cast<long long>(ngroups) * ft::GROUP >= (1LL << 31)
      || (bmax != nullptr && ngroups % 8 != 0)
      || (fmt == F32_PLANES && db_lo == nullptr)
      || (int8 && q_lo == nullptr)
      || ((int8 || f16_mma) && beta == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ft::EncodeTiled enc = ft::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUtensorMapDataType qt = int8      ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : f16_mma ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType vt =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : fmt == F16_BITS ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int bn = fmt == BF16_ROWS ? K1_BN : 64;
  CUtensorMap maps[4];
  const int rows = ngroups * ft::GROUP;
  if (!ft::plane_map(enc, &maps[0], qt, q_hi, d, nq, QTILE)
      || !ft::plane_map(enc, &maps[1], qt, q_lo != nullptr ? q_lo : q_hi, d, nq,
                    QTILE)
      || !ft::plane_map(enc, &maps[2], vt, db, d, rows, bn)
      || !ft::plane_map(enc, &maps[3], vt, fmt == F32_PLANES ? db_lo : db, d,
                    rows, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q_hi, q_lo, static_cast<const float*>(vn),
               static_cast<const float*>(beta), static_cast<float*>(gm),
               static_cast<float*>(bmax), nq, d, ngroups};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (fmt) {
    case BF16_ROWS:
      e = q_lo != nullptr ? launch_metric<BF16_ROWS>(maps, a, l2, s)
                          : launch_metric<BF16_ROWS, 1>(maps, a, l2, s);
      break;
    case F32_PLANES:
      e = q_lo != nullptr ? launch_metric<F32_PLANES>(maps, a, l2, s)
                          : launch_metric<F32_PLANES, 1>(maps, a, l2, s);
      break;
    case F16_BITS:
      e = q_lo != nullptr ? launch_metric<F16_BITS>(maps, a, l2, s)
                          : launch_metric<F16_BITS, 1>(maps, a, l2, s);
      break;
    default: e = launch_metric<INT8_CODES>(maps, a, l2, s); break;
  }
  return static_cast<int>(e);
}

// The message of a code the entry points return (a cudaError_t).
extern "C" const char* ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
