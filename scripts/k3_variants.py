"""The tensor-core sweeps (csrc/sweep_split_mma.cu: K3 over the f32 planes,
K1 and, with one query plane, K2 over bf16 rows, K6 and, with one query
plane, K7 over f16 bits, K5 over int8 codes) against variants of
themselves, on one CUDA card; K4, the f32 planes with one query plane,
too.

    python scripts/k3_variants.py [--kernels k3,k1,k6,k5,k2,k7,k4] [--only a,b]
                                  [--nv 1000448,10000384] [--d 128,256]
                                  [--reps 10]

Each variant is a patched copy of the kernel's source, built with nvcc into
its own library and called through ``ft_sweep_mma`` on the same inputs (nq
104, d 128 or the --d list, L2, with the supergroup maxes; Gaussian rows:
K3 and K4 their f32 planes, K1 and K2 their bf16 values, K6 and K7 their
f16 bits; K5
random codes and query planes in [-127, 127]):

  kernel        the source as it is
  no_mma        the products left out: the TMA ring and its barriers alone
  no_load       the row tiles' loads left out: the products alone (on stale
                shared memory)
  norms_ldg     each tile's norms loaded from device memory by every
                consumer thread before its products (the earlier design), not
                brought into shared memory by a bulk copy on the tile's
                first full barrier
  K3 only:
  norms_late    norms_ldg with each tile's norms loaded in its epilogue,
                after its products have drained
  ordered       the two warpgroups take turns issuing a tile's products
                (K1's schedule)
  wait0         each stage released only once its own products have ended
                (wgmma.wait_group 0), not once the next chunk's are issued
  even_split    the groups split evenly over the blocks, a supergroup
                shared by two blocks folded with an fp32 atomic max (the
                variant's own copy of the one K4's CUDA-core kernel used
                until it moved onto this template)
  K1 only:
  no_rs         the query planes' A fragments from shared memory (TMA), as
                at d > 128 and in K3, not from registers
  no_order      the warpgroups issue their products side by side, without
                turns, so their epilogues coincide (K3's schedule)
  first         no_rs, no_order and K3's norms_late together: the first
                design, K3's schedule with one db plane
  n128          wgmma's N side 128 rows (K1_BN): one m64n128k16 a term over
                a whole group, 2 × 64 accumulators, 8 stages of 16 KB
  n128_no_mma, n128_no_load   the same two cuts of n128
  K6 only (K1's over the stored f16 rows and f16 query planes, without
  the turns; time it at --d 96, the f16 cell's width):
  no_rs         the query planes from shared memory, as K1's no_rs
  ordered       the two warpgroups take turns, as K1's (ptxas serializes
                the wgmma under them with the k-tail skipped: C7520)
  ktail         the last chunk's k-steps past d issued too (zeros)
  ktail_ordered ktail with the turns: K1's structure as it is
  kt2           the k-tail skip as a constant, 2 k-steps (d 96 only)
  K5 only:
  no_rs         the query planes from shared memory, as K1's no_rs
  ordered       the two warpgroups take turns, as K1's
  K2 only:
  no_rs         the query plane from shared memory, as K1's no_rs
  no_order      without the turns, as K1's no_order
  n128          K1's n128: one m64n128k16 over a whole group, 64
                accumulators (one term), A from shared memory
  rs4           the query plane as A fragments in registers at 4 chunks
                (d 256; 64 registers) and not at 2 (d 128): time it at
                --d 256 against the kernel, which reads A from shared
                memory there
  K7 only:
  no_rs         q1 from shared memory (TMA), as at d > 128, not as A
                fragments in registers for both terms
  ndec96        three decode warps, not four: 384 threads
  ndec224       seven decode warps (512 threads; 128 registers a thread)
  K4: the kernel and the cuts above (no_mma: its products left out).

Times are graph replays (chip_smoke.graph_ms) in two rounds; every variant
that computes must give the kernel's group maxes bit for bit, and supergroup
maxes equal to block_max_plain of them (one that does not is reported, left
untimed, and makes the script exit 1). Last, each float kernel (through
kernels.sweep_split, kernels.sweep_groupmax, kernels.sweep_f16) on the
truncation adversary of tests/test_torch_mma_eps.py (K2, K4 and K7 with one
query plane): its error, in units
of ‖q‖·‖v‖·u (u = 2^-24), where a sum that truncates every addend at the
largest one's exponent loses ≈ 254 and round to nearest ≈ 0 (K5's integer
sums are exact). Prints the card's name and power
limit first. Imports nothing of jax or faiss_tpu; exits 1 without a card.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "faiss_tpu_torch" / "csrc" / "sweep_split_mma.cu"


def _patch(text, pairs):
    for a, b in pairs:
        if a not in text:
            raise RuntimeError(f"k3_variants: the source no longer holds "
                               f"{a.strip()[:60]!r}")
        text = text.replace(a, b)
    return text


MMA = """      if constexpr (RS) {
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
                                 dvh + 2 * ks, on);"""
ROW_LOADS = """          mbar_expect_tx(full + stage,
                         (resident ? S::B_TX : S::A_BYTES + S::B_TX)
                             + (kc == 0 ? S::BN * 4 : 0));"""
NORM_LOAD = """          if (kc == 0)   // the tile's norms, with its first chunk
            bulk_load(nring + stage * S::BN, vn + row, S::BN * 4,
                      full + stage);
"""
NORM_READ = """    if (kc == 0) {
      const float* v = nring + stage * S::BN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < S::BN / 8; ++j)
        w[j] = *reinterpret_cast<const float2*>(v + 8 * j);
    }
"""
FOLD_AT = "  // a tile's epilogue into the group's running maxes"
TURN = "      if (ordered && (wg == 1 || i > 0)) named_sync(1 + wg);\n"
ROW_TMA = """          tma_load(&tv_hi, st, full + stage, kc * S::KC, row);
          if constexpr (S::LOADS == 2)
            tma_load(&tv_lo, st + S::B_PLANE, full + stage, kc * S::KC, row);"""
DEFER = """    wgmma_commit();
    wgmma_wait_prev();   // the chunk before this one has been read
    if (prev >= 0 && t == 0) mbar_arrive(empty + prev);
    prev = stage;"""
TILE_END = """      if (t == 0) mbar_arrive(empty + prev);
      prev = -1;
"""
WAIT0 = """    wgmma_commit();
    wgmma_wait_all();
    if (t == 0) mbar_arrive(empty + stage);
    prev = -1;"""
K1_N = "constexpr int K1_BN = 64;"
KTAIL = """        if constexpr (S::F16_MMA)
          if (kc == RSK - 1 && ks >= last_ks) continue;
"""
LAST_KS = ("  [[maybe_unused]] const int last_ks = "
           "(d - (RSK - 1) * S::KC + 15) / 16;")
KT2 = "  constexpr int last_ks = 2;   // d 96 only"
NDEC = "static constexpr int NDEC = DECODE ? 128 : 0;"
ORDERED = "static constexpr bool ORDERED = F == BF16_ROWS;"
K6_TURNS = "static constexpr bool ORDERED = F == BF16_ROWS || F16_MMA;"
RS_AT = "  if constexpr (RS_KC > 0)\n"
RS_K1 = "  constexpr int RS_KC = F == BF16_ROWS && K1_BN == 64 ? 2\n"
RS_K2_AT4 = ("  constexpr int RS_KC = F == BF16_ROWS && K1_BN == 64\n"
             "                            ? (QP == 1 ? 4 : 2)\n")
NORMS = "      norms(w, g, h);\n"
WAIT_ALL = ("      wgmma_wait_all();   // the tile's last chunk, and its "
            "accumulators\n")
NO_MMA = "      (void)on;"
# n128: the m64n128k16 wgmma (64 accumulators a thread) beside m64n64k16
WGMMA_N = """  static_assert(N == 64, "wgmma: N = 64 only");
  wgmma_64x64<F16>(d, da, db, scale_d);"""
WGMMA_N128 = """  if constexpr (N == 64)
    wgmma_64x64<F16>(d, da, db, scale_d);
  else
    wgmma_64x128(d, da, db, scale_d);"""
WGMMA_AT = "// The wgmma of an N = BN tile:"
W128 = r'''__device__ __forceinline__ void wgmma_64x128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
'''


def _norms_ldg(text):
    """Each tile's norms loaded from device memory by every consumer
    thread at the tile's start (the design before the norms' ring)."""
    return _patch(text, [
        (NORM_LOAD, ""),
        (ROW_LOADS, "          mbar_expect_tx(full + stage, resident ? "
                    "S::B_TX : S::A_BYTES + S::B_TX);"),
        (NORM_READ, ""),
        (FOLD_AT, """  auto norms = [&](Norms& w, int g, int h) {
    const float* v = vn + static_cast<size_t>(g) * ft::GROUP + h * S::BN
                     + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < S::BN / 8; ++j)
      w[j] = __ldg(reinterpret_cast<const float2*>(v + 8 * j));
  };
""" + FOLD_AT),
        (TURN, NORMS + TURN),
    ])


# the fp32 atomic max that even_split folds a shared supergroup with: a value
# with the sign bit clear wins by a signed-integer max of the bits, one with
# it set by an unsigned min (the exact max in any order on non-NaN values)
ATOMIC_MAX = """__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_uint(v) >> 31)
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  else
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
}

"""
KERNEL_AT = "// -- the kernel ----"


def _even_split(text):
    return _patch(text, [
        (KERNEL_AT, ATOMIC_MAX + KERNEL_AT),
        ("""  const int nsg = (ngroups + 7) / 8;
  const int sg0 = static_cast<int>(
      static_cast<long long>(blockIdx.x) * nsg / gridDim.x);
  const int sg1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * nsg / gridDim.x);
  const int g0 = 8 * sg0, g1 = min(8 * sg1, ngroups);""",
         """  const int g0 = static_cast<int>(
      static_cast<long long>(blockIdx.x) * ngroups / gridDim.x);
  const int g1 = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * ngroups / gridDim.x);"""),
        ("""      if ((g & 7) == 7) {
        if (writer && q0 < nq) bmax[q0 * nsgs + g / 8] = bm0;
        if (writer && q1 < nq) bmax[q1 * nsgs + g / 8] = bm1;""",
         """      if ((g & 7) == 7 || g == g1 - 1) {
        const bool whole = (g & 7) == 7 && g - 7 >= g0;
        auto fold = [&](int q, float m) {
          float* out = bmax + q * nsgs + g / 8;
          if (whole) *out = m; else atomic_max_f32(out, m);
        };
        if (writer && q0 < nq) fold(q0, bm0);
        if (writer && q1 < nq) fold(q1, bm1);"""),
        ("  const int nsg = (a.ngroups + 7) / 8;\n"
         "  const int nbx = max(1, min(nsg, di.sms / nqt));",
         "  const int nbx = max(1, min(a.ngroups, di.sms / nqt));"),
    ])


def _n128(text):
    """wgmma's N side 128 rows for the bf16 rows (K1_BN): one m64n128k16 a
    term over a whole group; the query planes from shared memory."""
    return _patch(text, [(K1_N, "constexpr int K1_BN = 128;"),
                         (WGMMA_N, WGMMA_N128),
                         (WGMMA_AT, W128 + "\n" + WGMMA_AT)])


def _cuts(text):
    """The kernel without its products, and without its loads (the rows'
    tiles and the norms; the full barrier a plain arrival)."""
    return {"no_mma": _patch(text, [(MMA, NO_MMA)]),
            "no_load": _patch(text, [(ROW_LOADS,
                                      "          mbar_arrive(full + stage);"),
                                     (ROW_TMA, ""), (NORM_LOAD, "")])}


def variants(text, kernel):
    """{name: source}: the variants of ``kernel`` (k3, k1, k6, k5, k2, k7,
    k4)."""
    base = {"kernel": text, **_cuts(text), "norms_ldg": _norms_ldg(text)}
    late = [(NORMS, ""), (WAIT_ALL, WAIT_ALL + NORMS)]
    free = _patch(text, [(ORDERED, "static constexpr bool ORDERED = false;")])
    if kernel == "k7":
        base.update({"no_rs": _patch(text, [(RS_AT,
                                             "  if constexpr (false)\n")]),
                     "ndec96": _patch(text, [(NDEC, NDEC.replace("128",
                                                                 "96"))]),
                     "ndec224": _patch(text, [(NDEC, NDEC.replace("128",
                                                                  "224"))])})
    elif kernel == "k6":
        base.update({"no_rs": _patch(text, [(RS_AT,
                                             "  if constexpr (false)\n")]),
                     "ordered": _patch(text, [(ORDERED, K6_TURNS)]),
                     "ktail": _patch(text, [(KTAIL, "")]),
                     "ktail_ordered": _patch(text, [(KTAIL, ""),
                                                    (ORDERED, K6_TURNS)]),
                     "kt2": _patch(text, [(LAST_KS, KT2)])})
    elif kernel == "k2":
        base.update({"no_rs": _patch(text, [(RS_AT,
                                             "  if constexpr (false)\n")]),
                     "no_order": free,
                     "rs4": _patch(text, [(RS_K1, RS_K2_AT4)]),
                     "n128": _n128(text)})
    elif kernel == "k5":
        base.update({"no_rs": _patch(text, [(RS_AT,
                                             "  if constexpr (false)\n")]),
                     "ordered": _patch(text, [(
                         ORDERED, "static constexpr bool ORDERED = PLANES "
                                  "== 1;")])})
    elif kernel == "k1":
        n128 = _n128(text)
        no_rs = [(RS_AT, "  if constexpr (false)\n")]
        base.update({"no_rs": _patch(text, no_rs),
                     "no_order": free,
                     "first": _patch(_norms_ldg(free), no_rs + late),
                     "n128": n128,
                     **{f"n128_{k}": v for k, v in _cuts(n128).items()}})
    elif kernel == "k3":
        base.update({"norms_late": _patch(_norms_ldg(text), late),
                     "ordered": _patch(text, [(
                         ORDERED, "static constexpr bool ORDERED = true;")]),
                     "wait0": _patch(text, [(DEFER, WAIT0), (TILE_END, "")]),
                     "even_split": _even_split(text)})
    return base


def build(kernels, tmp, srcs):
    """{name: ctypes library} built side by side from {name: source}."""
    procs = {}
    for name, text in srcs.items():
        d = Path(tmp) / name
        d.mkdir()
        (d / "k.cu").write_text(text)
        for h in SRC.parent.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-Xptxas", "-v",
             "-o", str(d / "lib.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        _, err = p.communicate()
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in err.splitlines() if "Used " in line})
        if p.returncode != 0:
            raise RuntimeError(f"k3_variants: {name} did not build:\n{err}")
        ser = sum("C7520" in line or "serialized" in line
                  for line in err.splitlines())
        print(f"{name}: {', '.join(regs)}"
              + (f"; {ser} wgmma serialization notes" if ser else ""),
              flush=True)
        lib = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
        lib.ft_sweep_mma.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I,
                                     P]
        lib.ft_sweep_mma.restype = I
        libs[name] = lib
    return libs


def adversary_error(torch, fused, kernels, split_f32_bf16, MetricType,
                    kernel):
    """The kernel's largest |dot − exact| on query [1, s, …, s] against
    rows [1, −s, …, −s] scaled by 2^j in group j (s = 2^-12·1.4140625: s² is
    just under ulp(1) = 2^-23), IP, over ‖q‖·‖v‖·u of the row's group: K3
    over the rows' f32 planes, K1 and K2 over the rows in bf16, K6 over
    their f16 bits (exact in both) against the query's f16 split; K2, K4
    and K7 with one query plane."""
    d, nq, ng = 128, 8, 8
    s = 2.0 ** -12 * 1.4140625
    a = torch.full((d,), s, dtype=torch.float64)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = 2.0 ** torch.arange(ng, dtype=torch.float64)
    x = (row[None, :] * scale[:, None]).repeat_interleave(128, dim=0)
    dev = torch.device("cuda")
    qh, ql = fused.query_planes(a.float().to(dev).expand(nq, d).contiguous(),
                                2)
    vn = torch.zeros((ng * 128,), device=dev)
    ip = MetricType.INNER_PRODUCT
    if kernel in ("k1", "k2"):
        if kernel == "k2":   # a bf16-valued query: q1 is qh, ql is zero
            ql = None
        gm = kernels.sweep_groupmax(qh, ql, x.to(dev).to(torch.bfloat16), vn,
                                    metric=ip)
    elif kernel in ("k6", "k7"):
        sc = None
        if kernel == "k7":   # a bf16-valued query: q1 is qh
            ql = None
        else:
            from faiss_tpu_torch.storage import split_f32_f16
            qh, ql, sc = split_f32_f16(qh.float())
        gm = kernels.sweep_f16(qh, ql, x.to(dev).to(torch.float16), vn,
                               metric=ip, scales=sc)
    else:
        if kernel == "k4":   # a bf16-valued query: q1 is qh
            ql = None
        hi, lo = split_f32_bf16(x.float().to(dev))
        gm = kernels.sweep_split(qh, ql, hi, lo, vn, metric=ip)
    exact = (x[::128] @ a).to(dev)
    unit = torch.linalg.norm(a) * torch.linalg.norm(x[::128], dim=1) * 2.0 ** -24
    return float(((gm.double() - exact) / unit.to(dev)).abs().max())


FMT = {"k1": 0, "k3": 1, "k6": 2, "k5": 3, "k2": 0, "k7": 2,
       "k4": 1}   # enum Fmt


def time_variants(torch, chip_smoke, fused, MetricType, libs, kernel, nv,
                  reps, gen, d=128):
    """Each variant once (the computing ones bit for bit against the
    kernel's gm, their supergroup maxes against block_max_plain), then
    timed by graph replay in two rounds, at nq 104, d, L2. Returns the
    names of the variants that differed (left untimed)."""
    from faiss_tpu_torch.storage import (encode_f16_bits,
                                         flush_f16_subnormals,
                                         split_f32_bf16, split_f32_f16)

    dev = torch.device("cuda")
    nq = 104
    x = torch.randn((nv, d), device=dev, generator=gen)
    beta = None
    if kernel in ("k1", "k2"):
        hi, lo = x.to(torch.bfloat16), None
    elif kernel in ("k6", "k7"):
        hi, lo = flush_f16_subnormals(encode_f16_bits(x)), None
    elif kernel == "k5":
        hi = torch.randint(-127, 128, (nv, d), device=dev, generator=gen,
                           dtype=torch.int8)
        lo = None
        beta = torch.rand((nq, 2), device=dev, generator=gen) * 1e-2
    else:
        hi, lo = split_f32_bf16(x)
    vn = fused._premask_norms((x * x).sum(-1), nv, nv, MetricType.L2)
    del x
    if kernel == "k5":
        qh, ql = (torch.randint(-127, 128, (nq, d), device=dev, generator=gen,
                                dtype=torch.int8) for _ in range(2))
    elif kernel == "k6":
        qh, ql, beta = split_f32_f16(
            torch.randn((nq, d), device=dev, generator=gen))
    else:
        qh, ql = fused.query_planes(
            torch.randn((nq, d), device=dev, generator=gen),
            1 if kernel in ("k2", "k7", "k4") else 2)
    ng = nv // 128
    gm = torch.empty((nq, ng), device=dev)
    bm = torch.empty((nq, ng // 8), device=dev)
    ref = None
    bad = set()
    for rnd in range(2):
        for name, lib in libs.items():
            if name in bad:
                continue
            def run(lib=lib, name=name):
                bm.fill_(float("-inf"))
                rc = lib.ft_sweep_mma(
                    FMT[kernel], qh.data_ptr(),
                    None if ql is None else ql.data_ptr(), hi.data_ptr(),
                    None if lo is None else lo.data_ptr(), vn.data_ptr(),
                    None if beta is None else beta.data_ptr(),
                    gm.data_ptr(), bm.data_ptr(), nq, d, ng, 1,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            run()
            torch.cuda.synchronize()
            note = ""
            if not name.endswith(("no_mma", "no_load")):
                if ref is None:
                    ref = gm.clone()
                same = torch.equal(gm.view(torch.int32), ref.view(torch.int32))
                bits = torch.equal(bm.view(torch.int32),
                                   fused.block_max_plain(gm).view(torch.int32))
                if not (same and bits):
                    print(f"{kernel} nv {nv} d {d} {name}: DIFFERS from the "
                          f"kernel "
                          f"(gm {same}, bmax {bits}); not timed", flush=True)
                    bad.add(name)
                    continue
                note = " (gm and bmax bit for bit)"
            ms = chip_smoke.graph_ms(torch, run, reps)
            print(f"{kernel} nv {nv} d {d} round {rnd} {name}: {ms:.4f} ms"
                  f"{note}", flush=True)
    del hi, lo, gm, bm, beta
    torch.cuda.empty_cache()
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="k3,k1,k6,k5")
    ap.add_argument("--only", default="",
                    help="build and time only these variants (comma list)")
    ap.add_argument("--nv", default="1000448,10000384")
    ap.add_argument("--d", default="128")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import faiss_tpu_torch as ft
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused, kernels
    from faiss_tpu_torch.storage import split_f32_bf16

    print(ft.gpu_name_and_power_limit(), flush=True)
    which = args.kernels.split(",")
    bad = set()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        only = set(args.only.split(",")) - {""}
        srcs = {f"{k}/{name}": text for k in which
                for name, text in variants(SRC.read_text(), k).items()
                if not only or name in only or name == "kernel"}
        for k in which:
            (Path(tmp) / k).mkdir()
        libs = build(kernels, tmp, srcs)
        for k in which:
            mine = {n.split("/")[1]: lib for n, lib in libs.items()
                    if n.startswith(k + "/")}
            for nv in (int(x) for x in args.nv.split(",")):
                for d in (int(x) for x in args.d.split(",")):
                    bad |= time_variants(torch, chip_smoke, fused,
                                         MetricType, mine, k, nv, args.reps,
                                         gen, d)
    for k in which:
        if k == "k5":
            continue
        err = adversary_error(torch, fused, kernels, split_f32_bf16,
                              MetricType, k)
        print(f"{k} on the truncation adversary: error {err:.2f} "
              f"‖q‖·‖v‖·u (a truncating sum ≈ 254, round to nearest ≈ 0)",
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
