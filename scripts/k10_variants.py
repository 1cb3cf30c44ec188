"""K10's f32-rows mode, the IVF fine scan (csrc/rescore_groups.cu,
ft_rescore_groups with fmt 4), or its pair mode, stage 3a of the f32 flat
search (fmt 1), against variants of itself, on one CUDA card.

    python scripts/k10_variants.py [--mode f32|pair] [--only a,b]
                                   [--nprobe 16] [--nv 1000000,10000000]
                                   [--reps 20]

--mode f32 (the default): the inputs are the ivf_1m main path's
(chip_smoke.py): IVF4096,Flat over 1,000,000 mixture rows of
chip_smoke.ivf_data(), f32 lists, L2, 100 queries padded to 104, at each
--nprobe: the index's own probe, chunk budget and pre-masked norms.
--mode pair: the f32 main path's (chip_smoke.py): TorchIndexFlat() over
the --nv rows (1M: default_rng(42) as chip_smoke.py makes them; 10M: those
and 9M from default_rng(44), as its f32_10m), L2, the same 100 queries:
the arguments of the search's one stage-3a call (nq_pad 104, kg 14),
caught as the search makes it. Each variant is a patched copy of the
source, built with nvcc into its own library and called through
``ft_rescore_groups``:

  kernel        the source as it is
  legacy        the thread-per-row kernel: one block per (query, rank),
                thread r reading row r in 16-byte steps, every position's
                group read again, for the f32 rows (PRs 5-8) and the pair
                (PRs 2-9)
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
  grouped       the f32 rows' grouping pass first (each distinct group
                read once a launch, a run of more than 16 positions in
                pieces), then the streaming kernel over the pieces, q read
                from device memory (L1) for each piece's queries
  one_stage     a ring of one stage (32 KB): no load in flight under a
                block's products (six blocks an SM)
  stages6       a ring of six stages (192 KB): one block an SM
  no_swizzle    the tiles unswizzled: a quarter-warp's 16-byte reads of 8
                rows 128 bytes apart on one bank group

Every variant must give the kernel's scores bit for bit (one that does not
is reported, left untimed, and makes the script exit 1). Times are graph
replays (chip_smoke.graph_ms) in two rounds. Prints the card's name and
power limit first, then for each input the positions, the distinct groups
(chunks), the longest run and the reads in pieces. Last, in --mode f32,
the other four modes (bf16 rows, the pair, int8 codes, f16 bits) through
the kernel's library and the legacy one on the same random rows and group
ids: equal bit for bit, or the script exits 1. Imports nothing of jax or
faiss_tpu; exits 1 without a card.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "faiss_tpu_torch" / "csrc" / "rescore_groups.cu"

EPC = """  constexpr int EPC = FMT == INT8 ? 16 : 8;
  constexpr int ESZ = FMT == INT8 ? 1 : 2;"""
EPC_F32 = """  constexpr int EPC = FMT == INT8 ? 16 : FMT == F32 ? 4 : 8;
  constexpr int ESZ = FMT == INT8 ? 1 : FMT == F32 ? 4 : 2;"""
UNPACK = """      if constexpr (FMT == INT8) {
        ft::unpack16_i8(w, x);
      } else if constexpr (FMT == F16) {"""
UNPACK_F32 = """      if constexpr (FMT == INT8) {
        ft::unpack16_i8(w, x);
      } else if constexpr (FMT == F32) {
        x[0] = __uint_as_float(w.x);
        x[1] = __uint_as_float(w.y);
        x[2] = __uint_as_float(w.z);
        x[3] = __uint_as_float(w.w);
      } else if constexpr (FMT == F16) {"""
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


# -- the pair mode's variants ----------------------------------------------

PAIR_CASE = """    case PAIR:
      return static_cast<int>(
          l2 ? launch_pair<true>(qq, db, db2, n, gi, o, nq, d, kg, ngroups, s)
             : launch_pair<false>(qq, db, db2, n, gi, o, nq, d, kg, ngroups,
                                  s));"""
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
PAIR_CASE_GROUPED = """    case PAIR: {
      auto* wk = static_cast<int*>(work);
      return static_cast<int>(
          l2 ? launch_pair<true>(qq, db, db2, n, gi, o, nq, d, kg, ngroups,
                                 wk, s)
             : launch_pair<false>(qq, db, db2, n, gi, o, nq, d, kg, ngroups,
                                  wk, s));
    }"""
PAIR_AT = "// -- PAIR: streaming"
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
PAIR_STAGES = "constexpr int PAIR_STAGES = 3;"
SWIZZLED = "  const int off = 16 * (u ^ (r & 7));"
PAIR_LAUNCH = """  const long long P = static_cast<long long>(nq) * kg;
  const long long slots = static_cast<long long>(di.sms) * max(per_sm, 1);
  const int grid = static_cast<int>(P < slots ? P : slots);
  rescore_pair_kernel<L2><<<grid, PAIR_THREADS, smem, s>>>(
      maps[0], maps[1], q, vn, gidx, out, d, kg, ngroups, P);"""
PAIR_LAUNCH_GROUPED = """  const int P = nq * kg;
  const F32Work w(work, P, ngroups);
  e = cudaMemsetAsync(work, 0, (4 + static_cast<size_t>(ngroups)) * 4, s);
  if (e != cudaSuccess) return e;
  const int gb = (P + F32_GT - 1) / F32_GT;
  f32_count<<<gb, F32_GT, 0, s>>>(gidx, P, ngroups, w);
  f32_runs<<<gb, F32_GT, 0, s>>>(w);
  f32_order<<<gb, F32_GT, 0, s>>>(gidx, P, ngroups, w);
  rescore_pair_grouped<L2><<<min(P, di.sms * max(per_sm, 1)), PAIR_THREADS,
                             smem, s>>>(maps[0], maps[1], q, vn, w, out, d,
                                        kg);"""
PAIR_SIG = """                        int nq, int d, int kg, int ngroups, cudaStream_t s) {
  static PairDevice info[64];"""
PAIR_DEVICE_AT = "// Per device: SM count and opt-in shared memory, and whether the kernels"
# grouped: the pieces of the f32 rows' grouping pass, each group's slices
# streamed once for up to F32_CAP positions, each with its own chain
PAIR_GROUPED = """// grouped: the grouping pass's pieces, each group streamed once for its
// positions (q from device memory)
template <bool L2>
__global__ void __launch_bounds__(PAIR_THREADS)
rescore_pair_grouped(const __grid_constant__ CUtensorMap t_hi,
                     const __grid_constant__ CUtensorMap t_lo,
                     const float* __restrict__ q, const float* __restrict__ vn,
                     F32Work w, float* __restrict__ out, int d, int kg) {
  extern __shared__ uint8_t pair_smem[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(pair_smem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + PAIR_STAGES * PAIR_STAGE);
  uint64_t* empty = full + PAIR_STAGES;
  const int npieces = w.meta[2];
  const int nkc = (d + PAIR_KC - 1) / PAIR_KC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < PAIR_STAGES; ++s) {
      ft::mbar_init(full + s, 1);
      ft::mbar_init(empty + s, PAIR_CONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31;
  int stage = 0;
  uint32_t phase = 0;
  if (t >= PAIR_CONS) {
    if (lane != 0) return;
    for (int k = blockIdx.x; k < npieces; k += gridDim.x) {
      const int row = w.pieces[k].z * ft::GROUP;
      for (int kc = 0; kc < nkc; ++kc) {
        ft::mbar_wait(empty + stage, phase ^ 1u);
        uint8_t* st = ring + stage * PAIR_STAGE;
        ft::mbar_expect_tx(full + stage, PAIR_STAGE);
        ft::tma_load(&t_hi, st, full + stage, kc * PAIR_KC, row);
        ft::tma_load(&t_lo, st + PAIR_TILE, full + stage, kc * PAIR_KC, row);
        if (++stage == PAIR_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }
  for (int k = blockIdx.x; k < npieces; k += gridDim.x) {
    const int4 pc = w.pieces[k];
    int pos[F32_CAP];
    const float* qr[F32_CAP];
    float acc[F32_CAP];
#pragma unroll
    for (int j = 0; j < F32_CAP; ++j) {
      pos[j] = j < pc.y ? w.order[pc.x + j] : 0;
      qr[j] = q + static_cast<size_t>(pos[j] / kg) * d;
      acc[j] = 0.f;
    }
    for (int kc = 0; kc < nkc; ++kc) {
      ft::mbar_wait(full + stage, phase);
      const uint8_t* row = ring + stage * PAIR_STAGE + t * ft::TMA_ROW_BYTES;
      const int nu = min(PAIR_KC, d - kc * PAIR_KC) / 8;
      for (int u = 0; u < nu; ++u) {
        float x[8];
        pair_unit(row, u, t, x);
#pragma unroll
        for (int j = 0; j < F32_CAP; ++j) {
          if (j < pc.y) {   // block-uniform
            const float4* a = reinterpret_cast<const float4*>(
                qr[j] + kc * PAIR_KC + 8 * u);
            const float4 a0 = __ldg(a), a1 = __ldg(a + 1);
            acc[j] = fmaf(a0.x, x[0], acc[j]);
            acc[j] = fmaf(a0.y, x[1], acc[j]);
            acc[j] = fmaf(a0.z, x[2], acc[j]);
            acc[j] = fmaf(a0.w, x[3], acc[j]);
            acc[j] = fmaf(a1.x, x[4], acc[j]);
            acc[j] = fmaf(a1.y, x[5], acc[j]);
            acc[j] = fmaf(a1.z, x[6], acc[j]);
            acc[j] = fmaf(a1.w, x[7], acc[j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) ft::mbar_arrive(empty + stage);
      if (++stage == PAIR_STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
    const float vr = vn[static_cast<size_t>(pc.z) * ft::GROUP + t];
#pragma unroll
    for (int j = 0; j < F32_CAP; ++j)
      if (j < pc.y)
        out[static_cast<size_t>(pos[j]) * ft::GROUP + t] =
            (L2 ? 2.f * acc[j] : acc[j]) - vr;
  }
}

"""


def _plane_map_flat():
    """tma.cuh's plane_map as plane_map_flat, without the swizzle."""
    text = (SRC.parent / "tma.cuh").read_text()
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


def variants(text, mode):
    """{name: source}: the variants of ``mode`` (f32, pair)."""
    legacy = _patch(text, [(EPC, EPC_F32), (UNPACK, UNPACK_F32),
                           (CASE, CASE_LEGACY), (PAIR_CASE, PAIR_CASE_LEGACY),
                           (PAIR_AT, PAIR_LEGACY + PAIR_AT)])
    if mode == "pair":
        return {
            "kernel": text,
            "legacy": legacy,
            "grouped": _patch(text, [
                (PAIR_LAUNCH, PAIR_LAUNCH_GROUPED),
                ("rescore_pair_kernel<L2>", "rescore_pair_grouped<L2>"),
                (PAIR_SIG, PAIR_SIG.replace("int ngroups,",
                                            "int ngroups, int* work,")),
                (PAIR_CASE, PAIR_CASE_GROUPED),
                (PAIR_DEVICE_AT, PAIR_GROUPED + PAIR_DEVICE_AT)]),
            "one_stage": _patch(text, [(PAIR_STAGES, PAIR_STAGES.replace(
                "3", "1"))]),
            "stages6": _patch(text, [(PAIR_STAGES, PAIR_STAGES.replace(
                "3", "6"))]),
            "no_swizzle": _patch(text, [
                (SWIZZLED, "  const int off = 16 * u;"),
                ("ft::plane_map(", "plane_map_flat("),
                (PAIR_DEVICE_AT, _plane_map_flat() + PAIR_DEVICE_AT)]),
        }
    return {
        "kernel": text,
        "legacy": legacy,
        "pregrouped": _patch(text, [(GROUPING, "")]),
        "query_major": _patch(text, [(GROUPING, IDENTITY_LAUNCH),
                                     (PIECE_AT, IDENTITY + PIECE_AT)]),
        "cap32": _patch(text, [(CAP, "constexpr int F32_CAP = 32;")]),
        "no_pad": _patch(text, [(STRIDE, STRIDE.replace(" | 1", ""))]),
        "lb1": _patch(text, [(BOUNDS, BOUNDS.replace(
            "(ft::GROUP, 3)", "(ft::GROUP)"))]),
    }


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
        if p.returncode != 0:
            raise RuntimeError(f"k10_variants: {name} did not build:\n{err}")
        regs = [line.split("Used ")[1].split(",")[0]
                for line in err.splitlines() if "Used " in line]
        print(f"{name}: built ({', '.join(sorted(set(regs)))})", flush=True)
        lib = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
        lib.ft_rescore_groups.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I,
                                          P, P]
        lib.ft_rescore_groups.restype = I
        lib.ft_rescore_f32_work.argtypes = [I, I, I]
        lib.ft_rescore_f32_work.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


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


def pair_inputs(torch, chip_smoke, ft, nvs):
    """[(label, fmt, q, hi, lo, vn, gidx)]: the one stage-3a call of an f32
    L2 search over each --nv rows (chip_smoke.py's data: its 1M rows, then
    rows from default_rng(SEED + 2) in 1M batches, as its f32_10m), caught
    as fused_search makes it."""
    import numpy as np

    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused

    rng = np.random.default_rng(chip_smoke.SEED)
    xb = rng.standard_normal((chip_smoke.NV, chip_smoke.D), dtype=np.float32)
    xq = rng.standard_normal((chip_smoke.NQ, chip_smoke.D), dtype=np.float32)
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
        seen = []
        real = fused.rescore_groups

        def catch(queries, db, vn, gidx, *, metric, db2=None):
            if db2 is not None:
                seen.append((queries, db, db2, vn, gidx))
            return real(queries, db, vn, gidx, metric=metric, db2=db2)

        fused.rescore_groups = catch
        try:
            idx.search(xq, chip_smoke.K)
        finally:
            fused.rescore_groups = real
        if len(seen) != 1:
            raise RuntimeError(f"k10_variants: {len(seen)} stage-3a calls")
        q, hi, lo, vn, gidx = seen[0]
        out.append((f"nv {nv}", 1, q, hi, lo, vn, gidx))
        del idx
    return out


def time_variants(torch, chip_smoke, libs, case, reps):
    """Each variant bit for bit against the kernel on one input, then timed
    by graph replay in two rounds. Returns the names that differed
    (untimed)."""
    from faiss_tpu_torch.ops import kernels

    label, fmt, q, db, db2, vn, gidx = case
    nq, d = q.shape
    kg = gidx.shape[1]
    ngroups = vn.shape[0] // 128
    _, run = gidx.clamp(0, ngroups - 1).unique(return_counts=True)
    cap = kernels.RESCORE_F32_CAP
    pieces = int(((run + cap - 1) // cap).sum())
    print(f"{label}: nq {nq}, kg {kg}, positions {gidx.numel()}; distinct "
          f"groups {run.numel()}, the longest run {int(run.max())}; group "
          f"reads: {pieces} in pieces of ≤ {cap}, {gidx.numel()} one per "
          f"position", flush=True)
    nwork = libs["kernel"].ft_rescore_f32_work(nq, kg, ngroups)
    work = {name: torch.empty((nwork,), dtype=torch.int32, device="cuda")
            for name in libs}
    out = {name: torch.empty((nq, kg * 128), device="cuda") for name in libs}

    def call(lib, name, w):
        rc = lib.ft_rescore_groups(
            q.data_ptr(), db.data_ptr(),
            None if db2 is None else db2.data_ptr(), vn.data_ptr(),
            gidx.data_ptr(), out[name].data_ptr(), nq, d, kg, ngroups, 1,
            fmt, w.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed ({rc})")

    if "pregrouped" in libs:   # its grouping, made by the kernel
        call(libs["kernel"], "pregrouped", work["pregrouped"])
    bad = set()
    for rnd in range(2):
        for name, lib in libs.items():
            if name in bad:
                continue
            def run_it(lib=lib, name=name):
                call(lib, name, work[name])
            run_it()
            torch.cuda.synchronize()
            if not torch.equal(out[name].view(torch.int32),
                               out["kernel"].view(torch.int32)):
                print(f"{label} {name}: DIFFERS from the kernel; not timed",
                      flush=True)
                bad.add(name)
                continue
            ms = chip_smoke.graph_ms(torch, run_it, reps)
            print(f"{label} round {rnd} {name}: {ms:.4f} ms (bit for bit)",
                  flush=True)
    return bad


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
            rc = libs[name].ft_rescore_groups(
                q.data_ptr(), db.data_ptr(),
                None if db2 is None else db2.data_ptr(), vn.data_ptr(),
                gidx.data_ptr(), out.data_ptr(), nq, d, kg, ng, 1, fmt, None,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name} fmt {fmt}: launch failed ({rc})")
            outs.append(out)
        torch.cuda.synchronize()
        eq = torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
        print(f"fmt {fmt}: the kernel's library and the legacy one "
              f"{'agree bit for bit' if eq else 'DIFFER'}", flush=True)
        same &= eq
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("f32", "pair"), default="f32")
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
        srcs = {name: text
                for name, text in variants(SRC.read_text(), args.mode).items()
                if not only or name in only or name == "kernel"}
        libs = build(kernels, tmp, srcs)
        if args.mode == "pair":
            cases = pair_inputs(torch, chip_smoke, ft,
                                [int(x) for x in args.nv.split(",")])
        else:
            cases = ivf_inputs(torch, chip_smoke, ft,
                               [int(x) for x in args.nprobe.split(",")])
        for case in cases:
            bad |= time_variants(torch, chip_smoke, libs, case, args.reps)
        if (args.mode == "f32" and "legacy" in libs
                and not other_modes_bitwise(torch, libs)):
            bad.add("other modes")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
