"""K10's f32-rows mode, the IVF fine scan (csrc/rescore_groups.cu,
ft_rescore_groups with fmt 4), against variants of itself, on one CUDA card.

    python scripts/k10_variants.py [--only a,b] [--nprobe 16] [--reps 20]

The inputs are the ivf_1m main path's (chip_smoke.py): IVF4096,Flat over
1,000,000 mixture rows of chip_smoke.ivf_data(), f32 lists, L2, 100 queries
padded to 104, at each --nprobe: the index's own probe, chunk budget and
pre-masked norms. Each variant is a patched copy of the source, built with
nvcc into its own library and called through ``ft_rescore_groups``:

  kernel        the source as it is: the grouping pass (three kernels over
                the positions) and the chunk-major kernel, each distinct
                chunk read once (a run of more than 16 positions in pieces)
  legacy        the earlier kernel: one block per (query, rank), thread r
                reading row r in 16-byte steps, every position's chunk read
                again
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

Every variant must give the kernel's scores bit for bit (one that does not
is reported, left untimed, and makes the script exit 1). Times are graph
replays (chip_smoke.graph_ms) in two rounds. Prints the card's name and
power limit first, then the grouping's runs, the longest run and the chunk
reads. Last, the other four modes (bf16 rows, the pair, int8 codes, f16
bits), whose code the f32 kernel left as it was, through the kernel's
library and the legacy one on the same random rows and group ids: equal
bit for bit, or the script exits 1. Imports nothing of jax or faiss_tpu;
exits 1 without a card.
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
CASE_LEGACY = """    case F32: launch<F32>(qq, db, v2, n, gi, o, nq, d, kg, ngroups, l2, s); break;"""
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
  w.pieces[p] = make_int4(p, 1, clamp_chunk(gidx[p], ngroups), 0);
}

"""
CAP = "constexpr int F32_CAP = 16;"
STRIDE = "  const int stride4 = (min(d, F32_DK) / 4) | 1;"
BOUNDS = """__global__ void __launch_bounds__(ft::GROUP, 3)
rescore_f32_kernel("""


def _patch(text, pairs):
    for a, b in pairs:
        if a not in text:
            raise RuntimeError(f"k10_variants: the source no longer holds "
                               f"{a.strip()[:60]!r}")
        text = text.replace(a, b)
    return text


def variants(text):
    """{name: source}."""
    return {
        "kernel": text,
        "legacy": _patch(text, [(EPC, EPC_F32), (UNPACK, UNPACK_F32),
                                (CASE, CASE_LEGACY)]),
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
    """{nprobe: (q, rows, vn, cidx)} of the ivf_1m f32 index's fine scan."""
    from faiss_tpu_torch import ivf as ivf_mod
    from faiss_tpu_torch.ops import fused

    xb, xq = chip_smoke.ivf_data()
    idx = ft.TorchIndexIVFFlat(chip_smoke.D, chip_smoke.NLIST, device="cuda")
    idx.train(xb)
    idx.add(xb)
    nv = idx._data.shape[0]
    vn = fused._premask_norms(idx._norms, nv, nv, idx.metric, idx._ids >= 0)
    out = {}
    for nprobe in nprobes:
        idx.nprobe = nprobe
        q, _, _, npb, nbudget, _ = idx._prep_search(xq, None)
        cidx, _ = ivf_mod._chunk_ids(idx._probe(q, npb), idx._counts_dev,
                                     idx._ctable, nbudget)
        out[nprobe] = (q, idx._data, vn, cidx)
    return out


def time_variants(torch, chip_smoke, libs, nprobe, q, rows, vn, cidx, reps):
    """Each variant bit for bit against the kernel, then timed by graph
    replay in two rounds. Returns the names that differed (untimed)."""
    from faiss_tpu_torch.ops import kernels

    nq, d = q.shape
    kg = cidx.shape[1]
    ngroups = vn.shape[0] // 128
    _, run = cidx.clamp(0, ngroups - 1).unique(return_counts=True)
    cap = kernels.RESCORE_F32_CAP
    pieces = int(((run + cap - 1) // cap).sum())
    print(f"nprobe {nprobe}: nq {nq}, nbudget {kg}, positions {cidx.numel()}; "
          f"runs {run.numel()}, the longest {int(run.max())}; chunk reads: "
          f"{pieces} in pieces of ≤ {cap}, {cidx.numel()} one per position",
          flush=True)
    nwork = libs["kernel"].ft_rescore_f32_work(nq, kg, ngroups)
    work = {name: torch.empty((nwork,), dtype=torch.int32, device="cuda")
            for name in libs}
    out = {name: torch.empty((nq, kg * 128), device="cuda") for name in libs}

    def call(lib, name, w):
        rc = lib.ft_rescore_groups(
            q.data_ptr(), rows.data_ptr(), None, vn.data_ptr(),
            cidx.data_ptr(), out[name].data_ptr(), nq, d, kg, ngroups, 1, 4,
            w.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
                print(f"nprobe {nprobe} {name}: DIFFERS from the kernel; not "
                      f"timed", flush=True)
                bad.add(name)
                continue
            ms = chip_smoke.graph_ms(torch, run_it, reps)
            print(f"nprobe {nprobe} round {rnd} {name}: {ms:.4f} ms (bit for "
                  f"bit)", flush=True)
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
    ap.add_argument("--only", default="",
                    help="build and time only these variants (comma list)")
    ap.add_argument("--nprobe", default="16")
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
    inputs = ivf_inputs(torch, chip_smoke, ft,
                        [int(x) for x in args.nprobe.split(",")])
    bad = set()
    with tempfile.TemporaryDirectory() as tmp:
        srcs = {name: text for name, text in variants(SRC.read_text()).items()
                if not only or name in only or name == "kernel"}
        libs = build(kernels, tmp, srcs)
        for nprobe, (q, rows, vn, cidx) in inputs.items():
            bad |= time_variants(torch, chip_smoke, libs, nprobe, q, rows, vn,
                                 cidx, args.reps)
        if "legacy" in libs and not other_modes_bitwise(torch, libs):
            bad.add("other modes")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
