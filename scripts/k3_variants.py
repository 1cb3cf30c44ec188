"""K3 (csrc/sweep_split_mma.cu) against variants of itself, on one CUDA card.

    python scripts/k3_variants.py [--nv 1000448,10000384] [--reps 10]

Each variant is a patched copy of the kernel's source, built with nvcc into
its own library and called through ``ft_sweep_split_mma`` on the same
inputs (nq 104, d 128, L2, with the supergroup maxes; the planes of
Gaussian rows):

  kernel      the source as it is
  no_mma      the products left out: the TMA ring and its barriers alone
  no_load     the row tiles' loads left out: the products alone (on stale
              shared memory)
  wait0       each stage released only once its own products have ended
              (wgmma.wait_group 0), not once the next chunk's are issued
  n128        one m64n128k16 a term over a whole group (192 accumulators,
              setmaxnreg 232 for the consumers, 40 for a producer
              warpgroup, 384 threads)
  even_split  the groups split evenly over the blocks, a supergroup shared
              by two blocks folded with ft::atomic_max_f32

Times are graph replays (chip_smoke.graph_ms) in two rounds; every variant
that computes must give the kernel's group maxes bit for bit, and supergroup
maxes equal to block_max_plain of them. Last, the kernel (through
kernels.sweep_split) on the truncation adversary of
tests/test_torch_mma_eps.py: its error, in units of ‖q‖·‖v‖·u (u = 2^-24),
where a sum that truncates every addend at the largest one's exponent
loses ≈ 254 and round to nearest ≈ 0. Prints the card's name and power
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


MMA = """          wgmma_64x64(acc1, dqh + 2 * ks, dvh + 2 * ks, acc);
          wgmma_64x64(acc2, dqh + 2 * ks, dvl + 2 * ks, acc);
          wgmma_64x64(acc3, dql + 2 * ks, dvh + 2 * ks, acc);"""
ROW_LOADS = """          mbar_expect_tx(full + stage, stage_bytes);"""
ROW_TMA = """          tma_load(&tv_hi, st, full + stage, kc * KC, row);
          tma_load(&tv_lo, st + B_PLANE, full + stage, kc * KC, row);"""
DEFER = """        wgmma_commit();
        wgmma_wait_prev();   // the chunk before this one has been read
        if (prev >= 0 && t == 0) mbar_arrive(empty + prev);
        prev = stage;"""
HALF_END = """      if (t == 0) mbar_arrive(empty + prev);
"""
WAIT0 = """        wgmma_commit();
        wgmma_wait_all();
        if (t == 0) mbar_arrive(empty + stage);
        prev = -1;"""


def _n128(text):
    """One m64n128k16 a term over the whole group, setmaxnreg."""
    ops = ", ".join(f"%{i}" for i in range(64))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    wg = ('__device__ __forceinline__ void wgmma_64x64(float (&d)[64], '
          'uint64_t da,\n    uint64_t db, int scale_d) {\n  asm volatile(\n'
          '      "{\\n .reg .pred p;\\n setp.ne.b32 p, %66, 0;\\n"\n'
          '      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
          f'      "{{{ops}}}, %64, %65, p, 1, 1, 0, 0;\\n}}\\n"\n'
          f'      : {outs}\n      : "l"(da), "l"(db), "r"(scale_d));\n}}\n\n')
    i0 = text.index("__device__ __forceinline__ void wgmma_64x64(")
    i1 = text.index("__device__ __forceinline__ void wgmma_fence()")
    text = text[:i0] + wg + text[i1:]
    return _patch(text, [
        ("constexpr int NTHREADS = NCONS + 32;",
         "constexpr int NTHREADS = NCONS + 128;"),
        ("constexpr int HALF = 64;", "constexpr int HALF = 128;"),
        ("void fence_regs(float (&d)[32]) {\n#pragma unroll\n"
         "  for (int i = 0; i < 32; ++i)",
         "void fence_regs(float (&d)[64]) {\n#pragma unroll\n"
         "  for (int i = 0; i < 64; ++i)"),
        ("  if (warp == NCONS / 32) {\n    // producer: one thread issues "
         "every load\n    if (lane != 0) return;",
         "  if (warp >= NCONS / 32) {\n    asm volatile(\"setmaxnreg.dec."
         "sync.aligned.u32 40;\\n\" ::: \"memory\");\n"
         "    if (warp != NCONS / 32 || lane != 0) return;"),
        ("      for (int h = 0; h < 2; ++h)\n",
         "      for (int h = 0; h < 1; ++h)\n"),
        ("  const int wg = warp >> 2;",
         "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 232;\\n\" ::: "
         "\"memory\");\n  const int wg = warp >> 2;"),
        ("  float acc1[32], acc2[32], acc3[32];\n#pragma unroll\n"
         "  for (int i = 0; i < 32; ++i)",
         "  float acc1[64], acc2[64], acc3[64];\n#pragma unroll\n"
         "  for (int i = 0; i < 64; ++i)"),
        ("    for (int h = 0; h < 2; ++h) {\n",
         "    for (int h = 0; h < 1; ++h) {\n"),
        ("      for (int j = 0; j < 8; ++j) {\n        const float2 w",
         "      for (int j = 0; j < 16; ++j) {\n        const float2 w"),
    ])


def _even_split(text):
    return _patch(text, [
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
          if (whole) *out = m; else ft::atomic_max_f32(out, m);
        };
        if (writer && q0 < nq) fold(q0, bm0);
        if (writer && q1 < nq) fold(q1, bm1);"""),
        ("  const int nsg = (ngroups + 7) / 8;\n"
         "  const int nbx = max(1, min(nsg, di.sms / nqt));",
         "  const int nbx = max(1, min(ngroups, di.sms / nqt));"),
    ])


def variants(text):
    return {
        "kernel": text,
        "no_mma": _patch(text, [(MMA, "          (void)acc;")]),
        "no_load": _patch(text, [(ROW_LOADS,
                                  "          mbar_arrive(full + stage);"),
                                 (ROW_TMA, "")]),
        "wait0": _patch(text, [(DEFER, WAIT0), (HALF_END, "")]),
        "n128": _n128(text),
        "even_split": _even_split(text),
    }


def build(kernels, tmp, srcs):
    """{name: ctypes library} built side by side from {name: source}."""
    procs = {}
    common = (SRC.parent / "common.cuh").read_text()
    for name, text in srcs.items():
        d = Path(tmp) / name
        d.mkdir()
        (d / "k.cu").write_text(text)
        (d / "common.cuh").write_text(common)
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
        print(f"{name}: {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
        lib.ft_sweep_split_mma.argtypes = [P, P, P, P, P, P, P, I, I, I, I, P]
        lib.ft_sweep_split_mma.restype = I
        libs[name] = lib
    return libs


def adversary_error(torch, fused, kernels, split_f32_bf16, MetricType):
    """K3's largest |dot − exact| on query [1, s, …, s] against rows
    [1, −s, …, −s] scaled by 2^j in group j (s = 2^-12·1.4140625: s² is
    just under ulp(1) = 2^-23), IP, over ‖q‖·‖v‖·u of the row's group."""
    d, nq, ng = 128, 8, 8
    s = 2.0 ** -12 * 1.4140625
    a = torch.full((d,), s, dtype=torch.float64)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    scale = 2.0 ** torch.arange(ng, dtype=torch.float64)
    x = (row[None, :] * scale[:, None]).repeat_interleave(128, dim=0)
    dev = torch.device("cuda")
    hi, lo = split_f32_bf16(x.float().to(dev))
    qh, ql = fused.query_planes(a.float().to(dev).expand(nq, d).contiguous(),
                                2)
    vn = torch.zeros((ng * 128,), device=dev)
    gm = kernels.sweep_split(qh, ql, hi, lo, vn,
                             metric=MetricType.INNER_PRODUCT)
    exact = (x[::128] @ a).to(dev)
    unit = torch.linalg.norm(a) * torch.linalg.norm(x[::128], dim=1) * 2.0 ** -24
    return float(((gm.double() - exact) / unit.to(dev)).abs().max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nv", default="1000448,10000384")
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
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    nq, d = 104, 128
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(kernels, tmp, variants(SRC.read_text()))
        for nv in (int(x) for x in args.nv.split(",")):
            x = torch.randn((nv, d), device=dev, generator=gen)
            hi, lo = split_f32_bf16(x)
            vn = fused._premask_norms((x * x).sum(-1), nv, nv, MetricType.L2)
            del x
            qh, ql = fused.query_planes(
                torch.randn((nq, d), device=dev, generator=gen), 2)
            ng = nv // 128
            gm = torch.empty((nq, ng), device=dev)
            bm = torch.empty((nq, ng // 8), device=dev)
            ref = None
            for rnd in range(2):
                for name, lib in libs.items():
                    def run(lib=lib):
                        bm.fill_(float("-inf"))
                        rc = lib.ft_sweep_split_mma(
                            qh.data_ptr(), ql.data_ptr(), hi.data_ptr(),
                            lo.data_ptr(), vn.data_ptr(), gm.data_ptr(),
                            bm.data_ptr(), nq, d, ng, 1,
                            torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: launch failed ({rc})")
                    run()
                    torch.cuda.synchronize()
                    note = ""
                    if not name.startswith("no_"):
                        if ref is None:
                            ref = gm.clone()
                        same = torch.equal(gm.view(torch.int32),
                                           ref.view(torch.int32))
                        bits = torch.equal(
                            bm.view(torch.int32),
                            fused.block_max_plain(gm).view(torch.int32))
                        if not (same and bits):
                            raise RuntimeError(f"{name} differs from the "
                                               f"kernel at nv {nv}")
                        note = " (gm and bmax bit for bit)"
                    ms = chip_smoke.graph_ms(torch, run, args.reps)
                    print(f"nv {nv} round {rnd} {name}: {ms:.4f} ms{note}",
                          flush=True)
            del hi, lo, gm, bm
            torch.cuda.empty_cache()
    err = adversary_error(torch, fused, kernels, split_f32_bf16, MetricType)
    print(f"kernel on the truncation adversary: error {err:.2f} "
          f"‖q‖·‖v‖·u (a truncating sum ≈ 254, round to nearest ≈ 0)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
