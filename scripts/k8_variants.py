"""The group select (K8, csrc/select_groups.cu) against variants of itself
and torch.topk, on one CUDA card.

    python scripts/k8_variants.py [--reps 50]

Each variant is a patched copy of the kernel's source, built with nvcc into
its own library and called through ``ft_select_groups``, at the two shapes
the flat main paths give it (nq 104: phase 2 over 7816 group maxes with kg
14, and the f32 stage 3a over 1792 pair scores with m = 32; Gaussian rows):

  kernel   the source as it is (8 warps a row over 7816 columns, 4 over 1792)
  w16      16 warps a row from 2049 to 8192 columns (16 keys a lane)
  w8_1792  8 warps a row from 513 to 2048 columns (8 keys a lane)

Every variant must give select_groups_plain's ids and t bit for bit. Times
are graph replays (chip_smoke.graph_ms) in two rounds, beside
torch.topk(x, kg + 1), the one PyTorch call that yields the top kg and the
threshold. Prints the card's name and power limit first. Imports nothing of
jax or faiss_tpu; exits 1 without a card.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "faiss_tpu_torch" / "csrc" / "select_groups.cu"
W8 = "      : ngroups <= 8192 ? launch<32, 8>(x, g, tv, nq, ngroups, kg, st)"
W4 = "      : ngroups <= 2048 ? launch<16, 4>(x, g, tv, nq, ngroups, kg, st)"


def _patch(text, old, new):
    if old not in text:
        raise RuntimeError(f"k8_variants: the source no longer holds "
                           f"{old.strip()[:60]!r}")
    return text.replace(old, new)


def variants(text):
    return {"kernel": text,
            "w16": _patch(text, W8, W8.replace("<32, 8>", "<16, 16>")),
            "w8_1792": _patch(text, W4, W4.replace("<16, 4>", "<8, 8>"))}


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
            raise RuntimeError(f"k8_variants: {name} did not build:\n{err}")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in err.splitlines() if "Used " in line})
        print(f"{name}: {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
        lib.ft_select_groups.argtypes = [P, P, P, I, I, I, P]
        lib.ft_select_groups.restype = I
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k8_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import faiss_tpu_torch as ft
    from faiss_tpu_torch.ops import fused, kernels

    print(ft.gpu_name_and_power_limit(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(kernels, tmp, variants(SRC.read_text()))
        for nq, ncols, kg in ((104, 7816, 14), (104, 1792, 32)):
            x = torch.randn((nq, ncols), device=dev, generator=gen)
            gi_p, t_p = fused.select_groups_plain(x, kg)
            gi = torch.empty((nq, kg), dtype=torch.int32, device=dev)
            t = torch.empty((nq,), device=dev)
            for rnd in range(2):
                for name, lib in libs.items():
                    def run(lib=lib, name=name):
                        rc = lib.ft_select_groups(
                            x.data_ptr(), gi.data_ptr(), t.data_ptr(), nq,
                            ncols, kg, torch.cuda.current_stream().cuda_stream)
                        if rc != 0:
                            raise RuntimeError(f"{name}: launch failed ({rc})")
                    run()
                    torch.cuda.synchronize()
                    if not (torch.equal(gi, gi_p) and torch.equal(
                            t.view(torch.int32), t_p.view(torch.int32))):
                        raise RuntimeError(f"{name} differs from "
                                           f"select_groups_plain at {ncols}")
                    ms = chip_smoke.graph_ms(torch, run, args.reps)
                    print(f"({nq}, {ncols}) kg {kg} round {rnd} {name}: "
                          f"{ms:.4f} ms (bit for bit)", flush=True)
                ms = chip_smoke.graph_ms(
                    torch, lambda: torch.topk(x, kg + 1), args.reps)
                print(f"({nq}, {ncols}) kg {kg} round {rnd} torch.topk(kg + 1): "
                      f"{ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
