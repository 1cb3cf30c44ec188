"""Where the time of one faiss_tpu_torch search goes, on one CUDA card.

    python scripts/torch_profile.py [--configs bf16,f32,f32_sift,pair,int8,f16,
                                               f32_10m,ivf_1m,ivf_1m_dense,
                                               sharded_f32,f32_range]
                                    [--searches 20] [--nv 1000000]

Builds each configuration at SIFT1M shape (nv×128, nq=100, k=10; data from
numpy.random.default_rng(42) as chip_smoke.py and bench.py make it; f32_10m
is f32 over 10·nv rows, the nv of the others then 9·nv from
default_rng(44) in batches of nv, as chip_smoke.py's main path), runs
two warm-up searches (the first may pin the one-plane shape, and builds the
shape's program), then torch.profiler over ``--searches`` synchronous
``search`` calls, each a replay of the search's CUDA graph. Prints one
line per configuration: device time per batch by part (the sweep kernel,
the group select, the rescore, the final select, torch's sorts, every other
kernel and copy), device busy, host wall per batch (profiler on) and the device's idle
share, the five kernels that took the most device time, plus the card's
name and power limit. Imports nothing of jax or faiss_tpu; exits 1 without
a card.

sharded_f32 is ShardedIndexFlat over ["cuda:0"] * 4 with the f32 rows
(one CUDA graph a search: four shard searches and the merge, whose sorts
count under "sorts"); f32_range the f32 index's ``range_search`` at the
median 10th-neighbour distance (one range pass, a replayed graph: the
GEMM, then a stable sort of each (nq_pad, chunk) score block).

ivf_1m is chip_smoke.py's IVF main path: TorchIndexIVFFlat(128, 4096), f32
lists, trained and filled with the nv rows of chip_smoke.ivf_data (the
Gaussian mixture), searched at nprobe 16 (the fine scan on K10's f32
rows); ivf_1m_dense the same index at nprobe 4096 (the plain dense sweep).
For ivf_1m the line also splits the device time by stage (``stages``):
the kernel time inside the span on the card of each profiler range that
``TorchIndexIVFFlat`` opens in its gather search (``ivf.coarse_gemm``,
``ivf.top_nprobe``, ``ivf.chunk_ids``, ``ivf.k10`` with its pre-masked
norms, ``ivf.top_k`` with the slot → id map), read from a second profile of
the eager search (``_search_packed_uncached``): the ranges open while a
program is captured, not when it is replayed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

D, NQ, K = 128, 100, 10
# the sweeps: the tensor-core template (K1 to K7); the rescores: K10 by
# (query, rank) (bf16, int8), its pair and f16 modes streamed, and its f32
# rows' grouping pass and chunk-major kernel
PARTS = (("sweep", ("sweep_split_mma_kernel",)),
         ("select_groups", ("select_groups_kernel",)),
         ("rescore", ("rescore_groups_kernel", "rescore_stream_kernel",
                      "rescore_f32_kernel", "f32_count", "f32_runs",
                      "f32_order")),
         ("final_select", ("final_select_kernel",)),
         # torch's stable sorts: phase 2 past the select kernel's limits
         # (_top_groups, _top_groups_from_bmax), topk_scores and the sharded
         # merge (rows of up to 4096 sort in place: SortKVInPlace)
         ("sorts", ("RadixSort", "radix_sort", "SortKernel", "sort_",
                    "SortKVInPlace")))


def device_events(torch, fn, reps: int):
    """torch.profiler over ``reps`` calls of fn (after one warm-up): the
    (name, µs) of every kernel, copy and set the card ran, the host wall
    time per call in ms, and the device µs under each ``ivf.*`` range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    events, work, spans = [], [], []
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        tr = evt.time_range
        if getattr(evt, "is_user_annotation", False):
            # a range's span on the card, from its first kernel's start to
            # its last one's end: not work itself
            if evt.name.startswith("ivf."):
                spans.append((evt.name, tr.start, tr.end))
        else:
            events.append((evt.name, tr.elapsed_us()))
            work.append((tr.start, tr.end))
    # one stream, launched in order by one thread: the work inside a
    # range's span is the work that range launched (the kernels of the
    # ctypes wrappers hang under no torch op, so the host tree misses them)
    stages = {}
    for name, a, b in spans:
        stages[name] = stages.get(name, 0.0) + sum(
            e - s for s, e in work if a <= s and e <= b)
    return events, wall, stages


def profile(torch, idx, xq, searches: int, call=None) -> dict:
    """``call`` (default: ``idx.search(xq, K)``) profiled ``searches``
    times after two warm-ups."""
    call = call or (lambda: idx.search(xq, K))
    call()                  # with device_events' warm-up: two calls
    events, wall, _ = device_events(torch, call, searches)
    stages = {}
    if hasattr(idx, "_search_packed_uncached"):
        _, _, stages = device_events(
            torch, lambda: idx._search_packed_uncached(xq, K).cpu(),
            searches)
    out = {name: 0.0 for name, _ in PARTS}
    other = 0.0
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
        part = next((p for p, keys in PARTS
                     if any(k in name for k in keys)), None)
        if part is None:
            other += us
        else:
            out[part] += us
    out = {k: v / searches / 1e3 for k, v in out.items()}
    out["other"] = other / searches / 1e3
    busy = sum(out.values())
    out.update(device_busy=busy, host_wall=wall,
               idle_share=1.0 - busy / wall,
               fused_fallbacks=idx.fused_fallbacks)
    if stages:
        out["stages"] = {k[len("ivf."):]: v / searches / 1e3
                         for k, v in stages.items()}
    out["top"] = [(name[:80], us / searches / 1e3) for name, us in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:5]]
    return out


def build_ivf(ft, torch, nv: int):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    chip_smoke.NV = nv
    xb, xq = chip_smoke.ivf_data()
    idx = ft.TorchIndexIVFFlat(D, chip_smoke.NLIST, device="cuda")
    idx.train(xb)
    idx.add(xb)
    torch.cuda.synchronize()
    return idx, xq


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs",
                    default="bf16,f32,f32_sift,pair,int8,f16,f32_10m,ivf_1m,"
                            "ivf_1m_dense")
    ap.add_argument("--searches", type=int, default=20)
    ap.add_argument("--nv", type=int, default=1_000_000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_profile: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import faiss_tpu_torch as ft

    rng = np.random.default_rng(42)
    xb = rng.standard_normal((args.nv, D), dtype=np.float32)
    xq = rng.standard_normal((NQ, D), dtype=np.float32)
    xb_i = rng.integers(0, 256, (args.nv, D)).astype(np.float32)
    xq_i = rng.integers(0, 256, (NQ, D)).astype(np.float32)
    configs = {"bf16": (xb, xq, dict(storage="bf16")),
               "f32": (xb, xq, {}),
               "f32_sift": (xb_i, xq_i, {}),
               "pair": (xb, xq, dict(keep_master=False)),
               "int8": (xb, xq, dict(storage="int8")),
               "f16": (xb, xq, dict(storage="f16")),
               "f32_10m": (xb, xq, {}),
               "sharded_f32": (xb, xq, {}),
               "f32_range": (xb, xq, {})}
    print(ft.gpu_name_and_power_limit(), flush=True)
    ivf = None
    for name in args.configs.split(","):
        if name.startswith("ivf_1m"):
            if ivf is None:
                ivf = build_ivf(ft, torch, args.nv)
            idx, queries = ivf
            idx.nprobe = idx.nlist if name == "ivf_1m_dense" else 16
            row = profile(torch, idx, queries, args.searches)
            print(json.dumps({"config": name, "metric": "l2",
                              "ntotal": idx.ntotal, "nprobe": idx.nprobe,
                              "ms_per_batch": row}), flush=True)
            continue
        base, queries, kw = configs[name]
        if name == "sharded_f32":
            idx = ft.ShardedIndexFlat(D, devices=["cuda:0"] * 4)
        else:
            idx = ft.TorchIndexFlat(D, device="cuda", **kw)
        idx.add(base)
        if name == "f32_10m":
            more = np.random.default_rng(44)
            for _ in range(9):
                idx.add(more.standard_normal((args.nv, D), dtype=np.float32))
        torch.cuda.synchronize()
        call = None
        if name == "f32_range":
            radius = float(np.median(idx.search(queries, K)[0][:, -1]))
            call = lambda: idx.range_search(queries, radius)  # noqa: E731
        row = profile(torch, idx, queries, args.searches, call)
        print(json.dumps({"config": name, "metric": "l2",
                          "ntotal": idx.ntotal, "ms_per_batch": row}),
              flush=True)
        del idx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
