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
share, the five kernels that took the most device time, each program span's
mean host ms and count a batch (``spans``: ``faiss_tpu_torch.tracing``'s
ranges, on the profiler's clock) and each idle gap of the card past 0.5 ms
with the innermost program span open on the host at its middle
(``idle_gaps``), plus the card's name and power limit. Imports nothing of
jax or faiss_tpu; exits 1 without a card.

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
the device time of the operations launched inside each span that
``TorchIndexIVFFlat`` opens in its gather search (``ivf.coarse_gemm``,
``ivf.top_nprobe``, ``ivf.chunk_ids``, ``ivf.k10`` with its pre-masked
norms, ``ivf.top_k`` with the slot → id map), read from a second profile of
the eager search (``_search_packed`` under ``programs.eager()``): the
spans open while a program is captured, not when it is replayed.
"""

import argparse
import bisect
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


def program_spans(prof):
    """[(name, start µs, end µs)] of the port's spans (``tracing.SPANS``)
    among a stopped profiler's host events, by start."""
    from faiss_tpu_torch.tracing import SPANS

    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in SPANS),
                  key=lambda x: x[1])


def span_means(spans, reps: int) -> dict:
    """{span: [host ms a call, spans a call]} of ``program_spans``."""
    out = {}
    for name, a, b in spans:
        tot = out.setdefault(name, [0.0, 0])
        tot[0] += (b - a) * 1e-3
        tot[1] += 1
    return {k: [ms / reps, n / reps] for k, (ms, n) in out.items()}


def innermost(spans):
    """A function of a host time ``t`` (µs, or None): the innermost of
    ``spans`` open at ``t``, "none" where none is. Spans nest within one
    thread, so the innermost open one is the latest to start before ``t``
    among those not ended: a look back over the few spans that started
    just before ``t``."""
    spans = sorted(spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]

    def at(t):
        if t is not None:
            i = bisect.bisect_right(starts, t)
            for name, _, e in reversed(spans[max(0, i - 32):i]):
                if e >= t:
                    return name
        return "none"

    return at


def idle_gaps(work, spans, min_ms: float = 0.5):
    """[[ms, span]]: each idle gap of the card longer than ``min_ms``
    between its first and its last operation, longest first, with the
    innermost program span open on the host at the gap's middle ("none"
    outside every span); ``work`` the device's (start, end) µs, all on the
    profiler's one clock."""
    busy = []
    for a, b in sorted(work):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    label = innermost(spans)
    out = [[(b - a) * 1e-3, label(0.5 * (a + b))]
           for (_, a), (b, _) in zip(busy, busy[1:])
           if (b - a) * 1e-3 > min_ms]
    return sorted(out, reverse=True)


def device_events(torch, fn, reps: int):
    """torch.profiler over ``reps`` calls of fn (after one warm-up): the
    (name, µs) of every kernel, copy and set the card ran, the host wall
    time per call in ms, the device µs under each ``ivf.*`` range, each
    program span's host ms and count a call (``span_means``) and the
    device's idle gaps past 0.5 ms (``idle_gaps``)."""
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
    # each device operation's launch on the host: the CUDA runtime call
    # that shares its correlation id (a ctypes wrapper's kernels hang under
    # no torch op, so the host tree misses them)
    launch = {e.id: e.time_range.start for e in prof.events()
              if e.device_type == DeviceType.CPU
              and e.name.startswith(("cuda", "cu"))}
    host = program_spans(prof)
    label = innermost(host)
    events, work, stages = [], [], {}
    for evt in prof.events():
        if (evt.device_type != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        tr = evt.time_range
        events.append((evt.name, tr.elapsed_us()))
        work.append((tr.start, tr.end))
        stage = label(launch.get(evt.id))
        if stage.startswith("ivf."):
            stages[stage] = stages.get(stage, 0.0) + tr.elapsed_us()
    return (events, wall, stages, span_means(host, reps),
            idle_gaps(work, host))


def profile(torch, idx, xq, searches: int, call=None) -> dict:
    """``call`` (default: ``idx.search(xq, K)``) profiled ``searches``
    times after two warm-ups."""
    call = call or (lambda: idx.search(xq, K))
    call()                  # with device_events' warm-up: two calls
    events, wall, _, span_ms, gaps = device_events(torch, call, searches)
    stages = {}
    if hasattr(idx, "_prep_search"):      # the IVF index
        from faiss_tpu_torch import programs

        def eager():
            with programs.eager():
                return idx._search_packed(xq, K)[0].cpu()

        _, _, stages, _, _ = device_events(torch, eager, searches)
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
    out["spans"] = span_ms
    out["idle_gaps"] = gaps
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
