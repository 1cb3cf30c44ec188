"""Smoke run of faiss_tpu_torch on one CUDA card, at SIFT1M shape.

    python3 chip_smoke.py

Drives the port's main path through its user entry points: a 1M×128 bf16
TorchIndexFlat (data from numpy.random.default_rng(42), as bench.py makes
it), 100 queries, k=10, for L2 and IP; one search_async; nq=8 (two-plane
sweep); and a duplicated-vector index whose certificate fails, so both
fallback tiers run. Before that it builds the four CUDA kernels from
``faiss_tpu_torch/csrc`` and holds each against its plain PyTorch version
at the main path's shapes (nq_pad 104, d 128, nv_eff 1,000,448, kg 14,
k 10), timing both with CUDA events.

Exits non-zero, printing no result, when CUDA is absent or any phase fails.
The last two lines of stdout are the kernel table and the result:
    {"kernels": [{"name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "plain_ms"}, ...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Imports nothing of jax or faiss_tpu.
"""

import json
import sys
import time

import numpy as np

NV, D, NQ, K = 1_000_000, 128, 100, 10
SEED = 42
PF = "faiss_tpu/ops/pallas_fused.py"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps launches (after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(torch, idx, xq, metric):
    """Each kernel against its plain version at the main path's shapes.
    Sweep and rescore: |kernel − plain| ≤ the query's two-plane ε (it
    bounds the accumulation error of both sides). Selects: equal bits."""
    from faiss_tpu_torch.ops import fused, kernels
    from faiss_tpu_torch.storage import ROW_TILE, _round_up

    q, _, nq_pad = idx._prep_queries(xq)
    db, norms = idx.store.db, idx.store.norms
    nt = idx.ntotal
    nv_eff = _round_up(nt, ROW_TILE)   # as TorchIndexFlat._run_search_fn
    kg = K + fused.GROUP_PAD
    vn = fused._premask_norms(norms, nt, nv_eff, metric)
    eps = fused._sweep_eps(q, norms, nv_eff, metric=metric,
                           d_pad=idx.store.d_pad)[:, None]
    rows = {}

    def close(a, b, what):
        fin = torch.isfinite(b)
        check(torch.equal(fin, torch.isfinite(a)),
              f"{what}: non-finite entries differ")
        err = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
        check(bool((err <= eps).all()), f"{what}: error beyond ε")
        return float(err.max())

    for passes in (1, 2):
        qh, ql = fused.query_planes(q, passes)
        gm = kernels.sweep_groupmax(qh, ql, db, vn, metric=metric)
        gm_p = fused.sweep_groupmax_plain(qh, ql, db, vn, metric=metric)
        err = close(gm, gm_p, f"sweep_groupmax planes={passes}")
        rows[f"sweep_groupmax_{passes}"] = (err, cuda_ms(
            torch, lambda: kernels.sweep_groupmax(qh, ql, db, vn,
                                                  metric=metric), 20),
            cuda_ms(torch, lambda: fused.sweep_groupmax_plain(
                qh, ql, db, vn, metric=metric), 5))
    check(gm.shape == (nq_pad, nv_eff // 128), "gm shape")

    gidx, t = kernels.select_groups(gm, kg)
    gidx_p, t_p = fused.select_groups_plain(gm, kg)
    check(torch.equal(gidx, gidx_p) and torch.equal(t, t_p),
          "select_groups differs from its plain version")
    rows["select_groups"] = (0.0, cuda_ms(
        torch, lambda: kernels.select_groups(gm, kg), 50),
        cuda_ms(torch, lambda: fused.select_groups_plain(gm, kg), 5))

    s = kernels.rescore_groups(q, db, vn, gidx, metric=metric)
    s_p = fused.rescore_groups_plain(q, db, vn, gidx, metric=metric)
    rows["rescore_groups"] = (close(s, s_p, "rescore_groups"), cuda_ms(
        torch, lambda: kernels.rescore_groups(q, db, vn, gidx,
                                              metric=metric), 50),
        cuda_ms(torch, lambda: fused.rescore_groups_plain(
            q, db, vn, gidx, metric=metric), 5))

    vals, pos = kernels.final_select(s, K)
    vals_p, pos_p = fused.final_select_plain(s, K)
    check(torch.equal(vals, vals_p) and torch.equal(pos, pos_p),
          "final_select differs from its plain version")
    rows["final_select"] = (0.0, cuda_ms(
        torch, lambda: kernels.final_select(s, K), 50),
        cuda_ms(torch, lambda: fused.final_select_plain(s, K), 5))
    for name, (err, ms, pms) in rows.items():
        print(f"  {metric.value:>2} {name:<17} max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms", flush=True)
    return rows


def oracle_check(torch, idx, xq, metric, D, I):
    """recall@K and max |D − D_oracle| / ε against an fp64 oracle over the
    STORED bf16 rows and the stored fp32 norms (the ranking the index
    certifies), computed on the card. ε is the query's two-plane
    certificate bound, which covers the rescore's fp32 error."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused

    v = idx.store.db[: idx.ntotal, : idx.d].to(torch.float64)
    q = torch.from_numpy(np.asarray(xq, np.float64)).to(v.device)
    s = q @ v.T
    if metric is MetricType.L2:
        s = 2.0 * s - idx.store.norms[: idx.ntotal].to(torch.float64)
    ref = torch.sort(s, dim=1, descending=True, stable=True)[1][:, :K]
    got = torch.gather(s, 1, torch.from_numpy(I).to(v.device))
    if metric is MetricType.L2:
        got = (q * q).sum(1, keepdim=True) - got
    qp, nq, _ = idx._prep_queries(xq)
    eps = fused._sweep_eps(qp, idx.store.norms, idx.ntotal, metric=metric,
                           d_pad=idx.store.d_pad)[:nq, None]
    rel = np.abs(got.cpu().numpy() - D) / eps.cpu().numpy()
    ref = ref.cpu().numpy()
    hits = sum(len(set(a) & set(b)) for a, b in zip(ref.tolist(), I.tolist()))
    return hits / ref.size, float(rel.max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import faiss_tpu_torch as ft
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import kernels

    name = torch.cuda.get_device_name(0)
    smi = ft.gpu_name_and_power_limit()
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}", flush=True)

    rng = np.random.default_rng(SEED)
    xb = rng.standard_normal((NV, D), dtype=np.float32)
    xq = rng.standard_normal((NQ, D), dtype=np.float32)
    indexes = {}
    for metric in (MetricType.L2, MetricType.INNER_PRODUCT):
        t0 = time.perf_counter()
        idx = ft.TorchIndexFlat(D, metric=metric, device="cuda")
        idx.add(xb)
        torch.cuda.synchronize()
        print(f"add {metric.value}: {time.perf_counter() - t0:.3f} s, "
              f"capacity {idx.store.capacity}", flush=True)
        indexes[metric] = idx

    print("kernels vs plain (main-path shapes):", flush=True)
    by_metric = {m: phase_kernels(torch, idx, xq, m)
                 for m, idx in indexes.items()}
    # the table keeps the L2 times and the larger error of the two metrics
    rows = {key: (max(r[key][0] for r in by_metric.values()),) + row[1:]
            for key, row in by_metric[MetricType.L2].items()}

    # -- the main path, through the user entry points ----------------------
    # The counts are read right after this loop, which calls only search
    # and search_async; the pipelined timing below runs after the read.
    kernels.reset_launches()
    reps = 20
    for metric, idx in indexes.items():
        D_, I_ = idx.search(xq, K)
        check(D_.shape == (NQ, K) and I_.shape == (NQ, K), "result shape")
        check(np.isfinite(D_).all() and (I_ >= 0).all(), "sentinels in result")
        rec, rel = oracle_check(torch, idx, xq, metric, D_, I_)
        check(rec == 1.0, f"{metric.value}: recall@{K} {rec} != 1.0")
        check(rel <= 1.0, f"{metric.value}: distance error {rel:.2e} ε")
        t0 = time.perf_counter()
        for _ in range(reps):
            idx.search(xq, K)
        ms = (time.perf_counter() - t0) / reps * 1e3
        tok = idx.search_async(xq, K)
        Da, Ia = tok.wait()
        check(tok.is_ready() and np.array_equal(Ia, I_)
              and np.array_equal(Da, D_), "search_async differs from search")
        print(f"search {metric.value}: recall@{K}={rec} "
              f"max |D - D_oracle| = {rel:.2e} ε "
              f"ms/batch={ms:.4f} (host clock, incl. copy-back) "
              f"QPS={NQ / ms * 1e3:.1f} "
              f"fused_fallbacks={idx.fused_fallbacks}", flush=True)
    counts = dict(kernels.launches)
    print(f"launches in the main-path run: {counts}", flush=True)
    for key, n in counts.items():
        check(n > 0, f"kernel {key} was never launched by the main path")

    for metric, idx in indexes.items():
        q, _, nq_pad = idx._prep_queries(xq)
        pipe_ms = cuda_ms(torch, lambda: idx._run_search_fn(
            q, K, nq_pad, force_plain=False), reps)
        print(f"search {metric.value}: pipelined ms/batch={pipe_ms:.4f} "
              f"(CUDA events, {reps} searches enqueued back to back)",
              flush=True)

    # nq=8: the two-plane sweep from the start; ids equal to the plain path's
    kernels.reset_launches()
    idx = indexes[MetricType.L2]
    D8, I8 = idx.search(xq[:8], K)
    idx.set_force_plain(True)
    Dp, Ip = idx.search(xq[:8], K)
    idx.set_force_plain(False)
    n8 = dict(kernels.launches)
    check(n8["sweep_groupmax_1"] == 0 and n8["sweep_groupmax_2"] > 0,
          f"nq=8: expected the two-plane sweep only, launches {n8}")
    check(np.array_equal(I8, Ip), "nq=8: fused ids differ from plain")
    check(np.allclose(D8, Dp, rtol=1e-5, atol=1e-3), "nq=8: distances")
    print(f"nq=8: ids equal the plain path's; max |ΔD| "
          f"{np.abs(D8 - Dp).max():.3e}; launches {n8}", flush=True)

    # duplicated vectors: every score ties, the certificate fails, the
    # one-plane search falls back to tier 1 (two planes), then tier 2
    kernels.reset_launches()
    row = np.random.default_rng(SEED + 1).standard_normal(D).astype(np.float32)
    dup = ft.TorchIndexFlat(D, device="cuda")
    dup.add(np.tile(row, (200_000, 1)))
    qd = xq[:32]
    Dd, Id = dup.search(qd, K)
    nd = dict(kernels.launches)
    check(dup.fused_fallbacks == 1 and dup._no_reduced_sweep == {32},
          f"duplicates: fallbacks {dup.fused_fallbacks}, "
          f"pinned {dup._no_reduced_sweep}")
    check(nd["sweep_groupmax_1"] == 1 and nd["sweep_groupmax_2"] == 1,
          f"duplicates: expected one sweep per tier, launches {nd}")
    check(np.array_equal(Id, np.tile(np.arange(K), (32, 1))),
          "duplicates: ids are not 0..k-1")
    dup.set_force_plain(True)
    check(np.array_equal(dup.search(qd, K)[1], Id),
          "duplicates: ids differ from the plain path")
    print(f"duplicates: both fallback tiers ran, fused_fallbacks="
          f"{dup.fused_fallbacks}, ids = plain path's; launches {nd}",
          flush=True)

    meta = {
        "sweep_groupmax_1": ("sweep_groupmax.cu", f"{PF}:190"),
        "sweep_groupmax_2": ("sweep_groupmax.cu", f"{PF}:174"),
        "select_groups": ("select_groups.cu", f"{PF}:739"),
        "rescore_groups": ("rescore_groups.cu", f"{PF}:1050"),
        "final_select": ("final_select.cu", f"{PF}:809"),
    }
    table = [{"name": key, "route": "cuda",
              "source": f"faiss_tpu_torch/csrc/{src}", "replaces": rep,
              "launches": counts[key], "max_abs_err": rows[key][0],
              "ms": rows[key][1], "plain_ms": rows[key][2]}
             for key, (src, rep) in meta.items()]
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
