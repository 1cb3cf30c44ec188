"""Smoke run of faiss_tpu_torch on one CUDA card, at SIFT1M shape.

    python3 chip_smoke.py

Builds the CUDA kernels from ``faiss_tpu_torch/csrc`` and drives the port's
main paths through its user entry points (search, search_async) at 1M×128,
100 queries, k=10, data from numpy.random.default_rng(42) as bench.py makes
it. Each path's launch counts are zeroed just before it and read just after:

  bf16      TorchIndexFlat(storage="bf16"), Gaussian, L2 and IP
  f32       TorchIndexFlat() (f32, the default), Gaussian, L2 and IP
  f32_sift  integer data in [0, 255] (bench.py's f32_sift), L2: hi_exact
  pair      f32 with keep_master=False (hi + lo planes only), L2

plus nq=8 (two-plane bf16 sweep) and a duplicated-vector index whose
certificate fails, so both fallback tiers run. Before the searches each
kernel is held against its plain PyTorch version at the main paths' shapes
(nq_pad 104, d 128, nv_eff 1,000,448, kg 14, k 10), both timed with CUDA
events. Recall@10 must be 1.0 against an fp64 oracle over the stored
database (bf16 rows, the f32 master, or hi + lo).

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
REPS = 20
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


def _within(torch, a, b, eps, what):
    """|a − b| ≤ eps row by row on finite entries; the max error."""
    fin = torch.isfinite(b)
    check(torch.equal(fin, torch.isfinite(a)),
          f"{what}: non-finite entries differ")
    err = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    check(bool((err <= eps).all()), f"{what}: error beyond ε")
    return float(err.max())


def _certificate_eps(idx, q, metric):
    """The two-plane certificate bound of the index's own sweep (bf16, or
    the f32 pair with the stored split statistics), (nq_pad, 1)."""
    from faiss_tpu_torch.ops import fused

    st = idx.store
    return fused._sweep_eps(q, st.norms, idx.ntotal, metric=metric,
                            d_pad=st.d_pad, pair_sweep=st.has_split,
                            split_stats=st.split_stats)[:, None]


def _shapes(idx, xq, metric):
    from faiss_tpu_torch.ops import fused
    from faiss_tpu_torch.storage import ROW_TILE, _round_up

    q, _, nq_pad = idx._prep_queries(xq)
    nv_eff = _round_up(idx.ntotal, ROW_TILE)   # as TorchIndexFlat does
    vn = fused._premask_norms(idx.store.norms, idx.ntotal, nv_eff, metric)
    return q, nq_pad, nv_eff, vn


def phase_kernels(torch, idx, xq, metric):
    """The bf16 kernels against their plain versions at the main path's
    shapes. Sweep and rescore: |kernel − plain| ≤ the query's two-plane ε
    (it bounds the accumulation error of both sides). Selects: equal bits."""
    from faiss_tpu_torch.ops import fused, kernels

    q, nq_pad, nv_eff, vn = _shapes(idx, xq, metric)
    db = idx.store.db
    kg = K + fused.GROUP_PAD
    eps = _certificate_eps(idx, q, metric)
    rows = {}

    for passes in (1, 2):
        qh, ql = fused.query_planes(q, passes)
        gm = kernels.sweep_groupmax(qh, ql, db, vn, metric=metric)
        gm_p = fused.sweep_groupmax_plain(qh, ql, db, vn, metric=metric)
        err = _within(torch, gm, gm_p, eps, f"sweep_groupmax planes={passes}")
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
    rows["rescore_groups"] = (_within(torch, s, s_p, eps, "rescore_groups"),
                              cuda_ms(torch, lambda: kernels.rescore_groups(
                                  q, db, vn, gidx, metric=metric), 50),
                              cuda_ms(torch, lambda: fused.rescore_groups_plain(
                                  q, db, vn, gidx, metric=metric), 5))

    vals, pos = kernels.final_select(s, K)
    vals_p, pos_p = fused.final_select_plain(s, K)
    check(torch.equal(vals, vals_p) and torch.equal(pos, pos_p),
          "final_select differs from its plain version")
    rows["final_select"] = (0.0, cuda_ms(
        torch, lambda: kernels.final_select(s, K), 50),
        cuda_ms(torch, lambda: fused.final_select_plain(s, K), 5))
    _print_rows(metric, rows)
    return rows


def phase_f32_kernels(torch, idx, xq, metric):
    """The f32 kernels against their plain versions at the main path's
    shapes: the pair sweep with 3 terms (K3) and 2 (K4) within the pair
    sweep's ε, the pair rescore within ε₂ of _pair_rescore_eps."""
    from faiss_tpu_torch.ops import fused, kernels

    q, nq_pad, nv_eff, vn = _shapes(idx, xq, metric)
    st = idx.store
    hi, lo = st.db_hi, st.db_lo
    rows = {}
    for passes in (2, 1):
        qh, ql = fused.query_planes(q, passes)
        eps = fused._sweep_eps(q, st.norms, idx.ntotal, metric=metric,
                               d_pad=st.d_pad, single_pass=passes == 1,
                               pair_sweep=True,
                               split_stats=st.split_stats)[:, None]
        gm = kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric)
        gm_p = fused.sweep_split_plain(qh, ql, hi, lo, vn, metric=metric)
        name = f"sweep_split_{passes + 1}"
        rows[name] = (_within(torch, gm, gm_p, eps, name), cuda_ms(
            torch, lambda: kernels.sweep_split(qh, ql, hi, lo, vn,
                                               metric=metric), 20),
            cuda_ms(torch, lambda: fused.sweep_split_plain(
                qh, ql, hi, lo, vn, metric=metric), 5))
        if passes == 2:
            gidx, _ = kernels.select_groups(gm, K + fused.GROUP_PAD)
    eps2 = fused._pair_rescore_eps(q, st.norms, idx.ntotal, metric=metric,
                                   d_pad=st.d_pad,
                                   split_stats=st.split_stats)[:, None]
    s = kernels.rescore_groups(q, hi, vn, gidx, metric=metric, db2=lo)
    s_p = fused.rescore_groups_plain(q, hi, vn, gidx, metric=metric, db2=lo)
    rows["rescore_groups_pair"] = (
        _within(torch, s, s_p, eps2, "rescore_groups_pair"),
        cuda_ms(torch, lambda: kernels.rescore_groups(
            q, hi, vn, gidx, metric=metric, db2=lo), 50),
        cuda_ms(torch, lambda: fused.rescore_groups_plain(
            q, hi, vn, gidx, metric=metric, db2=lo), 5))
    _print_rows(metric, rows)
    return rows


def _print_rows(metric, rows):
    for name, (err, ms, pms) in rows.items():
        print(f"  {metric.value:>2} {name:<19} max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms", flush=True)


def stored_rows(torch, idx):
    """The stored database the index certifies, as fp64: the bf16 rows, the
    f32 master, or hi + lo when pair only."""
    st, n = idx.store, idx.ntotal
    if st.pair_only:
        return (st.db_hi[:n, : idx.d].to(torch.float64)
                + st.db_lo[:n, : idx.d].to(torch.float64))
    return st.db[:n, : idx.d].to(torch.float64)


def oracle_check(torch, idx, xq, metric, D, I):
    """recall@K and max |D − D_oracle| / ε against an fp64 oracle over the
    stored database and the stored fp32 norms (the ranking the index
    certifies), computed on the card. ε is the query's two-plane
    certificate bound, which covers the rescore's fp32 error."""
    from faiss_tpu_torch import MetricType

    v = stored_rows(torch, idx)
    q = torch.from_numpy(np.asarray(xq, np.float64)).to(v.device)
    s = q @ v.T
    if metric is MetricType.L2:
        s = 2.0 * s - idx.store.norms[: idx.ntotal].to(torch.float64)
    ref = torch.sort(s, dim=1, descending=True, stable=True)[1][:, :K]
    got = torch.gather(s, 1, torch.from_numpy(I).to(v.device))
    if metric is MetricType.L2:
        got = (q * q).sum(1, keepdim=True) - got
    qp, nq, _ = idx._prep_queries(xq)
    eps = _certificate_eps(idx, qp, metric)[:nq]
    rel = np.abs(got.cpu().numpy() - D) / eps.cpu().numpy()
    ref = ref.cpu().numpy()
    hits = sum(len(set(a) & set(b)) for a, b in zip(ref.tolist(), I.tolist()))
    return hits / ref.size, float(rel.max())


def drive(torch, label, idx, xq, metric):
    """One checked search, REPS timed searches (host clock, copy-back
    included) and one search_async, through the user entry points."""
    D_, I_ = idx.search(xq, K)
    check(D_.shape == (NQ, K) and I_.shape == (NQ, K), f"{label}: shape")
    check(np.isfinite(D_).all() and (I_ >= 0).all(), f"{label}: sentinels")
    rec, rel = oracle_check(torch, idx, xq, metric, D_, I_)
    check(rec == 1.0, f"{label} {metric.value}: recall@{K} {rec} != 1.0")
    check(rel <= 1.0, f"{label} {metric.value}: distance error {rel:.2e} ε")
    t0 = time.perf_counter()
    for _ in range(REPS):
        idx.search(xq, K)
    ms = (time.perf_counter() - t0) / REPS * 1e3
    tok = idx.search_async(xq, K)
    Da, Ia = tok.wait()
    check(tok.is_ready() and np.array_equal(Ia, I_)
          and np.array_equal(Da, D_), f"{label}: search_async differs")
    print(f"search {label} {metric.value}: recall@{K}={rec} "
          f"max |D - D_oracle| = {rel:.2e} ε "
          f"ms/batch={ms:.4f} (host clock, incl. copy-back) "
          f"QPS={NQ / ms * 1e3:.1f} "
          f"fused_fallbacks={idx.fused_fallbacks}", flush=True)
    return I_


def main_path(torch, label, runs, need):
    """Drive ``runs`` [(index, queries, metric)] with the counts zeroed
    just before and read just after; every kernel in ``need`` must have
    launched."""
    from faiss_tpu_torch.ops import kernels

    kernels.reset_launches()
    for idx, xq, metric in runs:
        drive(torch, label, idx, xq, metric)
    counts = dict(kernels.launches)
    print(f"launches in the {label} main-path run: {counts}", flush=True)
    for key in need:
        check(counts[key] > 0,
              f"{label}: kernel {key} was never launched by the main path")
    return counts


def pipelined(torch, label, runs):
    for idx, xq, metric in runs:
        q, _, nq_pad = idx._prep_queries(xq)
        pipe_ms = cuda_ms(torch, lambda: idx._run_search_fn(
            q, K, nq_pad, force_plain=False), REPS)
        print(f"search {label} {metric.value}: pipelined ms/batch="
              f"{pipe_ms:.4f} (CUDA events, {REPS} searches enqueued back "
              f"to back)", flush=True)


def build_index(torch, ft, xb, metric, **kw):
    t0 = time.perf_counter()
    idx = ft.TorchIndexFlat(D, metric=metric, device="cuda", **kw)
    idx.add(xb)
    torch.cuda.synchronize()
    print(f"add {idx.storage_type.value} {metric.value} {kw}: "
          f"{time.perf_counter() - t0:.3f} s, capacity {idx.store.capacity}, "
          f"{idx.store.nbytes() / 1e9:.3f} GB", flush=True)
    return idx


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import faiss_tpu_torch as ft
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import kernels

    L2, IP = MetricType.L2, MetricType.INNER_PRODUCT
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
    xb_i = rng.integers(0, 256, (NV, D)).astype(np.float32)
    xq_i = rng.integers(0, 256, (NQ, D)).astype(np.float32)
    bf16 = {m: build_index(torch, ft, xb, m, storage="bf16") for m in (L2, IP)}
    f32 = {m: build_index(torch, ft, xb, m) for m in (L2, IP)}
    sift = build_index(torch, ft, xb_i, L2)
    pair = build_index(torch, ft, xb, L2, keep_master=False)
    check("hi_exact=True" in sift.describe(), "f32_sift is not hi_exact")
    check("hi_exact=False" in f32[L2].describe(), "Gaussian f32 is hi_exact")

    print("kernels vs plain (main-path shapes):", flush=True)
    by_metric = [phase_kernels(torch, idx, xq, m) for m, idx in bf16.items()]
    by_metric += [phase_f32_kernels(torch, idx, xq, m)
                  for m, idx in f32.items()]
    # the table keeps the L2 times and the larger error of the two metrics
    rows = {}
    for r in by_metric:
        for key, (err, ms, pms) in r.items():
            prev = rows.get(key)
            rows[key] = (err, ms, pms) if prev is None \
                else (max(prev[0], err),) + prev[1:]
    k4_launches = kernels.launches["sweep_split_2"]

    # -- the main paths, through the user entry points ---------------------
    # Each path's counts are read right after its loop, which calls only
    # search and search_async; the pipelined timing runs after the reads.
    bf16_runs = [(idx, xq, m) for m, idx in bf16.items()]
    f32_runs = [(idx, xq, m) for m, idx in f32.items()]
    counts = {"bf16": main_path(
        torch, "bf16", bf16_runs,
        ("sweep_groupmax_1", "sweep_groupmax_2", "select_groups",
         "rescore_groups", "final_select"))}
    counts["f32"] = main_path(
        torch, "f32", f32_runs,
        ("sweep_split_3", "rescore_groups_pair", "select_groups",
         "final_select"))
    counts["f32_sift"] = main_path(torch, "f32_sift", [(sift, xq_i, L2)],
                                   ("sweep_groupmax_1", "select_groups",
                                    "rescore_groups", "final_select"))
    check(counts["f32_sift"]["sweep_split_3"] == 0,
          "f32_sift swept the pair: hi_exact was not taken")
    counts["pair"] = main_path(torch, "pair", [(pair, xq, L2)],
                               ("sweep_split_3", "rescore_groups_pair",
                                "select_groups", "final_select"))
    pipelined(torch, "bf16", bf16_runs)
    pipelined(torch, "f32", f32_runs)
    pipelined(torch, "f32_sift", [(sift, xq_i, L2)])
    pipelined(torch, "pair", [(pair, xq, L2)])

    # keep_master=False ranks by hi + lo: its own plain path (pair_scores)
    # must return the same ids
    pair.set_force_plain(True)
    Dp, Ip = pair.search(xq, K)
    pair.set_force_plain(False)
    Df, If = pair.search(xq, K)
    check(np.array_equal(If, Ip), "pair: fused ids differ from plain")
    print(f"pair: ids equal the plain path's (pair_scores); max |ΔD| "
          f"{np.abs(Df - Dp).max():.3e}", flush=True)

    # nq=8: the two-plane sweep from the start; ids equal to the plain path's
    kernels.reset_launches()
    idx = bf16[L2]
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
    dup = ft.TorchIndexFlat(D, storage="bf16", device="cuda")
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
        "sweep_groupmax_1": ("sweep_groupmax.cu", f"{PF}:190", None),
        "sweep_groupmax_2": ("sweep_groupmax.cu", f"{PF}:174", None),
        "sweep_split_3": ("sweep_groupmax.cu", f"{PF}:239", None),
        "sweep_split_2": ("sweep_groupmax.cu", f"{PF}:204",
                          "no index route reaches _kernel_split2: launches "
                          "counted in the kernel phase"),
        "select_groups": ("select_groups.cu", f"{PF}:739", None),
        "rescore_groups": ("rescore_groups.cu", f"{PF}:1050", None),
        "rescore_groups_pair": ("rescore_groups.cu", f"{PF}:1074", None),
        "final_select": ("final_select.cu", f"{PF}:809", None),
    }
    table = []
    for key, (src, rep, note) in meta.items():
        n = k4_launches if note else sum(c[key] for c in counts.values())
        entry = {"name": key, "route": "cuda",
                 "source": f"faiss_tpu_torch/csrc/{src}", "replaces": rep,
                 "launches": n, "max_abs_err": rows[key][0],
                 "ms": rows[key][1], "plain_ms": rows[key][2]}
        if note:
            entry["note"] = note
        table.append(entry)
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
