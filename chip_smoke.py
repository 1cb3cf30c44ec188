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
  int8      TorchIndexFlat(storage="int8"), Gaussian, L2 and IP (scales
            trained on the one add batch)
  f16       TorchIndexFlat(storage="f16"), Gaussian, L2 and IP, and an
            nq=8 L2 search (two query planes)

  f32_10m   the slice's main path: TorchIndexFlat() (f32), L2, 10,000,000
            rows (the 1M of the other paths, then 9M from
            default_rng(SEED + 2) in 1M batches): 78,128 groups, so the
            sweep also writes its supergroup maxes and phase 2 goes
            hierarchical; its plain path's time at the same size beside it
  f16_cell  K6 alone at the f16 cell's shape: 10M normalised f16 rows
            at d 96 (the k-steps past d in the last chunk not issued), IP,
            nq_pad 104, with its supergroup maxes, against its plain
            version; its launch counts zeroed just before it
  surface   the flat surface at 1M through its entry points: filtered f32
            and bf16 searches, a k=64 f32 search, rescore_select=True on the
            bf16, int8 and f16 stores, merge_from, remove_ids, range_search,
            IndexShardsHost and TorchIndexIDMap2 over it
  ivf_1m    the IVF slice's main path: TorchIndexIVFFlat(128, 4096), the
            "IVF4096,Flat" of faiss's benchs/bench_gpu_sift1m.py, over
            1,000,000 rows of a Gaussian mixture (4,096 centres 5·N(0, 1),
            N(0, 1) noise; scripts/bench_ivf_r4.py's recipe, data from
            default_rng(SEED + 3)), trained (Kmeans + balancing) three times
            with one seed for f32, bf16 and int8 lists (centroids equal bit
            for bit), then searched at nprobe 1, 16, 64 and 4096 (f32) and
            16 and 4096 (bf16, int8): the fine scan on K10 (f32 rows: the
            last TPU kernel) and its top-k on budget_select, the dense
            route on the fused kernels; recall
            1.0 against an fp64 oracle over the probed lists of the index's
            own coarse step; a flat f32 index over the same rows as the
            control; then range_search, remove_ids, merge_from, a filtered
            search, save / load and TorchIndexIDMap2 with nprobe
  sharded_1m  ShardedIndexFlat over ["cuda:0"] * 4 (four shards of the
            1M rows on the one card) for f32 and int8, L2: ids equal to
            the unsharded index's, recall 1.0, the merge's device ms; and
            the ivf_1m f32 index saved and reloaded with
            load_index(sharded=True, num_shards=4): at nprobe 16 its ids
            equal the single index's; each a programs row (one CUDA graph
            a search: four shard searches and the merge)
  native    the native host runtime (g++, at first call): the 1M bf16 and
            f16 adds above take its route (host norms and conversion, one
            2-byte upload), shown by its call counts; one 1M batch of each
            added by both routes, timed, with equal row bits and the
            norms' differences in ulps
  loader_1m build_index_from_file at DEFAULT_BATCH_ROWS (4 add batches):
            the Gaussian rows as .fvecs (f32, L2 and IP; and sharded over
            ["cuda:0"] * 4) and as .npy (bf16, every batch through the
            native route), the integer rows as .bvecs (f32, hi_exact):
            the in-memory indexes' ids, recall 1.0
  interop   index_cpu_to_torch / index_torch_to_cpu through a stand-in
            faiss module: the f32 index's ids, its rows bit for bit
  profiling bench_grid over the whole DEFAULT_GRID (14 configs, k up to
            2048, d up to 1536; faiss_tpu's data) on the card, recall over
            every query (1.0 on the f32 configs); measure_search on the 1M
            f32 index at depths 1, 8 and 32; a torch.profiler trace of one
            search, which names the sweep kernel
  programs  the search programs of TorchResources' cache (each search a
            CUDA graph captured once per shape and replayed; every search
            above and below runs through them): for f32, f32_sift, pair,
            bf16, int8 and f16 at 1M (L2), f32_10m (in its phase), the
            f32 flat range pass at 1M after the surface phase (a second
            radius must replay it),
            sharded_1m's f32 and int8 indexes and the sharded IVF reload
            (in theirs), ivf_1m's f32 lists at nprobe 1, 16 and 64, its
            range pass at nprobe 16 and the coarse assign of its 1M add (in
            its phase), the index's programs dropped and the cold first
            batch timed (eager warm-up and capture), the first batch and
            two replays held against the eager search (the uncached
            function) bit for bit, distances, id bits and certificates;
            host ms/batch eager and replayed in turns (eager, replay,
            replay, eager; the range pass and the assign: 3 reps) and
            cache_info()

plus nq=8 (two-plane bf16 sweep) and a duplicated-vector index whose
certificate fails, so both fallback tiers run. First, nan_repair holds the
bf16 NaN repair on the card (``storage.f32_to_bf16``: its bits on the card
equal its bits on the CPU; rows holding NaNs stored as bf16 rows, f32
pair-only planes and an IVF bf16 pool with the CPU port's bits, and their
searches return the CPU port's ids) and the f16 one (``encode_f16_bits``
on the card equals the CPU, negative NaNs included; f16 rows with
negative NaNs stored with the CPU's bits). The card's capabilities
(``describe_capabilities``) print on an early line. Before the searches each
kernel is held against its plain PyTorch version at the main paths' shapes
(nq_pad 104, d 128, nv_eff 1,000,448, kg 14, k 10; K9 also at the f32
path's 32 candidates, K8 at its stage-3a 1792 candidates with m = 32, K3
with its supergroup maxes also at 10M): the sweeps' supergroup-max output
(every format, both metrics), K8, K9, budget_select (at the IVF cell's
shape, 104 × 131,072 scores), K5 (int8, on the integer tensor cores) and
the rescore-select kernel (bf16, int8, f16) bit for bit, K3,
K4, K1, K2, K6 and K7 (the tensor-core sweeps with float sums) within their
ε with the tensor-core term (``_sweep_eps(accum="mma")``), and K3, K4, K1,
K6, K7 also on the truncation adversary of tests/test_torch_mma_eps.py,
their errors printed; K10's pair mode (stage 3a) within ε₂, with the count of
distinct groups its positions name; K10's f16 mode and K11 also bit for bit
PR 10's kernels (scripts/k10_variants.py legacy_sources, built beside the
library and timed beside them: ``legacy_ms``). f32_sift prints K2's
certificate ε on the card over the fmaf ε it had on the CUDA cores, and
its fallbacks; the K10 f32 row prints the runs of equal chunk ids, the
longest, and the pieces the kernel reads. Each main path's ms/batch on the
host clock closes its launch counts.
Kernels and their library calls are timed on the device (``graph_ms``: a
CUDA graph of the reps, replayed between CUDA events), the plain versions
eagerly (``cuda_ms``). Recall@K must be
1.0 against an fp64 oracle over the stored database (bf16 rows, the f32
master, hi + lo, the f16 values, or the int8 codes times the scales) and
the stored norms, computed on the card in chunks of 1M rows.

Exits non-zero, printing no result, when CUDA is absent or any phase fails.
The last three lines of stdout are the card's name and power limit
(nvidia-smi), the kernel table and the result:
    {"kernels": [{"name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms"}, ...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
``bound_ms`` is the least time the card could take for the kernel's work at
these shapes: the larger of its bytes (each input read once, each output
written once; the rescores read the rows of each distinct group their
result needs once, the IVF fine scan's dead budget positions left out)
over 3.35 TB/s and its operations over the data sheet's peak for their
type (bf16 or f16 products 989 TFLOP/s, int8 1979 TOP/s, fp32 FMA outside
the tensor cores 67 TFLOP/s). ``library_ms`` times the one PyTorch call that computes the
same function, where there is one (``torch.topk`` for the selects), else
null. Imports nothing of jax or faiss_tpu.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

NV, D, NQ, K = 1_000_000, 128, 100, 10
NV_10M = 10_000_000
NLIST = 4096                       # IVF4096,Flat (benchs/bench_gpu_sift1m.py)
SEED = 42
REPS = 20
ORACLE_CHUNK = 1 << 20
PF = "faiss_tpu/ops/pallas_fused.py"
HBM_BPS = 3.35e12                                  # H100 SXM data sheet
PEAK = {"bf16": 989e12, "f16": 989e12, "int8": 1979e12, "fp32": 67e12}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean time of fn over reps calls enqueued back to back (after one
    warm-up), CUDA events around them: the device time where the device is
    the bottleneck, else the host's launch rate. The plain versions and
    the pipelined searches are timed so."""
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


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of one call of fn: reps calls captured in one CUDA graph
    (after one eager warm-up), the graph replayed once to warm it and once
    between CUDA events, so the host's launch cost drops out. The kernels'
    ctypes launches go on torch.cuda.current_stream(), the capture stream
    there; each capture adds its reps launches to the wrappers' counts."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def _within(torch, a, b, eps, what):
    """|a − b| ≤ eps row by row on finite entries; the max error."""
    fin = torch.isfinite(b)
    check(torch.equal(fin, torch.isfinite(a)),
          f"{what}: non-finite entries differ")
    err = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    check(bool((err <= eps).all()), f"{what}: error beyond ε")
    return float(err.max())


def _eps(q, norms, n, d_pad, metric, scales=None, int_norm_max=None,
         split_stats=None, accum="fmaf"):
    """(nq_pad, 1) two-plane certificate bound over the stored rows: int8's
    when ``scales`` is given, the pair sweep's with ``split_stats`` (f32,
    f16), else bf16's, with the sweep accumulation ``accum``; it covers one
    fp32-true scoring of a stored row."""
    from faiss_tpu_torch.ops import fused

    if scales is not None:
        return fused._sweep_eps_int8(q, scales, int_norm_max, norms, n,
                                     metric=metric, d_pad=d_pad)[:, None]
    return fused._sweep_eps(q, norms, n, metric=metric, d_pad=d_pad,
                            pair_sweep=split_stats is not None,
                            split_stats=split_stats, accum=accum)[:, None]


def _certificate_eps(idx, q, metric, accum="fmaf"):
    """The two-plane certificate bound of the flat index's own sweep, with
    the sweep accumulation ``accum`` ("mma": K1, K3 on the tensor cores)."""
    st = idx.store
    return _eps(q, st.norms, idx.ntotal, st.d_pad, metric, st.scales,
                st.int_norm_max, st.split_stats, accum)


def k2_certificate(torch, idx, xq):
    """hi_exact's one-plane certificate on the card: its ε with the
    tensor-core term (K2) over its ε with the fmaf term (the JAX bound's),
    per query, and the index's fallbacks so far (an uncertified query is
    re-run exactly: a cost, not an error)."""
    from faiss_tpu_torch.ops import fused

    q, nq, _ = idx._prep_queries(xq)
    st = idx.store
    accum = fused.sweep_accum("hi_exact", 1, q.device)
    check(accum == "mma", f"f32_sift: K2 is certified with {accum}")
    kw = dict(metric=idx.metric, d_pad=st.d_pad, single_pass=True,
              pair_sweep=True, split_stats=st.split_stats)
    r = (fused._sweep_eps(q, st.norms, idx.ntotal, accum=accum, **kw)
         / fused._sweep_eps(q, st.norms, idx.ntotal, **kw))[:nq]
    print(f"f32_sift: K2's certificate ε (accum {accum}) over the fmaf ε: "
          f"{float(r.min()):.4f} to {float(r.max()):.4f} across the "
          f"queries; fused_fallbacks={idx.fused_fallbacks}", flush=True)


def _shapes(idx, xq, metric):
    from faiss_tpu_torch.ops import fused
    from faiss_tpu_torch.storage import ROW_TILE, _round_up

    q, _, nq_pad = idx._prep_queries(xq)
    nv_eff = _round_up(idx.ntotal, ROW_TILE)   # as TorchIndexFlat does
    vn = fused._premask_norms(idx.store.norms, idx.ntotal, nv_eff, metric)
    return q, nq_pad, nv_eff, vn


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, ops, kind):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sweep_bound(planes, dbs, vn, gm, terms, kind, extra=(), extra_bytes=0):
    """A sweep reads its query planes, the nv_eff rows of each db plane
    and the norm stream once and writes the group maxes (and, with
    ``extra_bytes``, the supergroup maxes); it does `terms` products of
    (nq, d) by (d, nv_eff)."""
    nq, d = planes[0].shape
    nv = vn.shape[0]
    nbytes = _nbytes(*planes, vn, gm, *extra) + extra_bytes + sum(
        nv * d * t.element_size() for t in dbs)
    return _bound(nbytes, 2.0 * terms * nq * nv * d, kind)


def _rescore_bound(q, row_bytes, gidx, *outs, live=None):
    """A rescore reads the query, the group ids, and the rows and norms of
    each distinct group its result needs once (a group that several
    queries nominate is read once), and writes its outputs; it does fp32
    dots outside the tensor cores (an fp32-true product) for the needed
    (query, group) positions. ``live``: the positions the result needs
    (the IVF fine scan's okc; None: all)."""
    d = q.shape[1]
    need = gidx if live is None else gidx[live]
    groups = int(need.unique().numel())
    return _bound(_nbytes(q, gidx, *outs) + groups * 128 * (d * row_bytes + 4),
                  2.0 * need.numel() * 128 * d, "fp32")


def _block_max(torch, name, launch):
    """The sweep ``launch(with_block_max)``'s second output against the
    plain amax over the (nq, ngroups/8, 8) view of its gm, bit for bit, and
    its gm against the one-output launch's, bit for bit."""
    from faiss_tpu_torch.ops import fused

    gm, bmax = launch(True)
    want = fused.block_max_plain(gm)
    check(torch.equal(bmax.view(torch.int32), want.view(torch.int32)),
          f"{name}: block max differs from amax of its group maxes")
    check(torch.equal(gm.view(torch.int32), launch(False).view(torch.int32)),
          f"{name}: the block-max launch's group maxes differ")


def _rescore_select(torch, rows, name, idx, q, db, vn, gidx, metric,
                    row_bytes, eps, legacy):
    """K11 against K10 → candidate_drop → K9 on the same gidx and against
    PR 10's kernel, bit for bit in values and ids, and against its plain
    version within the rescore term ``eps`` (the two are fp32-true in
    different orders); PR 10's kernel timed beside it (L2)."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused, kernels

    nt = idx.ntotal
    vals, ids = kernels.rescore_select_groups(q, db, vn, gidx, nt, k=K,
                                              metric=metric)
    s = kernels.rescore_groups(q, db, vn, gidx, metric=metric)
    v2, p2 = kernels.final_select(
        s.masked_fill(fused.candidate_drop(gidx, nt), float("-inf")), K)
    ids2 = torch.gather(fused.candidate_columns(gidx), 1, p2.to(torch.int64))
    check(torch.equal(vals.view(torch.int32), v2.view(torch.int32))
          and torch.equal(ids, ids2),
          f"{name}: differs from rescore_groups → final_select")
    vp, _ = fused.rescore_select_groups_plain(q, db, vn, gidx, nt, k=K,
                                              metric=metric)
    err = _within(torch, vals, vp, eps, name)
    bound = _rescore_bound(q, row_bytes, gidx, vals, ids)
    fmt = kernels._SELECT_FMT[db.dtype][0]
    lv = torch.empty_like(vals)
    li = torch.empty_like(ids)
    l2 = metric is MetricType.L2

    def run_legacy():
        k10_variants().call_select(torch, legacy["libs"]["k11_legacy"], fmt,
                                   q, db, vn, gidx, nt, K, lv, li, l2)
    run_legacy()
    torch.cuda.synchronize()
    check(torch.equal(vals.view(torch.int32), lv.view(torch.int32))
          and torch.equal(ids, li), f"{name}: differs from PR 10's kernel")
    if l2:
        legacy["ms"][name] = graph_ms(torch, run_legacy, 50)
    rows[name] = _row(
        torch, err,
        lambda: kernels.rescore_select_groups(q, db, vn, gidx, nt, k=K,
                                              metric=metric),
        lambda: fused.rescore_select_groups_plain(q, db, vn, gidx, nt, k=K,
                                                  metric=metric),
        50, bound)


def _row(torch, err, kern, plain, reps, bound, lib=None, plain_reps=5):
    """(max error, kernel ms, plain ms, (bound ms, bound by), library ms):
    the kernel and the library call by graph replay, the plain version
    eagerly."""
    return (err, graph_ms(torch, kern, reps),
            cuda_ms(torch, plain, plain_reps), bound,
            None if lib is None else graph_ms(torch, lib, reps))


def _k8_check(torch, gm, kg):
    """K8 over ``gm`` against its plain version: ids and t bit for bit (t
    is the lowest unnominated column's own value at their max). Returns
    the kernel's (gidx, t)."""
    from faiss_tpu_torch.ops import fused, kernels

    gidx, t = kernels.select_groups(gm, kg)
    gidx_p, t_p = fused.select_groups_plain(gm, kg)
    check(torch.equal(gidx, gidx_p)
          and torch.equal(t.view(torch.int32), t_p.view(torch.int32)),
          f"select_groups at {tuple(gm.shape)}, kg {kg} differs from its "
          f"plain version")
    return gidx, t


def _k8_row(torch, gm, kg):
    """K8's kernel row over ``gm``; torch.topk(gm, kg + 1) is the library
    call (the top kg and the threshold t in one call)."""
    from faiss_tpu_torch.ops import fused, kernels

    gidx, t = kernels.select_groups(gm, kg)
    return _row(torch, 0.0, lambda: kernels.select_groups(gm, kg),
                lambda: fused.select_groups_plain(gm, kg), 50,
                _bound(_nbytes(gm, gidx, t), 0, "fp32"),
                lambda: torch.topk(gm, kg + 1))


def _selects(torch, rows, gm, s_fn, kg):
    """K8 over ``gm`` and K9 over the scores ``s_fn(gidx)`` rescores: equal
    bits to their plain versions; torch.topk is the library call."""
    gidx, _ = _k8_check(torch, gm, kg)
    rows["select_groups"] = _k8_row(torch, gm, kg)
    rows["final_select"] = _k9_row(torch, s_fn(gidx))


def _k9_row(torch, s):
    """K9 over the scores s against its plain version, bit for bit in
    values and columns; torch.topk is the library call."""
    from faiss_tpu_torch.ops import fused, kernels

    vals, pos = kernels.final_select(s, K)
    vals_p, pos_p = fused.final_select_plain(s, K)
    check(torch.equal(vals.view(torch.int32), vals_p.view(torch.int32))
          and torch.equal(pos, pos_p),
          f"final_select at {tuple(s.shape)} differs from its plain version")
    return _row(torch, 0.0, lambda: kernels.final_select(s, K),
                lambda: fused.final_select_plain(s, K), 50,
                _bound(_nbytes(s, vals, pos), 0, "fp32"),
                lambda: torch.topk(s, K))


def phase_kernels(torch, idx, xq, metric, legacy):
    """The bf16 kernels against their plain versions at the main path's
    shapes. Sweep and rescore: |kernel − plain| ≤ the query's two-plane ε
    (it bounds the accumulation error of both sides; K2 and K1, on the
    tensor cores, with accum="mma"). Selects: equal bits."""
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
        err = _within(torch, gm, gm_p, _certificate_eps(
            idx, q, metric, fused.sweep_accum("bf16", passes, q.device)),
            f"sweep_groupmax planes={passes}")
        planes = (qh,) if ql is None else (qh, ql)
        rows[f"sweep_groupmax_{passes}"] = _row(
            torch, err,
            lambda: kernels.sweep_groupmax(qh, ql, db, vn, metric=metric),
            lambda: fused.sweep_groupmax_plain(qh, ql, db, vn, metric=metric),
            20, _sweep_bound(planes, (db,), vn, gm, passes, "bf16"))
        _block_max(torch, f"sweep_groupmax_{passes}",
                   lambda bm: kernels.sweep_groupmax(
                       qh, ql, db, vn, metric=metric, with_block_max=bm))
    check(gm.shape == (nq_pad, nv_eff // 128), "gm shape")

    def rescore(gidx):
        s = kernels.rescore_groups(q, db, vn, gidx, metric=metric)
        s_p = fused.rescore_groups_plain(q, db, vn, gidx, metric=metric)
        rows["rescore_groups"] = _row(
            torch, _within(torch, s, s_p, eps, "rescore_groups"),
            lambda: kernels.rescore_groups(q, db, vn, gidx, metric=metric),
            lambda: fused.rescore_groups_plain(q, db, vn, gidx,
                                               metric=metric),
            50, _rescore_bound(q, 2, gidx, s))
        _rescore_select(torch, rows, "rescore_select", idx, q, db, vn, gidx,
                        metric, 2, eps, legacy)
        return s

    _selects(torch, rows, gm, rescore, kg)
    _print_rows(metric, rows)
    return rows


def phase_f32_kernels(torch, idx, xq, metric):
    """The f32 kernels against their plain versions at the main path's
    shapes: the pair sweep with 3 terms (K3) and 2 (K4, one query plane),
    both on the tensor cores (the pair ε with the accumulation
    ``fused.sweep_accum`` names: "mma"), their supergroup maxes bit for
    bit, the pair rescore (K10's pair mode, stage
    3a) within ε₂ of _pair_rescore_eps, with the count of distinct groups
    its positions name (the bound reads each once), and K9 at the f32
    path's own width (stage 3b's k + 22 candidates, ``final_select_32``)."""
    from faiss_tpu_torch.ops import fused, kernels

    q, nq_pad, nv_eff, vn = _shapes(idx, xq, metric)
    st = idx.store
    hi, lo = st.db_hi, st.db_lo
    rows = {}
    for passes in (2, 1):
        qh, ql = fused.query_planes(q, passes)
        accum = fused.sweep_accum("pair", passes, q.device)
        check(accum == "mma", f"the pair sweep with {passes} query planes "
                              f"is certified with {accum}")
        eps = fused._sweep_eps(q, st.norms, idx.ntotal, metric=metric,
                               d_pad=st.d_pad, single_pass=passes == 1,
                               pair_sweep=True, split_stats=st.split_stats,
                               accum=accum)[:, None]
        gm = kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric)
        gm_p = fused.sweep_split_plain(qh, ql, hi, lo, vn, metric=metric)
        name = f"sweep_split_{passes + 1}"
        planes = (qh,) if ql is None else (qh, ql)
        rows[name] = _row(
            torch, _within(torch, gm, gm_p, eps, name),
            lambda: kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric),
            lambda: fused.sweep_split_plain(qh, ql, hi, lo, vn,
                                            metric=metric),
            20, _sweep_bound(planes, (hi, lo), vn, gm, passes + 1, "bf16"))
        def launch(bm, qh=qh, ql=ql):
            return kernels.sweep_split(qh, ql, hi, lo, vn, metric=metric,
                                       with_block_max=bm)
        _block_max(torch, name, launch)
        if passes == 2:
            gidx, _ = kernels.select_groups(gm, K + fused.GROUP_PAD)
    eps2 = fused._pair_rescore_eps(q, st.norms, idx.ntotal, metric=metric,
                                   d_pad=st.d_pad,
                                   split_stats=st.split_stats)[:, None]
    s = kernels.rescore_groups(q, hi, vn, gidx, metric=metric, db2=lo)
    s_p = fused.rescore_groups_plain(q, hi, vn, gidx, metric=metric, db2=lo)
    print(f"  {metric.value:>2} rescore_groups_pair: {gidx.numel()} positions "
          f"name {int(gidx.unique().numel())} distinct groups", flush=True)
    rows["rescore_groups_pair"] = _row(
        torch, _within(torch, s, s_p, eps2, "rescore_groups_pair"),
        lambda: kernels.rescore_groups(q, hi, vn, gidx, metric=metric,
                                       db2=lo),
        lambda: fused.rescore_groups_plain(q, hi, vn, gidx, metric=metric,
                                           db2=lo),
        50, _rescore_bound(q, 4, gidx, s))
    # stage 3a → its select (K8 over kg·128 candidates, m = k + 22) → stage
    # 3b, as fused_search runs them: K9's (nq_pad, k + 22) input on the f32
    # path
    m = K + fused.F32_CAND_PAD
    s_pair = s.masked_fill(fused.candidate_drop(gidx, idx.ntotal),
                           float("-inf"))
    ppos, _ = _k8_check(torch, s_pair, m)
    rows["select_groups_1792"] = _k8_row(torch, s_pair, m)
    cols = torch.gather(fused.candidate_columns(gidx), 1, ppos.to(torch.int64))
    rows["final_select_32"] = _k9_row(
        torch, fused.rescore_exact(q, st.db, st.norms, cols, metric=metric))
    _print_rows(metric, rows)
    return rows


def _rescore_term(torch, q, v_max, norms, nv, d, metric):
    """(nq, 1) bound on |kernel − plain| for two fp32-true rescores of the
    same rows: each errs ≤ d·u·‖q‖·V, plus both epilogues."""
    from faiss_tpu_torch.ops import fused

    Q = torch.sqrt(torch.sum(q * q, dim=-1))
    N = torch.amax(norms[:nv])
    return fused._epilogue_eps(2.0 * d * fused._U32 * Q * v_max, Q, v_max, N,
                               metric)[:, None]


def phase_int8_kernels(torch, idx, xq, metric, legacy):
    """K5 and K10's int8 mode against their plain versions at the main
    path's shapes: K5 equal bit for bit (exact integer dots, the same
    three roundings in the same order; else it fails, though ε_int8 would
    bound it), the rescore within its rescore term."""
    from faiss_tpu_torch.ops import fused, kernels

    q, nq_pad, nv_eff, vn = _shapes(idx, xq, metric)
    st = idx.store
    db, scales = st.db, st.scales
    q1, q2, b1, b2 = fused.int8_query_pair(q, scales)
    beta = torch.stack([b1, b2], dim=1)
    rows = {}
    gm = kernels.sweep_int8(q1, q2, db, vn, beta, metric=metric)
    gm_p = fused.sweep_int8_plain(q1, q2, db, vn, beta, metric=metric)
    fin = torch.isfinite(gm_p)
    check(torch.equal(fin, torch.isfinite(gm))
          and bool((gm[fin] == gm_p[fin]).all()),
          "sweep_int8 differs from its plain version")
    check(gm.shape == (nq_pad, nv_eff // 128), "int8 gm shape")
    rows["sweep_int8"] = _row(
        torch, 0.0,
        lambda: kernels.sweep_int8(q1, q2, db, vn, beta, metric=metric),
        lambda: fused.sweep_int8_plain(q1, q2, db, vn, beta, metric=metric),
        20, _sweep_bound((q1, q2), (db,), vn, gm, 2, "int8", extra=(beta,)))
    _block_max(torch, "sweep_int8",
               lambda bm: kernels.sweep_int8(q1, q2, db, vn, beta,
                                             metric=metric,
                                             with_block_max=bm))
    gidx, _ = kernels.select_groups(gm, K + fused.GROUP_PAD)
    qs = q * scales[None, :]
    s = kernels.rescore_groups(qs, db, vn, gidx, metric=metric)
    s_p = fused.rescore_groups_plain(qs, db, vn, gidx, metric=metric)
    term = _rescore_term(torch, qs, st.int_norm_max, st.norms, nv_eff,
                         st.d_pad, metric)
    rows["rescore_groups_int8"] = _row(
        torch, _within(torch, s, s_p, term, "rescore_groups_int8"),
        lambda: kernels.rescore_groups(qs, db, vn, gidx, metric=metric),
        lambda: fused.rescore_groups_plain(qs, db, vn, gidx, metric=metric),
        50, _rescore_bound(qs, 1, gidx, s))
    _rescore_select(torch, rows, "rescore_select_int8", idx, qs, db, vn, gidx,
                    metric, 1, term, legacy)
    _print_rows(metric, rows)
    return rows


def k10_variants():
    """scripts/k10_variants.py, which builds and calls PR 10's kernels."""
    scripts = str(Path(__file__).resolve().parent / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import k10_variants as kv
    return kv


def _k10_f16_legacy(torch, q, db, vn, gidx, metric, s, legacy):
    """K10's streamed f16 mode (scores ``s``) against PR 10's thread-per-row
    kernel on the same inputs, bit for bit; the latter timed (L2)."""
    from faiss_tpu_torch import MetricType

    out = torch.empty_like(s)
    l2 = metric is MetricType.L2

    def run_legacy():
        k10_variants().call_rescore(torch, legacy["libs"]["k10_legacy"], 3, q,
                                    db, None, vn, gidx, out, l2)
    run_legacy()
    torch.cuda.synchronize()
    check(torch.equal(s.view(torch.int32), out.view(torch.int32)),
          "rescore_groups_f16: differs from PR 10's thread-per-row kernel")
    if l2:
        legacy["ms"]["rescore_groups_f16"] = graph_ms(torch, run_legacy, 50)


def _f16_sweep_planes(q, passes):
    """((q_hi, q_lo, scales), f16_planes) of the f16 rows' sweep on the
    card, as ``fused_search`` makes them: two passes sweep the f16 split
    (K6), which the certificate also reads; one pass the bf16 plane (K7)."""
    from faiss_tpu_torch.ops import fused
    from faiss_tpu_torch.storage import split_f32_f16

    accum = fused.sweep_accum("f16", passes, q.device)
    if fused.sweep_query_split("f16", passes, accum) == "f16":
        planes = split_f32_f16(q)
        return planes, planes
    return (*fused.query_planes(q, passes), None), None


def phase_f16_kernels(torch, idx, xq, metric, legacy):
    """K6 (two f16 query planes over the stored rows) and K7 (one bf16
    plane over the decoded pair), both on the tensor cores (accum="mma"),
    against their plain version within the ε of their split (K6: the f16
    split's; K7: the pair ε with the f16 split statistics, single_pass),
    K10's f16 mode within its rescore term and bit for bit the
    thread-per-row kernel it replaced."""
    from faiss_tpu_torch.ops import fused, kernels

    q, nq_pad, nv_eff, vn = _shapes(idx, xq, metric)
    st = idx.store
    db = st.db
    rows = {}
    for passes in (2, 1):
        (qh, ql, sc), f16_planes = _f16_sweep_planes(q, passes)
        eps = fused._sweep_eps(q, st.norms, idx.ntotal, metric=metric,
                               d_pad=st.d_pad, single_pass=passes == 1,
                               pair_sweep=True, split_stats=st.split_stats,
                               accum=fused.sweep_accum("f16", passes,
                                                       q.device),
                               f16_planes=f16_planes)[:, None]
        gm = kernels.sweep_f16(qh, ql, db, vn, metric=metric, scales=sc)
        gm_p = fused.sweep_f16_plain(qh, ql, db, vn, metric=metric,
                                     scales=sc)
        name = f"sweep_f16_{passes}"
        planes = (qh,) if ql is None else (qh, ql)
        # K6: qh·v + ql·v; K7: q1·dh + q1·dl
        rows[name] = _row(
            torch, _within(torch, gm, gm_p, eps, name),
            lambda: kernels.sweep_f16(qh, ql, db, vn, metric=metric,
                                      scales=sc),
            lambda: fused.sweep_f16_plain(qh, ql, db, vn, metric=metric,
                                          scales=sc),
            20, _sweep_bound(planes, (db,), vn, gm, 2, "f16"))
        _block_max(torch, name,
                   lambda bm: kernels.sweep_f16(qh, ql, db, vn, metric=metric,
                                                with_block_max=bm,
                                                scales=sc))
        if passes == 2:
            gidx, _ = kernels.select_groups(gm, K + fused.GROUP_PAD)
    v_max = torch.sqrt(torch.amax(st.norms)) * fused._QUANT_V
    term = _rescore_term(torch, q, v_max, st.norms, nv_eff, st.d_pad, metric)
    s = kernels.rescore_groups(q, db, vn, gidx, metric=metric)
    s_p = fused.rescore_groups_plain(q, db, vn, gidx, metric=metric)
    _k10_f16_legacy(torch, q, db, vn, gidx, metric, s, legacy)
    rows["rescore_groups_f16"] = _row(
        torch, _within(torch, s, s_p, term, "rescore_groups_f16"),
        lambda: kernels.rescore_groups(q, db, vn, gidx, metric=metric),
        lambda: fused.rescore_groups_plain(q, db, vn, gidx, metric=metric),
        50, _rescore_bound(q, 2, gidx, s))
    _rescore_select(torch, rows, "rescore_select_f16", idx, q, db, vn, gidx,
                    metric, 2, term, legacy)
    _print_rows(metric, rows)
    return rows


def phase_truncation_adversary(torch, dev="cuda"):
    """The tensor-core sweeps with float sums (K3 and K4, with one query
    plane, over the f32 planes, K1 over bf16 rows, K6 (against the f16
    query split) and K7, with one query plane, over f16 bits) on the
    truncation adversary of tests/test_torch_mma_eps.py: the query
    [1, s, …, s] against rows [1, −s, …, −s] scaled by 2^j in group j
    (s = 2^-12·1.4140625, s² just under ulp(1) = 2^-23; exact in bf16 and
    in f16), IP. Each kernel's error must stay within
    _sweep_eps(accum="mma"); it is printed in units of ‖q‖·‖v‖·u
    (u = 2^-24; a sum that truncates every addend at the largest one's
    exponent loses ≈ 254, round to nearest ≈ 0), beside the model's
    allowance for its term (2), (36·⌈d/16⌉ + 2) in the same units. The
    query is bf16-valued, so K4's and K7's one plane q1 is the query
    itself."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused, kernels
    from faiss_tpu_torch.storage import split_f32_bf16, split_stats

    d, nq, ng = 128, 8, 8
    a = torch.full((d,), 2.0 ** -12 * 1.4140625, dtype=torch.float64)
    a[0] = 1.0
    row = -a
    row[0] = 1.0
    x64 = (row[None, :] * 2.0 ** torch.arange(ng, dtype=torch.float64)[:, None]
           ).repeat_interleave(128, dim=0)
    x = x64.float().to(dev)
    q = a.float().to(dev).expand(nq, d).contiguous()
    qh, ql = fused.query_planes(q, 2)
    hi, lo = split_f32_bf16(x)
    stats = split_stats(x, hi, lo)
    ip = MetricType.INNER_PRODUCT
    vn = torch.zeros((ng * 128,), device=dev)
    exact = (x64[::128] @ a).to(dev)[None, :]
    unit = (torch.linalg.norm(a) * torch.linalg.norm(x64[::128], dim=1)
            * 2.0 ** -24).to(dev)[None, :]
    runs = {"sweep_split_3": (kernels.sweep_split, (hi, lo), stats, 2),
            "sweep_split_2": (kernels.sweep_split, (hi, lo), stats, 1),
            "sweep_groupmax_2": (kernels.sweep_groupmax,
                                 (x.to(torch.bfloat16),), None, 2),
            "sweep_f16_2": (kernels.sweep_f16, (x.to(torch.float16),),
                            stats, 2),
            "sweep_f16_1": (kernels.sweep_f16, (x.to(torch.float16),),
                            stats, 1)}
    errs = {}
    (fh, fl, sc), f16_planes = _f16_sweep_planes(q, 2)
    for name, (fn, dbs, st, passes) in runs.items():
        planes = (qh, ql) if passes == 2 else fused.query_planes(q, 1)
        kw, fp = {}, None
        if name == "sweep_f16_2":
            planes, kw, fp = (fh, fl), dict(scales=sc), f16_planes
        gap = (fn(*planes, *dbs, vn, metric=ip, **kw).double()
               - exact).abs()
        eps = fused._sweep_eps(q, (x * x).sum(-1), ng * 128, metric=ip,
                               d_pad=d, single_pass=passes == 1,
                               pair_sweep=st is not None, split_stats=st,
                               accum="mma", f16_planes=fp)[:, None]
        check(bool((gap <= eps.double()).all()),
              f"{name}: beyond the mma ε on the truncation adversary")
        errs[name] = float((gap / unit).max())
    allow = fused._accum_coeff(d, "mma")
    print(f"truncation adversary (error in ‖q‖·‖v‖·u; a truncating sum ≈ "
          f"254, round to nearest ≈ 0; within the mma ε, whose term (2) "
          f"allows {allow:.0f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in errs.items()), flush=True)
    return errs


def _print_rows(metric, rows):
    for name, (err, ms, pms, (bms, by), lms) in rows.items():
        lib = "" if lms is None else f"  torch {lms:.4f} ms"
        print(f"  {metric.value:>2} {name:<19} max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms  plain {pms:.4f} ms  bound {bms:.4f} ms "
              f"({by}){lib}", flush=True)


def _rows64(torch, idx, rows):
    """The stored rows ``rows`` (a slice or an index tensor) decoded to
    fp64, and their stored norms."""
    from faiss_tpu_torch.storage import decode_f16_bits

    st = idx.store
    if st.pair_only:
        v = (st.db_hi[rows][..., : idx.d].to(torch.float64)
             + st.db_lo[rows][..., : idx.d].to(torch.float64))
    else:
        v = st.db[rows][..., : idx.d]
        if st.scales is not None:
            v = v.to(torch.float32) * st.scales[: idx.d]
        elif v.dtype == torch.float16:
            v = decode_f16_bits(v)
        v = v.to(torch.float64)
    return v, st.norms[rows].to(torch.float64)


def _merge_top(torch, top, s, i0, k):
    """One step of a running stable top-k over row chunks: the chunk's
    scores ``s`` (rows i0…) merged into ``top`` = (values, ids), which
    holds the lower ids, so ties go to the lowest id."""
    v, i = torch.sort(s, dim=1, descending=True, stable=True)
    v, i = v[:, :k], i[:, :k] + i0
    if top is not None:
        v, pos = torch.sort(torch.cat([top[0], v], 1), dim=1,
                            descending=True, stable=True)
        i = torch.gather(torch.cat([top[1], i], 1), 1, pos)
        v, i = v[:, :k], i[:, :k]
    return v, i


def oracle_check(torch, idx, xq, metric, D, I, k=K, admit=None):
    """recall@k and max |D − D_oracle| / ε against an fp64 oracle over the
    stored database and the stored fp32 norms (the ranking the index
    certifies; only the rows ``admit``, a host bool mask, lets through),
    computed on the card in chunks of ORACLE_CHUNK rows with a running
    stable top-k. ε is the query's two-plane certificate bound, which
    covers the rescore's fp32 error."""
    from faiss_tpu_torch import MetricType

    l2 = metric is MetricType.L2
    q = torch.from_numpy(np.asarray(xq, np.float64)).to(idx.store.norms.device)
    top = None
    for i0 in range(0, idx.ntotal, ORACLE_CHUNK):
        n = min(ORACLE_CHUNK, idx.ntotal - i0)
        v, nrm = _rows64(torch, idx, slice(i0, i0 + n))
        s = q @ v.T
        if l2:
            s = 2.0 * s - nrm
        if admit is not None:
            ok = torch.from_numpy(admit[i0:i0 + n]).to(s.device)
            s = s.masked_fill(~ok, float("-inf"))
        top = _merge_top(torch, top, s, i0, k)
    top_i = top[1]
    rows, nrm = _rows64(torch, idx, torch.from_numpy(I).to(q.device))
    got = torch.einsum("qd,qkd->qk", q, rows)
    got = (q * q).sum(1, keepdim=True) - 2.0 * got + nrm if l2 else got
    qp, nq, _ = idx._prep_queries(xq)
    eps = _certificate_eps(idx, qp, metric)[:nq]
    rel = np.abs(got.cpu().numpy() - D) / eps.cpu().numpy()
    ref = top_i.cpu().numpy()
    hits = sum(len(set(a) & set(b)) for a, b in zip(ref.tolist(), I.tolist()))
    return hits / ref.size, float(rel.max())


def drive(torch, label, idx, xq, metric, k=K, params=None, admit=None,
          reps=REPS):
    """One checked search, ``reps`` timed searches (host clock, copy-back
    included) and one search_async, through the user entry points, with
    the search parameters ``params`` (their selector as the host mask
    ``admit``, for the oracle). Returns (D, I, host ms/batch)."""
    nq = len(xq)
    D_, I_ = idx.search(xq, k, params=params)
    check(D_.shape == (nq, k) and I_.shape == (nq, k), f"{label}: shape")
    check(np.isfinite(D_).all() and (I_ >= 0).all(), f"{label}: sentinels")
    rec, rel = oracle_check(torch, idx, xq, metric, D_, I_, k, admit)
    check(rec == 1.0, f"{label} {metric.value}: recall@{k} {rec} != 1.0")
    check(rel <= 1.0, f"{label} {metric.value}: distance error {rel:.2e} ε")
    t0 = time.perf_counter()
    for _ in range(reps):
        idx.search(xq, k, params=params)
    ms = (time.perf_counter() - t0) / reps * 1e3
    tok = idx.search_async(xq, k, params=params)
    Da, Ia = tok.wait()
    check(tok.is_ready() and np.array_equal(Ia, I_)
          and np.array_equal(Da, D_), f"{label}: search_async differs")
    print(f"search {label} {metric.value} nq={nq} k={k}: recall@{k}={rec} "
          f"max |D - D_oracle| = {rel:.2e} ε "
          f"ms/batch={ms:.4f} (host clock, incl. copy-back) "
          f"QPS={nq / ms * 1e3:.1f} "
          f"fused_fallbacks={idx.fused_fallbacks}", flush=True)
    return D_, I_, ms


def main_path(torch, label, runs, need):
    """Drive ``runs`` [(index, queries, metric)] with the counts zeroed
    just before and read just after; every kernel in ``need`` must have
    launched."""
    from faiss_tpu_torch.ops import kernels

    kernels.reset_launches()
    ms = [(metric, drive(torch, label, idx, xq, metric)[2])
          for idx, xq, metric in runs]
    counts = dict(kernels.launches)
    print(f"launches in the {label} main-path run: {counts}", flush=True)
    print(f"ms/batch {label}: " + ", ".join(
        f"{m.value} {t:.4f}" for m, t in ms) + " (host clock)", flush=True)
    for key in need:
        check(counts[key] > 0,
              f"{label}: kernel {key} was never launched by the main path")
    return counts


def pipelined(torch, label, runs):
    for idx, xq, metric in runs:
        q, _, nq_pad = idx._prep_queries(xq)
        pipe_ms = cuda_ms(torch, lambda: idx._run_search_fn(
            q, K, nq_pad, force_plain=False), REPS)
        print(f"search {label} {metric.value} nq={len(xq)}: pipelined "
              f"ms/batch="
              f"{pipe_ms:.4f} (CUDA events, {REPS} searches enqueued back "
              f"to back)", flush=True)


def phase_f32_10m(torch, ft, xb, xq):
    """The slice's main path: f32, L2, 10M rows (xb, then 9M rows from
    default_rng(SEED + 2) in 1M batches, so the host never holds more than
    2M rows at once). 78,128 groups: the 3-term pair sweep also writes its
    supergroup maxes and phase 2 ranks those first. Counts zeroed just
    before the search loop and read just after; then the pipelined time,
    the programs row and the plain path's time at the same size, with its
    ids. Frees the index before it returns (counts, the K3 row, the
    programs row)."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import kernels

    L2 = MetricType.L2
    t0 = time.perf_counter()
    idx = ft.TorchIndexFlat(D, metric=L2, device="cuda")
    idx.add(xb)
    rng = np.random.default_rng(SEED + 2)
    for _ in range((NV_10M - NV) // NV):
        idx.add(rng.standard_normal((NV, D), dtype=np.float32))
    torch.cuda.synchronize()
    check(idx.ntotal == NV_10M, f"f32_10m: ntotal {idx.ntotal}")
    print(f"add f32_10m: {time.perf_counter() - t0:.3f} s, capacity "
          f"{idx.store.capacity}, {idx.store.nbytes() / 1e9:.3f} GB",
          flush=True)
    kernels.reset_launches()
    _, I_f, _ = drive(torch, "f32_10m", idx, xq, L2)
    counts = dict(kernels.launches)
    print(f"launches in the f32_10m main-path run: {counts}", flush=True)
    check(counts["sweep_split_3"] > 0
          and counts["sweep_block_max"] == counts["sweep_split_3"],
          "f32_10m: the sweep did not write its supergroup maxes")
    for key in ("select_groups", "rescore_groups_pair", "final_select"):
        check(counts[key] > 0, f"f32_10m: kernel {key} was never launched")
    pipelined(torch, "f32_10m", [(idx, xq, L2)])
    prog = programs_row(torch, "f32_10m", idx, *_flat_runs(idx, xq))
    k3_row = _k3_block_max_10m(torch, idx, xq)
    idx.set_force_plain(True)
    idx.search(xq, K)
    t0 = time.perf_counter()
    for _ in range(3):
        _, I_p = idx.search(xq, K)
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    check(np.array_equal(I_p, I_f), "f32_10m: plain ids differ from fused")
    print(f"search f32_10m l2 nq={len(xq)}: plain path ms/batch="
          f"{plain_ms:.4f} (host clock, set_force_plain, 3 searches), ids "
          f"equal to the fused path's; fused_fallbacks={idx.fused_fallbacks}",
          flush=True)
    del idx
    torch.cuda.empty_cache()
    return counts, k3_row, prog


def _k3_block_max_10m(torch, idx, xq):
    """K3 with its supergroup maxes at the f32_10m shapes (nq_pad 104,
    78,128 groups): the maxes bit for bit against
    block_max_plain of its gm, the gm within the MMA ε of the plain version
    (timed once: it builds ≈ 27 GB of fp32 copies and products), the
    kernel by graph replay; the table's ``sweep_block_max`` row."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused, kernels

    L2 = MetricType.L2
    q, nq_pad, nv_eff, vn = _shapes(idx, xq, L2)
    st = idx.store
    hi, lo = st.db_hi, st.db_lo
    qh, ql = fused.query_planes(q, 2)

    def launch():
        return kernels.sweep_split(qh, ql, hi, lo, vn, metric=L2,
                                   with_block_max=True)

    def plain():
        return fused.sweep_split_plain(qh, ql, hi, lo, vn, metric=L2,
                                       with_block_max=True)

    gm, bmax = launch()
    check(torch.equal(bmax.view(torch.int32),
                      fused.block_max_plain(gm).view(torch.int32)),
          "f32_10m: K3's block max differs from amax of its group maxes")
    eps = fused._sweep_eps(q, st.norms, idx.ntotal, metric=L2,
                           d_pad=st.d_pad, pair_sweep=True,
                           split_stats=st.split_stats, accum="mma")[:, None]
    err = _within(torch, gm, plain()[0], eps, "f32_10m sweep_split_3")
    row = _row(torch, err, launch, plain, 10,
               _sweep_bound((qh, ql), (hi, lo), vn, gm, 3, "bf16",
                            extra=(bmax,)), plain_reps=1)
    print(f"K3 + block max at 10M (nq_pad {nq_pad}, nv_eff {nv_eff}):",
          flush=True)
    _print_rows(L2, {"sweep_block_max": row})
    del gm, bmax
    torch.cuda.empty_cache()
    return row


def _k6_at_the_cell_width(torch, dev="cuda"):
    """K6 at the f16 cell's shape (benchmark/configs/deep10m-ip-f16.json:
    10M normalised rows in f16 at d 96, IP, 100 normalised queries padded
    with zero rows to nq_pad 104) with its supergroup maxes, as
    fused_search launches it there: the query planes in registers and the
    k-steps of the last chunk that lie wholly past d 96 not issued. Launch
    counts zeroed just before its one eager launch: one sweep_f16_2 with
    its block max, no sweep_f16_1. Its gm within
    _sweep_eps(accum="mma", f16_planes=) of sweep_f16_plain on the same
    planes and scales (timed once: ≈ 17 GB of fp32 copies and products),
    its block max bit for bit against block_max_plain of that gm, the
    kernel by graph replay; the table's ``sweep_f16_2`` entry's
    ``at_d96_10m``. Returns (counts, row)."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused, kernels
    from faiss_tpu_torch.storage import (ROW_TILE, _round_up,
                                         encode_f16_bits,
                                         flush_f16_subnormals, split_f32_f16)

    ip, d = MetricType.INNER_PRODUCT, 96
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def normalised(n):
        x = torch.randn((n, d), generator=g, device=dev)
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    nv_eff = _round_up(NV_10M, ROW_TILE)
    db = torch.zeros((nv_eff, d), dtype=torch.float16, device=dev)
    norms = torch.zeros((nv_eff,), device=dev)
    for i0 in range(0, NV_10M, NV):
        x = normalised(NV)
        db[i0:i0 + NV] = flush_f16_subnormals(encode_f16_bits(x))
        norms[i0:i0 + NV] = (x * x).sum(-1)
    q = torch.zeros((104, d), device=dev)
    q[:NQ] = normalised(NQ)
    vn = fused._premask_norms(norms, NV_10M, nv_eff, ip)
    planes = split_f32_f16(q)
    qh, ql, sc = planes
    check(fused.sweep_query_split("f16", 2, fused.sweep_accum(
        "f16", 2, q.device)) == "f16", "f16 cell: K6 does not take the "
          "f16 split")

    def launch():
        return kernels.sweep_f16(qh, ql, db, vn, metric=ip,
                                 with_block_max=True, scales=sc)

    def plain():
        return fused.sweep_f16_plain(qh, ql, db, vn, metric=ip,
                                     with_block_max=True, scales=sc)

    kernels.reset_launches()
    gm, bmax = launch()
    counts = dict(kernels.launches)
    check(counts["sweep_f16_2"] == 1 and counts["sweep_block_max"] == 1
          and counts["sweep_f16_1"] == 0,
          f"f16 cell: expected one K6 launch with its block max, {counts}")
    check(torch.equal(bmax.view(torch.int32),
                      fused.block_max_plain(gm).view(torch.int32)),
          "f16 cell: K6's block max differs from amax of its group maxes")
    eps = fused._sweep_eps(q, norms, NV_10M, metric=ip, d_pad=d,
                           accum="mma", f16_planes=planes)[:, None]
    err = _within(torch, gm, plain()[0], eps, "f16 cell sweep_f16_2")
    row = _row(torch, err, launch, plain, 10,
               _sweep_bound((qh, ql), (db,), vn, gm, 2, "f16",
                            extra=(bmax,)), plain_reps=1)
    print(f"K6 + block max at the f16 cell's shape (d {d}, nq_pad 104, "
          f"nv_eff {nv_eff}):", flush=True)
    _print_rows(ip, {"sweep_f16_2": row})
    del db, norms, gm, bmax
    torch.cuda.empty_cache()
    return counts, row


def _fused_call(idx, xq, **kw):
    """fused.fused_search over the index's store, as TorchIndexFlat calls
    it (two query planes), for the rescore_select comparison."""
    from faiss_tpu_torch import StorageType
    from faiss_tpu_torch.ops import fused
    from faiss_tpu_torch.storage import ROW_TILE, _round_up

    st = idx.store
    q, _, _ = idx._prep_queries(xq)
    extra = {}
    if st.storage is StorageType.INT8:
        extra = dict(scales=st.scales, int_norm_max=st.int_norm_max)
    elif st.storage is StorageType.FLOAT16:
        extra = dict(split_stats=st.split_stats)
    return fused.fused_search(q, st.db, st.norms, idx.ntotal, k=K,
                              metric=idx.metric,
                              nv_eff=_round_up(idx.ntotal, ROW_TILE),
                              sweep_passes=2, **extra, **kw)


def phase_surface(torch, ft, xb, xq, f32, bf16, int8, f16):
    """The flat surface at 1M through its entry points, L2, with the counts
    zeroed just before and read just after: filtered searches (kept on the
    fused kernels), k=64, rescore_select=True, merge_from, remove_ids,
    range_search, IndexShardsHost and TorchIndexIDMap2."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import kernels

    L2 = MetricType.L2
    rng = np.random.default_rng(SEED + 3)
    sweeps = lambda: sum(n for key, n in kernels.launches.items()  # noqa
                         if key.startswith("sweep_"))
    kernels.reset_launches()

    sel = (ft.IDSelectorRange(0, NV // 2)
           | ft.IDSelectorBatch(rng.choice(NV, NV // 100, replace=False)))
    admit = sel.is_member(np.arange(NV, dtype=np.int64))
    for name, idx in (("f32", f32), ("bf16", bf16)):
        n0 = sweeps()
        _, I_, _ = drive(torch, f"filtered {name}", idx, xq, L2,
                         params=ft.SearchParams(sel=sel), admit=admit, reps=3)
        check(sweeps() > n0, f"filtered {name}: left the fused kernels")
        check(admit[I_].all(), f"filtered {name}: a filtered row came back")
    drive(torch, "k=64 f32", f32, xq, L2, k=64, reps=3)

    for name, idx in (("bf16", bf16), ("int8", int8), ("f16", f16)):
        a = _fused_call(idx, xq, rescore_select=True)
        b = _fused_call(idx, xq)
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"rescore_select {name}: differs from the default route")
    print("rescore_select=True: ids, values and certificates equal the "
          "default route's on bf16, int8 and f16", flush=True)

    half = NV // 2
    parts = (xb[:half], xb[half:])
    a, b, whole = (ft.TorchIndexFlat(D, storage="bf16", device="cuda")
                   for _ in range(3))
    a.add(parts[0])
    b.add(parts[1])
    for part in parts:
        whole.add(part)
    a.merge_from(b)
    check(b.ntotal == 0 and a.ntotal == NV, "merge_from: counts")
    Da, Ia = a.search(xq, K)
    Dw, Iw = whole.search(xq, K)
    check(np.array_equal(Ia, Iw) and np.array_equal(Da, Dw),
          "merge_from: search differs from the index built by the same adds")
    print("merge_from: two 500,000-row bf16 indexes search as the one built "
          "by the same adds, bit for bit in D and I", flush=True)
    rm = rng.choice(NV, NV // 10, replace=False)
    check(a.remove_ids(rm) == NV // 10 and a.ntotal == NV - NV // 10,
          "remove_ids: counts")
    drive(torch, "after remove_ids bf16", a, xq, L2, reps=3)
    del a, b, whole

    D100, _ = f32.search(xq, 100)
    radius = float(np.median(D100[:, -1]))
    lims, Dr, Ir = f32.range_search(xq, radius)
    q64 = torch.from_numpy(xq.astype(np.float64)).to(f32.store.norms.device)
    v, nrm = _rows64(torch, f32, slice(0, NV))
    d64 = ((q64 * q64).sum(1, keepdim=True) - 2.0 * (q64 @ v.T)
           + nrm).cpu().numpy()
    del v
    near = 0
    for r in range(len(xq)):
        want = set(np.nonzero(d64[r] < radius)[0].tolist())
        got = set(Ir[lims[r]:lims[r + 1]].tolist())
        diff = np.array(sorted(want ^ got), np.int64)
        check(np.all(np.abs(d64[r, diff] - radius) <= 1e-4 * radius),
              f"range_search: query {r} differs from the oracle's set")
        near += diff.size
    print(f"range_search f32 radius {radius:.4f}: {lims[-1] / len(xq):.1f} "
          f"hits a query, equal to the fp64 oracle's set but for {near} "
          f"rows within 1e-4·radius of the radius", flush=True)

    w = ft.TorchIndexIDMap2(ft.IndexShardsHost(
        [ft.TorchIndexFlat(D, storage="bf16", device="cuda")
         for _ in range(2)]))
    w.add_with_ids(parts[0], 10 * np.arange(half))
    w.add_with_ids(parts[1], 10 * np.arange(half, NV))
    I1 = bf16.search(xq, K)[1]
    check(np.array_equal(w.index.search(xq, K)[1], I1),
          "IndexShardsHost: ids differ from the 1M index's")
    check(np.array_equal(w.search(xq, K)[1], 10 * I1),
          "TorchIndexIDMap2: labels are not 10x the ids")
    for i in (0, NV // 8, half, NV - 1):
        check(np.array_equal(w.reconstruct(10 * i), bf16.reconstruct(i)),
              f"TorchIndexIDMap2: reconstruct({10 * i})")
    del w
    counts = dict(kernels.launches)
    print(f"launches in the surface run: {counts}", flush=True)
    for key in ("rescore_select", "rescore_select_int8",
                "rescore_select_f16"):
        check(counts[key] > 0, f"surface: kernel {key} was never launched")
    torch.cuda.empty_cache()
    return counts


def ivf_data():
    """1M rows and NQ queries of the Gaussian mixture of
    scripts/bench_ivf_r4.py's make_data (4,096 centres 5·N(0, 1), each row
    a centre plus N(0, 1) noise; NQ + 8 queries drawn, the first NQ kept),
    from default_rng(SEED + 3)."""
    rng = np.random.default_rng(SEED + 3)
    cents = (5.0 * rng.standard_normal((NLIST, D))).astype(np.float32)
    xb = cents[rng.integers(0, NLIST, NV)] + rng.standard_normal(
        (NV, D), dtype=np.float32)
    xq = cents[rng.integers(0, NLIST, NQ + 8)] + rng.standard_normal(
        (NQ + 8, D), dtype=np.float32)
    return xb.astype(np.float32), xq[:NQ].astype(np.float32)


def ivf_oracle(torch, idx, xq, nprobe, k=K, admit=None):
    """fp64 top-k over the stored rows of the lists the index probes (every
    row at nprobe = nlist): the lists come from the index's own coarse step
    (``_probe``, which its search calls), the rows' lists from its stored
    assignment; the rows decoded to fp64 (f32, the bf16 values, the int8
    codes times the scales) with the stored norms; only the rows ``admit``
    (a host bool mask over the ids) lets through. Computed on the card in
    chunks of ORACLE_CHUNK rows with a running stable top-k. Returns
    (ids (nq, k), fp64 distances (nq, k)) on the host."""
    from faiss_tpu_torch import MetricType

    l2 = idx.metric is MetricType.L2
    q, nq = idx._prep_search(xq, None)[:2]
    rows, norms = idx._rows_by_id()
    assign = torch.from_numpy(idx._assignments()).to(q.device)
    probed = None
    if nprobe < idx.nlist:
        probe = idx._probe(q, nprobe)[:nq].to(torch.int64)
        probed = torch.zeros((nq, idx.nlist), dtype=torch.bool,
                             device=q.device)
        probed.scatter_(1, probe, True)
    q64 = torch.from_numpy(xq.astype(np.float64)).to(q.device)
    top = None
    for i0 in range(0, idx.ntotal, ORACLE_CHUNK):
        i1 = min(idx.ntotal, i0 + ORACLE_CHUNK)
        v = rows[i0:i1, : idx.d].to(torch.float64)
        if idx._scales is not None:
            v = v * idx._scales[: idx.d].to(torch.float64)
        s = q64 @ v.T
        if l2:
            s = 2.0 * s - norms[i0:i1].to(torch.float64)
        if probed is not None:
            s = s.masked_fill(~probed[:, assign[i0:i1]], float("-inf"))
        if admit is not None:
            ok = torch.from_numpy(admit[i0:i1]).to(s.device)
            s = s.masked_fill(~ok, float("-inf"))
        top = _merge_top(torch, top, s, i0, k)
    top_v, top_i = top
    if l2:
        top_v = (q64 * q64).sum(1, keepdim=True) - top_v
    return top_i.cpu().numpy(), top_v.cpu().numpy()


def _ivf_term(torch, idx, xq):
    """(nq, 1) bound on |D − D_oracle| over the IVF index's stored rows.
    Every IVF route returns fp32-true scores of the stored rows (K10 and
    the fused route's rescore; the plain dense sweep's exact fp32 GEMM),
    each within one scoring's d·u·Q·V and its epilogue (``_rescore_term``
    charges two); for L2 add the fp32 ‖q‖² (≤ d·u·‖q‖²) and the
    subtraction (≤ u·|D|). Q: ‖q‖, or ‖q∘s‖ against int8 codes; V: the
    largest stored row (int8: the largest ‖codes‖; bf16: the f32 norm's
    rounding allowance on top)."""
    from faiss_tpu_torch import MetricType, StorageType
    from faiss_tpu_torch.ops import fused

    q, nq = idx._prep_search(xq, None)[:2]
    qe = idx._qeff(q)
    norms = idx._norms
    if idx._scales is not None:
        v_max = idx._int8_qn
    else:
        v_max = torch.sqrt(torch.amax(norms))
        if idx.storage_type is StorageType.BFLOAT16:
            v_max = v_max * fused._QUANT_V
    term = _rescore_term(torch, qe, v_max, norms, norms.shape[0], idx.d_pad,
                         idx.metric)
    if idx.metric is MetricType.L2:
        qq = torch.sum(q * q, dim=-1)[:, None]
        qn = torch.sqrt(torch.sum(qe * qe, dim=-1))[:, None]
        term = term + fused._U32 * ((idx.d_pad + 1) * qq + 2.0 * qn * v_max
                                    + torch.amax(norms))
    return term[:nq].cpu().numpy()


def _recall(I, ref):
    return sum(len(set(a) & set(b))
               for a, b in zip(I.tolist(), ref.tolist())) / ref.size


def drive_ivf(torch, label, idx, xq, nprobe, flat_I, need, counts,
              reps=REPS):
    """One checked IVF search at ``nprobe`` with the counts zeroed just
    before and read just after (every kernel in ``need`` must have
    launched; the counts add into ``counts``): recall@K = 1.0 against the
    fp64 oracle over the probed lists (all rows at nprobe = nlist), |D −
    D_oracle| within the rescore term (``_ivf_term``); ``reps`` timed
    searches (host clock, copy-back included), one search_async equal to
    search; then, after the read, the pipelined time (CUDA events, REPS
    searches enqueued back to back). The recall against the flat exact
    top-K ``flat_I`` (None: not printed) is printed, not bounded: IVF
    recall depends on the data."""
    from faiss_tpu_torch.ops import kernels

    idx.nprobe = nprobe
    kernels.reset_launches()
    D_, I_ = idx.search(xq, K)
    check(D_.shape == (len(xq), K) and np.isfinite(D_).all()
          and (I_ >= 0).all(), f"{label}: shape or sentinels")
    ref_i, ref_d = ivf_oracle(torch, idx, xq, nprobe)
    rec = _recall(I_, ref_i)
    rel = float((np.abs(D_ - ref_d) / _ivf_term(torch, idx, xq)).max())
    check(rec == 1.0, f"{label}: recall@{K} {rec} != 1.0 over the probed "
                      f"lists")
    check(rel <= 1.0, f"{label}: distance error {rel:.2e} of the term")
    t0 = time.perf_counter()
    for _ in range(reps):
        idx.search(xq, K)
    ms = (time.perf_counter() - t0) / reps * 1e3
    tok = idx.search_async(xq, K)
    Da, Ia = tok.wait()
    check(tok.is_ready() and np.array_equal(Ia, I_)
          and np.array_equal(Da, D_), f"{label}: search_async differs")
    n = dict(kernels.launches)
    for key in need:
        check(n[key] > 0, f"{label}: kernel {key} was never launched")
    for key, v in n.items():
        counts[key] = counts.get(key, 0) + v
    pipe = cuda_ms(torch, lambda: idx._search_packed(xq, K), REPS)
    print(f"search {label} nprobe={nprobe} nq={len(xq)} k={K}: recall@{K}="
          f"{rec} over the probed lists, max |D - D_oracle| = {rel:.2e} of "
          f"the rescore term, "
          f"recall against the flat exact top-{K} "
          f"{'n/a' if flat_I is None else _recall(I_, flat_I)}; "
          f"ms/batch={ms:.4f} (host clock, incl. copy-back), pipelined "
          f"{pipe:.4f} (CUDA events, {REPS} enqueued); fused_fallbacks="
          f"{idx.fused_fallbacks}; launches {({k: v for k, v in n.items() if v})}",
          flush=True)
    return D_, I_


def _k10_f32_row(torch, idx, xq):
    """K10's f32-rows mode against its plain version at the nprobe-16
    shapes of the f32 IVF index (its own probe, chunk layout and
    pre-masked norms), within the rescore term d·u·Q·V of each side."""
    from faiss_tpu_torch import ivf as ivf_mod
    from faiss_tpu_torch.ops import fused, kernels

    q, _, nq_pad, nprobe, nbudget, _ = idx._prep_search(xq, None)
    check(nprobe == 16, "K10 f32 row: the index is not at nprobe 16")
    cidx, okc = ivf_mod._chunk_ids(idx._probe(q, nprobe), idx._counts_dev,
                                   idx._ctable, nbudget)
    nv = idx._data.shape[0]
    vn = fused._premask_norms(idx._norms, nv, nv, idx.metric, idx._ids >= 0)
    db = idx._data
    s = kernels.rescore_groups(q, db, vn, cidx, metric=idx.metric)
    s_p = fused.rescore_groups_plain(q, db, vn, cidx, metric=idx.metric)
    v_max = torch.sqrt(torch.amax(idx._norms))
    term = _rescore_term(torch, q, v_max, idx._norms, nv, idx.d_pad,
                         idx.metric)
    row = _row(torch, _within(torch, s, s_p, term, "rescore_groups_f32"),
               lambda: kernels.rescore_groups(q, db, vn, cidx,
                                              metric=idx.metric),
               lambda: fused.rescore_groups_plain(q, db, vn, cidx,
                                                  metric=idx.metric),
               50, _rescore_bound(q, 4, cidx, s, live=okc))
    chunk_mb = 128 * idx.d_pad * 4 / 1e6
    live = int(okc.sum())
    distinct = int(cidx[okc].unique().numel())
    # the kernel's grouping: runs of equal (clamped) chunk ids, cut into
    # pieces of ≤ RESCORE_F32_CAP positions, one chunk read each
    _, run = cidx.clamp(0, nv // 128 - 1).unique(return_counts=True)
    cap = kernels.RESCORE_F32_CAP
    pieces = int(((run + cap - 1) // cap).sum())
    print(f"K10 f32 rows at nprobe 16: nq_pad {nq_pad}, nbudget {nbudget} "
          f"chunks; positions {cidx.numel()}, live {live} (dead share "
          f"{1 - live / cidx.numel():.4f}, the dead at chunk 0); runs of "
          f"equal chunk ids {run.numel()}, the longest {int(run.max())} "
          f"positions, pieces of ≤ {cap}: {pieces}; rows read by the launch "
          f"{pieces * chunk_mb:.1f} MB (one block per position would read "
          f"{cidx.numel() * chunk_mb:.1f} MB), distinct live chunks "
          f"{distinct} ({distinct * chunk_mb:.1f} MB, the bound's)",
          flush=True)
    _print_rows(idx.metric, {"rescore_groups_f32": row})
    return row


def _budget_select_row(torch):
    """The IVF fine scan's top-k (``kernels.budget_select``) at the IVF
    cell's shape: nq_pad 104, nbudget 1,024 chunks (131,072 scores a row),
    k 10, Gaussian scores with 43 % of the chunks dead at the end of each
    row, as ``ivf._chunk_ids`` lays them out; bit for bit its plain version
    (the masked stable sort). The bound reads the live chunks' scores and
    okc once and writes the result; the library calls are the masked
    ``topk_scores`` it replaces (``sort_ms``, by graph replay) and
    ``torch.topk`` of the masked scores."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import kernels

    nq, nbudget = 104, 1024
    g = torch.Generator(device="cuda").manual_seed(SEED)
    s = torch.randn((nq, nbudget * 128), device="cuda", generator=g)
    live = torch.round(nbudget * 0.57 * (0.8 + 0.4 * torch.rand(
        (nq, 1), device="cuda", generator=g)))
    okc = torch.arange(nbudget, device="cuda")[None] < live
    vals, pos = kernels.budget_select(s, okc, K)
    vals_p, pos_p = kernels.budget_select_plain(s, okc, K)
    check(torch.equal(vals.view(torch.int32), vals_p.view(torch.int32))
          and torch.equal(pos, pos_p),
          "budget_select at the IVF cell's shape differs from its plain "
          "version")
    masked = s.masked_fill(~okc.repeat_interleave(128, 1), float("-inf"))
    n_live = int(okc.sum()) * 128
    row = _row(torch, 0.0, lambda: kernels.budget_select(s, okc, K),
               lambda: kernels.budget_select_plain(s, okc, K), 50,
               _bound(n_live * 4 + _nbytes(okc, vals, pos), 0, "fp32"),
               lambda: torch.topk(masked, K))
    sort_ms = graph_ms(torch, lambda: kernels.budget_select_plain(s, okc, K),
                       20)
    print(f"budget_select at ({nq}, {nbudget}·128), k {K}, live share "
          f"{n_live / s.numel():.4f}: the masked stable sort it replaces "
          f"{sort_ms:.4f} ms by graph replay", flush=True)
    _print_rows(MetricType.L2, {"budget_select": row})
    return row, sort_ms


def _build_ivf(torch, ft, xb, storage):
    t0 = time.perf_counter()
    idx = ft.TorchIndexIVFFlat(D, NLIST, storage=storage, device="cuda")
    idx.train(xb)
    st = idx.train_stats
    t1 = time.perf_counter()
    idx.add(xb)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sizes = idx.list_sizes()
    print(f"ivf {storage}: train {t1 - t0:.3f} s (Kmeans {st['kmeans_s']:.3f}"
          f" s, balance {st['balance_s']:.3f} s), objective "
          f"{np.array2string(st['obj'], precision=1, max_line_width=200)}; "
          f"add {t2 - t1:.3f} s, pool {idx.pool_bytes() / 1e9:.3f} GB; list "
          f"sizes max {sizes.max()} mean {sizes.mean():.2f} (cap "
          f"{st['cap']}); {idx.describe()}", flush=True)
    return idx


def phase_sharded_1m(torch, ft, xb, xq, singles):
    """The sharded flat slice at 1M×128: ShardedIndexFlat over
    ["cuda:0"] * 4 (one card named four times: four shards of 250,000
    rows, each searched on the port's fused path, the lists merged on the
    card), f32 and int8, L2, nq=100, k=10, against the unsharded index of
    the same storage over the same rows (``singles``): ids equal, recall@10
    = 1.0 against the fp64 oracle over the stored rows, fused_fallbacks as
    the unsharded index's. Counts zeroed just before each storage's
    searches and read just after. Prints the host ms/batch, the pipelined
    ms and the merge's device ms, then each index's programs row (one
    CUDA graph a search: the four shard searches and the merge); no
    scaling claim (one card). Returns (counts, the programs rows)."""
    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import kernels
    from faiss_tpu_torch.parallel.sharded import merge_shard_lists

    L2 = MetricType.L2
    need = {"f32": ("sweep_split_3", "select_groups", "rescore_groups_pair",
                    "final_select"),
            "int8": ("sweep_int8", "select_groups", "rescore_groups_int8",
                     "final_select")}
    counts, rows = {}, {}
    for storage, single in singles.items():
        t0 = time.perf_counter()
        sh = ft.ShardedIndexFlat(D, storage=storage, devices=["cuda:0"] * 4)
        sh.add(xb)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
        D1, I1 = single.search(xq, K)
        kernels.reset_launches()
        Ds, Is = sh.search(xq, K)
        t0 = time.perf_counter()
        for _ in range(REPS):
            sh.search(xq, K)
        ms = (time.perf_counter() - t0) / REPS * 1e3
        Da, Ia = sh.search_async(xq, K).wait()
        n = dict(kernels.launches)
        for key in need[storage]:
            check(n[key] > 0, f"sharded_1m {storage}: kernel {key} was "
                              f"never launched")
        for key, v in n.items():
            counts[key] = counts.get(key, 0) + v
        check(np.array_equal(Is, I1), f"sharded_1m {storage}: ids differ "
                                      f"from the unsharded index's")
        check(np.array_equal(Ia, Is) and np.array_equal(Da, Ds),
              f"sharded_1m {storage}: search_async differs")
        rec, rel = oracle_check(torch, single, xq, L2, Ds, Is)
        check(rec == 1.0 and rel <= 1.0,
              f"sharded_1m {storage}: recall@{K} {rec}, distance error "
              f"{rel:.2e} ε")
        check(sh.fused_fallbacks == single.fused_fallbacks,
              f"sharded_1m {storage}: fused_fallbacks {sh.fused_fallbacks} "
              f"against {single.fused_fallbacks} unsharded")
        q, _, nq_pad = sh._prep_queries(xq)
        pipe = cuda_ms(torch, lambda: sh._run_search_fn(
            q, K, nq_pad, force_plain=False), REPS)
        parts = []
        for s in sh.shards:
            v, i, _ = s.index._search_local(
                q, K, use_fused=True, passes=2, hi_exact=False,
                use_direct=False, sel=None)
            parts.append((v, s.to_global(v, i)))
        merge = cuda_ms(torch, lambda: merge_shard_lists(
            parts, K, L2, q.device), REPS)
        rows[f"sharded_1m_{storage}"] = programs_row(
            torch, f"sharded_1m {storage} P=4", sh, *_flat_runs(sh, xq),
            drop=sh._changed)
        print(f"search sharded_1m {storage} L2 P=4 on cuda:0 nq={len(xq)} "
              f"k={K}: ids = the unsharded index's, recall@{K}={rec}, max "
              f"|D - D_oracle| = {rel:.2e} ε; add {add_s:.3f} s, "
              f"per_shard={[x.store.ntotal for x in sh.shards]}; "
              f"ms/batch={ms:.4f} (host clock, incl. copy-back; unsharded "
              f"in its main path above), pipelined {pipe:.4f}, the merge "
              f"{merge:.4f} ms (CUDA events); fused_fallbacks="
              f"{sh.fused_fallbacks}; launches "
              f"{({k: v for k, v in n.items() if v})}", flush=True)
        del sh, parts
        torch.cuda.empty_cache()
    return counts, rows


def _sharded_ivf(torch, ft, ivf, xq):
    """The IVF half of sharded_1m: ``ivf`` (f32 lists, nprobe 16) saved,
    reloaded with load_index(sharded=True, num_shards=4) over cuda:0 named
    four times (the saved routing, ids kept), searched at nprobe 16 with
    the counts zeroed just before and read just after: ids equal to the
    single index's, recall@10 = 1.0 against the fp64 oracle over the
    probed lists; then its programs row. Returns (the counts, the
    row)."""
    import tempfile

    from faiss_tpu_torch.ops import kernels

    D1, I1 = ivf.search(xq, K)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ivf_f32.npz"
        t0 = time.perf_counter()
        ft.save_index(ivf, path)
        sh = ft.load_index(path, sharded=True, devices=["cuda:0"] * 4,
                           num_shards=4)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    check(sh.nprobe == 16 and sh.num_shards == 4, "sharded ivf: reload")
    kernels.reset_launches()
    Ds, Is = sh.search(xq, K)
    t0 = time.perf_counter()
    for _ in range(REPS):
        sh.search(xq, K)
    ms = (time.perf_counter() - t0) / REPS * 1e3
    n = dict(kernels.launches)
    check(n["rescore_groups_f32"] > 0,
          "sharded ivf: K10's f32 rows were never launched")
    check(np.array_equal(Is, I1), "sharded ivf: ids differ from the single "
                                  "index's at nprobe 16")
    ref_i, _ = ivf_oracle(torch, ivf, xq, 16)
    rec = _recall(Is, ref_i)
    check(rec == 1.0, f"sharded ivf: recall@{K} {rec} != 1.0")
    pipe = cuda_ms(torch, lambda: sh._search_packed(xq, K), REPS)
    row = programs_row(torch, "sharded_1m ivf f32 P=4 nprobe=16", sh,
                       *_ivf_runs(ft, sh, xq, 16), drop=sh._changed)
    print(f"search sharded_1m ivf f32 P=4 on cuda:0 nprobe=16 nq={len(xq)} "
          f"k={K}: ids = the single index's, recall@{K}={rec} over the "
          f"probed lists; save + sharded load {load_s:.3f} s, per_shard="
          f"{[x.ntotal for x in sh.shards]}; ms/batch={ms:.4f} (host "
          f"clock), pipelined {pipe:.4f} (CUDA events); launches "
          f"{({k: v for k, v in n.items() if v})}", flush=True)
    del sh
    torch.cuda.empty_cache()
    return n, row


def phase_ivf_1m(torch, ft):
    """The IVF slice's main path (see the module docstring). Returns (the
    launch counts of its counted runs, the K10 f32 kernel row, the counts
    of the sharded reload's run, ``_sharded_ivf``, the programs rows: the
    f32 lists at nprobe 1, 16, 64, their sharded reload, their range pass
    at nprobe 16 and the coarse assign of their 1M add). Frees what it
    builds."""
    import tempfile

    from faiss_tpu_torch import MetricType, programs
    from faiss_tpu_torch.calls import RANGE_CAP0, range_threshold
    from faiss_tpu_torch.ops import kernels

    xb, xq = ivf_data()
    t0 = time.perf_counter()
    flat = ft.TorchIndexFlat(D, device="cuda")
    flat.add(xb)
    _, flat_I = flat.search(xq, K)
    t1 = time.perf_counter()
    for _ in range(REPS):
        flat.search(xq, K)
    flat_ms = (time.perf_counter() - t1) / REPS * 1e3
    q, _, nq_pad = flat._prep_queries(xq)
    flat_pipe = cuda_ms(torch, lambda: flat._run_search_fn(
        q, K, nq_pad, force_plain=False), REPS)
    print(f"ivf_1m control: flat f32 over the same rows, built and searched "
          f"in {t1 - t0:.3f} s; ms/batch={flat_ms:.4f} (host clock), "
          f"pipelined {flat_pipe:.4f}", flush=True)
    del flat
    torch.cuda.empty_cache()

    ivf = {s: _build_ivf(torch, ft, xb, s) for s in ("f32", "bf16", "int8")}
    for s in ("bf16", "int8"):
        check(np.array_equal(ivf[s]._centroids, ivf["f32"]._centroids),
              f"ivf_1m: {s} training gave other centroids than f32's")
    print("ivf_1m: the f32, bf16 and int8 trainings gave bit-equal "
          "centroids", flush=True)

    counts = {}
    gather = {"f32": ("rescore_groups_f32", "budget_select"),
              "bf16": ("rescore_groups", "budget_select"),
              "int8": ("rescore_groups_int8", "budget_select")}
    dense = {"f32": (),
             "bf16": ("sweep_groupmax_2", "select_groups", "rescore_groups",
                      "final_select"),
             "int8": ("sweep_int8", "select_groups", "rescore_groups_int8",
                      "final_select")}
    runs = [("f32", npb) for npb in (1, 16, 64, NLIST)]
    runs += [(s, npb) for s in ("bf16", "int8") for npb in (16, NLIST)]
    for s, npb in runs:
        drive_ivf(torch, f"ivf {s}", ivf[s], xq, npb, flat_I,
                  dense[s] if npb == NLIST else gather[s], counts)
    print(f"launches in the ivf_1m main-path runs: {counts}", flush=True)

    f32 = ivf["f32"]
    prog = {f"ivf_1m_nprobe{npb}": programs_row(
        torch, f"ivf_1m nprobe={npb}", f32, *_ivf_runs(ft, f32, xq, npb))
        for npb in (1, 16, 64)}
    f32.nprobe = 16
    k10 = _k10_f32_row(torch, f32, xq)

    sharded_counts, prog["sharded_1m_ivf"] = _sharded_ivf(torch, ft, f32, xq)

    # -- the surface at 1M, as checks ----------------------------------------
    D16, I16 = f32.search(xq, K)
    radius = float(np.median(D16[:, -1]))
    lims, _, Ir = f32.range_search(xq, radius)
    ref_i, ref_d = ivf_oracle(torch, f32, xq, 16, k=4096)
    near = 0
    for r in range(len(xq)):
        ok = ref_i[r][np.isfinite(ref_d[r])]
        dd = ref_d[r][np.isfinite(ref_d[r])]
        check(dd[-1] >= radius, f"range oracle: k too small for query {r}")
        want = set(ok[dd < radius].tolist())
        got = set(Ir[lims[r]:lims[r + 1]].tolist())
        diff = np.array(sorted(want ^ got), np.int64)
        dist = dict(zip(ok.tolist(), dd.tolist()))
        check(all(abs(dist.get(int(i), np.inf) - radius) <= 1e-4 * radius
                  for i in diff), f"ivf range_search: query {r} differs")
        near += diff.size
    print(f"ivf range_search f32 nprobe=16 radius {radius:.4f}: "
          f"{lims[-1] / len(xq):.1f} hits a query, the fp64 oracle's set "
          f"within the probed lists but for {near} rows within 1e-4·radius",
          flush=True)
    q, _, _, nprobe, nbudget, _ = f32._prep_search(xq, None)
    prog["ivf_1m_range_nprobe16"] = programs_row(
        torch, f"ivf_1m range nprobe=16 radius {radius:.4f}", f32,
        *_range_runs(f32, q, nprobe, nbudget,
                     range_threshold(radius, f32.metric), RANGE_CAP0, None))
    n = f32.res.cache_info()["entries"]
    f32.range_search(xq, radius * 1.01)
    check(f32.res.cache_info()["entries"] == n,
          "programs ivf_1m range: another radius built another program")
    # the coarse assign of a 1M add (its copy to the card included), under
    # the assign's own owner: an add keeps it
    prog["ivf_1m_assign"] = programs_row(
        torch, f"ivf_1m assign n={NV}", f32,
        _eagerly(lambda: f32._assign_padded(xb)[1]),
        lambda: f32._assign_padded(xb)[1],
        drop=lambda: f32.res.discard(
            programs.owned_by(f32._assign_owner)),
        reps=3)

    rng = np.random.default_rng(SEED + 4)
    sel = (ft.IDSelectorRange(0, NV // 2)
           | ft.IDSelectorBatch(rng.choice(NV, NV // 100, replace=False)))
    admit = sel.is_member(np.arange(NV, dtype=np.int64))
    Df, If = f32.search(xq, K, params=ft.SearchParams(sel=sel))
    ref_i, _ = ivf_oracle(torch, f32, xq, 16, admit=admit)
    check(_recall(If, ref_i) == 1.0 and admit[If[If >= 0]].all(),
          "ivf filtered search differs from the oracle over admitted rows")
    print("ivf filtered search f32 nprobe=16: recall@10 = 1.0 over the "
          "admitted rows of the probed lists", flush=True)

    int8 = ivf["int8"]
    int8.nprobe = 16
    Di, Ii = int8.search(xq, K)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/ivf_int8.npz"
        t0 = time.perf_counter()
        ft.save_index(int8, path)
        back = ft.load_index(path)
        t1 = time.perf_counter()
    Db, Ib = back.search(xq, K)
    check(np.array_equal(Ib, Ii) and np.array_equal(Db, Di)
          and np.array_equal(back._assignments(), int8._assignments()),
          "ivf save/load: results differ")
    print(f"ivf save_index / load_index int8: {t1 - t0:.3f} s, the same "
          f"routing and results bit for bit", flush=True)
    del back

    half = NV // 2
    a, b, whole = (ft.TorchIndexIVFFlat(D, NLIST, nprobe=16, device="cuda")
                   for _ in range(3))
    for x in (a, b, whole):
        x._set_centroids(f32._centroids, quantizer=f32.quantizer)
    a.add(xb[:half])
    b.add(xb[half:])
    whole.add(xb[:half])
    whole.add(xb[half:])
    a.merge_from(b)
    check(b.ntotal == 0 and a.ntotal == NV, "ivf merge_from: counts")
    Da, Ia = a.search(xq, K)
    Dw, Iw = whole.search(xq, K)
    check(np.array_equal(Ia, Iw) and np.array_equal(Da, Dw),
          "ivf merge_from: differs from the index built by the same adds")
    print("ivf merge_from: two 500,000-row f32 halves search as the index "
          "built by the same two adds, bit for bit", flush=True)
    del a, b, whole

    w = ft.TorchIndexIDMap2(ft.TorchIndexIVFFlat(D, NLIST, storage="bf16",
                                                 nprobe=1, device="cuda"))
    w.index._set_centroids(f32._centroids, quantizer=f32.quantizer)
    w.add_with_ids(xb, 10 * np.arange(NV))
    bf16 = ivf["bf16"]
    bf16.nprobe = 16
    _, Ib16 = bf16.search(xq, K)
    check(np.array_equal(w.search(xq, K, params=ft.SearchParams(nprobe=16))[1],
                         10 * Ib16), "TorchIndexIDMap2 over IVF: labels")
    for i in (0, NV // 3, NV - 1):
        check(np.array_equal(w.reconstruct(10 * i), bf16.reconstruct(i)),
              f"TorchIndexIDMap2 over IVF: reconstruct({10 * i})")
    print("TorchIndexIDMap2 over bf16 IVF with SearchParams(nprobe=16): "
          "labels 10x the index's, reconstruct by custom id", flush=True)
    del w

    rm = rng.choice(NV, NV // 10, replace=False)
    check(f32.remove_ids(rm) == NV // 10 and f32.ntotal == NV - NV // 10,
          "ivf remove_ids: counts")
    drive_ivf(torch, "ivf f32 after remove_ids", f32, xq, 16, None,
              ("rescore_groups_f32",), {}, reps=3)
    del ivf, f32, int8, bf16
    torch.cuda.empty_cache()
    return counts, k10, sharded_counts, prog


# f32 patterns whose bf16 bits the NaN repair holds on the card: NaN
# payloads of both signs (quiet, signalling, low bits only), ±inf, ±0,
# subnormals and round-to-nearest-even halfway cases
NAN_PATTERNS = [0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FC00001,
                0x7FFFFFFF, 0xFFFFFFFF, 0x7FA00000, 0x7F810000, 0xFF810000,
                0x7F800000, 0xFF800000, 0, 0x80000000, 1, 0x80000001,
                0x7FFFFF, 0x807FFFFF, 0x8000, 0x3F808000, 0x3F818000,
                0xBF808000, 0x7F7F8000]


def phase_nan_repair(torch, ft):
    """The bf16 NaN repair on the card (storage.f32_to_bf16: every NaN to
    sign | 0x7fc0, as jnp.astype): the helper's bits on a CUDA tensor equal
    its bits on a CPU tensor over NAN_PATTERNS and 65,536 random values of
    every magnitude; rows holding NaNs (quiet and signalling, positive) are
    stored as bf16 rows, f32 pair-only planes and an IVF16 bf16 pool with
    the CPU port's bits, and their searches return the CPU port's ids and
    distances (IP and L2; flat fused and plain, the IVF at nprobe 4 and 16).
    Integer rows and queries: every score is exact on both devices."""
    import os

    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import fused
    from faiss_tpu_torch.storage import encode_f16_bits, f32_to_bf16

    rng = np.random.default_rng(SEED + 5)
    x = np.concatenate([
        np.array(NAN_PATTERNS, np.uint32).view(np.float32),
        (rng.standard_normal(1 << 16)
         * 2.0 ** rng.integers(-140, 120, 1 << 16)).astype(np.float32)])
    t = torch.from_numpy(x)
    check(torch.equal(f32_to_bf16(t.cuda()).view(torch.int16).cpu(),
                      f32_to_bf16(t).view(torch.int16)),
          "f32_to_bf16: the card's bits differ from the CPU's")
    # f16: the card's own conversion turns every NaN into 0x7fff (+inf in
    # the f16 contract); encode_f16_bits writes the NaN lanes from the
    # input's bits, as the CPU, XLA and the native runtime do
    f16 = encode_f16_bits(t.cuda()).view(torch.int16).cpu()
    check(torch.equal(f16, encode_f16_bits(t).view(torch.int16)),
          "encode_f16_bits: the card's bits differ from the CPU's")
    check(int(f16[1]) == -512, "encode_f16_bits: a negative NaN lost its "
          "sign on the card")
    nan = torch.isnan(t)
    raw = t.cuda().to(torch.float16).view(torch.int16).cpu()[nan]
    raw_diff = int((raw != t.to(torch.float16).view(torch.int16)[nan]).sum())
    print(f"nan_repair: Tensor.to(float16) on the card differs from the CPU "
          f"on {raw_diff} of {int(nan.sum())} NaN lanes (card patterns "
          f"{sorted({hex(v & 0xFFFF) for v in raw.tolist()})})", flush=True)
    n, d, snan = 20_000, 64, np.uint32(0x7F800001).view(np.float32)
    xb = rng.integers(-8, 9, (n, d)).astype(np.float32)
    xb[[5, 300, 9000, n - 1], [1, 7, 63, 0]] = [np.nan, snan, np.nan, snan]
    xq = rng.integers(-8, 9, (NQ, d)).astype(np.float32)
    bits = lambda t: t.contiguous().view(torch.int16).cpu()  # noqa: E731

    def same(a, b, what):
        (Da, Ia), (Db, Ib) = a, b
        check(np.array_equal(Ia, Ib) and np.array_equal(Da, Db),
              f"NaN rows {what}: the card's ids or distances differ from the "
              f"CPU's")
        check((Ia == -1).any(), f"NaN rows {what}: no NaN row came back")

    gate = fused.fused_path_eligible
    fused.fused_path_eligible = lambda **kw: kw["nv_eff"] >= 8192
    runs = 0
    try:
        for metric in (MetricType.L2, MetricType.INNER_PRODUCT):
            for label, kw, planes in (("bf16", {"storage": "bf16"}, ("db",)),
                                      ("pair", {"keep_master": False},
                                       ("db_hi", "db_lo"))):
                idx = [ft.TorchIndexFlat(d, metric=metric, device=dev, **kw)
                       for dev in ("cpu", "cuda")]
                for i in idx:   # two batches below the native threshold:
                    i.add(xb[: n // 2])   # the conversion on the card
                    i.add(xb[n // 2:])
                for p in planes:
                    check(torch.equal(bits(getattr(idx[0].store, p)[:n]),
                                      bits(getattr(idx[1].store, p)[:n])),
                          f"NaN rows {label}: stored {p} bits differ")
                for plain in (False, True):
                    for i in idx:
                        i.set_force_plain(plain)
                    same(idx[0].search(xq, K), idx[1].search(xq, K),
                         f"{label} {metric.value} plain={plain}")
                    runs += 1
            # f16 rows with NaNs of both signs: the card's stored bits are
            # the CPU's (a negative NaN decodes to -inf on both)
            xs = xb.copy()
            xs[[7, 4000], [2, 9]] = np.array([0xFFC00000, 0xFF800001],
                                             np.uint32).view(np.float32)
            f16s = [ft.TorchIndexFlat(d, metric=metric, storage="f16",
                                      device=dev) for dev in ("cpu", "cuda")]
            for i in f16s:
                i.add(xs[: n // 2])
                i.add(xs[n // 2:])
            check(torch.equal(bits(f16s[0].store.db[:n]),
                              bits(f16s[1].store.db[:n])),
                  "NaN rows f16: stored bits differ")
            cpu = ft.TorchIndexIVFFlat(d, 16, metric=metric, storage="bf16",
                                       device="cpu")
            cpu.train(rng.integers(-8, 9, (4096, d)).astype(np.float32))
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "ivf.npz")
                ft.save_index(cpu, path)
                gpu = ft.load_index(path, device="cuda")
            for i in (cpu, gpu):
                i.add(xb)
            check(np.array_equal(cpu._assignments(), gpu._assignments()),
                  "NaN rows ivf: the lists differ")
            check(torch.equal(bits(cpu._rows_by_id()[0]),
                              bits(gpu._rows_by_id()[0])),
                  "NaN rows ivf: stored pool bits differ")
            for nprobe in (4, 16):
                cpu.nprobe = gpu.nprobe = nprobe
                same(cpu.search(xq, K), gpu.search(xq, K),
                     f"ivf bf16 {metric.value} nprobe={nprobe}")
                runs += 1
    finally:
        fused.fused_path_eligible = gate
    print(f"nan_repair: f32_to_bf16 and encode_f16_bits equal on the card "
          f"and the CPU over {x.size} values (a negative NaN keeps its sign "
          f"in f16); rows with NaNs stored with the CPU's bits (bf16 rows, "
          f"pair planes, f16 rows with negative NaNs, IVF bf16 pool); {runs} "
          f"searches with the CPU port's ids and distances", flush=True)


def phase_native(torch, ft, xb, build_calls):
    """The native host runtime on the card's host: the 1M bf16 and f16
    adds of the main paths took its route (``build_calls``, its call counts
    over those builds); then one 1M batch of each storage added by both
    routes, timed (host clock, from the empty index to the rows on the
    card): the native route (host norms and conversion, one 2-byte upload)
    and the device route (the batch below a raised threshold: a 4-byte
    upload, norms and conversion on the card). Both store the same row
    bits (no NaN in these rows); the norms' differences are printed in
    ulps (double against fp32 accumulation)."""
    from faiss_tpu_torch import native, storage

    want = {"f32_to_bf16": 2, "f32_to_f16": 2, "l2_norms": 4}
    check(all(build_calls[k] == n for k, n in want.items()),
          f"native: the 1M bf16 and f16 adds did not take the native route: "
          f"{build_calls}")
    print(f"native: {native.build()} (ft_version "
          f"{native._load().ft_version()}); the "
          f"main paths' 1M bf16 and f16 adds called it {build_calls}",
          flush=True)
    for st in ("bf16", "f16"):
        out = {}
        for route in ("native", "device"):
            saved = storage.NATIVE_CONVERT_MIN_ELEMS
            if route == "device":
                storage.NATIVE_CONVERT_MIN_ELEMS = xb.size + 1
            native.reset_calls()
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                idx = ft.TorchIndexFlat(D, storage=st, device="cuda")
                idx.add(xb)
                torch.cuda.synchronize()
                out[route] = (idx.store, time.perf_counter() - t0)
            finally:
                storage.NATIVE_CONVERT_MIN_ELEMS = saved
            check((native.calls["l2_norms"] == 1) == (route == "native"),
                  f"native: the {st} add did not take the {route} route")
        (a, ta), (b, tb) = out["native"], out["device"]
        check(torch.equal(a.db[:NV].view(torch.int16),
                          b.db[:NV].view(torch.int16)),
              f"native: {st} row bits differ between the routes")
        ulps = (a.norms[:NV].view(torch.int32).long()
                - b.norms[:NV].view(torch.int32).long()).abs()
        print(f"native {st} 1M×{D} add: native route {ta:.3f} s, device "
              f"route {tb:.3f} s (host clock); row bits equal; norms differ "
              f"in {int((ulps > 0).sum())} of {NV} rows, at most "
              f"{int(ulps.max())} ulp", flush=True)
        del a, b, out, idx
        # the parts of each route, one at a time (host clock)
        conv = native.f32_to_bf16 if st == "bf16" else native.f32_to_f16
        parts = {}
        for part, fn in (("norms", lambda: native.l2_norms(xb)),
                         ("conversion", lambda: conv(xb)),
                         ("upload 2 B", lambda: torch.from_numpy(
                             bits.view(np.int16)).to("cuda")),
                         ("upload 4 B", lambda: torch.from_numpy(xb).to(
                             "cuda"))):
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            parts[part] = time.perf_counter() - t0
            if part == "conversion":
                bits = r
            del r
        print(f"native {st} parts: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in parts.items()), flush=True)
    torch.cuda.empty_cache()


def write_fvecs(path, x):
    """TexMex .fvecs: per row, int32 d then d float32s."""
    rows = np.empty((x.shape[0], x.shape[1] + 1), np.float32)
    rows[:, 0] = np.int32(x.shape[1]).view(np.float32)
    rows[:, 1:] = x
    rows.tofile(path)


def write_bvecs(path, x):
    """.bvecs: per row, int32 d then d uint8s."""
    rows = np.empty((x.shape[0], x.shape[1] + 4), np.uint8)
    rows[:, :4] = np.frombuffer(np.int32(x.shape[1]).tobytes(), np.uint8)
    rows[:, 4:] = x
    rows.tofile(path)


def phase_loader_1m(torch, ft, xb, xq, xb_i, xq_i, refs):
    """loader.build_index_from_file at DEFAULT_BATCH_ROWS (4 add batches
    of 1M rows) from three files written here: the Gaussian rows as .fvecs
    (f32, L2 and IP) and as .npy (bf16: every batch converts on the host),
    the integer rows as .bvecs (f32 L2: hi_exact across the batches, split
    statistics (0, 0)), and the .fvecs sharded over ["cuda:0"] * 4. Each
    index returns the in-memory index's ids (``refs``: the same rows and
    storage, one batch) with recall 1.0 against the fp64 oracle over that
    index's stored rows, which are the loaded index's. Counts zeroed just
    before the builds and read just after the last search."""
    import os

    from faiss_tpu_torch import MetricType, loader, native
    from faiss_tpu_torch.ops import kernels

    L2, IP = MetricType.L2, MetricType.INNER_PRODUCT
    runs = [("fvecs", "f32", {}, (L2, IP), xq),
            ("bvecs", "f32_sift", {}, (L2,), xq_i),
            ("npy", "bf16", {"storage": "bf16"}, (L2, IP), xq),
            ("fvecs", "f32 sharded", {"sharded": True,
                                      "devices": ["cuda:0"] * 4}, (L2, IP),
             xq)]
    want = {(label, m): refs[label.split()[0]][m].search(q, K)
            for _, label, _, metrics, q in runs for m in metrics}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {ext: os.path.join(tmp, f"base.{ext}")
                 for ext in ("fvecs", "bvecs", "npy")}
        t0 = time.perf_counter()
        write_fvecs(paths["fvecs"], xb)
        write_bvecs(paths["bvecs"], xb_i.astype(np.uint8))
        np.save(paths["npy"], xb)
        print(f"loader_1m: wrote " + ", ".join(
            f"{ext} {os.path.getsize(p) / 1e6:.1f} MB"
            for ext, p in paths.items())
            + f" in {time.perf_counter() - t0:.3f} s", flush=True)
        kernels.reset_launches()
        native.reset_calls()
        for ext, label, kw, metrics, q in runs:
            ref = refs[label.split()[0]]
            for m in metrics:
                t0 = time.perf_counter()
                idx = loader.build_index_from_file(paths[ext], metric=m,
                                                   **kw)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                check(idx.ntotal == NV, f"loader_1m {label}: ntotal "
                      f"{idx.ntotal}")
                if label == "f32_sift":
                    check(idx.store.split_stats_host() == (0.0, 0.0),
                          f"loader_1m {label}: split statistics "
                          f"{idx.store.split_stats_host()}, not (0, 0)")
                D_, I_ = idx.search(q, K)
                Dr, Ir = want[(label, m)]
                check(np.array_equal(I_, Ir), f"loader_1m {label} "
                      f"{m.value}: ids differ from the in-memory index's")
                rec, rel = oracle_check(torch, ref[m], q, m, D_, I_)
                check(rec == 1.0 and rel <= 1.0, f"loader_1m {label} "
                      f"{m.value}: recall@{K} {rec}, error {rel:.2e} ε")
                print(f"loader_1m {ext} -> {label} {m.value}: built in "
                      f"{secs:.3f} s (read, {-(-NV // loader.DEFAULT_BATCH_ROWS)}"
                      f" add batches, on the card), ids = the in-memory "
                      f"index's, recall@{K}={rec}, max |D - D_oracle| = "
                      f"{rel:.2e} ε", flush=True)
                del idx
    counts = dict(kernels.launches)
    check(native.calls["f32_to_bf16"] == 8,
          f"loader_1m: the bf16 batches did not all convert on the host: "
          f"{native.calls}")
    print(f"launches in the loader_1m run: {counts}; native calls "
          f"{native.calls}", flush=True)
    for key in ("sweep_split_3", "sweep_groupmax_1", "sweep_groupmax_2",
                "select_groups", "rescore_groups", "rescore_groups_pair",
                "final_select"):
        check(counts[key] > 0, f"loader_1m: kernel {key} was never launched")
    torch.cuda.empty_cache()
    return counts


class _StandInIndexFlat:
    """The faiss IndexFlat members the interop reads and writes."""

    def __init__(self, d, metric):
        self.d, self.metric_type, self.ntotal = d, metric, 0
        self._xb = np.zeros((0, d), np.float32)

    def add(self, x):
        x = np.ascontiguousarray(x, np.float32).reshape(-1, self.d)
        self._xb = np.concatenate([self._xb, x])
        self.ntotal = len(self._xb)

    def reconstruct_n(self, i0, n):
        return self._xb[i0:i0 + n].copy()


def phase_interop(torch, ft, xb, xq, f32):
    """index_cpu_to_torch / index_torch_to_cpu through a stand-in faiss
    module (an IndexFlat and faiss's metric constants, METRIC_L2 = 1,
    METRIC_INNER_PRODUCT = 0) in sys.modules: the 1M f32 rows of a CPU
    IndexFlat become a TorchIndexFlat on the card that returns the f32
    index's ids, and the f32 index goes back to a CPU IndexFlat with its
    rows bit for bit."""
    import types

    from faiss_tpu_torch import MetricType
    from faiss_tpu_torch.ops import kernels

    mod = types.ModuleType("faiss")
    mod.METRIC_L2, mod.METRIC_INNER_PRODUCT = 1, 0
    mod.IndexFlat = _StandInIndexFlat
    saved = sys.modules.get("faiss")
    sys.modules["faiss"] = mod
    _, I_ref = f32.search(xq, K)
    try:
        kernels.reset_launches()
        cpu = mod.IndexFlat(D, mod.METRIC_L2)
        cpu.add(xb)
        t0 = time.perf_counter()
        idx = ft.index_cpu_to_torch(cpu)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(idx.device.type == "cuda" and idx.metric is MetricType.L2,
              "interop: the converted index is not L2 on the card")
        check(np.array_equal(idx.search(xq, K)[1], I_ref),
              "interop: index_cpu_to_torch's ids differ from the f32 index's")
        counts = dict(kernels.launches)
        t0 = time.perf_counter()
        back = ft.index_torch_to_cpu(f32)
        secs_back = time.perf_counter() - t0
        check(back.metric_type == mod.METRIC_L2 and back.ntotal == NV
              and np.array_equal(back.reconstruct_n(0, NV).view(np.uint32),
                                 xb.view(np.uint32)),
              "interop: index_torch_to_cpu did not give back the rows")
    finally:
        if saved is None:
            sys.modules.pop("faiss", None)
        else:
            sys.modules["faiss"] = saved
    print(f"interop: index_cpu_to_torch over {NV} f32 rows {secs:.3f} s, "
          f"ids = the f32 index's; index_torch_to_cpu {secs_back:.3f} s, "
          f"rows bit for bit; launches {counts}", flush=True)
    del idx, back, cpu
    return counts


def _grid_data_at(i):
    """(xb, xq) of DEFAULT_GRID[i], replayed from bench_grid's generator."""
    from faiss_tpu_torch.utils import profiling

    rng = np.random.default_rng(42)
    for cfg in profiling.DEFAULT_GRID[: i + 1]:
        xb, xq = profiling.grid_data(rng, cfg)
    return xb, xq


def phase_profiling(torch, ft, f32, xq):
    """utils.profiling on the card: bench_grid over the whole DEFAULT_GRID
    (14 configs, faiss_tpu's data from default_rng(42)) with TorchIndexFlat
    on cuda, recall against the fp64 oracle over every query (the f32
    configs must give 1.0; a miss prints the score gap at rank k and
    fails); measure_search on the 1M f32 index at depths 1, 8 and 32; a
    trace around one 1M f32 search that names the sweep kernel. Counts
    zeroed just before the grid and read just after the trace."""
    from faiss_tpu_torch.ops import kernels
    from faiss_tpu_torch.utils import profiling

    def factory(d, metric, storage):
        return ft.TorchIndexFlat(d, metric=metric, storage=storage,
                                 device="cuda")

    kernels.reset_launches()
    t0 = time.perf_counter()
    res = profiling.bench_grid(factory, profiling.DEFAULT_GRID)
    secs = time.perf_counter() - t0
    torch.cuda.empty_cache()
    check(len(res) == 14, f"profiling: {len(res)} grid lines")
    bad = [(i, r) for i, (cfg, r) in enumerate(zip(profiling.DEFAULT_GRID,
                                                   res))
           if cfg["storage"] == "f32" and r.recall_at_k != 1.0]
    for i, r in bad:
        cfg = profiling.DEFAULT_GRID[i]
        xb, q = _grid_data_at(i)
        idx = factory(cfg["d"], cfg.get("metric", "l2"), "f32")
        idx.add(xb)
        _, I_ = idx.search(q, cfg["k"])
        s = q.astype(np.float64) @ xb.astype(np.float64).T
        if cfg.get("metric", "l2") == "l2":
            s = 2 * s - (xb.astype(np.float64) ** 2).sum(1)
        for qi in range(len(q)):
            top = np.sort(s[qi])[::-1]
            got = s[qi][I_[qi]].min()
            if got < top[cfg["k"] - 1]:
                print(f"profiling {cfg['name']}: query {qi} fp64 score at "
                      f"rank k {top[cfg['k'] - 1]!r}, rank k+1 "
                      f"{top[cfg['k']]!r}, gap {top[cfg['k'] - 1] - top[cfg['k']]!r}; "
                      f"worst returned {got!r}", flush=True)
                break
        del idx
    check(not bad, "profiling: f32 grid configs below recall 1.0: "
          + ", ".join(f"{r.name} {r.recall_at_k}" for _, r in bad))
    print(f"profiling: bench_grid over DEFAULT_GRID took {secs:.1f} s (the "
          f"fp64 oracle on the host included)", flush=True)
    for depth in (1, 8, 32):
        lat, pipe = profiling.measure_search(f32, xq, K, depth=depth)
        print(f"profiling measure_search 1M f32 L2 nq={len(xq)} k={K} depth "
              f"{depth}: blocking {lat:.4f} ms, pipelined {pipe:.4f} ms a "
              f"search (host clock)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            f32.search(xq, K)
        path = Path(prof.trace_file)
        check(path.exists(), "profiling: trace wrote no file")
        text = path.read_text()
        check("sweep_split_mma_kernel" in text,
              f"profiling: the trace does not name the sweep kernel "
              f"({len(text)} bytes, {text.count('\"cat\": \"kernel\"')} "
              f"kernel events)")
        print(f"profiling trace: {path.name}, {path.stat().st_size} bytes, "
              f"names sweep_split_mma_kernel", flush=True)
    counts = dict(kernels.launches)
    print(f"launches in the profiling run: {counts}", flush=True)
    for key in ("sweep_split_3", "sweep_groupmax_1", "sweep_groupmax_2",
                "sweep_int8", "select_groups", "rescore_groups",
                "rescore_groups_pair", "rescore_groups_int8",
                "final_select"):
        check(counts[key] > 0, f"profiling: kernel {key} was never launched")
    return counts


# -- the search programs: CUDA graphs replayed from the cache ---------------


def _eagerly(fn):
    """``fn`` run under ``programs.eager()``: the search with no program
    and no cache entry (what a replay must equal bit for bit)."""
    from faiss_tpu_torch import programs

    def run():
        with programs.eager():
            return fn()

    return run


def _flat_runs(idx, xq):
    """(eager, cached) first passes of one flat search of ``xq`` (the
    queries' copy to the card included): the eager search, and the
    program of the index's TorchResources."""
    def run():
        q, _, nq_pad = idx._prep_queries(xq)
        return idx._run_search_fn(q, K, nq_pad, force_plain=False)[0]

    return _eagerly(run), run


def _ivf_runs(ft, ivf, xq, nprobe):
    p = ft.SearchParams(nprobe=nprobe)

    def run():
        return ivf._search_packed(xq, K, p)[0]

    return _eagerly(run), run


def _host_ms(fn, reps):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn().cpu()
    return (time.perf_counter() - t0) / reps * 1e3


def programs_row(torch, label, idx, eager, cached, drop=None, reps=REPS):
    """The programs phase for one configuration: the index's programs
    dropped (a new generation; ``drop``, default ``idx._mutated``), the
    cold first batch (eager warm-up and capture: the capture time), the
    replays against the eager search bit for bit, and host ms/batch eager
    and replayed in turns (eager, replay, replay, eager; ``reps`` each).
    Returns the row."""
    (drop or idx._mutated)()
    torch.cuda.synchronize()
    n0 = idx.res.cache_info()["entries"]
    t0 = time.perf_counter()
    first = cached().cpu()
    cold = (time.perf_counter() - t0) * 1e3
    check(idx.res.cache_info()["entries"] == n0 + 1,
          f"programs {label}: the search built no program")
    ref = eager().cpu().view(torch.int32)
    for name, got in (("the first batch", first), ("a replay", cached()),
                      ("a replay", cached())):
        check(torch.equal(got.cpu().view(torch.int32), ref),
              f"programs {label}: {name} differs from the eager search")
    turns = {"eager": eager, "replay": cached}
    host = {"eager": [], "replay": []}
    for mode in ("eager", "replay", "replay", "eager"):
        host[mode].append(_host_ms(turns[mode], reps))
    row = {"capture_ms": cold, "host_ms": host,
           "cache_info": idx.res.cache_info()}
    print(f"programs {label}: {json.dumps(row)}", flush=True)
    return row


def _range_runs(idx, q, *args):
    """(eager, cached) packed range passes of ``idx`` (flat: q, nq_pad,
    thr, cap, sel; IVF: q, nprobe, nbudget, thr, rcap, sel)."""
    def run():
        return idx._range_packed(q, *args)[0]

    return _eagerly(run), run


def phase_programs(torch, runs):
    """The programs phase over the 1M flat configurations ``runs``
    [(label, index, queries)], L2."""
    out = {}
    for label, idx, xq in runs:
        out[label] = programs_row(torch, label, idx, *_flat_runs(idx, xq))
    return out


def range_programs_row(torch, idx, xq):
    """The flat range pass of the 1M f32 index at the median
    10th-neighbour distance as a programs row (a pass takes about half a
    second on an H100: 3 reps, depth 4); a second radius must replay the
    program."""
    from faiss_tpu_torch.calls import RANGE_CAP0, range_threshold

    D10, _ = idx.search(xq, K)
    radius = float(np.median(D10[:, -1]))
    q, _, nq_pad = idx._prep_queries(xq)
    thr = range_threshold(radius, idx.metric)
    row = programs_row(
        torch, f"range_1m f32 radius {radius:.4f}", idx,
        *_range_runs(idx, q, nq_pad, thr, RANGE_CAP0, None), reps=3)
    n = idx.res.cache_info()["entries"]
    lims, _, _ = idx.range_search(xq, radius * 1.01)
    check(idx.res.cache_info()["entries"] == n,
          "programs range_1m: another radius built another program")
    print(f"programs range_1m: radius {radius * 1.01:.4f} replayed the "
          f"program ({lims[-1] / len(xq):.1f} hits a query)", flush=True)
    return row


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
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = ft.gpu_name_and_power_limit()
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(ft.describe_capabilities(), flush=True)

    t0 = time.perf_counter()
    kv = k10_variants()
    # PR 10's kernels (K10's thread-per-row f16 mode, K11's block a query),
    # built beside the library (loaded, they outlive their directory): the
    # redesigned kernels are held against them, and their times in this run
    with tempfile.TemporaryDirectory() as tmp:
        procs = kv.start_build(kernels._nvcc(), kernels.NVCC_FLAGS, tmp,
                               kv.legacy_sources())
        lib = kernels.build()
        legacy = {"libs": kv.finish_build(procs, verbose=False), "ms": {}}
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name} (and PR "
          f"10's K10 f16 and K11 beside it)", flush=True)
    phase_nan_repair(torch, ft)

    rng = np.random.default_rng(SEED)
    xb = rng.standard_normal((NV, D), dtype=np.float32)
    xq = rng.standard_normal((NQ, D), dtype=np.float32)
    xb_i = rng.integers(0, 256, (NV, D)).astype(np.float32)
    xq_i = rng.integers(0, 256, (NQ, D)).astype(np.float32)
    # the native host runtime builds here (g++), before the adds are timed;
    # the 1M bf16 and f16 adds below take its route
    check(ft.native.available(), "native: the host runtime is not available")
    ft.native.reset_calls()
    bf16 = {m: build_index(torch, ft, xb, m, storage="bf16") for m in (L2, IP)}
    f32 = {m: build_index(torch, ft, xb, m) for m in (L2, IP)}
    sift = build_index(torch, ft, xb_i, L2)
    pair = build_index(torch, ft, xb, L2, keep_master=False)
    int8 = {m: build_index(torch, ft, xb, m, storage="int8") for m in (L2, IP)}
    f16 = {m: build_index(torch, ft, xb, m, storage="f16") for m in (L2, IP)}
    native_build_calls = dict(ft.native.calls)
    check("hi_exact=True" in sift.describe(), "f32_sift is not hi_exact")
    check("hi_exact=False" in f32[L2].describe(), "Gaussian f32 is hi_exact")
    check(all(i.is_trained for i in int8.values()), "int8 is not trained")
    check(all(i.store.f16_clean() for i in f16.values()),
          "Gaussian f16 is not clean")

    print("kernels vs plain (main-path shapes):", flush=True)
    by_metric = [phase_kernels(torch, idx, xq, m, legacy)
                 for m, idx in bf16.items()]
    by_metric += [phase_f32_kernels(torch, idx, xq, m)
                  for m, idx in f32.items()]
    by_metric += [phase_int8_kernels(torch, idx, xq, m, legacy)
                  for m, idx in int8.items()]
    by_metric += [phase_f16_kernels(torch, idx, xq, m, legacy)
                  for m, idx in f16.items()]
    phase_truncation_adversary(torch)
    # the table keeps the L2 times and bound and the larger error of the
    # two metrics
    rows = {}
    for r in by_metric:
        for key, row in r.items():
            prev = rows.get(key)
            rows[key] = row if prev is None \
                else (max(prev[0], row[0]),) + prev[1:]
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
    k2_certificate(torch, sift, xq_i)
    counts["pair"] = main_path(torch, "pair", [(pair, xq, L2)],
                               ("sweep_split_3", "rescore_groups_pair",
                                "select_groups", "final_select"))
    int8_runs = [(idx, xq, m) for m, idx in int8.items()]
    counts["int8"] = main_path(torch, "int8", int8_runs,
                               ("sweep_int8", "rescore_groups_int8",
                                "select_groups", "final_select"))
    # nq=8 sweeps two query planes (K6) from the start, whatever the
    # one-plane certificate does at nq=100
    f16_runs = [(idx, xq, m) for m, idx in f16.items()]
    f16_runs.append((f16[L2], xq[:8], L2))
    counts["f16"] = main_path(torch, "f16", f16_runs,
                              ("sweep_f16_1", "sweep_f16_2",
                               "rescore_groups_f16", "select_groups",
                               "final_select"))
    pipelined(torch, "bf16", bf16_runs)
    pipelined(torch, "f32", f32_runs)
    pipelined(torch, "f32_sift", [(sift, xq_i, L2)])
    pipelined(torch, "pair", [(pair, xq, L2)])
    pipelined(torch, "int8", int8_runs)
    pipelined(torch, "f16", f16_runs)

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

    # the search programs: each 1M configuration's CUDA graphs against
    # its eager search (f32_10m and ivf_1m add theirs in their phases)
    programs = phase_programs(torch, [
        ("f32", f32[L2], xq), ("f32_sift", sift, xq_i), ("pair", pair, xq),
        ("bf16", bf16[L2], xq), ("int8", int8[L2], xq),
        ("f16", f16[L2], xq)])

    # the native route against the device route; the loader, the faiss
    # interop and the profiling harness over the 1M rows and DEFAULT_GRID
    phase_native(torch, ft, xb, native_build_calls)
    counts["loader_1m"] = phase_loader_1m(
        torch, ft, xb, xq, xb_i, xq_i,
        {"f32": f32, "f32_sift": {L2: sift}, "bf16": bf16})
    counts["interop"] = phase_interop(torch, ft, xb, xq, f32[L2])
    counts["profiling"] = phase_profiling(torch, ft, f32[L2], xq)

    # the 10M main path, the surface, then the IVF slice's main path; each
    # frees what it builds
    (counts["f32_10m"], rows["sweep_block_max"],
     programs["f32_10m"]) = phase_f32_10m(torch, ft, xb, xq)
    counts["f16_cell_k6"], rows["sweep_f16_2_d96"] = \
        _k6_at_the_cell_width(torch)
    counts["surface"] = phase_surface(torch, ft, xb, xq, f32[L2], bf16[L2],
                                      int8[L2], f16[L2])
    programs["range_1m"] = range_programs_row(torch, f32[L2], xq)
    del bf16, sift, pair, f16, dup, idx
    torch.cuda.empty_cache()
    counts["sharded_1m"], prog = phase_sharded_1m(
        torch, ft, xb, xq, {"f32": f32[L2], "int8": int8[L2]})
    programs.update(prog)
    del f32, int8
    torch.cuda.empty_cache()
    (counts["ivf_1m"], rows["rescore_groups_f32"],
     counts["sharded_ivf"], prog) = phase_ivf_1m(torch, ft)
    programs.update(prog)
    rows["budget_select"], budget_sort_ms = _budget_select_row(torch)
    print(f"programs: {json.dumps(programs)}", flush=True)

    k11_note = ("reached through fused_search(rescore_select=True): "
                "launches counted in the surface phase")
    meta = {
        "sweep_groupmax_1": ("sweep_split_mma.cu", f"{PF}:190", None),
        "sweep_groupmax_2": ("sweep_split_mma.cu", f"{PF}:174", None),
        "sweep_split_3": ("sweep_split_mma.cu", f"{PF}:239", None),
        "sweep_split_2": ("sweep_split_mma.cu", f"{PF}:204",
                          "no index route reaches _kernel_split2: launches "
                          "counted in the kernel phase"),
        "sweep_int8": ("sweep_split_mma.cu", f"{PF}:219", None),
        "sweep_f16_2": ("sweep_split_mma.cu", f"{PF}:259", None),
        "sweep_f16_1": ("sweep_split_mma.cu", f"{PF}:281", None),
        "select_groups": ("select_groups.cu", f"{PF}:739", None),
        "rescore_groups": ("rescore_groups.cu", f"{PF}:1050", None),
        "rescore_groups_pair": ("rescore_groups.cu", f"{PF}:1074", None),
        "rescore_groups_int8": ("rescore_groups.cu", f"{PF}:1045", None),
        "rescore_groups_f16": ("rescore_groups.cu", f"{PF}:1035", None),
        "rescore_groups_f32": ("rescore_groups.cu", f"{PF}:1040",
                               "the IVF fine scan: launches counted in the "
                               "ivf_1m phase"),
        "final_select": ("final_select.cu", f"{PF}:809", None),
        "budget_select": ("budget_select.cu", "none (faiss_tpu/ivf.py:414-420:"
                          " jnp.where + lax.top_k)",
                          "the IVF fine scan's top-k: launches counted in "
                          "the ivf_1m phase, timed at the IVF cell's shape"),
        "sweep_block_max": ("sweep_split_mma.cu", f"{PF}:155",
                            "timed on K3 at 10M (the f32_10m phase), its "
                            "main path; every sweep writes it"),
        "rescore_select": ("rescore_select.cu", f"{PF}:1195", k11_note),
        "rescore_select_int8": ("rescore_select.cu", f"{PF}:1195", k11_note),
        "rescore_select_f16": ("rescore_select.cu", f"{PF}:1195", k11_note),
    }
    table = []
    for key, (src, rep, note) in meta.items():
        n = k4_launches if key == "sweep_split_2" \
            else sum(c[key] for c in counts.values())
        err, ms, pms, (bms, by), lms = rows[key]
        entry = {"name": key, "route": "cuda",
                 "source": f"faiss_tpu_torch/csrc/{src}", "replaces": rep,
                 "launches": n, "max_abs_err": err, "ms": ms,
                 "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                 "library_ms": lms}
        if note:
            entry["note"] = note
        if key == "budget_select":   # the masked stable sort it replaces
            entry["sort_ms"] = budget_sort_ms
        if key in legacy["ms"]:   # PR 10's kernel, timed in this run
            entry["legacy_ms"] = legacy["ms"][key]
        # K9 at the f32 path's stage-3b width, (nq_pad, k + 22); K8 at its
        # stage-3a shape, (nq_pad, kg·128) with m = k + 22; K6 at the f16
        # cell's shape
        at = {"final_select": ("at_ncand_32", "final_select_32"),
              "select_groups": ("at_ncols_1792", "select_groups_1792"),
              "sweep_f16_2": ("at_d96_10m", "sweep_f16_2_d96")}
        if key in at:
            err, ms, pms, (bms, by), lms = rows[at[key][1]]
            entry[at[key][0]] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                                 "bound_by": by, "library_ms": lms}
        table.append(entry)
    check(all(e["launches"] > 0 for e in table),
          "a kernel of the table was never launched")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          f"included", flush=True)
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
