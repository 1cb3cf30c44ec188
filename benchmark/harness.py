"""One run of one cell of the benchmark of ``faiss_tpu_torch``.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``configs/<config>.json`` (the sizes, the index, the
data generator's parameters, the sweep's route and the limits of the
comparison), ``indexes/<index.type>.py`` (the index built on the cell's
devices), ``generators/<data.generator>.py`` (the rows and queries, see
``datagen``), ``traffic/<mix>.json`` (queries a call, k, calls in flight,
the selector) and ``metrics/<metric>.py`` (a reader ``read(run)``; a name
with a dot, ``enqueue_ms.batch``, falls back to ``metrics/enqueue_ms.py``).
An unknown name raises.

A run: the rows are made on the device in chunks from the seed and handed
to the index's ``add`` as numpy, the query pool and the selector sets are
drawn, the traffic's shapes are warmed (a closed loop of a few calls: the
kernels built, every program captured, the host's pinned buffers
allocated), then one caller keeps ``depth`` calls in flight for
``seconds``: ``search_async`` of the next ``nq`` pool queries, then
``wait()`` of the oldest. The window closes at the first call that
returns after ``seconds``; the calls still in flight are waited for and
judged, not counted. With ``trace`` the last ``TRACE_S`` seconds of the
window run under ``torch.profiler``. Then the program is freed and every
answer is judged against the plain reference (``reference.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from benchmark import datagen, devtrace, reference

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CHIPS = (1, 4)          # the cards a cell may ask for
FORBIDDEN = ("jax", "jaxlib", "flax", "faiss_tpu")
# the traced part of a --trace 1 window: its last seconds (a whole window
# under the profiler holds millions of events at a call every 0.5 ms)
TRACE_S = 2.0
SPAN_ENQUEUE = devtrace.SPAN_PREFIX + "enqueue"
SPAN_WAIT = devtrace.SPAN_PREFIX + "wait"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, bench: Optional[dict] = None) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic
    and the metrics it reports: {cell, config, traffic, end_to_end,
    per_layer}."""
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = read_json(ROOT / cfg_entry["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) and m["moves"] in e2e_names]
    return dict(cell=cell, config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer)


def _load(folder: str, stem: str):
    path = BENCH_DIR / folder / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(run)`` of a metric, from metrics/<name>.py, or from the
    file of the part of the name before its first dot."""
    for stem in (metric, metric.split(".")[0]):
        if (BENCH_DIR / "metrics" / f"{stem}.py").exists():
            return _load("metrics", stem).read
    raise SystemExit(f"no reader for metric {metric!r} in "
                     f"{BENCH_DIR / 'metrics'}")


def index_type(config: dict):
    """The module indexes/<index.type>.py of a configuration: ``build``,
    ``search_params``, ``fallbacks`` and, where the index's answers are
    not the exact top-k, its own ``judge`` (``judge``'s signature)."""
    name = config["index"]["type"]
    if not (BENCH_DIR / "indexes" / f"{name}.py").exists():
        raise SystemExit(f"no index type {name!r} in {BENCH_DIR / 'indexes'}")
    return _load("indexes", name)


def devices_of(chips: int, device) -> list:
    """The devices of a cell of ``chips`` cards: cuda:0 … on the card, the
    one ``device`` otherwise (the tests' CPU)."""
    if chips not in CHIPS:
        raise SystemExit(f"a cell takes {CHIPS} chips, not {chips!r}")
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    torch.cuda.init()   # the allocator's per-device state, for its stats
    return [torch.device("cuda", i) for i in range(chips)]


def forbidden_modules():
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    faiss_tpu (whole names: faiss_tpu_torch is not faiss_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """What the readers read. Arrays are over the window's calls."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    nq: np.ndarray            # queries of each call
    t_enqueue: np.ndarray     # seconds in search_async
    latency: np.ndarray       # seconds from search_async to wait's return
    traced: np.ndarray        # the call was enqueued under the profiler
    fallbacks: int            # the index's fallbacks added in the window
    trace: Optional[devtrace.Trace]


def call_queries(i: int, nq: int, pool_size: int) -> np.ndarray:
    """The pool indices of call i's queries: the next ``nq`` of the pool,
    cyclically."""
    start = (i * nq) % pool_size
    return np.arange(start, start + nq)


class Caller:
    """One closed-loop caller: ``depth`` calls in flight, the next
    ``nq`` pool queries each (cyclically), call i under selector set
    i mod sets."""

    def __init__(self, index, pool: np.ndarray, traffic: dict, params):
        self.index, self.pool = index, pool
        self.nq, self.k = traffic["nq"], traffic["k"]
        self.depth = traffic["depth"]
        if len(pool) % self.nq:
            raise SystemExit(f"the query pool ({len(pool)}) is not a "
                             f"multiple of the queries a call ({self.nq})")
        self.params = params
        self.failed = 0           # calls that raised (tracebacks printed)
        self.prof = None          # the profiler of the traced part
        self.tracing = False      # it is recording

    def _enqueue(self, i: int):
        p = self.params[i % len(self.params)] if self.params else None
        q0 = (i * self.nq) % len(self.pool)
        x = self.pool[q0:q0 + self.nq]
        traced = self.tracing
        t0 = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function(SPAN_ENQUEUE):
                    tok = self.index.search_async(x, self.k, params=p)
            else:
                tok = self.index.search_async(x, self.k, params=p)
        except Exception:
            self._failure()
            tok = None
        return [i, t0, time.perf_counter(), tok, traced]

    def _wait(self, tok):
        if tok is None:
            return None
        try:
            if self.tracing:
                with torch.profiler.record_function(SPAN_WAIT):
                    return tok.wait()
            return tok.wait()
        except Exception:
            self._failure()
            return None

    def _failure(self):
        self.failed += 1
        if self.failed <= 3:
            traceback.print_exc(file=sys.stderr)

    def drive(self, *, calls: Optional[int] = None,
              seconds: Optional[float] = None, trace_s: float = 0.0):
        """Run the loop until ``calls`` calls were made, or until the first
        call that returns ``seconds`` after the start; the calls in flight
        are then waited for. Returns (records [i, t_enqueue_start,
        t_enqueue_end, t_done, traced, in_window, D, I], window seconds,
        the stopped profiler or None)."""
        recs, pending = [], deque()
        i = 0
        t_start = time.perf_counter()
        t_trace = t_start + seconds - trace_s if trace_s else math.inf
        t_close = None
        while len(pending) < self.depth and (calls is None or i < calls):
            pending.append(self._enqueue(i))
            i += 1
        while pending:
            ci, t0, t1, tok, traced = pending.popleft()
            res = self._wait(tok)
            t2 = time.perf_counter()
            open_ = t_close is None
            recs.append([ci, t0, t1, t2, traced, open_, res])
            if not open_:
                continue
            if seconds is not None and t2 - t_start >= seconds:
                t_close = t2
                if self.tracing:
                    self.prof.stop()
                    self.tracing = False
                continue
            if self.prof is None and t2 >= t_trace:
                self.prof = _profiler()
                self.prof.start()
                self.tracing = True
            if calls is None or i < calls:
                pending.append(self._enqueue(i))
                i += 1
            elif not pending:
                t_close = t2
        prof, self.prof = self.prof, None
        return recs, (t_close or time.perf_counter()) - t_start, prof


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_index(config: dict, src: datagen.Source, devices: list):
    """The index of the configuration's type on ``devices``, the rows
    made chunk by chunk on the first device and each handed to ``add`` as
    numpy."""
    index = index_type(config).build(config, devices)
    for _, rows in src.chunks():
        x = rows.cpu().numpy()
        del rows        # the chunk leaves the card before the add
        index.add(x)
    for d in devices:
        _sync(d)
    return index


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: Optional[float] = None,
             spec: Optional[dict] = None) -> dict:
    """One run of the cell ``name``; returns the result line's object
    (the caller checks the loaded modules before it prints it).
    ``spec`` (tests): the cell_spec to run in place of BENCHMARK.json's."""
    t_process = time.perf_counter() if t_process is None else t_process
    spec = spec if spec is not None else cell_spec(name)
    config, traffic = spec["config"], spec["traffic"]
    data = config["data"]
    devices = devices_of(spec["cell"]["chips"], device)
    dev0 = devices[0]
    ixt = index_type(config)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)

    src = datagen.Source(data, seed, dev0)
    index = build_index(config, src, devices)
    pool_t = src.queries()
    pool = pool_t.cpu().numpy()
    sets, params = [], []
    if traffic.get("selector"):
        if traffic["selector"]["kind"] != "batch":
            raise SystemExit(f"unknown selector kind {traffic['selector']}")
        sets = datagen.selector_sets(data["rows"], traffic["selector"], seed,
                                     dev0)
        params = ixt.search_params(sets)
    caller = Caller(index, pool, traffic, params)
    caller.drive(calls=2 * caller.depth + 2)
    if trace:   # the profiler's own first start (CUPTI) before the window
        prof = _profiler()
        prof.start()
        caller.tracing = True
        caller.drive(calls=2)
        prof.stop()
        caller.tracing = False
    for d in devices:
        _sync(d)
    # the set-up's objects leave the collector's generations, so that its
    # passes in the window scan only what the window allocates
    gc.collect()
    gc.freeze()
    fb0 = ixt.fallbacks(index)
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    recs, window_s, prof = caller.drive(
        seconds=seconds, trace_s=min(TRACE_S, seconds / 2) if trace else 0.0)
    fallbacks = ixt.fallbacks(index) - fb0
    gc.unfreeze()
    peak = max(torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0
               for d in devices)
    tr = devtrace.from_profiler(prof) if prof is not None else None

    win = [r for r in recs if r[5]]
    _print_seconds(win, traffic["nq"])
    run = Run(
        cell=spec["cell"], config=config, traffic=traffic,
        setup_s=setup_s, window_s=window_s,
        nq=np.full(len(win), traffic["nq"]),
        t_enqueue=np.array([r[2] - r[1] for r in win]),
        latency=np.array([r[3] - r[1] for r in win]),
        traced=np.array([r[4] for r in win], bool),
        fallbacks=fallbacks, trace=tr)

    # the program's state goes before the reference runs
    del index, caller, prof
    gc.collect()
    if dev0.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks, correct = judge_run(recs, pool_t, src, sets, config, traffic,
                                getattr(ixt, "judge", judge))
    print(f"set-up {setup_s:.3f} s, window {window_s:.3f} s, "
          f"reference {time.perf_counter() - t_judge:.3f} s", file=sys.stderr)

    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        v = reader(m["name"])(run)
        if v is None:
            print(f"{m['name']}: nothing to read", file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if dev0.type == "cuda" else dev0.type,
           "kind": (torch.cuda.get_device_name(dev0)
                    if dev0.type == "cuda" else dev0.type),
           "count": len(devices), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(recs),
           "failed": caller_failed(recs), "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = devtrace.busy_s(tr)
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": devtrace.top_ops(tr),
                            "idle_gaps": devtrace.longest_gaps(tr)}
    out["checks"] = checks
    return out


def _print_seconds(win, nq: int) -> None:
    """Queries answered, and the median latency in ms, in each whole
    second of the window (standard error): how steady the window was."""
    if not win:
        return
    t0 = win[0][1]
    sec = np.array([int(r[3] - t0) for r in win])
    lat = np.array([r[3] - r[1] for r in win]) * 1e3
    full = range(int(sec.max()))
    print("by second: queries " + " ".join(
        str(int((sec == s).sum()) * nq) for s in full), file=sys.stderr)
    print("by second: p50 ms " + " ".join(
        f"{np.median(lat[sec == s]):.4g}" for s in full
        if (sec == s).any()), file=sys.stderr)


def caller_failed(recs) -> int:
    """Calls that raised or returned nothing."""
    return sum(1 for r in recs if r[6] is None)


def judge(pool_idx, set_idx, dists, ids, pool_t, src: datagen.Source,
          sets, config: dict, traffic: dict) -> dict:
    """The comparison's numbers (``reference.judge``) for answer rows:
    each row's query (index into the pool), selector set (-1: none), and
    returned distances and ids."""
    data = config["data"]
    ans = reference.Answers.unique(pool_idx, set_idx, dists, ids)
    admits = reference.admit_masks(sets, data["rows"], pool_t.device)
    return reference.judge(ans, pool_t, src.chunks, traffic["k"],
                           config["index"]["metric"].upper() == "L2",
                           data["rows"], admits)


def verdict(nums: dict, failed_calls: int, limits: dict):
    """(checks {name: {value, limit}}, correct) of the comparison's
    numbers: correct when some answer was judged and each number is
    within its limit."""
    checks = {
        "failed_calls": {"value": failed_calls, "limit": 0},
        "bad_ids": {"value": nums["bad_ids"], "limit": 0},
        "dist_err": {"value": nums["dist_err"], "limit": limits["dist_err"]},
        "rank_gap": {"value": nums["rank_gap"], "limit": limits["rank_gap"]},
    }
    correct = nums["answers"] > 0 and all(c["value"] <= c["limit"]
                                          for c in checks.values())
    return checks, bool(correct)


def judge_run(recs, pool_t, src, sets, config, traffic, judge_fn):
    """(checks, correct): every answer of the run (the window's and those
    drained after it) judged by ``judge_fn``: the index type's own
    ``judge`` where its module has one (an index whose answers are not the
    exact top-k), else ``judge``, the exact top-k."""
    nq = traffic["nq"]
    got = [r for r in recs if r[6] is not None]
    if got:
        nums = judge_fn(
            np.concatenate([call_queries(r[0], nq, len(pool_t))
                            for r in got]),
            np.concatenate([np.full(nq, r[0] % len(sets) if sets else -1)
                            for r in got]),
            np.concatenate([r[6][0] for r in got]),
            np.concatenate([r[6][1] for r in got]),
            pool_t, src, sets, config, traffic)
    else:
        nums = dict(bad_ids=0, dist_err=0.0, rank_gap=0.0, answers=0)
    print(f"judged {nums['answers']} answers of {len(recs)} calls",
          file=sys.stderr)
    return verdict(nums, caller_failed(recs), config["limits"])
