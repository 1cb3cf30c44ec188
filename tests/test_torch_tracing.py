"""The port's spans (``faiss_tpu_torch.tracing``) and the program cache's
counters, on the CPU.

Under ``torch.profiler`` every search records its spans at the layer
boundaries (the enqueue, the queries' upload, the selector's stream, the
program's capture or replay, the token's wait and its parts) with their
parents and the call id that the enqueue minted, and the same names appear
among the profiler's events. Without a profiler nothing is recorded. The
device's half of the trace (``token.sync`` on a real CUDA event, the
kernels on the spans' clock) is the card's.
"""

import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from faiss_tpu_torch import (IDSelectorRange, SearchParams, ShardedIndexFlat,
                             ShardedIndexIVFFlat, TorchIndexFlat,
                             TorchIndexIVFFlat, TorchResources, tracing)

torch.set_num_threads(2)

NV, D, NQ, K = 3000, 16, 3, 5
XB = np.random.default_rng(0).standard_normal((NV, D), dtype=np.float32)
XQ = np.random.default_rng(1).standard_normal((NQ, D), dtype=np.float32)
SEL = SearchParams(sel=IDSelectorRange(0, NV // 2))


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def make_index(kind):
    """A filled index of ``kind`` on the CPU, searched once (its program
    captured), on resources of its own."""
    res = TorchResources(["cpu"])
    if kind == "flat":
        idx = TorchIndexFlat(D, device="cpu", resources=res)
    elif kind == "ivf":
        idx = TorchIndexIVFFlat(D, 8, nprobe=2, device="cpu", resources=res)
    elif kind == "sharded":
        idx = ShardedIndexFlat(D, devices=["cpu"] * 2, resources=res)
    else:
        idx = ShardedIndexIVFFlat(D, 8, nprobe=2, devices=["cpu"] * 2,
                                  resources=res)
    if kind in ("ivf", "sharded_ivf"):
        idx.train(XB)
    idx.add(XB)
    idx.search(XQ, K)
    idx.search(XQ, K, params=SEL)
    return idx


def by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


KINDS = ["flat", "ivf", "sharded", "sharded_ivf"]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_a_profiled_search_records_its_spans(kind, filtered):
    idx = make_index(kind)
    params = SEL if filtered else None
    want = idx.search(XQ, K, params=params)
    with _profiled() as prof:
        tok = idx.search_async(XQ, K, params=params)
        got = tok.wait()
    np.testing.assert_array_equal(got[1], want[1])
    recs = tracing.spans()
    names = by_name(recs)
    assert set(names) <= set(tracing.SPANS)
    (enq,) = names["index.search_async"]
    (wait,) = names["token.wait"]
    assert enq.parent is None and wait.parent is None
    # the enqueue and the wait of one call share its id
    assert enq.call is not None and wait.call == enq.call == tok._call
    expect = {"index.prep_queries": "index.search_async",
              "programs.replay": "index.search_async",
              "token.copy": "token.wait",
              "token.unpack": "token.wait"}
    if filtered:
        expect["index.sel_stream"] = "index.search_async"
    for name, parent in expect.items():
        assert names[name], name
        for r in names[name]:
            assert (r.parent, r.call) == (parent, enq.call), r
            assert r.t0_ns <= r.t1_ns
    assert "programs.capture" not in names        # the shape was captured
    assert "token.sync" not in names              # no CUDA event here
    assert enq.t0_ns <= names["index.prep_queries"][0].t0_ns
    assert names["token.unpack"][0].t1_ns <= wait.t1_ns
    # the same ranges in the profiler's own trace
    events = {e.name for e in prof.events()}
    assert set(names) <= events


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_each_call_uploads_its_queries_once(kind, filtered):
    """Every call of every index records exactly one ``index.prep_queries``
    span, under its own call id (the sharded IVF's upload included)."""
    idx = make_index(kind)
    params = SEL if filtered else None
    with _profiled():
        toks = [idx.search_async(XQ, K, params=params) for _ in range(3)]
        for t in toks:
            t.wait()
    names = by_name(tracing.spans())
    ids = sorted(r.call for r in names["index.search_async"])
    assert ids == sorted(t._call for t in toks) and len(set(ids)) == 3
    assert sorted(r.call for r in names["index.prep_queries"]) == ids


def test_no_profiler_records_nothing():
    idx = make_index("flat")
    with _profiled():
        idx.search(XQ, K)
    before = tracing.spans()
    assert before
    tok = idx.search_async(XQ, K)
    assert tok._call is None and tracing.current_call() is None
    tok.wait()
    assert tracing.spans() == before
    assert tracing.span("index.search_async") is tracing.span("token.copy")


class _Event:
    """A stand-in for the token's CUDA event: counts its syncs."""

    def __init__(self):
        self.syncs = 0

    def synchronize(self):
        self.syncs += 1


@pytest.mark.parametrize("traced", [False, True])
def test_token_sync_runs_only_while_tracing(traced):
    idx = make_index("flat")
    want = idx.search(XQ, K)
    ev = _Event()
    if traced:
        with _profiled():
            tok = idx.search_async(XQ, K)
            tok._event = ev
            got = tok.wait()
        names = by_name(tracing.spans())
        (sync,) = names["token.sync"]
        (copy,) = names["token.copy"]
        assert (sync.parent, sync.call) == ("token.wait", tok._call)
        assert sync.t1_ns <= copy.t0_ns
    else:
        tok = idx.search_async(XQ, K)
        tok._event = ev
        got = tok.wait()
    assert ev.syncs == int(traced)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("nq", [1, NQ])
@pytest.mark.parametrize("kind", KINDS)
def test_token_returns_arrays_of_their_own(kind, nq):
    """wait() copies the result out of the packed tensor (one query's
    distances are a contiguous row of it, which a view would alias), and a
    second wait() returns the same arrays."""
    idx = make_index(kind)
    want = idx.search(XQ[:nq], K)
    tok = idx.search_async(XQ[:nq], K)
    packed = tok._packed.numpy()
    got = tok.wait()
    for a, b in zip(got, want):
        assert not np.shares_memory(a, packed)
        np.testing.assert_array_equal(a, b)
    again = tok.wait()
    assert again[0] is got[0] and again[1] is got[1]


def test_a_second_profiled_stretch_replaces_the_first():
    idx = make_index("flat")
    with _profiled():
        first = [idx.search_async(XQ, K) for _ in range(2)]
        for t in first:
            t.wait()
    assert {r.call for r in tracing.spans()} == {t._call for t in first}
    idx.search(XQ, K)                  # skipped: no profiler
    with _profiled():
        tok = idx.search_async(XQ, K)
        tok.wait()
    assert {r.call for r in tracing.spans()} == {tok._call}
    assert tok._call not in {t._call for t in first}


def test_the_buffer_stays_within_its_bound(monkeypatch):
    assert tracing._records.maxlen == tracing.MAX_RECORDS
    monkeypatch.setattr(tracing, "_records", deque(maxlen=8))
    with _profiled():
        for i in range(20):
            with tracing.span("index.search_async", mint=True):
                with tracing.span("index.prep_queries"):
                    pass
    recs = tracing.spans()
    assert len(recs) == 8
    # the newest: the last four calls, each its two spans
    assert [r.call for r in recs[::2]] == sorted({r.call for r in recs})
    assert recs[-1].name == "index.search_async"


@pytest.mark.parametrize("kind", ["flat", "sharded"])
def test_program_stats_count_misses_then_hits(kind):
    res = TorchResources(["cpu"])
    if kind == "flat":
        idx = TorchIndexFlat(D, device="cpu", resources=res)
    else:
        idx = ShardedIndexFlat(D, devices=["cpu"] * 2, resources=res)
    idx.add(XB)
    assert res.program_stats() == {"hits": 0, "misses": 0}
    idx.search(XQ, K)
    assert res.program_stats() == {"hits": 0, "misses": 1}
    for _ in range(3):
        idx.search(XQ, K)
    assert res.program_stats() == {"hits": 3, "misses": 1}
    idx.add(XB[:100])                  # a new generation: recaptured
    idx.search(XQ, K)
    assert res.program_stats() == {"hits": 3, "misses": 2}
    assert res.cache_info() == {"entries": 1}


def test_a_capture_records_the_ivf_stages():
    res = TorchResources(["cpu"])
    idx = TorchIndexIVFFlat(D, 8, nprobe=2, device="cpu", resources=res)
    idx.train(XB)
    idx.add(XB)
    with _profiled() as prof:
        idx.search(XQ, K)              # a miss: captured
    names = by_name(tracing.spans())
    (cap,) = names["programs.capture"]
    assert cap.parent == "index.search_async"
    stages = ("ivf.coarse_gemm", "ivf.top_nprobe", "ivf.chunk_ids",
              "ivf.k10", "ivf.top_k")
    for name in stages:
        (r,) = names[name]
        assert (r.parent, r.call) == ("programs.capture", cap.call)
        assert cap.t0_ns <= r.t0_ns <= r.t1_ns <= cap.t1_ns
    assert set(stages) <= {e.name for e in prof.events()}


def test_threads_keep_their_own_parents_and_calls(monkeypatch):
    # a profiler records the thread that started it: here every thread
    # records, so that their spans interleave in the one buffer
    idx = make_index("flat")
    want = idx.search(XQ, K)[1]
    monkeypatch.setattr(tracing, "recording", lambda: True)
    calls, errors = [], []

    def worker():
        try:
            for _ in range(5):
                tok = idx.search_async(XQ, K)
                np.testing.assert_array_equal(tok.wait()[1], want)
                calls.append(tok._call)
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    names = by_name(tracing.spans())
    assert len(calls) == len(set(calls)) == 60 and None not in calls
    for name in ("index.search_async", "token.wait"):
        assert sorted(r.call for r in names[name]) == sorted(calls)
    for r in names["token.copy"] + names["token.unpack"]:
        assert r.parent == "token.wait"
    for r in names["index.prep_queries"] + names["programs.replay"]:
        assert r.parent == "index.search_async"
    assert tracing.current_call() is None


def _scan_counts_by_hand(idx, q, nprobe):
    """The fine scan's counters from the index's host state: each padded
    query row's probed lists (the program's probe), their chunks from the
    page table, the budget from the host counts."""
    from faiss_tpu_torch.ivf import _CHUNK, _chunk_budget

    probe = idx._probe(q, nprobe).numpy()
    nchunks = -(-idx.list_sizes().astype(np.int64) // _CHUNK)
    nbudget = _chunk_budget(idx.list_sizes(), nprobe)
    live, read = 0, set()
    for lists in probe:
        n = int(nchunks[lists].sum())
        live += n
        for lst in lists:
            read.update(idx._ctable_host[lst, :nchunks[lst]].tolist())
        if n < nbudget:              # dead positions read chunk 0
            read.add(0)
    return live, len(probe) * nbudget, len(read)


@pytest.mark.parametrize("nprobe", [1, 3])
def test_the_ivf_fine_scan_records_its_counters(nprobe):
    """Each profiled fine-scan call records its three counters under its
    call id, with the values the host state gives; the result is the same
    as without a profiler."""
    idx = make_index("ivf")
    params = SearchParams(nprobe=nprobe)
    want = idx.search(XQ, K, params=params)
    with _profiled():
        toks = [idx.search_async(XQ, K, params=params) for _ in range(2)]
        got = [t.wait() for t in toks]
    for g in got:
        for a, b in zip(g, want):
            np.testing.assert_array_equal(a, b)
    q = torch.zeros((8, D))
    q[:NQ] = torch.from_numpy(XQ)
    live, budget, read = _scan_counts_by_hand(idx, q, nprobe)
    assert 0 < live <= budget
    recs = tracing.counts()
    assert [c.name for c in recs] == list(tracing.COUNTERS) * 2
    for i, t in enumerate(toks):
        assert [(c.value, c.call) for c in recs[3 * i:3 * i + 3]] == [
            (live, t._call), (budget, t._call), (read, t._call)]


@pytest.mark.parametrize("kind", KINDS)
def test_other_routes_record_no_counters(kind):
    """The flat, dense IVF and sharded searches carry no counters; without
    a profiler the fine scan records none either."""
    idx = make_index(kind)
    params = SearchParams(nprobe=8) if kind == "ivf" else None
    with _profiled():
        idx.search(XQ, K, params=params)
    assert tracing.counts() == []
    if kind == "ivf":
        with _profiled():
            idx.search(XQ, K)
        before = tracing.counts()
        assert len(before) == 3
        idx.search(XQ, K)
        assert tracing.counts() == before
