"""TorchResources and the search programs it caches, on the CPU.

The cache's concurrency contract is ``faiss_tpu``'s (tests/test_resources.py):
its four cases run here against both packages. On the CPU a program is the
eager function (the counterpart of ``interpret=True``), so a search through
the cache must equal the uncached search bit for bit; what these tests
hold is the plumbing: one entry per shape and route, every mutation and a
collected index dropping the index's entries, and the same number of
entries as ``faiss_tpu`` for one sequence of searches where both packages
take the same routes. The CUDA graphs themselves are held on the card
(tests/test_torch_cuda.py).
"""

import gc
import threading
import time

import jax
import numpy as np
import pytest
import torch

from faiss_tpu import IDSelectorRange as JIDSelectorRange
from faiss_tpu import SearchParams as JSearchParams
from faiss_tpu import TpuIndexFlat
from faiss_tpu.resources import TpuResources
from faiss_tpu_torch import (IDSelectorRange, SearchParams, ShardedIndexFlat,
                             ShardedIndexIVFFlat, TorchIndexFlat,
                             TorchIndexIVFFlat, TorchResources,
                             default_resources, index_numpy_to_torch,
                             programs)
from faiss_tpu_torch import calls
from faiss_tpu_torch.index import flat_route
from faiss_tpu_torch.ops import fused

torch.set_num_threads(2)

NV, D, NQ, K = 9000, 32, 5, 7


@pytest.fixture(params=["faiss_tpu", "faiss_tpu_torch"])
def res(request):
    if request.param == "faiss_tpu":
        return TpuResources()
    return TorchResources(["cpu"])


# -- the cache's contract: faiss_tpu's four cases, on both packages --------

def test_slow_build_does_not_block_other_keys(res):
    started = threading.Event()
    release = threading.Event()

    def slow():
        started.set()
        assert release.wait(timeout=30)
        return "slow-value"

    out = {}
    t = threading.Thread(target=lambda: out.__setitem__(
        "slow", res.cached("slow-key", slow)))
    t.start()
    assert started.wait(timeout=10)
    t0 = time.monotonic()
    assert res.cached("fast-key", lambda: "fast-value") == "fast-value"
    assert time.monotonic() - t0 < 5.0
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert out["slow"] == "slow-value"
    assert res.cached("slow-key", lambda: "WRONG") == "slow-value"


def test_same_key_builds_exactly_once_under_contention(res):
    calls = []
    barrier = threading.Barrier(8)

    def builder():
        calls.append(1)
        time.sleep(0.05)
        return "built"

    results = []

    def worker():
        barrier.wait()
        results.append(res.cached("k", builder))

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert results == ["built"] * 8
    assert len(calls) == 1
    assert res.cache_info()["entries"] >= 1


def test_raising_builder_recovers(res):
    with pytest.raises(RuntimeError):
        res.cached("bad", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    assert res.cached("bad", lambda: "ok-now") == "ok-now"


def test_waiter_retries_after_owner_failure(res):
    gate = threading.Event()

    def failing():
        gate.set()
        time.sleep(0.05)
        raise RuntimeError("owner failed")

    errs, vals = [], []

    def owner():
        try:
            res.cached("flaky", failing)
        except RuntimeError as e:
            errs.append(str(e))

    def waiter():
        assert gate.wait(timeout=10)
        vals.append(res.cached("flaky", lambda: "second-try"))

    to, tw = threading.Thread(target=owner), threading.Thread(target=waiter)
    to.start()
    tw.start()
    to.join(timeout=30)
    tw.join(timeout=30)
    assert not to.is_alive() and not tw.is_alive()
    assert errs == ["owner failed"]
    assert vals == ["second-try"]


# -- the object ---------------------------------------------------------------

def test_resources_surface():
    res = TorchResources(["cpu"])
    assert res.devices == [torch.device("cpu")]
    assert res.default_device == torch.device("cpu")
    assert res.capabilities.device_type == "cpu"
    assert res.cache_info() == {"entries": 0}
    assert res.describe().endswith("fn-cache entries    : 0")
    res.cached(("k", 1), lambda: 1)
    assert "fn-cache entries    : 1" in res.describe()
    assert res.discard(lambda key: key == ("k", 1)) == 1
    assert res.cache_info() == {"entries": 0}
    assert default_resources("cpu") is default_resources("cpu")
    with pytest.raises(ValueError):
        TorchResources([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchResources()
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchResources(["cuda:0"])


def test_index_device_must_be_a_resources_device():
    class Elsewhere(TorchResources):
        @property
        def devices(self):
            return [torch.device("cuda", 0)]

    with pytest.raises(ValueError, match="devices"):
        TorchIndexFlat(D, device="cpu", resources=Elsewhere(["cpu"]))
    with pytest.raises(ValueError, match="devices"):
        TorchIndexIVFFlat(D, 4, device="cpu", resources=Elsewhere(["cpu"]))
    res = TorchResources(["cpu"])
    xb = np.ones((10, D), np.float32)
    assert index_numpy_to_torch(xb, device="cpu", resources=res).res is res
    assert TorchIndexFlat(D, device="cpu").res is default_resources("cpu")
    idx = TorchIndexFlat(D, device="cpu", resources=res)
    assert idx.describe().endswith("fn-cache entries    : 0")


# -- searches through the cache ----------------------------------------------

@pytest.fixture
def open_gate(monkeypatch):
    """The fused path from 8192 rows, as the card tests open it."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 8192)


def _data(seed=0, nv=NV, nq=NQ):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nv, D)).astype(np.float32),
            rng.standard_normal((nq, D)).astype(np.float32))


def _packed_pair(idx, xq, k, params=None, **kw):
    """(cached, uncached) packed first-pass results of one search."""
    q, _, nq_pad = idx._prep_queries(xq)
    sel = idx._sel_stream(params)
    a = idx._run_search_fn(q, k, nq_pad, sel=sel, **kw)
    with programs.eager():
        b = idx._run_search_fn(q, k, nq_pad, sel=sel, **kw)
    assert a[1:] == b[1:]
    return a[0], b[0], a[1]


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "int8"])
def test_flat_search_through_the_cache_is_the_eager_search(
        open_gate, storage, metric):
    res = TorchResources(["cpu"])
    xb, xq = _data(1, nq=40)      # nq_pad 40: bf16 and f16 sweep one plane
    idx = TorchIndexFlat(D, metric=metric, storage=storage, device="cpu",
                         resources=res)
    idx.add(xb)
    sel = SearchParams(sel=IDSelectorRange(100, 6000))
    for params in (None, sel):
        for _ in range(2):          # a miss, then the cached program
            a, b, use_fused = _packed_pair(idx, xq, K, params,
                                           force_plain=False)
            assert use_fused
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # the fallback tiers' programs: the two-plane sweep, the plain path
    for kw in (dict(force_plain=False, full_sweep=True),
               dict(force_plain=True)):
        a, b, _ = _packed_pair(idx, xq, K, sel, **kw)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # the two-plane rerun is a program of its own where the search swept
    # one plane (bf16, f16); f32 and int8 always sweep two
    one_plane = storage in ("bf16", "f16")
    assert res.cache_info()["entries"] == (4 if one_plane else 3)
    # the user entry point
    D1, I1 = idx.search(xq, K, params=sel)
    idx.set_force_plain(True)
    D2, I2 = idx.search(xq, K, params=sel)
    np.testing.assert_array_equal(I1, I2)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_ivf_search_through_the_cache_is_the_eager_search(storage):
    res = TorchResources(["cpu"])
    xb, xq = _data(2, nv=4000)
    ivf = TorchIndexIVFFlat(D, 16, storage=storage, device="cpu",
                            resources=res)
    ivf.train(xb)
    ivf.add(xb)
    n0 = res.cache_info()["entries"]
    sel = SearchParams(sel=IDSelectorRange(0, 3000))
    for nprobe in (3, 16):          # the fine scan, the dense route
        for params in (None, sel):
            p = (SearchParams(nprobe=nprobe) if params is None
                 else SearchParams(sel=params.sel, nprobe=nprobe))
            for force in (False, True):
                for _ in range(2):
                    a = ivf._search_packed(xq, K, p, force_plain_dense=force)
                    with programs.eager():
                        b = ivf._search_packed(xq, K, p,
                                               force_plain_dense=force)
                    assert torch.equal(a[0].view(torch.int32),
                                       b[0].view(torch.int32))
    # below nlist the forced dense flag changes nothing: one program each;
    # at nlist f32 takes the plain sweep either way, bf16 / int8 two routes
    n_dense = 2 if storage == "f32" else 4
    assert res.cache_info()["entries"] - n0 == 2 + n_dense


def test_repeated_shape_adds_no_entry():
    res = TorchResources(["cpu"])
    xb, xq = _data(3)
    idx = TorchIndexFlat(D, device="cpu", resources=res)
    idx.add(xb)
    idx.search(xq, K)
    assert res.cache_info()["entries"] == 1
    for _ in range(3):
        idx.search(xq[::-1].copy(), K)       # same nq_pad, same k
    idx.search(xq[:3], K)                    # nq 3 pads to 8 as well
    assert res.cache_info()["entries"] == 1
    idx.search(xq, K + 1)
    idx.search(np.tile(xq, (3, 1)), K)       # nq_pad 16
    assert res.cache_info()["entries"] == 3


def _fresh_flat(res, rows, storage="f32"):
    idx = TorchIndexFlat(D, storage=storage, device="cpu", resources=res)
    if storage == "int8":
        idx.train(rows)
    if len(rows):
        idx.add(rows)
    return idx


FLAT_MUTATIONS = ["add", "remove_ids", "merge_from", "reset", "train",
                  "set_force_plain", "store"]


@pytest.mark.parametrize("mutation", FLAT_MUTATIONS)
def test_flat_mutation_drops_the_programs(open_gate, mutation):
    res = TorchResources(["cpu"])
    xb, xq = _data(4)
    extra = _data(5, nv=500)[0]
    idx = _fresh_flat(res, xb)
    other = _fresh_flat(res, extra)
    other.search(xq, K)
    idx.search(xq, K)
    idx.search(xq, K, params=SearchParams(sel=IDSelectorRange(0, 50)))
    assert res.cache_info()["entries"] == 3
    rows = xb
    force_plain = False
    if mutation == "add":
        idx.add(extra)
        rows = np.concatenate([xb, extra])
    elif mutation == "remove_ids":
        idx.remove_ids(np.arange(0, NV, 3))
        rows = np.delete(xb, np.arange(0, NV, 3), axis=0)
    elif mutation == "merge_from":
        idx.merge_from(other)
        rows = np.concatenate([xb, extra])
    elif mutation == "reset":
        idx.reset()
        idx.add(extra)
        rows = extra
    elif mutation == "train":
        idx.train(xb)            # a no-op for f32 rows, a new generation
    elif mutation == "set_force_plain":
        idx.set_force_plain(True)
        force_plain = True
    else:                        # the store changed under the index
        idx.store.add(extra)
        rows = np.concatenate([xb, extra])
    # merge_from also resets (and so empties) the other index's entries; a
    # change made on the store alone is seen at the next search
    left = {"merge_from": 0, "store": 3}.get(mutation, 1)
    assert res.cache_info()["entries"] == left
    D1, I1 = idx.search(xq, K)
    assert res.cache_info()["entries"] == (1 if mutation == "merge_from"
                                           else 2)
    fresh = _fresh_flat(TorchResources(["cpu"]), rows)
    fresh.set_force_plain(force_plain)
    D2, I2 = fresh.search(xq, K)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)


def test_int8_train_drops_the_programs():
    res = TorchResources(["cpu"])
    xb, xq = _data(6)
    idx = TorchIndexFlat(D, storage="int8", device="cpu", resources=res)
    idx.store.set_scales(np.full(D, 0.05, np.float32))   # a stale grid
    idx.add(xb)
    idx.search(xq, K)
    assert res.cache_info()["entries"] == 1
    idx.store.reset()
    idx.store.scales = None
    idx.train(xb)                 # the grid of the data
    assert res.cache_info()["entries"] == 0
    idx.add(xb)
    D1, I1 = idx.search(xq, K)
    D2, I2 = _fresh_flat(TorchResources(["cpu"]), xb, "int8").search(xq, K)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_array_equal(D1, D2)


IVF_MUTATIONS = ["add", "remove_ids", "merge_from", "reset"]


@pytest.mark.parametrize("mutation", IVF_MUTATIONS)
def test_ivf_mutation_drops_the_programs(mutation):
    res = TorchResources(["cpu"])
    xb, xq = _data(7, nv=3000)
    extra = _data(8, nv=400)[0]

    def build(r, rows):
        ivf = TorchIndexIVFFlat(D, 8, nprobe=2, device="cpu", resources=r)
        ivf.train(xb)
        if len(rows):
            ivf.add(rows)
        return ivf

    ivf, other = build(res, xb), build(res, extra)
    ivf.search(xq, K)
    ivf.search(xq, K, params=SearchParams(nprobe=8))
    n_other = res.cache_info()["entries"] - 2
    rows = xb
    if mutation == "add":
        ivf.add(extra)
        rows = np.concatenate([xb, extra])
    elif mutation == "remove_ids":
        ivf.remove_ids(np.arange(0, 3000, 4))
        rows = np.delete(xb, np.arange(0, 3000, 4), axis=0)
    elif mutation == "merge_from":
        ivf.merge_from(other)
        rows = np.concatenate([xb, extra])
    else:
        ivf.reset()
        ivf.add(extra)
        rows = extra
    # the searches' entries went; the coarse assign's (keyed by the
    # centroids) stay, and an add of another padded size builds one more
    assert res.cache_info()["entries"] == n_other + (
        mutation in ("add", "reset"))
    for nprobe in (2, 8):
        p = SearchParams(nprobe=nprobe)
        D1, I1 = ivf.search(xq, K, params=p)
        D2, I2 = build(TorchResources(["cpu"]), rows).search(xq, K, params=p)
        np.testing.assert_array_equal(I1, I2)
        np.testing.assert_array_equal(D1, D2)


def test_ivf_train_drops_the_programs():
    """train on an untrained index installs centroids (and int8 scales):
    a new generation, as every _set_centroids / _set_scales is."""
    res = TorchResources(["cpu"])
    xb, xq = _data(9, nv=2000)
    ivf = TorchIndexIVFFlat(D, 8, nprobe=8, device="cpu", resources=res)
    ivf.train(xb)
    ivf.add(xb)
    ivf.search(xq, K)
    gen = ivf._gen
    ivf._set_centroids(ivf._centroids)
    assert ivf._gen > gen
    assert res.cache_info()["entries"] == 0


def test_a_collected_index_leaves_no_entry(open_gate):
    res = TorchResources(["cpu"])
    xb, xq = _data(10)
    idx = _fresh_flat(res, xb, "bf16")
    idx.search(xq, K)
    ivf = TorchIndexIVFFlat(D, 8, device="cpu", resources=res)
    ivf.train(xb[:2000])
    ivf.add(xb[:2000])
    ivf.search(xq, K)
    # a token in flight holds its index (its fallback may search again);
    # once waited on, only its result
    tok = idx.search_async(xq, K)
    assert res.cache_info()["entries"] == 3     # the IVF add's assign too
    D1, I1 = tok.wait()
    del idx, ivf
    gc.collect()
    assert res.cache_info()["entries"] == 0
    np.testing.assert_array_equal(tok.wait()[1], I1)


def test_entries_match_faiss_tpu():
    """One sequence of searches, no mutation, on the plain route in both
    packages (asserted first): the same number of programs."""
    rng = np.random.default_rng(11)
    d = 128
    xb = rng.standard_normal((3000, d)).astype(np.float32)
    xq = rng.standard_normal((40, d)).astype(np.float32)
    jres, tres = TpuResources(jax.devices("cpu")), TorchResources(["cpu"])
    jidx = TpuIndexFlat(d, resources=jres)
    tidx = TorchIndexFlat(d, device="cpu", resources=tres)
    jidx.add(xb)
    tidx.add(xb)
    steps = [(5, 10, False), (5, 10, False), (13, 10, False),
             (3, 10, False), (5, 4, False), (5, 10, True), (40, 10, True),
             (13, 4, False)]
    for nq, k, filtered in steps:
        tparams = jparams = None
        if filtered:
            tparams = SearchParams(sel=IDSelectorRange(10, 2500))
            jparams = JSearchParams(sel=JIDSelectorRange(10, 2500))
        x = xq[:nq]
        tq, _, nq_pad = tidx._prep_queries(x)
        jq, _, jnq_pad = jidx._prep_queries(x)
        assert nq_pad == jnq_pad
        t_fused = tidx._run_search_fn(tq, k, nq_pad, force_plain=False,
                                      sel=tidx._sel_stream(tparams))[1]
        j_fused = jidx._run_search_fn(jq, k, nq_pad, force_plain=False,
                                      sel=jidx._sel_stream(jparams))[3]
        assert t_fused is False and j_fused is False
        Dt, It = tidx.search(x, k, params=tparams)
        Dj, Ij = jidx.search(x, k, params=jparams)
        np.testing.assert_array_equal(It, Ij)
        assert tres.cache_info() == jres.cache_info()
    assert tres.cache_info()["entries"] == 6


def test_threads_share_one_index_through_the_cache():
    """More threads than cores search one index at three shapes, with a
    short switch interval: each result equals the single-threaded one and
    each shape built one program."""
    import sys

    res = TorchResources(["cpu"])
    xb, xq = _data(12, nv=3000, nq=24)
    idx = _fresh_flat(res, xb, "bf16")
    shapes = (5, 13, 24)
    want = {n: idx.search(xq[:n], K) for n in shapes}
    idx.reset()
    idx.add(xb)                       # the same rows, no programs
    errors = []

    def worker(i):
        try:
            for j in range(6):
                n = shapes[(i + j) % len(shapes)]
                D, I = idx.search(xq[:n], K)
                np.testing.assert_array_equal(I, want[n][1])
                np.testing.assert_array_equal(D, want[n][0])
        except Exception as e:        # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors[0]
    assert res.cache_info()["entries"] == len(shapes)


# -- the call layer: the programs' keys, the split, the empty answer ---------

KIND_OF = {"flat": "flat_search", "ivf": "ivf_search",
           "sharded": "sharded_search", "sharded_ivf": "sharded_ivf"}


def _index(kind, res, xb, metric="L2", add=True):
    """An index of ``kind`` on the CPU (two shards on one device where
    sharded, IVF at 8 lists, nprobe 2), trained on ``xb`` where IVF, and
    filled with it where ``add``."""
    if kind == "flat":
        idx = TorchIndexFlat(D, metric=metric, device="cpu", resources=res)
    elif kind == "ivf":
        idx = TorchIndexIVFFlat(D, 8, metric=metric, nprobe=2, device="cpu",
                                resources=res)
    elif kind == "sharded":
        idx = ShardedIndexFlat(D, metric=metric, devices=["cpu"] * 2,
                               resources=res)
    else:
        idx = ShardedIndexIVFFlat(D, 8, metric=metric, nprobe=2,
                                  devices=["cpu"] * 2, resources=res)
    if kind in ("ivf", "sharded_ivf"):
        idx.train(xb)
    if add:
        idx.add(xb)
    return idx


def _static(kind, idx):
    """The static numbers of a search of 8 query rows at k = K."""
    if kind == "flat":
        return (K, *flat_route([idx.store], idx.metric, K, 8, plain=False))
    if kind == "sharded":
        return (K, *flat_route([s.store for s in idx.shards], idx.metric, K,
                               8, plain=False, direct=False))
    if kind == "ivf":
        return (K, 2, idx._budget(2), False)
    return (K, 2, tuple(s._budget(2) for s in idx.shards), False)


@pytest.mark.parametrize("kind", list(KIND_OF))
def test_a_program_key_is_what_its_function_is_built_from(kind):
    """A search's program is keyed (kind, owner, generation, the static
    numbers its function reads, the inputs' shapes and dtypes), plus the
    device for a sharded index; a second call of the same shape and route
    replays it (a hit, no entry); under ``programs.eager()`` a call makes
    no entry and no lookup, and answers the same."""
    res = TorchResources(["cpu"])
    xb, xq = _data(4, nv=3000)
    idx = _index(kind, res, xb)
    want = idx.search(xq, K)

    def owned():
        return [key for key in res._cache if key[1] == idx._owner]

    (key,) = owned()
    q_in = ((8, D), torch.float32)
    tail = (torch.device("cpu"),) if kind.startswith("sharded") else ()
    assert key == (KIND_OF[kind], idx._owner, idx._gen, _static(kind, idx),
                   (q_in,)) + tail
    stats = res.program_stats()
    got = idx.search(xq, K)
    assert res.program_stats() == {"hits": stats["hits"] + 1,
                                   "misses": stats["misses"]}
    assert owned() == [key]
    with programs.eager():
        eager = idx.search(xq, K)
    assert res.program_stats()["hits"] == stats["hits"] + 1
    assert owned() == [key]
    for a, b, c in zip(want, got, eager):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # a selector: its stream(s) another input, of their own dtype
    idx.search(xq, K, params=SearchParams(sel=IDSelectorRange(0, 2000)))
    (fkey,) = [k for k in owned() if k != key]
    assert fkey[:4] == key[:4] and fkey[5:] == tail
    assert fkey[4][0] == q_in and len(fkey[4]) > 1
    assert all(dt == torch.bool for _, dt in fkey[4][1:])


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("kind", list(KIND_OF))
def test_a_split_batch_and_an_empty_index_answer_as_one_call(kind, metric):
    """A batch past the index's cap (``_split_rows``, here 8 rows) is
    enqueued in row chunks, all up front, under one ConcatSearchToken whose
    answer equals the unsplit search's, row for row. An empty index
    answers sentinels: the metric's worst distance and label −1, f32 and
    int64, (nq, k)."""
    res = TorchResources(["cpu"])
    xb, xq = _data(5, nv=3000, nq=21)
    idx = _index(kind, res, xb, metric)
    want = idx.search(xq, K)
    idx._split_rows = lambda params: 8
    tok = idx.search_async(xq, K)
    assert isinstance(tok, calls.ConcatSearchToken)
    assert len(tok._toks) == 3
    got = tok.wait()
    assert tok.is_ready()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    empty = _index(kind, res, xb, metric, add=False)
    for nq in (1, 21):
        De, Ie = empty.search(xq[:nq], K)
        assert De.dtype == np.float32 and Ie.dtype == np.int64
        assert De.shape == Ie.shape == (nq, K)
        assert (Ie == -1).all()
        assert (De == (np.inf if metric == "L2" else -np.inf)).all()
