"""The sharded searches, range_search and the IVF coarse assign through
TorchResources' program cache, on the CPU.

faiss_tpu runs six more sites through ``TpuResources.cached``: the sharded
flat search and range search, the sharded IVF search, the flat and IVF
range passes and the IVF coarse assign of ``add``. The port runs each
through ``programs.call`` (on the card a CUDA graph, on the CPU the eager
function), and under ``programs.eager()`` with no program. On the CPU a
cached result must equal its eager run's bit for bit, and agree with
faiss_tpu on the same seeded numpy data: ids equal up to near-ties
(``assert_ids_match``),
distances within tests/common.py's ladder. The entry counts are held
against ``TpuResources``' for the same call sequences: two radii on one
shape make one entry, and so do two add batches that pad alike. A
mutation of a sharded index, and its collection, drop its entries; every
function that takes ``resources=`` in faiss_tpu takes it here, and a
device outside the resources raises. The CUDA graphs themselves are held
on the card (tests/test_torch_cuda.py).
"""

import gc

import jax
import numpy as np
import pytest
import torch

import faiss_tpu
from faiss_tpu import ShardedIndexFlat as JShardedFlat
from faiss_tpu import TpuIndexFlat, TpuIndexIVFFlat
from faiss_tpu import selector as jsel
from faiss_tpu.resources import TpuResources
import faiss_tpu_torch as ft
from faiss_tpu_torch import (Kmeans, ShardedIndexFlat, ShardedIndexIVFFlat,
                             TorchIndexFlat, TorchIndexIVFFlat,
                             TorchResources, kmeans_clustering, load_index)
from faiss_tpu_torch import programs
from faiss_tpu_torch.calls import range_threshold
from faiss_tpu_torch.loader import build_index_from_file
from faiss_tpu_torch.ops import distance as dist_ops
from faiss_tpu_torch.ops import fused

from common import compare_results, make_data
from torch_parity import assert_ids_match

torch.set_num_threads(2)

D, K = 32, 7
XB, XQ = make_data(2000, 13, D)


def cpu_res(n=1):
    return TorchResources(["cpu"] * n)


def jax_res(n=1):
    return TpuResources(jax.devices("cpu")[:n])


def bits(t):
    return t.contiguous().view(torch.int32)


def near_tie_eps(Dj):
    """(nq,) a near-tie scale: 1e-5 of each row's largest distance."""
    return 1e-5 * np.maximum(np.abs(np.where(np.isfinite(Dj), Dj, 0)).max(1),
                             1.0)


def check_search(out_t, out_j, label, tol=1e-3):
    (Dt, It), (Dj, Ij) = out_t, out_j
    assert_ids_match(It, Ij, Dj, near_tie_eps(Dj), label)
    compare_results(Dt, It, Dj, Ij, dist_tol=tol, k=It.shape[1],
                    check_top1=False, label=label)


@pytest.fixture
def open_gate(monkeypatch):
    """The port's fused path from 1024 rows a shard (faiss_tpu keeps its
    exact plain path: its interpret-mode kernels are slow here)."""
    monkeypatch.setattr(fused, "fused_path_eligible",
                        lambda **kw: kw["nv_eff"] >= 1024)


def owned(res, owner):
    return sum(1 for key in res._cache if key[1] == owner)


# -- sharded flat --------------------------------------------------------------


def _sharded_pair(t, q, nq_pad, sel, **kw):
    a = t._run_search_fn(q, K, nq_pad, sel=sel, **kw)
    with programs.eager():
        b = t._run_search_fn(q, K, nq_pad, sel=sel, **kw)
    assert a[1:] == b[1:]
    assert torch.equal(bits(a[0]), bits(b[0]))
    return a[1], a[2]


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_sharded_flat_cached_equals_uncached_and_jax(open_gate, storage):
    tres, jres = cpu_res(2), jax_res(2)
    t = ShardedIndexFlat(D, storage=storage, resources=tres)
    j = JShardedFlat(D, storage=storage, resources=jres)
    assert t.num_shards == j.num_shards == 2
    t.add(XB)
    j.add(XB)
    sel_t = ft.SearchParams(sel=ft.IDSelectorRange(100, 1500))
    sel_j = jsel.SearchParams(sel=jsel.IDSelectorRange(100, 1500))
    for pt, pj in ((None, None), (sel_t, sel_j)):
        out = t.search(XQ, K, params=pt)
        check_search(out, j.search(XQ, K, params=pj), f"{storage} {pt}")
        if pt is not None:
            assert ((out[1] >= 100) & (out[1] < 1500)).all()
    # one program a shape and route in both packages (the port's fused
    # route, faiss_tpu's plain one)
    assert tres.cache_info() == jres.cache_info() == {"entries": 2}
    q, _, nq_pad = t._prep_queries(XQ)
    for params in (None, sel_t):
        sel = t._sel_stream(params)
        for _ in range(2):            # built above, then the cached one
            use_fused, reduced = _sharded_pair(t, q, nq_pad, sel,
                                               force_plain=False)
            assert use_fused
        # the fallback's tiers: the two-plane sweep, the plain path
        _sharded_pair(t, q, nq_pad, sel, force_plain=False, full_sweep=True)
        _sharded_pair(t, q, nq_pad, sel, force_plain=True)
    assert tres.cache_info()["entries"] == 2 * (3 if reduced else 2)


def test_sharded_flat_one_program_a_device():
    """Shards on two devices ("cpu" and "cpu:0" are two torch devices):
    one program each, the second's lists merged in the first's; replicas
    on a second device too. Results equal the one-device index's."""
    one = ShardedIndexFlat(D, devices=["cpu"] * 2, resources=cpu_res())
    two = ShardedIndexFlat(D, devices=["cpu", "cpu:0"], resources=cpu_res())
    rep = ShardedIndexFlat(D, num_replicas=2, resources=cpu_res(),
                           devices=["cpu", "cpu", "cpu:0", "cpu:0"])
    for idx in (one, two, rep):
        idx.add(XB[:1200])
        idx.add(XB[1200:])
    want = one.search(XQ, K)
    for idx, n in ((two, 2), (rep, 2)):
        q, _, nq_pad = idx._prep_queries(XQ)
        _sharded_pair(idx, q, nq_pad, None, force_plain=False)
        assert idx.res.cache_info()["entries"] == n
        got = idx.search(XQ, K)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        assert idx.res.cache_info()["entries"] == n
    assert len(rep._replicas) == 2


SHARDED_MUTATIONS = ["add", "remove_ids", "reset", "train",
                     "set_force_plain", "store"]


@pytest.mark.parametrize("mutation", SHARDED_MUTATIONS)
def test_sharded_flat_mutation_drops_the_programs(mutation):
    res = cpu_res()
    t = ShardedIndexFlat(D, devices=["cpu"] * 2, resources=res)
    t.add(XB)
    t.search(XQ, K)
    t.range_search(XQ, 40.0)          # each shard's own range program
    gen = t._gen
    assert owned(res, t._owner) == 1
    assert all(owned(res, s.index._owner) == 1 for s in t.shards)
    if mutation == "add":
        t.add(XB[:100])
    elif mutation == "remove_ids":
        t.remove_ids(np.arange(0, 2000, 3))
    elif mutation == "reset":
        t.reset()
        t.add(XB[:500])
    elif mutation == "train":
        t.train(XB)                   # a no-op for f32 rows
    elif mutation == "set_force_plain":
        t.set_force_plain(True)
    else:                             # a shard's store changed alone
        t.shards[1].store.add(XB[:10])
        t.search(XQ, K)
    assert t._gen > gen
    assert owned(res, t._owner) == (mutation == "store")
    if mutation in ("add", "remove_ids", "reset"):
        # each shard changed through its index or its store: its range
        # program goes at the shard's next range pass
        t.range_search(XQ, 40.0)
        assert all(owned(res, s.index._owner) <= 1 for s in t.shards)


def test_a_collected_sharded_index_leaves_no_entry():
    res = cpu_res()
    t = ShardedIndexFlat(D, devices=["cpu"] * 2, resources=res)
    t.add(XB)
    t.search(XQ, K)
    t.range_search(XQ, 40.0)
    ivf = ShardedIndexIVFFlat(D, 8, nprobe=2, devices=["cpu"] * 2,
                              resources=res)
    ivf.train(XB)
    ivf.add(XB)
    ivf.search(XQ, K)
    assert res.cache_info()["entries"] > 4
    del t, ivf
    gc.collect()
    assert res.cache_info()["entries"] == 0


# -- sharded IVF ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ivf_file(tmp_path_factory):
    """A trained f32 IVF16 of faiss_tpu over XB (its own resources), and
    its file."""
    jres = jax_res()
    j = TpuIndexIVFFlat(D, 16, nprobe=4, resources=jres)
    j.train(XB)
    j.add(XB)
    path = str(tmp_path_factory.mktemp("ivf") / "ivf.npz")
    faiss_tpu.save_index(j, path)
    return j, path


@pytest.mark.parametrize("nprobe", [4, 16])
def test_sharded_ivf_cached_equals_uncached_and_jax(ivf_file, nprobe):
    j, path = ivf_file
    res = cpu_res(2)
    t = load_index(path, sharded=True, resources=res)
    assert isinstance(t, ShardedIndexIVFFlat) and t.num_shards == 2
    assert all(s.res is res for s in t.shards)
    sel_t = ft.IDSelectorRange(0, 1500)
    sel_j = jsel.IDSelectorRange(0, 1500)
    for st, sj in ((None, None), (sel_t, sel_j)):
        pt = ft.SearchParams(sel=st, nprobe=nprobe)
        out = t.search(XQ, K, params=pt)
        check_search(out, j.search(XQ, K, params=jsel.SearchParams(
            sel=sj, nprobe=nprobe)), f"nprobe {nprobe} {st}")
        for force in (False, True):
            for _ in range(2):
                a = t._search_packed(XQ, K, pt, force_plain_dense=force)[0]
                with programs.eager():
                    b = t._search_packed(XQ, K, pt,
                                         force_plain_dense=force)[0]
                assert torch.equal(bits(a), bits(b))
    # f32 lists: one exact route, the forced flag a key of its own
    assert owned(res, t._owner) == 4


def test_sharded_ivf_mutation_drops_the_programs(ivf_file):
    _, path = ivf_file
    res = cpu_res(2)
    t = load_index(path, sharded=True, resources=res)
    t.search(XQ, K)
    gen = t._gen
    assert owned(res, t._owner) == 1
    t.add(XB[:300])
    assert t._gen > gen and owned(res, t._owner) == 0
    t.search(XQ, K)
    gen = t._gen
    t.shards[1].remove_ids([0])       # a shard changed directly
    assert owned(res, t._owner) == 1
    t.search(XQ, K)
    assert t._gen > gen and owned(res, t._owner) == 1
    t.reset()
    assert owned(res, t._owner) == 0


# -- range_search ----------------------------------------------------------------


def _radius(xb, xq, per_query):
    """An L2 radius with about ``per_query`` hits a query and no distance
    within 5e-5 relative of it (the fp64 distances' midpoint at a gap)."""
    x64, q64 = xb.astype(np.float64), xq.astype(np.float64)
    s = np.sort(((q64[:, None, :] - x64[None]) ** 2).sum(-1).ravel())
    i = per_query * len(xq)
    while s[i + 1] - s[i] < 1e-4 * max(1.0, abs(s[i])):
        i += 1
    return (s[i] + s[i + 1]) / 2


def check_range(out_t, out_j):
    (lt, Dt, It), (lj, Dj, Ij) = out_t, out_j
    np.testing.assert_array_equal(lt, lj)
    for r in range(len(lt) - 1):
        seg = slice(lt[r], lt[r + 1])
        assert set(It[seg]) == set(Ij[seg])
        np.testing.assert_allclose(np.sort(Dt[seg]), np.sort(Dj[seg]),
                                   rtol=1e-3, atol=1e-3)


def test_flat_range_search_one_program_for_every_radius():
    tres, jres = cpu_res(), jax_res()
    t = TorchIndexFlat(D, device="cpu", resources=tres)
    j = TpuIndexFlat(D, resources=jres)
    t.add(XB)
    j.add(XB)
    radii = [_radius(XB, XQ, 20), _radius(XB, XQ, 60)]
    for r in radii:
        check_range(t.range_search(XQ, r), j.range_search(XQ, r))
    assert tres.cache_info() == jres.cache_info() == {"entries": 1}
    # more than RANGE_CAP0 hits in a chunk: the rerun at 2048, a key of
    # its own in both
    big = _radius(XB, XQ, 1300)
    check_range(t.range_search(XQ, big), j.range_search(XQ, big))
    assert tres.cache_info() == jres.cache_info() == {"entries": 2}
    q, _, nq_pad = t._prep_queries(XQ)
    sel = t._sel_stream(ft.SearchParams(sel=ft.IDSelectorRange(0, 900)))
    for r in radii + [big]:
        thr = range_threshold(r, t.metric)
        for cap, s in ((1024, None), (2048, None), (1024, sel)):
            a = t._run_range(q, nq_pad, thr, cap, s)
            with programs.eager():
                b = t._run_range(q, nq_pad, thr, cap, s)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert tres.cache_info()["entries"] == 3


def test_ivf_range_search_one_program_for_every_radius(ivf_file):
    j, path = ivf_file
    res = cpu_res()
    t = load_index(path, resources=res)
    n0 = res.cache_info()["entries"]
    jn0 = j.res.cache_info()["entries"]
    radii = [_radius(XB, XQ, 10), _radius(XB, XQ, 40)]
    for r in radii:
        check_range(t.range_search(XQ, r), j.range_search(XQ, r))
    assert (res.cache_info()["entries"] - n0
            == j.res.cache_info()["entries"] - jn0 == 1)
    q, _, _, nprobe, nbudget, sel = t._prep_search(XQ, None)
    for r in radii:
        thr = range_threshold(r, t.metric)
        for rcap in (1024, 64):     # the first pass, a smaller capacity
            a = t._run_range(q, nprobe, nbudget, thr, rcap, sel)
            with programs.eager():
                b = t._run_range(q, nprobe, nbudget, thr, rcap, sel)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert res.cache_info()["entries"] - n0 == 2


# -- the IVF coarse assign ------------------------------------------------------


def test_ivf_assign_one_program_a_padded_size(tmp_path):
    """Add batches that pad alike share one program in both packages,
    one that pads otherwise builds another; the ids equal the eager
    helper's, the unpadded GEMM's and faiss_tpu's."""
    jres, tres = jax_res(), cpu_res()
    j = TpuIndexIVFFlat(D, 16, nprobe=4, resources=jres)
    j.train(XB)
    path = str(tmp_path / "trained.npz")
    faiss_tpu.save_index(j, path)
    t = load_index(path, resources=tres)
    jn0, tn0 = jres.cache_info()["entries"], tres.cache_info()["entries"]
    rng = np.random.default_rng(5)
    # 300 and 301 pad to 304 rows; 500 to 504; 9000 and 10000 (two blocks
    # of 8192) to 16384
    for n, grew in ((300, 1), (301, 1), (500, 2), (9000, 3), (10000, 3)):
        x = rng.standard_normal((n, D)).astype(np.float32)
        xd, a = t._coarse_assign(x)
        with programs.eager():
            _, b = t._coarse_assign(x)
        np.testing.assert_array_equal(a, b)
        assert xd.shape == (n, t.d_pad)
        xu = torch.zeros((n, t.d_pad))
        xu[:, :D] = torch.from_numpy(x)
        np.testing.assert_array_equal(a, torch.argmax(dist_ops.matmul_scores(
            xu, t._cents, t._cnorms, t.metric), dim=-1).numpy())
        t.add(x)
        j.add(x)
        assert (tres.cache_info()["entries"] - tn0
                == jres.cache_info()["entries"] - jn0 == grew)
    np.testing.assert_array_equal(t.list_sizes(),
                                  np.asarray(j.list_sizes()))
    # a search drops no assign program; new centroids drop them all
    t.search(XQ, K)
    n = tres.cache_info()["entries"]
    t._set_centroids(t._centroids)
    assert tres.cache_info()["entries"] == n - 4


# -- resources= ------------------------------------------------------------------


class Elsewhere(TorchResources):
    """Resources whose only device is a card: a CPU device is outside."""

    @property
    def devices(self):
        return [torch.device("cuda", 0)]


def test_resources_on_every_entry_point(tmp_path):
    res = cpu_res(2)
    flat = TorchIndexFlat(D, device="cpu")
    flat.add(XB)
    path = str(tmp_path / "flat.npz")
    ft.save_index(flat, path)
    npy = str(tmp_path / "xb.npy")
    np.save(npy, XB)
    built = [load_index(path, resources=res),
             ft.index_from_arrays({"format": 1, "kind": "flat", "d": D,
                                   "metric": "l2", "storage": "float32",
                                   "ntotal": 0},
                                  np.empty((0, D), np.float32),
                                  np.empty(0, np.float32), resources=res),
             build_index_from_file(npy, resources=res)]
    for idx in built:
        assert idx.res is res and idx.device == torch.device("cpu")
    for sh in (load_index(path, sharded=True, resources=res),
               build_index_from_file(npy, sharded=True, resources=res),
               ShardedIndexFlat(D, resources=res),
               ShardedIndexIVFFlat(D, 8, resources=res)):
        assert sh.res is res and sh.num_shards == 2
        assert all(getattr(s, "index", s).res is res for s in sh.shards)
    np.testing.assert_array_equal(built[0].search(XQ, K)[1],
                                  flat.search(XQ, K)[1])
    km = Kmeans(D, 8, niter=3, resources=res)
    km.train(XB)
    assert km.device == torch.device("cpu") and km.index.res is res
    cents, _ = kmeans_clustering(XB, 8, niter=3, resources=res)
    np.testing.assert_array_equal(cents, km.centroids)
    # TorchIndexIVFFlat.train hands its resources to its Kmeans, whose
    # index becomes the quantizer where no balancing runs
    ivf = TorchIndexIVFFlat(D, 8, balance=0, device="cpu", resources=res)
    ivf.train(XB)
    assert ivf.quantizer.res is res


def test_a_device_outside_the_resources_raises(tmp_path):
    away = Elsewhere(["cpu"])
    flat = TorchIndexFlat(D, device="cpu")
    flat.add(XB[:100])
    path = str(tmp_path / "flat.npz")
    ft.save_index(flat, path)
    npy = str(tmp_path / "xb.npy")
    np.save(npy, XB[:100])
    calls = [
        lambda: ShardedIndexFlat(D, devices=["cpu"] * 2, resources=away),
        lambda: ShardedIndexIVFFlat(D, 8, devices=["cpu"], resources=away),
        lambda: load_index(path, device="cpu", resources=away),
        lambda: load_index(path, sharded=True, devices=["cpu"],
                           resources=away),
        lambda: build_index_from_file(npy, device="cpu", resources=away),
        lambda: build_index_from_file(npy, sharded=True, devices=["cpu"],
                                      resources=away),
        lambda: Kmeans(D, 4, device="cpu", resources=away),
        lambda: kmeans_clustering(XB, 4, device="cpu", resources=away),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="devices"):
            call()
