"""faiss_tpu_torch's sharded indexes against faiss_tpu's, on the CPU.

faiss_tpu's ShardedIndexFlat and ShardedIndexIVFFlat run on the 8-device
CPU mesh of tests/conftest.py (their Pallas kernels in interpret mode);
the port's run on a list of torch devices that names the CPU P times
(``devices=["cpu"] * P``), every shard's kernels as their plain versions.
The inputs are made with numpy from seeds, as tests/test_sharded.py and
tests/test_sharded_ivf.py make them, and go into both.

Held: ids equal to faiss_tpu's sharded index and to the port's unsharded
index at P = 1, 2, 3 and 8 (the fused path forced open from 1024 rows a
shard in both packages, so that small shards take it), distances within
tests/common.py's ladder; incremental and uneven adds, k > ntotal, an
empty index; f32, bf16, f16, int8 and ``keep_master=False``; ties across
shards and add batches (gid order), replicas 1, 2 and 4 and their
validation, the fallback on ties; ``set_force_plain`` parity, remove_ids
with reconstruct, selectors, range_search; IVF with f32, bf16 and int8
lists at nprobe 1, 16 and nlist, the IP metric, the nprobe override,
async and selectors; ``save_index`` → ``faiss_tpu.load_index(sharded=
True)`` and the reverse, ids equal.
"""

import numpy as np
import pytest
import torch

import faiss_tpu
from faiss_tpu import ShardedIndexFlat as JShardedFlat
from faiss_tpu import ShardedIndexIVFFlat as JShardedIVF
from faiss_tpu import selector as jsel
from faiss_tpu.ops import pallas_fused as pf
import faiss_tpu_torch as ft
from faiss_tpu_torch import (ShardedIndexFlat, ShardedIndexIVFFlat,
                             TorchIndexFlat, load_index, save_index)
from faiss_tpu_torch.ops import fused

from common import compare_results, make_data, numpy_search, recall_at_k
from torch_parity import METRIC_IDS, METRICS

torch.set_num_threads(2)

NDEV = 8


def cpus(p=NDEV):
    return ["cpu"] * p


def ladder(metric, storage="f32"):
    if storage not in ("f32", "pair"):
        return 5e-2
    return 1e-3 if metric.value == "l2" else 1e-2


@pytest.fixture
def open_gate(monkeypatch):
    """The fused path from 1024 rows (a shard's nv_eff) in both packages."""
    gate = lambda **kw: kw["nv_eff"] >= 1024  # noqa: E731
    monkeypatch.setattr(pf, "fused_path_eligible", gate)
    monkeypatch.setattr(fused, "fused_path_eligible", gate)


def flat_pair(d, p, metric, jmetric, storage="f32", **kw):
    st = "f32" if storage == "pair" else storage
    if storage == "pair":
        kw["keep_master"] = False
    j = JShardedFlat(d, metric=jmetric, storage=st, num_shards=p, **kw)
    t = ShardedIndexFlat(d, metric=metric, storage=st, num_shards=p,
                         devices=cpus(), **kw)
    return j, t


def check_same(t_out, j_out, metric, storage="f32", k=None, label=""):
    (Dt, It), (Dj, Ij) = t_out, j_out
    np.testing.assert_array_equal(It, Ij, err_msg=label)
    assert It.dtype == np.int64
    compare_results(Dt, It, Dj, Ij, dist_tol=ladder(metric, storage),
                    k=k or It.shape[1], label=label)


# -- ShardedIndexFlat --------------------------------------------------------


# One data set for most cases, added in one batch: faiss_tpu compiles its
# append and search programs once for each shape and device, so cases that
# share the shapes share the programs (its interpret-mode kernels and
# per-device compiles dominate this file's time).
XB, XQ = make_data(2000, 13, 32)

# (shards, metric): P = 1, 2, 3 and 8, both metrics among them
P_CASES = [(1, 0), (2, 1), (3, 1), (8, 0)]


@pytest.mark.parametrize("p,m", P_CASES,
                         ids=[f"p{p}-{METRIC_IDS[m]}" for p, m in P_CASES])
def test_sharded_flat_matches_jax_and_single(p, m):
    metric, jmetric = METRICS[m]
    j, t = flat_pair(32, p, metric, jmetric)
    assert t.num_shards == p
    j.add(XB)
    t.add(XB)
    single = TorchIndexFlat(32, metric=metric, device="cpu")
    single.add(XB)
    out = t.search(XQ, 10)
    check_same(out, j.search(XQ, 10), metric, label=f"P={p}")
    check_same(out, single.search(XQ, 10), metric, label=f"P={p} single")
    assert [s.store.ntotal for s in t.shards] == \
        [s.store.ntotal for s in j.shards]
    assert t.fused_fallbacks == j.fused_fallbacks


# (storage, metric): every storage, both metrics among them; the port on
# its fused path (1000 rows a shard), faiss_tpu on its fused path for bf16
# and on its plain path for f32, int8 and pair (its interpret-mode kernels
# are slow here: tests/test_torch_f32.py and test_torch_int8.py hold the
# single index's fused paths against them). f16 is held against the
# port's single index alone, which tests/test_torch_f16.py holds against
# faiss_tpu: faiss_tpu's sharded f16 add compiles for ~14 s here.
STORAGE_CASES = [("f32", 1), ("bf16", 0), ("f16", 1), ("int8", 0),
                 ("pair", 1)]


@pytest.mark.parametrize("storage,m", STORAGE_CASES,
                         ids=[f"{s}-{METRIC_IDS[m]}" for s, m in STORAGE_CASES])
def test_sharded_flat_storages_match_jax(open_gate, storage, m):
    metric, jmetric = METRICS[m]
    j, t = flat_pair(32, 2, metric, jmetric, storage)
    single = TorchIndexFlat(32, metric=metric, device="cpu",
                            storage="f32" if storage == "pair" else storage,
                            keep_master=storage != "pair")
    for idx in (t, single) if storage == "f16" else (j, t, single):
        idx.add(XB)
    out = t.search(XQ, 10)
    if storage != "f16":
        j.set_force_xla(storage != "bf16")
        check_same(out, j.search(XQ, 10), metric, storage, label=storage)
    check_same(out, single.search(XQ, 10), metric, storage,
               label=f"{storage} single")


def test_sharded_incremental_uneven_adds_and_k_past_ntotal():
    """As tests/test_sharded.py: uneven batches (the rotating split), the
    port's single index and the numpy oracle; empty shards and k > ntotal
    as faiss_tpu's."""
    rng = np.random.default_rng(3)
    d = 32
    t = ShardedIndexFlat(d, devices=cpus())
    single = TorchIndexFlat(d, device="cpu")
    chunks = [rng.standard_normal((n, d), dtype=np.float32)
              for n in [5, 100, 1, 1500, 17]]
    for c in chunks:
        t.add(c)
        single.add(c)
    xb = np.concatenate(chunks)
    assert t.ntotal == xb.shape[0]
    assert max(s.store.ntotal for s in t.shards) \
        - min(s.store.ntotal for s in t.shards) <= 1
    xq = rng.standard_normal((6, d), dtype=np.float32)
    out = t.search(xq, 20)
    check_same(out, single.search(xq, 20), METRICS[0][0])
    assert recall_at_k(out[1], numpy_search(xb, xq, 20)[1], 20) == 1.0
    # fewer rows than shards: empty shards, k > ntotal
    j2, t2 = flat_pair(32, 4, *METRICS[0])
    j2.add(XB[:3])
    t2.add(XB[:3])
    D, I = t2.search(XQ, 12)
    check_same((D, I), j2.search(XQ, 12), METRICS[0][0])
    assert (I[:, 3:] == -1).all() and np.isposinf(D[:, 3:]).all()
    # an empty index
    t3 = ShardedIndexFlat(16, devices=cpus())
    D, I = t3.search(np.zeros((3, 16), np.float32), 4)
    assert (I == -1).all() and np.isposinf(D).all()
    assert t3.search_async(np.zeros((3, 16), np.float32), 4).is_ready()


def test_cross_shard_tie_order():
    """Duplicates spread over shards in several add batches (gid order no
    longer follows shard order): ties resolve to the lowest global id, as
    in faiss_tpu's sharded index and the port's single index."""
    rng = np.random.default_rng(21)
    base = rng.standard_normal((64, 32)).astype(np.float32)
    xb = np.tile(base, (8, 1))
    j, t = flat_pair(32, 3, *METRICS[0])
    single = TorchIndexFlat(32, device="cpu")
    for i in range(8):
        for idx in (j, t):
            idx.add(xb[i * 64: (i + 1) * 64])
    single.add(xb)
    out = t.search(XQ, 24)
    check_same(out, j.search(XQ, 24), METRICS[0][0])
    check_same(out, single.search(XQ, 24), METRICS[0][0])


@pytest.mark.parametrize("nreplicas", [1, 2, 4])
def test_query_replicas(nreplicas):
    """(R, P) grid: the database replicated over R groups, the queries
    split across them (13 queries: replica padding)."""
    p = NDEV // nreplicas
    j = JShardedFlat(32, num_replicas=nreplicas)
    t = ShardedIndexFlat(32, num_replicas=nreplicas, devices=cpus())
    assert t.num_shards == j.num_shards == p
    j.add(XB)
    t.add(XB)
    out = t.search(XQ, 10)
    check_same(out, j.search(XQ, 10), METRICS[0][0])
    assert recall_at_k(out[1], numpy_search(XB, XQ, 10)[1], 10) == 1.0


def test_query_replicas_validation_and_copies():
    with pytest.raises(ValueError):
        ShardedIndexFlat(16, num_replicas=NDEV + 1, num_shards=2,
                         devices=cpus())
    with pytest.raises(ValueError):
        ShardedIndexFlat(16, num_shards=NDEV + 1, devices=cpus())
    # replica 1 on a device that differs from replica 0's (cpu:0 vs cpu):
    # its shards are copies, results equal
    t = ShardedIndexFlat(32, num_replicas=2,
                         devices=["cpu", "cpu", "cpu:0", "cpu:0"])
    t.add(XB)
    ref = ShardedIndexFlat(32, num_shards=2, devices=cpus(2))
    ref.add(XB)
    D, I = t.search(XQ, 7)
    assert len(t._replicas) == 2
    Dr, Ir = ref.search(XQ, 7)
    np.testing.assert_array_equal(I, Ir)
    np.testing.assert_array_equal(D, Dr)


def test_fallback_on_ties(open_gate):
    """Every row the same: the certificate fails and the plain path re-runs
    the queries; ties resolve exactly (tests/test_sharded.py's case)."""
    rng = np.random.default_rng(23)
    row = rng.standard_normal(32).astype(np.float32)
    xb = np.tile(row, (4096, 1))
    xq = rng.standard_normal((4, 32)).astype(np.float32)
    t = ShardedIndexFlat(32, num_shards=2, devices=cpus())
    t.add(xb)
    D, I = t.search(xq, 8)
    assert t.fused_fallbacks == 1
    np.testing.assert_array_equal(I, np.tile(np.arange(8), (4, 1)))


def test_force_plain_parity_and_remove_reconstruct(open_gate):
    """The fused and the plain local searches agree; remove_ids renumbers
    as faiss_tpu's (searched on the plain path in both) and reconstruct
    follows the new extents."""
    j, t = flat_pair(32, 2, *METRICS[0])
    j.add(XB)
    t.add(XB)
    D1, I1 = t.search(XQ, 10)
    t.set_force_plain(True)
    D2, I2 = t.search(XQ, 10)
    np.testing.assert_array_equal(I1, I2)
    np.testing.assert_allclose(D1, D2, rtol=1e-5, atol=1e-4)
    # remove_ids: the dense renumbering over the gid extents
    rm = np.concatenate([np.arange(0, 2000, 7), [1999, 1000]])
    assert t.remove_ids(rm) == j.remove_ids(rm)
    assert t.ntotal == j.ntotal
    j.set_force_xla(True)
    check_same(t.search(XQ, 10), j.search(XQ, 10), METRICS[0][0])
    keep = np.setdiff1d(np.arange(2000), rm)
    for key in (0, 1, 500, t.ntotal - 1):
        np.testing.assert_array_equal(t.reconstruct(key), XB[keep[key]])
    with pytest.raises(IndexError):
        t.reconstruct(t.ntotal)


def test_selectors_match_jax(open_gate):
    """Selectors over global ids, as per-shard streams: a range on the
    port's fused path, a batch of four ids on its plain path, against
    faiss_tpu's plain path (on its fused path a shard with fewer admitted
    groups than it nominates repeats a group, and faiss_tpu returns an
    admitted row once per copy, a reference fault the port repairs: ROADMAP
    §3, "Repeated groups")."""
    j, t = flat_pair(32, 2, *METRICS[1])
    j.add(XB)
    t.add(XB)
    j.set_force_xla(True)
    for plain, tsel, jsl in [
            (False, ft.IDSelectorRange(400, 1700),
             jsel.IDSelectorRange(400, 1700)),
            (True, ft.IDSelectorBatch([3, 1000, 1999, 17]),
             jsel.IDSelectorBatch([3, 1000, 1999, 17]))]:
        t.set_force_plain(plain)
        out = t.search(XQ, 10, params=ft.SearchParams(tsel))
        check_same(out, j.search(XQ, 10, params=jsel.SearchParams(jsl)),
                   METRICS[1][0])
        assert bool(tsel.is_member(out[1][out[1] >= 0]).all())


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_range_search_matches_jax(metric, jmetric):
    j, t = flat_pair(32, 3, metric, jmetric)
    j.add(XB)
    t.add(XB)
    radius = 40.0 if metric.value == "l2" else 10.0
    lt, Dt, It = t.range_search(XQ, radius)
    lj, Dj, Ij = j.range_search(XQ, radius)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(It, Ij)
    np.testing.assert_allclose(Dt, Dj, rtol=1e-5, atol=1e-5)
    assert lt[-1] > len(XQ)


@pytest.mark.parametrize("storage", ["f32", "int8", "pair"])
def test_flat_files_cross_both_ways(tmp_path, storage):
    """save_index of either package → the other's load_index(sharded=
    True): ids equal, and equal to the saving index's."""
    j, t = flat_pair(32, 2, *METRICS[0], storage=storage)
    j.add(XB)
    t.add(XB)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    faiss_tpu.save_index(j, pj)
    save_index(t, pt)
    t2 = load_index(pj, sharded=True, devices=cpus(), num_shards=3,
                    keep_master=storage != "pair")
    j2 = faiss_tpu.load_index(pt, sharded=True,
                              keep_master=storage != "pair")
    assert isinstance(t2, ShardedIndexFlat) and t2.num_shards == 3
    want = j.search(XQ, 10)
    for out in (t2.search(XQ, 10), j2.search(XQ, 10), t.search(XQ, 10)):
        check_same(out, want, METRICS[0][0], storage)
    for key in (0, 1500, 1999):
        np.testing.assert_array_equal(t2.reconstruct(key), t.reconstruct(key))


# -- ShardedIndexIVFFlat -----------------------------------------------------


def int_data(nv, nq, d, seed=0, hi=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, (nv, d)).astype(np.float32),
            rng.integers(0, hi, (nq, d)).astype(np.float32))


NLIST = 32


def ivf_pair(path, storage="f32", p=4, metric=None, nv=4000, seed=1):
    """(JAX sharded IVF, the port's, rows, queries): JAX trains; the port
    loads the trained, empty index's file sharded (same centroids and
    scales); then the same rows go into both, in two batches."""
    m, jm = metric or METRICS[0]
    xb, xq = int_data(nv, 6, 16, seed=seed)
    j = JShardedIVF(16, NLIST, metric=jm, storage=storage, nprobe=4,
                    num_shards=p, seed=3)
    j.train(xb)
    faiss_tpu.save_index(j, path)
    t = load_index(path, sharded=True, devices=cpus(), num_shards=p)
    assert isinstance(t, ShardedIndexIVFFlat) and t.num_shards == p
    for idx in (j, t):
        idx.add(xb[:1500])
        idx.add(xb[1500:])
    return j, t, xb, xq


IVF_STORAGES = ["f32", "bf16", "int8"]


@pytest.fixture(scope="module")
def ivf_built(tmp_path_factory):
    """{storage: ivf_pair(storage)}, built once for the module."""
    root = tmp_path_factory.mktemp("ivf")
    return {st: ivf_pair(str(root / f"{st}.npz"), st, p=2)
            for st in IVF_STORAGES}


@pytest.mark.parametrize("nprobe", [1, 16, NLIST])
@pytest.mark.parametrize("storage", IVF_STORAGES)
def test_sharded_ivf_matches_jax(ivf_built, storage, nprobe):
    j, t, xb, xq = ivf_built[storage]
    np.testing.assert_array_equal(t.list_sizes(), j.list_sizes())
    j.nprobe = t.nprobe = nprobe
    out = t.search(xq, 7)
    want = j.search(xq, 7)
    np.testing.assert_array_equal(out[1], want[1])
    compare_results(*out, *want, dist_tol=ladder(METRICS[0][0], storage),
                    k=7)
    for key in (0, 1499, 1500, 3999):
        np.testing.assert_allclose(t.reconstruct(key), j.reconstruct(key))


def test_sharded_ivf_ip_override_async_selector_empty(tmp_path):
    j, t, xb, xq = ivf_pair(str(tmp_path / "ip.npz"), "f32", p=2,
                            metric=METRICS[1])
    j.nprobe = t.nprobe = 8
    np.testing.assert_array_equal(t.search(xq, 6)[1], j.search(xq, 6)[1])
    # async, with a selector and the per-query nprobe override
    tok = t.search_async(xq, 6, params=ft.SearchParams(
        ft.IDSelectorRange(1000, 3000), nprobe=2))
    Dj, Ij = j.search(xq, 6, params=jsel.SearchParams(
        jsel.IDSelectorRange(1000, 3000), nprobe=2))
    D, I = tok.wait()
    np.testing.assert_array_equal(I, Ij)
    assert ((I[I >= 0] >= 1000) & (I[I >= 0] < 3000)).all()
    assert not np.array_equal(I, t.search(xq, 6, params=ft.SearchParams(
        ft.IDSelectorRange(1000, 3000)))[1])
    t.reset()
    assert t.ntotal == 0 and t.is_trained
    tok = t.search_async(xq, 4)
    assert tok.is_ready()
    De, Ie = tok.wait()
    assert (Ie == -1).all() and (De == -np.inf).all()
    with pytest.raises(ValueError):
        t.search(np.zeros((2, 8), np.float32), 3)


def test_sharded_ivf_port_train_and_dense_fallback(tmp_path):
    """The port's own training (shard 0's quantizer in every shard) and
    the dense fused route's certificate, against the port's single index
    trained alike; duplicated rows make the dense certificate fail and
    re-run on the plain sweep."""
    xb, xq = int_data(3000, 5, 16, seed=7)
    t = ShardedIndexIVFFlat(16, 8, storage="bf16", nprobe=8, num_shards=3,
                            devices=cpus(), seed=5)
    single = ft.TorchIndexIVFFlat(16, 8, storage="bf16", nprobe=8,
                                  device="cpu", seed=5)
    with pytest.raises(RuntimeError):
        t.add(xb)
    t.train(xb)
    single.train(xb)
    for i in range(0, 3000, 700):
        t.add(xb[i: i + 700])
    single.add(xb)
    np.testing.assert_array_equal(t.list_sizes(), single.list_sizes())
    D, I = t.search(xq, 10)
    Ds, Is = single.search(xq, 10)
    np.testing.assert_array_equal(I, Is)
    np.testing.assert_array_equal(D, Ds)
    assert "shards=3" in t.describe()


def test_ivf_files_cross_both_ways(ivf_built, tmp_path):
    storage = "f32"
    j, t, xb, xq = ivf_built[storage]
    j.nprobe = t.nprobe = 16
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    faiss_tpu.save_index(j, pj)
    save_index(t, pt)
    t2 = load_index(pj, sharded=True, devices=cpus(), num_shards=3)
    j2 = faiss_tpu.load_index(pt, sharded=True)
    t1 = load_index(pt, device="cpu")     # the single-index format
    want = j.search(xq, 7)
    for out in (t2.search(xq, 7), j2.search(xq, 7), t1.search(xq, 7)):
        np.testing.assert_array_equal(out[1], want[1])
        compare_results(*out, *want, dist_tol=ladder(METRICS[0][0], storage),
                        k=7)
