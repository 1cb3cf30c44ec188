"""faiss_tpu_torch's IDMap / IDMap2 wrappers, IndexShardsHost and
save_index against faiss_tpu's, on the CPU.

After tests/test_idmap.py and test_multi.py: the wrappers and the host
shards are driven with the same calls in both packages, over stored
databases that are the same bit for bit (a faiss_tpu file loaded into the
port, or the same adds of f32 rows). ``save_index`` files of the port load
in ``faiss_tpu.load_index`` and the reverse, for every storage and both
wrappers, with rows, norms, scales and id maps equal.

Tolerances: labels equal; distances within the ladder of tests/common.py
(1e-3 f32 L2, 5e-2 reduced precision); reconstructions and saved arrays
equal bit for bit.
"""

import numpy as np
import pytest
import torch

import faiss_tpu
from faiss_tpu import TpuIndexFlat, TpuIndexIDMap, TpuIndexIDMap2
from faiss_tpu import io as jio
from faiss_tpu import selector as jsel
from faiss_tpu.multi import IndexShardsHost as JShards
from faiss_tpu.multi import merge_search_results as jmerge
import faiss_tpu_torch as ft
from faiss_tpu_torch import (IndexShardsHost, TorchIndexFlat,
                             TorchIndexIDMap, TorchIndexIDMap2, load_index,
                             merge_search_results, save_index)

from common import compare_results, make_data

torch.set_num_threads(2)

NV, D, NQ, K = 3000, 16, 6, 7


@pytest.fixture(scope="module")
def data():
    xb, xq = make_data(NV, NQ, D, seed=515)
    ids = (np.arange(NV, dtype=np.int64) * 7 + 1_000_000_007)[::-1].copy()
    return xb, xq, ids


def _pair(wrapper_t, wrapper_j, xb, ids):
    t = wrapper_t(TorchIndexFlat(D, device="cpu"))
    j = wrapper_j(TpuIndexFlat(D))
    for part in (slice(0, 1000), slice(1000, NV)):
        t.add_with_ids(xb[part], ids[part])
        j.add_with_ids(xb[part], ids[part])
    return t, j


@pytest.mark.parametrize("two", [False, True])
def test_idmap_matches_jax(data, two):
    xb, xq, ids = data
    t, j = _pair(TorchIndexIDMap2 if two else TorchIndexIDMap,
                 TpuIndexIDMap2 if two else TpuIndexIDMap, xb, ids)
    with pytest.raises(RuntimeError):
        t.add(xb[:2])
    with pytest.raises(ValueError):
        t.add_with_ids(xb[:3], ids[:2])
    D_t, I_t = t.search(xq, K)
    D_j, I_j = j.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    compare_results(D_t, I_t, D_j, I_j, dist_tol=1e-3, k=K)
    assert np.isin(I_t, ids).all()
    # the token translates at wait(), after the inner fallback
    tok = t.search_async(xq, K)
    np.testing.assert_array_equal(tok.wait()[1], I_t)
    assert tok.is_ready()
    np.testing.assert_array_equal(t.assign(xq, 2), j.assign(xq, 2))
    # a selector speaks custom ids
    sel_t = ft.SearchParams(sel=ft.IDSelectorBatch(ids[::3]))
    sel_j = jsel.SearchParams(sel=jsel.IDSelectorBatch(ids[::3]))
    D_t, I_t = t.search(xq, K, params=sel_t)
    np.testing.assert_array_equal(I_t, j.search(xq, K, params=sel_j)[1])
    assert np.isin(I_t, ids[::3]).all()
    r = float(np.median(D_t[:, 3]))
    lims_t, _, Ir_t = t.range_search(xq, r)
    lims_j, _, Ir_j = j.range_search(xq, r)
    np.testing.assert_array_equal(lims_t, lims_j)
    np.testing.assert_array_equal(np.sort(Ir_t), np.sort(Ir_j))
    # removal by custom id, unknown ids ignored
    rm = np.concatenate([ids[5:400:2], [12345]])
    assert t.remove_ids(rm) == j.remove_ids(rm) == 198
    np.testing.assert_array_equal(t.id_map, j.id_map)
    np.testing.assert_array_equal(t.search(xq, K)[1], j.search(xq, K)[1])
    if two:
        for key in (ids[0], ids[NV - 1], ids[1500]):
            np.testing.assert_array_equal(t.reconstruct(key),
                                          j.reconstruct(key))
        with pytest.raises(KeyError):
            t.reconstruct(ids[5])                   # removed
    else:
        with pytest.raises(RuntimeError):
            t.reconstruct(ids[0])
    t.reset()
    assert t.ntotal == 0 and t.id_map.size == 0


def test_idmap2_duplicate_id_last_wins_and_sentinels(data):
    xb, xq, _ = data
    t = TorchIndexIDMap2(TorchIndexFlat(D, device="cpu"))
    t.add_with_ids(xb[:3], [5, 9, 5])
    np.testing.assert_array_equal(t.reconstruct(5), xb[2])
    D_t, I_t = t.search(xq, K)                      # k > ntotal
    assert (I_t[:, 3:] == -1).all()
    assert set(I_t[0, :3]) == {5, 9}


def test_shards_host_matches_jax_and_flat(data):
    """Two shards, each a batch: ids equal the one-index search's and
    faiss_tpu's IndexShardsHost's; selectors, range_search and remove_ids
    follow the global ids."""
    xb, xq, _ = data
    t = IndexShardsHost([TorchIndexFlat(D, device="cpu") for _ in range(2)])
    j = JShards([TpuIndexFlat(D) for _ in range(2)])
    one = TorchIndexFlat(D, device="cpu")
    for part in (xb[:1400], xb[1400:]):
        t.add(part)
        j.add(part)
        one.add(part)
    assert [ix.ntotal for ix in t.indexes] == [1400, NV - 1400]
    D_t, I_t = t.search(xq, K)
    I_one = one.search(xq, K)[1]
    np.testing.assert_array_equal(I_t, I_one)
    D_j, I_j = j.search(xq, K)
    np.testing.assert_array_equal(I_t, I_j)
    compare_results(D_t, I_t, D_j, I_j, dist_tol=1e-3, k=K)
    sel = ft.SearchParams(sel=ft.IDSelectorRange(1000, 2000))
    np.testing.assert_array_equal(
        t.search(xq, K, params=sel)[1],
        j.search(xq, K, params=jsel.SearchParams(
            sel=jsel.IDSelectorRange(1000, 2000)))[1])
    r = float(np.median(D_t[:, 4]))
    lims_t, _, Ir_t = t.range_search(xq, r)
    lims_j, _, Ir_j = j.range_search(xq, r)
    np.testing.assert_array_equal(lims_t, lims_j)
    np.testing.assert_array_equal(Ir_t, Ir_j)
    rm = np.arange(1300, 1600)
    assert t.remove_ids(rm) == j.remove_ids(rm) == one.remove_ids(rm) == 300
    np.testing.assert_array_equal(t.search(xq, K)[1], one.search(xq, K)[1])
    np.testing.assert_array_equal(t.search(xq, K)[1], j.search(xq, K)[1])
    # TorchIndexIDMap2 over the shards: labels are the custom ids
    w = TorchIndexIDMap2(IndexShardsHost(
        [TorchIndexFlat(D, device="cpu") for _ in range(2)]))
    for part in (slice(0, 1400), slice(1400, NV)):
        w.add_with_ids(xb[part], np.arange(NV)[part] * 10)
    np.testing.assert_array_equal(w.search(xq, K)[1], I_one * 10)
    np.testing.assert_array_equal(w.reconstruct(10 * 1500), xb[1500])
    with pytest.raises(ValueError):
        IndexShardsHost([])


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_merge_search_results_matches_jax(metric):
    rng = np.random.default_rng(3)
    parts = []
    for base in (0, 100):
        d = np.sort(np.round(rng.standard_normal((5, 8)), 1), axis=1)
        if metric == "ip":
            d = d[:, ::-1].copy()
        parts.append((d.astype(np.float32),
                      np.arange(8)[None, :].repeat(5, 0) + base))
    got = merge_search_results(parts, 10, metric)
    want = jmerge(parts, 10, metric)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    padded = merge_search_results(parts, 20, metric)
    assert (padded[1][:, 16:] == -1).all()


# -- save_index ---------------------------------------------------------------


def _saved_arrays(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("wrapper", [None, "idmap", "idmap2"])
@pytest.mark.parametrize("storage", ["f32", "bf16", "f16", "int8", "pair"])
def test_save_index_round_trips_with_jax(data, tmp_path, storage, wrapper):
    """port → file → faiss_tpu and faiss_tpu → file → port: the same
    arrays in both files, the same search results after each load."""
    xb, xq, ids = data
    kw = dict(keep_master=False) if storage == "pair" else {}
    st = "f32" if storage == "pair" else storage
    j = TpuIndexFlat(D, storage=st, **kw)
    j.add(xb)
    jpath = str(tmp_path / "jax.npz")
    wrap_j = {None: lambda i: i, "idmap": TpuIndexIDMap,
              "idmap2": TpuIndexIDMap2}[wrapper]
    wrap_t = {None: lambda i: i, "idmap": TorchIndexIDMap,
              "idmap2": TorchIndexIDMap2}[wrapper]
    jw = wrap_j(j)
    if wrapper:
        jw.id_map = ids.copy()
    jio.save_index(jw, jpath)
    t = load_index(jpath, device="cpu", **kw)
    assert type(t) is type(wrap_t(TorchIndexFlat(D, device="cpu")))
    tpath = str(tmp_path / "torch.npz")
    save_index(t, tpath)
    a, b = _saved_arrays(jpath), _saved_arrays(tpath)
    assert set(a) == set(b)
    assert str(a["meta"]) == str(b["meta"])
    for key in ("vectors", "norms", "id_map"):
        if key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    if "scales" in a:
        np.testing.assert_array_equal(a["scales"][:D], b["scales"])
    back = jio.load_index(tpath, **kw)
    D_j, I_j = jw.search(xq, K)
    for other in (t, back):
        D_o, I_o = other.search(xq, K)
        np.testing.assert_array_equal(I_o, I_j)
        compare_results(D_o, I_o, D_j, I_j, k=K,
                        dist_tol=1e-3 if st == "f32" else 5e-2)


def test_save_index_refuses_other_indexes(tmp_path):
    shards = IndexShardsHost([TorchIndexFlat(D, device="cpu")])
    with pytest.raises(TypeError):
        save_index(shards, str(tmp_path / "x.npz"))
    empty = TorchIndexIDMap(TorchIndexFlat(D, storage="int8", device="cpu"))
    empty.index.train(np.ones((4, D), np.float32))
    save_index(empty, str(tmp_path / "e.npz"))
    back = faiss_tpu.load_index(str(tmp_path / "e.npz"))
    assert back.ntotal == 0 and isinstance(back, TpuIndexIDMap)
