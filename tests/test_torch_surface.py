"""faiss_tpu_torch's flat surface against faiss_tpu's, on the CPU.

Selectors, remove_ids, merge_from, assign, search_and_reconstruct,
vectors_numpy and range_search, each against the same call on
``faiss_tpu.TpuIndexFlat`` for every storage (f32, bf16, f16, int8), after
tests/test_selector.py, test_remove_ids.py, test_merge_from.py and
test_range_search.py. Both sides hold the same stored database: the JAX
index is built, saved, and loaded into the port (rows, norms and scales bit
for bit). The JAX fused path runs its Pallas kernels in interpret mode, the
port its kernels' plain versions.

Tolerances: stored rows, norms and reconstructions equal bit for bit;
search ids equal, or ordered differently only where two scores lie within
the query's certificate ε (``assert_ids_match``); distances within the
ladder of tests/common.py (1e-3 f32 L2, 1e-2 IP, 5e-2 reduced precision);
range_search hits equal as (query, id) sets at radii that leave a gap of
more than 100 ε around them, distances within the ladder.
"""

import numpy as np
import pytest
import torch

import faiss_tpu
from faiss_tpu import TpuIndexFlat
from faiss_tpu import io as jio
from faiss_tpu import selector as jsel
from faiss_tpu.ops import pallas_fused as pf
import faiss_tpu_torch as ft
from faiss_tpu_torch import TorchIndexFlat, load_index
from faiss_tpu_torch.ops import fused

from common import compare_results, make_data
from torch_parity import METRIC_IDS, METRICS, assert_ids_match

torch.set_num_threads(2)

NV, D, NQ, K = 8192, 32, 8, 10
STORAGES = ["f32", "bf16", "f16", "int8"]
TOL = {"f32": 1e-3, "bf16": 5e-2, "f16": 5e-2, "int8": 5e-2}


@pytest.fixture
def open_gate(monkeypatch):
    """Fused path from 8192 rows in both packages."""
    gate = lambda **kw: kw["nv_eff"] >= 8192  # noqa: E731
    monkeypatch.setattr(pf, "fused_path_eligible", gate)
    monkeypatch.setattr(fused, "fused_path_eligible", gate)


@pytest.fixture(scope="module")
def data():
    return make_data(NV, NQ, D, seed=606)


@pytest.fixture(scope="module")
def saved(data, tmp_path_factory):
    """(storage, metric value) → a faiss_tpu file of the NV rows."""
    root = tmp_path_factory.mktemp("surface")
    cache = {}

    def get(storage, jmetric):
        key = (storage, jmetric.value)
        if key not in cache:
            j = TpuIndexFlat(D, metric=jmetric, storage=storage)
            j.add(data[0])
            path = str(root / f"{storage}_{jmetric.value}.npz")
            jio.save_index(j, path)
            cache[key] = path
        return cache[key]
    return get


def _both(saved, storage, jmetric):
    path = saved(storage, jmetric)
    return jio.load_index(path), load_index(path, device="cpu")


def _eps(idx, xq):
    """(nq,) the port's two-plane certificate ε of its own sweep."""
    st = idx.store
    q, nq, _ = idx._prep_queries(xq)
    if st.scales is not None:
        e = fused._sweep_eps_int8(q, st.scales, st.int_norm_max, st.norms,
                                  idx.ntotal, metric=idx.metric,
                                  d_pad=st.d_pad)
    else:
        e = fused._sweep_eps(q, st.norms, idx.ntotal, metric=idx.metric,
                             d_pad=st.d_pad,
                             pair_sweep=st.split_stats is not None,
                             split_stats=st.split_stats)
    return e[:nq].numpy()


def _check_search(idx, D_t, I_t, D_j, I_j, xq, storage, metric, label):
    assert_ids_match(I_t, I_j, D_j, _eps(idx, xq), label)
    compare_results(D_t, I_t, D_j, I_j, check_top1=False, k=D_t.shape[1],
                    dist_tol=TOL[storage] if metric.value == "l2" else 1e-2,
                    label=label)


def _selectors(mod, rng_seed=5):
    """The same composite selector in either package's classes."""
    batch = np.random.default_rng(rng_seed).choice(NV, 400, replace=False)
    return ((mod.IDSelectorRange(1000, 6000) & ~mod.IDSelectorRange(2000, 2600))
            | mod.IDSelectorBatch(batch)), batch


# -- selectors ----------------------------------------------------------------


def test_selector_classes_match_jax():
    ids = np.arange(-3, NV + 5, dtype=np.int64)
    mask = np.zeros(NV, bool)
    mask[::7] = True
    pairs = [(ft.IDSelectorRange(10, 500), jsel.IDSelectorRange(10, 500)),
             (ft.IDSelectorBatch([5, 5, 99, NV + 2]),
              jsel.IDSelectorBatch([5, 5, 99, NV + 2])),
             (ft.IDSelectorMask(mask), jsel.IDSelectorMask(mask)),
             (_selectors(ft)[0], _selectors(jsel)[0]),
             (ft.IDSelectorAnd(ft.IDSelectorRange(0, 900),
                               ~ft.IDSelectorBatch([3])),
              jsel.IDSelectorAnd(jsel.IDSelectorRange(0, 900),
                                 ~jsel.IDSelectorBatch([3])))]
    for mine, theirs in pairs:
        np.testing.assert_array_equal(mine.is_member(ids),
                                      theirs.is_member(ids))
    assert ft.SearchParameters is ft.SearchParametersIVF is ft.SearchParams


# every storage and metric on the plain path; on the fused path (Pallas in
# interpret mode on the JAX side, the slow half) every storage under L2 and
# f32 under IP
SELECTOR_CASES = ([("plain", st, m) for st in STORAGES for m in (0, 1)]
                  + [("fused", st, 0) for st in STORAGES]
                  + [("fused", "f32", 1)])


@pytest.mark.parametrize("path,storage,m", SELECTOR_CASES,
                         ids=[f"{p}-{s}-{METRIC_IDS[m]}"
                              for p, s, m in SELECTOR_CASES])
def test_selector_search_matches_jax(saved, data, path, storage, m, request):
    metric, jmetric = METRICS[m]
    if path == "fused":
        request.getfixturevalue("open_gate")
    j, t = _both(saved, storage, jmetric)
    xq = data[1]
    sel_t, batch = _selectors(ft)
    sel_j, _ = _selectors(jsel)
    D_t, I_t = t.search(xq, K, params=ft.SearchParams(sel=sel_t))
    D_j, I_j = j.search(xq, K, params=jsel.SearchParams(sel=sel_j))
    _check_search(t, D_t, I_t, D_j, I_j, xq, storage, metric, "filtered")
    admitted = sel_t.is_member(np.arange(NV, dtype=np.int64))
    assert admitted[I_t].all()
    assert t.fused_fallbacks == 0
    # search_async takes the same params
    Da, Ia = t.search_async(xq, K, params=ft.SearchParams(sel=sel_t)).wait()
    np.testing.assert_array_equal(Ia, I_t)


def test_selector_edge_cases(saved, data, open_gate):
    """Fewer admitted rows than k sentinel-fill, also when an admitted row
    lies in the last group (the group select pads the nominated set with
    copies of it: faiss_tpu's fused route returns that row once per copy,
    its plain path, like the port's two paths, once); the all-admitting
    selector gives the unfiltered result; bad params raise."""
    j, t = _both(saved, "bf16", METRICS[0][1])
    xq = data[1]
    few = ft.SearchParams(sel=ft.IDSelectorBatch([17, 4000, 8191]))
    D_t, I_t = t.search(xq, K, params=few)
    j.set_force_xla(True)
    D_j, I_j = j.search(xq, K, params=jsel.SearchParams(
        sel=jsel.IDSelectorBatch([17, 4000, 8191])))
    np.testing.assert_array_equal(I_t, I_j)
    assert (I_t[:, 3:] == -1).all() and np.isinf(D_t[:, 3:]).all()
    t.set_force_plain(True)
    np.testing.assert_array_equal(t.search(xq, K, params=few)[1], I_t)
    t.set_force_plain(False)
    every = ft.SearchParams(sel=ft.IDSelectorRange(0, NV))
    np.testing.assert_array_equal(t.search(xq, K, params=every)[1],
                                  t.search(xq, K)[1])
    with pytest.raises(TypeError):
        t.search(xq, K, params=jsel.SearchParams())   # another package's
    with pytest.raises(TypeError):
        ft.SearchParams(sel=object())
    with pytest.raises(ValueError):
        ft.SearchParams(nprobe=0)
    with pytest.raises(ValueError):
        t.search(xq, K, params=ft.SearchParams(nprobe=4))
    empty = TorchIndexFlat(D, device="cpu")
    D0, I0 = empty.search(xq, K, params=few)
    assert (I0 == -1).all()


def test_filtered_fallback_keeps_filtering(open_gate):
    """Duplicated rows: the one-plane certificate fails under a selector;
    both fallback tiers run with it (tier 1 pins the shape), and every id
    returned is admitted: ties go to the lowest admitted ids, the result of
    faiss_tpu's test_fused_filtered_fallback_keeps_filtering."""
    row = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    xq = np.random.default_rng(2).standard_normal((32, D)).astype(np.float32)
    t = TorchIndexFlat(D, storage="bf16", device="cpu")
    t.add(np.tile(row, (NV, 1)))
    D_t, I_t = t.search(xq, K, params=ft.SearchParams(
        sel=ft.IDSelectorRange(3000, 8000)))
    assert t.fused_fallbacks == 1 and t._no_reduced_sweep == {32}
    np.testing.assert_array_equal(I_t, np.tile(np.arange(3000, 3010), (32, 1)))


@pytest.mark.parametrize("single_stage", [False, True])
def test_f32_rescore_masks_the_selector_again(data, open_gate, single_stage):
    """f32: the selector admits 5 rows, fewer than stage 3b's m = k + 22
    candidates (and, with k = NV, kg·128 ≤ m: the single-stage rescore).
    Filtered candidates, −inf in stage 3a, must not come back from the raw
    rescore against the master."""
    xb, xq = data
    keep = np.array([3, 999, 4096, 6000, 8191])
    k = NV if single_stage else K
    t = TorchIndexFlat(D, device="cpu")
    t.add(xb)
    D_t, I_t = t.search(xq, k, params=ft.SearchParams(
        sel=ft.IDSelectorBatch(keep)))
    assert (I_t[:, 5:] == -1).all() and np.isinf(D_t[:, 5:]).all()
    d2 = ((xq[:, None, :] - xb[keep][None]) ** 2).sum(-1)
    np.testing.assert_array_equal(I_t[:, :5], keep[np.argsort(d2, 1)])


# -- remove_ids, merge_from -------------------------------------------------------


@pytest.mark.parametrize("storage", STORAGES + ["pair"])
def test_remove_ids_matches_jax(saved, data, storage):
    jm = METRICS[0][1]
    if storage == "pair":
        path = saved("f32", jm)
        j = jio.load_index(path, keep_master=False)
        t = load_index(path, device="cpu", keep_master=False)
    else:
        j, t = _both(saved, storage, jm)
    rm = np.random.default_rng(9).choice(NV, 1500, replace=False)
    rm = np.concatenate([rm, rm[:10]])                  # duplicates count once
    assert t.remove_ids(rm) == j.remove_ids(rm) == 1500
    assert t.ntotal == j.ntotal == NV - 1500
    np.testing.assert_array_equal(t.reconstruct_n(0, t.ntotal),
                                  j.reconstruct_n(0, j.ntotal))
    np.testing.assert_array_equal(t.store.norms[: t.ntotal].numpy(),
                                  np.asarray(j.store.norms)[: j.ntotal])
    assert not t.store.norms[t.ntotal:].any()       # freed rows zeroed
    xq = data[1]
    D_t, I_t = t.search(xq, K)
    D_j, I_j = j.search(xq, K)
    _check_search(t, D_t, I_t, D_j, I_j, xq,
                  "f32" if storage == "pair" else storage, METRICS[0][0],
                  "after remove")
    with pytest.raises(IndexError):
        t.remove_ids([t.ntotal])
    assert t.remove_ids([]) == 0
    t.remove_ids(np.arange(t.ntotal))
    assert t.ntotal == 0 and t.is_trained


@pytest.mark.parametrize("storage", STORAGES + ["pair"])
def test_merge_from_matches_jax(data, tmp_path, storage):
    """Two halves merged equal one index built by the same adds, bit for
    bit in rows, norms and search results; faiss_tpu merged the same way
    gives the same ids."""
    xb, xq = data
    kw = dict(keep_master=False) if storage == "pair" else {}
    st = "f32" if storage == "pair" else storage
    paths = []
    for part in (xb[:4000], xb[4000:], xb):
        j = TpuIndexFlat(D, storage=st)
        if st == "int8":
            j.train(xb)                     # one scale grid for all three
        j.add(part)
        paths.append(str(tmp_path / f"{len(paths)}.npz"))
        jio.save_index(j, paths[-1])
    a, b, whole = (load_index(p, device="cpu", **kw) for p in paths)
    ja, jb = (jio.load_index(p, **kw) for p in paths[:2])
    a.merge_from(b)
    ja.merge_from(jb)
    assert b.ntotal == 0 and a.ntotal == NV
    np.testing.assert_array_equal(a.reconstruct_n(0, NV),
                                  whole.reconstruct_n(0, NV))
    np.testing.assert_array_equal(a.store.norms[:NV].numpy(),
                                  whole.store.norms[:NV].numpy())
    if a.store.split_stats is not None:
        np.testing.assert_array_equal(a.store.split_stats.numpy(),
                                      whole.store.split_stats.numpy())
        assert a.store.split_stats_host() == whole.store.split_stats_host()
    if st == "int8":
        assert float(a.store.int_norm_max) == float(whole.store.int_norm_max)
    D_a, I_a = a.search(xq, K)
    D_w, I_w = whole.search(xq, K)
    np.testing.assert_array_equal(I_a, I_w)
    np.testing.assert_array_equal(D_a, D_w)
    D_j, I_j = ja.search(xq, K)
    _check_search(a, D_a, I_a, D_j, I_j, xq, st, METRICS[0][0], "merged")


def test_merge_from_errors_and_int8_grid():
    a = TorchIndexFlat(D, device="cpu")
    with pytest.raises(ValueError):
        a.merge_from(a)
    with pytest.raises(ValueError):
        a.merge_from(TorchIndexFlat(D + 8, device="cpu"))
    with pytest.raises(ValueError):
        a.merge_from(TorchIndexFlat(D, metric="ip", device="cpu"))
    with pytest.raises(ValueError):
        a.merge_from(TorchIndexFlat(D, storage="bf16", device="cpu"))
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((300, D)).astype(np.float32)
    fresh, trained = (TorchIndexFlat(D, storage="int8", device="cpu")
                      for _ in range(2))
    trained.add(x1)
    fresh.merge_from(trained)               # an empty untrained store adopts
    assert fresh.is_trained and fresh.ntotal == 300
    other = TorchIndexFlat(D, storage="int8", device="cpu")
    other.add(x1 * 3)                       # another scale grid
    with pytest.raises(ValueError):
        fresh.merge_from(other)


# -- assign, search_and_reconstruct, vectors_numpy ---------------------------


@pytest.mark.parametrize("storage", STORAGES)
def test_assign_and_search_and_reconstruct_match_jax(saved, data, storage):
    j, t = _both(saved, storage, METRICS[0][1])
    xq = data[1]
    np.testing.assert_array_equal(t.assign(xq, 3), j.assign(xq, 3))
    np.testing.assert_array_equal(t.assign(xq[0]), t.search(xq[:1], 1)[1])
    few_t = ft.SearchParams(sel=ft.IDSelectorBatch([2, 77, 8000]))
    few_j = jsel.SearchParams(sel=jsel.IDSelectorBatch([2, 77, 8000]))
    D_t, I_t, R_t = t.search_and_reconstruct(xq, 5, params=few_t)
    D_j, I_j, R_j = j.search_and_reconstruct(xq, 5, params=few_j)
    np.testing.assert_array_equal(I_t, I_j)
    np.testing.assert_array_equal(R_t, R_j)        # the stored decode
    assert not R_t[:, 3:].any()                    # label -1: zeros
    keys = np.array([8191, 0, 17, 17])
    np.testing.assert_array_equal(t.store.reconstruct_batch(keys),
                                  np.stack([t.reconstruct(i) for i in keys]))
    with pytest.raises(IndexError):
        t.store.reconstruct_batch([NV])


@pytest.mark.parametrize("storage", STORAGES + ["pair"])
def test_vectors_numpy_matches_jax(saved, storage):
    kw = dict(keep_master=False) if storage == "pair" else {}
    path = saved("f32" if storage == "pair" else storage, METRICS[0][1])
    j, t = jio.load_index(path, **kw), load_index(path, device="cpu", **kw)
    got, want = t.vectors_numpy(), j.vectors_numpy()
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    assert TorchIndexFlat(D, device="cpu").vectors_numpy().shape == (0, D)


# -- range_search -----------------------------------------------------------


def _radius(xb, xq, metric, per_query):
    """A radius with about ``per_query`` hits a query and no score within
    100 ε of it: the fp64 distances' midpoint at a wide gap."""
    x64, q64 = xb.astype(np.float64), xq.astype(np.float64)
    if metric.value == "l2":
        s = np.sort(((q64[:, None, :] - x64[None]) ** 2).sum(-1).ravel())
    else:
        s = np.sort(-(q64 @ x64.T).ravel())
    i = per_query * len(xq)
    while s[i + 1] - s[i] < 2e-3 * max(1.0, abs(s[i])):
        i += 1
    r = (s[i] + s[i + 1]) / 2
    return r if metric.value == "l2" else -r


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("hits", [30, 1500])   # 1500 > RANGE_CAP0: a rerun
def test_range_search_matches_jax(saved, data, storage, metric, jmetric,
                                  hits):
    j, t = _both(saved, storage, jmetric)
    xb, xq = data
    # the stored rows the index ranks (the decode), for the radius's gap
    r = _radius(t.reconstruct_n(0, NV), xq, metric, hits)
    lims_t, D_t, I_t = t.range_search(xq, r)
    lims_j, D_j, I_j = j.range_search(xq, r)
    np.testing.assert_array_equal(lims_t, lims_j)
    assert lims_t[-1] > 0
    tol = TOL[storage] if metric.value == "l2" else 1e-2
    for q in range(len(xq)):
        seg = slice(lims_t[q], lims_t[q + 1])
        assert set(I_t[seg]) == set(I_j[seg])
        order = np.argsort(I_j[seg])
        np.testing.assert_array_equal(np.sort(I_t[seg]), I_j[seg][order])
        d_t = D_t[seg][np.argsort(I_t[seg])]
        np.testing.assert_allclose(d_t, D_j[seg][order], rtol=tol, atol=tol)
        best = D_t[seg]                     # best first
        assert (np.diff(best) >= 0).all() if metric.value == "l2" \
            else (np.diff(best) <= 0).all()
    if hits > 1024:
        assert (np.diff(lims_t) > 1024).any()


def test_range_search_selector_and_empty(saved, data):
    j, t = _both(saved, "f32", METRICS[0][1])
    xb, xq = data
    r = _radius(xb, xq, METRICS[0][0], 50)
    sel_t, _ = _selectors(ft)
    sel_j, _ = _selectors(jsel)
    lims_t, D_t, I_t = t.range_search(xq, r, params=ft.SearchParams(sel=sel_t))
    lims_j, D_j, I_j = j.range_search(xq, r, params=jsel.SearchParams(
        sel=sel_j))
    np.testing.assert_array_equal(lims_t, lims_j)
    np.testing.assert_array_equal(np.sort(I_t), np.sort(I_j))
    assert sel_t.is_member(I_t).all()
    empty = TorchIndexFlat(D, device="cpu")
    lims, _, I0 = empty.range_search(xq, r)
    assert lims.shape == (NQ + 1,) and not lims.any() and I0.size == 0
