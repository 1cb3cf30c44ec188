"""faiss_tpu_torch's IVF-Flat index against faiss_tpu's, on the CPU.

The JAX index is trained (k-means, then balancing; int8 also its scales)
and saved; the port loads the file, so both hold the same centroids and
scales and route every row to the same list. Then the same rows go into
both, in two batches, and every search runs in both packages: the JAX
fine scan through its Pallas kernel in interpret mode (K10, f32 rows
included), the port's through its kernels' plain versions. K10's f32-rows
plain version is also held against ``rescore_groups_pallas`` directly.

Tolerances (``tests/common.py``'s ladder: ``compare_results`` with the
f32-L2 rung 1e-3, the IP rung 1e-2, the reduced-precision rung 5e-2 for
bf16 and int8, top-1 ids equal), and tighter where both sides are
fp32-true scorings of the same stored rows: ids equal rank for rank except
near-ties within ε (``assert_ids_match``), distances within ε, where ε is
the rescore term of two fp32-true scorings (``rescore_term``, over the
JAX kernel's d_pad 128 chain: each side errs ≤ d·u·Q·V). On integer data
every score is exact, so ids, distances and range hits are equal, and
equal to the float64 numpy IVF oracle of ``tests/test_ivf.py``.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import faiss_tpu
from faiss_tpu import TpuIndexIVFFlat
from faiss_tpu import ivf as jivf
from faiss_tpu.ops import pallas_fused as pf
from faiss_tpu_torch import (IDSelectorBatch, IDSelectorRange, SearchParams,
                             TorchIndexIDMap2, TorchIndexIVFFlat, load_index,
                             save_index)
from faiss_tpu_torch import ivf as tivf
from faiss_tpu_torch.calls import ConcatSearchToken
from faiss_tpu_torch.ops import fused, kernels
from faiss_tpu_torch.ops.topk import topk_scores

from common import compare_results
from test_ivf import int_data, ivf_oracle
from test_torch_cuda import (BUDGET_CASES, assert_budget_select,
                             budget_rows, rescore_term,
                             rescore_term_rows)
from torch_parity import (METRIC_IDS, METRICS, assert_ids_match,
                          assert_within_eps)

torch.set_num_threads(2)

D, NLIST, NV, NQ, K = 24, 16, 3000, 12, 10
STORAGES = ["f32", "bf16", "int8"]
LADDER = {("f32", "l2"): 1e-3, ("f32", "ip"): 1e-2}   # else 5e-2


def mixture(n, nq, d, ncent=NLIST, seed=0):
    """Rows and queries around 5·N(0, 1) centres with N(0, 1) noise (the
    recipe of scripts/bench_ivf_r4.py at test size)."""
    rng = np.random.default_rng(seed)
    cent = (5.0 * rng.standard_normal((ncent, d))).astype(np.float32)
    xb = cent[rng.integers(0, ncent, n)] + rng.standard_normal((n, d))
    xq = cent[rng.integers(0, ncent, nq)] + rng.standard_normal((nq, d))
    return xb.astype(np.float32), xq.astype(np.float32)


def carry(jidx, path):
    """The port's copy of a JAX IVF index, through its saved file."""
    faiss_tpu.save_index(jidx, path)
    return load_index(path, device="cpu")


def eps_of(idx, xq):
    """(nq,) ε: the rescore term of two fp32-true scorings of idx's stored
    rows, over a d_pad 128 chain (the JAX kernel's)."""
    q = torch.zeros((len(xq), idx.d_pad))
    q[:, : idx.d] = torch.from_numpy(xq)
    if idx._scales is not None:
        q, v_max = q * idx._scales, idx._int8_qn
    else:
        v_max = torch.sqrt(torch.amax(idx._norms)) * fused._QUANT_V
    return rescore_term(q, v_max, idx._norms, idx._norms.shape[0], 128,
                        idx.metric).numpy()


def assert_search_matches(D_t, I_t, D_j, I_j, idx, xq, storage, metric, what):
    tol = LADDER.get((storage, metric.value), 5e-2)
    compare_results(D_t, I_t, D_j, I_j, dist_tol=tol, k=I_j.shape[1],
                    label=what)
    eps = eps_of(idx, xq)
    assert_ids_match(I_t, I_j, D_j, eps, what)
    fin = np.isfinite(D_j)
    assert (np.abs(np.where(fin, D_t - D_j, 0)) <= eps[:, None]).all(), what


@pytest.fixture(scope="module")
def data():
    return mixture(NV, NQ, D, seed=1)


@pytest.fixture(scope="module", params=[(s, m) for s in STORAGES
                                        for m in METRICS],
                ids=[f"{s}-{i}" for s in STORAGES for i in METRIC_IDS])
def pair(request, data, tmp_path_factory):
    """(JAX index, the port's copy) trained by JAX, carried through its
    saved file, then given the same two add batches."""
    storage, (metric, jmetric) = request.param
    xb, _ = data
    jidx = TpuIndexIVFFlat(D, NLIST, metric=jmetric, storage=storage,
                           nprobe=4, seed=3)
    jidx.train(xb)
    path = str(tmp_path_factory.mktemp("ivf") / "trained.npz")
    tidx = carry(jidx, path)
    assert tidx.ntotal == 0 and tidx.is_trained
    for part in (xb[:1700], xb[1700:]):
        jidx.add(part)
        tidx.add(part)
    return storage, metric, jidx, tidx


# -- the index against faiss_tpu -------------------------------------------


def test_add_routes_and_stores_as_jax(pair):
    """Two add batches: the same list for every row, the same list sizes
    and page layout, the stored rows bit for bit (int8 codes; bf16 bits;
    f32 rows), norms equal (f32 / bf16: the same f64 host sum) or within
    8 ulps (int8: decoded norms summed in another order, over d_pad 32
    against JAX's 128)."""
    storage, metric, jidx, tidx = pair
    np.testing.assert_array_equal(tidx._assignments(), jidx._assignments())
    np.testing.assert_array_equal(tidx.list_sizes(), jidx.list_sizes())
    np.testing.assert_array_equal(tidx._ctable_host, jidx._ctable_host)
    rows, norms = tidx._rows_by_id()
    jrows, jnorms = jidx._rows_by_id()
    rows = rows[:, :D]
    if storage == "bf16":
        rows = rows.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(np.asarray(rows), jrows)
    if storage == "int8":
        np.testing.assert_array_max_ulp(norms.numpy(), jnorms, maxulp=8)
        assert float(tidx._int8_qn) == float(jidx._int8_qn)
        assert "int8_clipped_fraction=0.00e+00" in tidx.describe()
    else:
        np.testing.assert_array_equal(norms.numpy(), jnorms)
    assert "bucket_load=" in tidx.describe()


@pytest.mark.parametrize("nprobe", [1, 4, NLIST])
def test_search_matches_jax(pair, data, nprobe):
    """Gather routes (nprobe 1, 4: K10 over the probed chunks) and the
    dense route (nprobe = nlist: f32 the plain sweep; bf16 / int8 the
    port's fused route, JAX's XLA sweep on this pool) against JAX, through
    search and search_async."""
    storage, metric, jidx, tidx = pair
    _, xq = data
    jidx.nprobe = tidx.nprobe = nprobe
    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = tidx.search(xq, K)
    assert I_t.dtype == np.int64 and D_t.dtype == np.float32
    assert_search_matches(D_t, I_t, D_j, I_j, tidx, xq, storage, metric,
                          f"{storage} {metric.value} nprobe={nprobe}")
    D_a, I_a = tidx.search_async(xq, K).wait()
    np.testing.assert_array_equal(I_a, I_t)
    np.testing.assert_array_equal(D_a, D_t)
    if nprobe == NLIST and storage != "f32":
        assert tidx.fused_fallbacks == 0


L2_PAIRS = dict(argnames="pair", indirect=True,
                argvalues=[(s, METRICS[0]) for s in STORAGES],
                ids=[f"{s}-l2" for s in STORAGES])


@pytest.mark.parametrize(**L2_PAIRS)
def test_nprobe_param_and_selector_match_jax(pair, data):
    """SearchParams(nprobe=...) overrides the index's width per call, and a
    selector filters inside the probed lists (gather and dense routes)."""
    storage, metric, jidx, tidx = pair
    from faiss_tpu import SearchParams as JParams
    from faiss_tpu import IDSelectorRange as JRange

    _, xq = data
    jidx.nprobe = tidx.nprobe = 1
    for npb in (3, NLIST):
        for sel in (None, (500, 2200)):
            p = SearchParams(IDSelectorRange(*sel) if sel else None,
                             nprobe=npb)
            jp = JParams(JRange(*sel) if sel else None, nprobe=npb)
            D_t, I_t = tidx.search(xq, K, params=p)
            D_j, I_j = jidx.search(xq, K, params=jp)
            assert_search_matches(D_t, I_t, D_j, I_j, tidx, xq, storage,
                                  metric, f"params nprobe={npb} sel={sel}")
            if sel:
                ok = I_t[I_t >= 0]
                assert ((ok >= 500) & (ok < 2200)).all()
    assert tidx.nprobe == 1


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_range_search_matches_jax(storage):
    """range_search in the probed lists (nprobe 3) and exhaustive (nprobe
    = nlist) against JAX on integer data: lims, ids and distances equal."""
    xb, xq = int_data(3000, 5, 16, seed=25)
    jidx = TpuIndexIVFFlat(16, NLIST, nprobe=3, storage=storage, seed=7)
    jidx.train(xb)
    jidx.add(xb)
    tidx = TorchIndexIVFFlat(16, NLIST, nprobe=3, storage=storage,
                             device="cpu")
    if storage == "int8":
        tidx._set_scales(np.asarray(jidx._scales)[:16])
    tidx._set_centroids(np.stack([jidx.quantizer.reconstruct(j)
                                  for j in range(NLIST)]))
    tidx.add(xb)
    d2 = ((xq.astype(np.float64)[:, None] - xb[None]) ** 2).sum(-1)
    rad = float(np.quantile(d2, 2e-2))
    for npb in (3, NLIST):
        tidx.nprobe = jidx.nprobe = npb
        lt, Dt, It = tidx.range_search(xq, rad)
        lj, Dj, Ij = jidx.range_search(xq, rad)
        np.testing.assert_array_equal(lt, lj)
        np.testing.assert_array_equal(It, Ij)
        if storage == "f32":
            np.testing.assert_array_equal(Dt, Dj)
        else:
            np.testing.assert_allclose(Dt, Dj, rtol=1e-5)
    assert lt[-1] > 0


@pytest.mark.parametrize(**L2_PAIRS)
def test_remove_ids_matches_jax(pair, data):
    """remove_ids on a copy of both (faiss's stable renumbering): the same
    list sizes, page layout, searches and reconstructs."""
    storage, metric, jidx, tidx = pair
    xb, xq = data
    j2 = TpuIndexIVFFlat(D, NLIST, metric=jidx.metric, storage=storage,
                         nprobe=4, seed=3)
    j2.quantizer = None
    if storage == "int8":
        j2._scales = jidx._scales
    j2._set_centroids(np.stack([jidx.quantizer.reconstruct(j)
                                for j in range(NLIST)]),
                      quantizer=jidx.quantizer)
    j2.add(xb)
    t2 = TorchIndexIVFFlat(D, NLIST, metric=metric, storage=storage,
                           nprobe=4, device="cpu")
    if storage == "int8":
        t2._set_scales(tidx._scales.numpy()[:D])
    t2._set_centroids(tidx._centroids)
    t2.add(xb)
    rm = np.arange(0, NV, 4)
    assert t2.remove_ids(rm) == j2.remove_ids(rm) == rm.size
    assert t2.ntotal == j2.ntotal == NV - rm.size
    np.testing.assert_array_equal(t2.list_sizes(), j2.list_sizes())
    np.testing.assert_array_equal(t2._ctable_host, j2._ctable_host)
    np.testing.assert_array_equal(t2._slot_of, j2._slot_of)
    D_t, I_t = t2.search(xq, K)
    D_j, I_j = j2.search(xq, K)
    assert_search_matches(D_t, I_t, D_j, I_j, t2, xq, storage, metric,
                          "after remove_ids")
    for i in (0, 1, t2.ntotal - 1):
        np.testing.assert_array_equal(t2.reconstruct(i), j2.reconstruct(i))
    t2.remove_ids(np.arange(t2.ntotal))
    assert t2.ntotal == 0 and t2.is_trained
    assert (t2.search(xq, 3)[1] == -1).all()
    with pytest.raises(IndexError):
        t2.remove_ids([t2.ntotal])


@pytest.mark.parametrize("storage", STORAGES)
def test_merge_from_matches_jax(storage, tmp_path):
    """merge_from of two indexes sharing centroids (and scales) equals one
    index built by the same adds, bit for bit, and JAX's merge."""
    xb, xq = int_data(3000, 6, 16, seed=61)
    ja = TpuIndexIVFFlat(16, 8, nprobe=3, storage=storage, seed=3)
    ja.train(xb)
    ta, tb, one = (carry(ja, str(tmp_path / "a.npz")) for _ in range(3))
    jb = TpuIndexIVFFlat(16, 8, nprobe=3, storage=storage, seed=3)
    jb.quantizer = None
    if storage == "int8":
        jb._scales = ja._scales
    jb._set_centroids(np.stack([ja.quantizer.reconstruct(j)
                                for j in range(8)]), quantizer=ja.quantizer)
    ja.add(xb[:1800])
    jb.add(xb[1800:])
    ja.merge_from(jb)
    ta.add(xb[:1800])
    tb.add(xb[1800:])
    one.add(xb)
    ta.merge_from(tb)
    assert ta.ntotal == 3000 and tb.ntotal == 0
    for npb in (3, 8):
        ta.nprobe = one.nprobe = ja.nprobe = npb
        D_m, I_m = ta.search(xq, 7)
        D_o, I_o = one.search(xq, 7)
        np.testing.assert_array_equal(I_m, I_o)
        np.testing.assert_array_equal(D_m, D_o)
        np.testing.assert_array_equal(I_m, ja.search(xq, 7)[1])
    np.testing.assert_array_equal(ta.reconstruct(2999), one.reconstruct(2999))
    with pytest.raises(ValueError):
        ta.merge_from(ta)
    with pytest.raises(ValueError):
        ta.merge_from(TorchIndexIVFFlat(16, 4, storage=storage, device="cpu"))


@pytest.mark.parametrize("storage", STORAGES)
def test_io_both_directions(storage, tmp_path):
    """A faiss_tpu file loads into the port (rows restored into their
    saved lists, never re-routed) and searches as the JAX index; the
    port's file loads into faiss_tpu and searches the same; an IDMap2
    wrapper survives with its ids; after remove_ids too."""
    xb, xq = mixture(2000, 8, D, seed=5)
    jidx = TpuIndexIVFFlat(D, NLIST, storage=storage, nprobe=5, seed=4)
    jidx.train(xb)
    jidx.add(xb)
    jidx.remove_ids(np.arange(0, 2000, 7))
    tidx = carry(jidx, str(tmp_path / "j.npz"))
    assert tidx.nprobe == 5 and tidx.ntotal == jidx.ntotal
    np.testing.assert_array_equal(tidx._assignments(), jidx._assignments())
    D_j, I_j = jidx.search(xq, K)
    D_t, I_t = tidx.search(xq, K)
    assert_search_matches(D_t, I_t, D_j, I_j, tidx, xq, storage,
                          tidx.metric, "JAX file → port")
    p = str(tmp_path / "t.npz")
    save_index(tidx, p)
    back = faiss_tpu.load_index(p)
    np.testing.assert_array_equal(back._assignments(), jidx._assignments())
    D_b, I_b = back.search(xq, K)
    np.testing.assert_array_equal(I_b, I_j)
    np.testing.assert_array_equal(D_b, D_j)
    again = load_index(p, device="cpu")
    D_a, I_a = again.search(xq, K)
    np.testing.assert_array_equal(I_a, I_t)
    np.testing.assert_array_equal(D_a, D_t)
    with np.load(p) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["kind"] == "ivf" and meta["nlist"] == NLIST
    w = TorchIndexIDMap2(TorchIndexIVFFlat(D, NLIST, storage=storage,
                                           nprobe=NLIST, device="cpu"))
    w.index._set_centroids(tidx._centroids)
    if storage == "int8":
        w.index._set_scales(tidx._scales.numpy()[:D])
    w.add_with_ids(xb, 10 * np.arange(2000) + 1)
    save_index(w, p)
    jw = faiss_tpu.load_index(p)
    w2 = load_index(p, device="cpu")
    assert isinstance(w2, TorchIndexIDMap2)
    for x in (w2, jw):
        np.testing.assert_array_equal(x.search(xq, K)[1], w.search(xq, K)[1])
    np.testing.assert_array_equal(w2.reconstruct(10 * 77 + 1),
                                  w.reconstruct(10 * 77 + 1))


def test_untrained_file_and_empty_index(tmp_path):
    xb, xq = mixture(500, 4, D)
    t = TorchIndexIVFFlat(D, 4, device="cpu")
    with pytest.raises(ValueError):
        save_index(t, str(tmp_path / "x.npz"))   # untrained
    t.train(xb)
    tok = t.search_async(xq, 4)
    assert tok.is_ready()
    De, Ie = tok.wait()
    assert (Ie == -1).all() and np.isinf(De).all()
    save_index(t, str(tmp_path / "e.npz"))
    e = load_index(str(tmp_path / "e.npz"), device="cpu")
    assert e.ntotal == 0 and e.is_trained


# -- the port's own routes ----------------------------------------------------


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_integer_data_exact_against_numpy_oracle(storage):
    """The port trains itself (Kmeans, balancing); on integer data every
    score is exact: the per-query sets and distances of the float64 IVF
    oracle over the same probed lists (``tests/test_ivf.py``)."""
    xb, xq = int_data(4000, 8, 16, seed=1, hi=16)
    ix = TorchIndexIVFFlat(16, 16, nprobe=4, storage=storage, seed=3,
                           device="cpu")
    ix.train(xb)
    ix.add(xb)
    D_t, I_t = ix.search(xq, 5)
    refD, refI = ivf_oracle(ix, xb, xq, 5, 4)
    for qi in range(8):
        assert set(I_t[qi]) == set(refI[qi]), qi
    np.testing.assert_array_equal(np.sort(D_t, 1), np.sort(refD, 1))


def test_training_matches_jax():
    """TorchIndexIVFFlat.train against TpuIndexIVFFlat.train on separated
    integer-centred data with one heavy component: the same balanced
    centroids (rtol 1e-5) and list sizes, the cap held, and balance=0
    keeping k-means' skew."""
    rng = np.random.default_rng(5)
    ncomp, d, k, n = 64, 16, 16, 8000
    cents = rng.integers(-8, 8, (ncomp, d)).astype(np.float32) * 4
    w = rng.dirichlet(np.full(ncomp, 0.25))
    xb = (cents[rng.choice(ncomp, n, p=w)]
          + rng.integers(-1, 2, (n, d))).astype(np.float32)
    j = TpuIndexIVFFlat(d, k, nprobe=4, seed=3)
    t = TorchIndexIVFFlat(d, k, nprobe=4, seed=3, device="cpu")
    raw = TorchIndexIVFFlat(d, k, nprobe=4, seed=3, balance=0, device="cpu")
    for ix in (j, t, raw):
        ix.train(xb)
        ix.add(xb)
    jc = np.stack([j.quantizer.reconstruct(i) for i in range(k)])
    np.testing.assert_allclose(t._centroids, jc, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.list_sizes(), j.list_sizes())
    assert t.list_sizes().max() < raw.list_sizes().max()
    assert t.list_sizes().max() <= 3.0 * n / k
    np.testing.assert_array_equal(t.quantizer.reconstruct(0), t._centroids[0])


def test_batch_split_matches_unsplit(monkeypatch):
    """A batch past the gather budget's query cap splits into row chunks
    (a ConcatSearchToken, all enqueued up front) with results equal to
    the unsplit search."""
    xb, xq = int_data(4000, 24, 16, seed=77)
    ix = TorchIndexIVFFlat(16, 16, nprobe=4, seed=3, device="cpu")
    ix.train(xb)
    ix.add(xb)
    D0, I0 = ix.search(xq, 5)
    nbudget = tivf._chunk_budget(ix._counts, 4)
    monkeypatch.setattr(tivf, "_GATHER_BUDGET",
                        nbudget * tivf._CHUNK * 4 * 8)
    assert ix._nq_cap(4) == 8 and ix._nq_cap(16) is None
    tok = ix.search_async(xq, 5)
    assert isinstance(tok, ConcatSearchToken) and len(tok._toks) == 3
    D1, I1 = tok.wait()
    assert tok.is_ready()
    np.testing.assert_array_equal(I0, I1)
    np.testing.assert_array_equal(D0, D1)
    np.testing.assert_array_equal(I0, ix.search(xq, 5)[1])


def test_the_chunk_budget_is_kept_until_a_mutation():
    """``_budget`` works the chunk budget out once per nprobe and keeps it
    until the index changes: it equals ``_chunk_budget`` of the list sizes,
    a search reads the kept one, and an add or a remove_ids clears it."""
    xb, xq = mixture(3000, 4, D, seed=21)
    ix = TorchIndexIVFFlat(D, NLIST, nprobe=2, device="cpu")
    ix.train(xb)
    ix.add(xb[:1000])
    assert ix._budgets == {}
    for nprobe in (1, 4, NLIST):
        assert ix._budget(nprobe) == tivf._chunk_budget(ix.list_sizes(),
                                                        nprobe)
    assert sorted(ix._budgets) == [1, 4, NLIST]
    ix._budgets[4] += 1               # a kept budget is what a search reads
    assert ix._prep_search(xq, SearchParams(nprobe=4))[4] == ix._budget(4)
    for mutate in (lambda: ix.add(xb[1000:]),
                   lambda: ix.remove_ids(np.arange(0, 1500, 2))):
        mutate()
        assert ix._budgets == {}
        for nprobe in (1, 4, NLIST):
            assert ix._budget(nprobe) == tivf._chunk_budget(
                ix.list_sizes(), nprobe)


def twin(ix):
    """An empty index with ``ix``'s centroids (and int8 scales)."""
    t = TorchIndexIVFFlat(ix.d, ix.nlist, metric=ix.metric,
                          storage=ix.storage_type, nprobe=ix.nprobe,
                          device="cpu")
    if ix._scales is not None:
        t._set_scales(ix._scales.numpy()[: ix.d])
    t._set_centroids(ix._centroids)
    return t


def premask_of(ix, sel=None):
    """The norm stream the fine scan built on every call before the index
    kept it: ``fused._premask_norms`` of the pool's norms with the slot
    validity (and the slot selector ``sel``) folded in."""
    nslots = ix._ids.shape[0]
    ok = ix._ids >= 0
    return fused._premask_norms(ix._norms, nslots, nslots, ix.metric,
                                ok if sel is None else ok & sel)


def assert_same_bits(a, b, what):
    assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, what
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), what


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", [m for m, _ in METRICS], ids=METRIC_IDS)
def test_the_norm_stream_follows_every_mutation(storage, metric):
    """The fine scan's norm stream is index state: after an add that grows
    the pool, a second add, remove_ids and merge_from it equals the
    per-call premask of the pool's norms and ids bit for bit; an empty
    pool (before the first add, after reset) has none."""
    xb, _ = mixture(3000, 4, D, seed=31)
    ix = TorchIndexIVFFlat(D, NLIST, metric=metric, storage=storage,
                           nprobe=4, device="cpu")
    ix.train(xb)
    assert ix._vn is None
    ix.add(xb[:400])
    assert ix.npool > 0
    assert_same_bits(ix._vn, premask_of(ix), "first add")
    npool = ix.npool
    ix.add(xb[400:2000])
    assert ix.npool > npool
    assert_same_bits(ix._vn, premask_of(ix), "second add")
    ix.remove_ids(np.arange(0, 2000, 3))
    assert (ix._ids < 0).any()
    assert_same_bits(ix._vn, premask_of(ix), "remove_ids")
    other = twin(ix)
    other.add(xb[2000:])
    ix.merge_from(other)
    assert_same_bits(ix._vn, premask_of(ix), "merge_from")
    assert other._vn is None
    ix.reset()
    assert ix._vn is None


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", [m for m, _ in METRICS], ids=METRIC_IDS)
def test_the_norm_stream_is_built_once_a_generation(storage, metric,
                                                    monkeypatch):
    """Searches without a selector read the kept stream and build nothing;
    each mutation builds it once. After remove_ids the search returns no
    removed row and equals a fresh index over the kept rows (no stale
    stream); with an IDSelectorBatch, K10 reads the per-call premask of
    the occupancy and the selector, bit for bit, and the answers are
    those of that premask."""
    xb, xq = mixture(3000, 8, D, seed=32)
    ix = TorchIndexIVFFlat(D, NLIST, metric=metric, storage=storage,
                           nprobe=4, device="cpu")
    ix.train(xb)
    assert ix.norm_stream_builds == 0
    ix.add(xb[:2000])
    assert ix.norm_stream_builds == 1
    for _ in range(3):
        ix.search(xq, K)
    assert ix.norm_stream_builds == 1
    rm = np.arange(0, 2000, 3)
    ix.remove_ids(rm)
    assert ix.norm_stream_builds == 2
    keep = np.setdiff1d(np.arange(2000), rm)
    fresh = twin(ix)
    fresh.add(xb[keep])
    D_r, I_r = ix.search(xq, K)
    D_f, I_f = fresh.search(xq, K)
    assert (I_r >= 0).all() and not np.isin(keep[I_r], rm).any()
    np.testing.assert_array_equal(I_r, I_f)
    np.testing.assert_array_equal(D_r, D_f)

    ids = np.arange(1, ix.ntotal, 2)
    slot_sel = torch.zeros(ix._ids.shape[0], dtype=torch.bool)
    slot_sel[torch.from_numpy(ix._slot_of[ids])] = True
    want = premask_of(ix, slot_sel)
    real, seen = kernels.rescore_groups, []

    def spy(q, db, vn, gidx, **kw):
        seen.append(vn)
        return real(q, db, vn, gidx, **kw)

    params = SearchParams(IDSelectorBatch(ids))
    monkeypatch.setattr(kernels, "rescore_groups", spy)
    D_s, I_s = ix.search(xq, K, params=params)
    assert len(seen) == 1
    assert_same_bits(seen[0], want, "selector stream")
    monkeypatch.setattr(kernels, "rescore_groups",
                        lambda q, db, vn, gidx, **kw: real(q, db, want, gidx,
                                                           **kw))
    D_o, I_o = ix.search(xq, K, params=params)
    monkeypatch.undo()
    np.testing.assert_array_equal(I_s, I_o)
    np.testing.assert_array_equal(D_s, D_o)
    assert np.isin(I_s[I_s >= 0], ids).all()
    assert ix.norm_stream_builds == 2

    other = twin(ix)
    other.add(xb[2000:])
    builds = other.norm_stream_builds
    ix.merge_from(other)
    assert ix.norm_stream_builds == 3
    assert other.norm_stream_builds == builds and other._vn is None
    ix.add(xb[:10])
    assert ix.norm_stream_builds == 4
    ix.search(xq, K)
    ix.reset()
    assert ix.norm_stream_builds == 4 and ix._vn is None


@pytest.mark.parametrize("nbudget", [1, 5, 1024, 1280])
@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("case", BUDGET_CASES)
def test_budget_select_plain_is_the_masked_total_order_top_k(case, k,
                                                             nbudget):
    """The fine scan's top-k (``kernels.budget_select`` on the CPU, its
    plain version) against the numpy contract and the masked stable sort
    it replaced, bit for bit: ties across chunk edges, ±0.0, ±inf, ±NaN
    (whole rows of the bits 0xffffffff and 0x7fffffff), all-dead rows and
    rows with fewer than k live finite columns."""
    s, okc = budget_rows(case, 6, nbudget, seed=nbudget + k)
    v, p = kernels.budget_select(s, okc, k)
    assert_budget_select(v, p, s, okc, k, f"{case} k={k} nbudget={nbudget}")
    v_s, p_s = topk_scores(
        s.masked_fill(~okc.repeat_interleave(tivf._CHUNK, 1), float("-inf")),
        k)
    assert torch.equal(v.view(torch.int32), v_s.view(torch.int32))
    assert torch.equal(p, p_s)
    assert kernels.launches["budget_select"] == 0


@pytest.mark.parametrize("k", [1, 10, 40, 41])
def test_fine_scan_top_k_routes_by_k(k, monkeypatch):
    """k ≤ 40 ranks the budget through ``kernels.budget_select``, k 41
    through the masked stable sort (``budget_select_plain`` called
    directly); on integer data either gives the float64 IVF oracle's
    distances, and its ids up to ties at the k-th distance."""
    xb, xq = int_data(4000, 8, 16, seed=5, hi=16)
    ix = TorchIndexIVFFlat(16, 16, nprobe=4, seed=3, device="cpu")
    ix.train(xb)
    ix.add(xb)
    calls = {"budget_select": [], "budget_select_plain": []}
    for name in calls:
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name,
                            lambda s, okc, kk, fn=fn, name=name:
                            calls[name].append(kk) or fn(s, okc, kk))
    D_t, I_t = ix.search(xq, k)
    assert calls["budget_select"] == ([k] if k <= 40 else [])
    assert calls["budget_select_plain"] == [k]
    refD, refI = ivf_oracle(ix, xb, xq, k, 4)
    np.testing.assert_array_equal(D_t, refD)
    for qi in range(len(xq)):
        below = refD[qi] < refD[qi, -1]
        assert set(I_t[qi][below]) == set(refI[qi][below]), qi


def test_skewed_lists_budget_and_chunk_layout():
    """One list holds ~70 % of the rows (true centres installed, as in
    ``tests/test_ivf.py``): the chunk budget equals JAX's, the per-query
    chunk layout equals JAX's ``_chunk_ids``, results equal the oracle's
    over the probed lists, and the exhaustive probe the flat sets."""
    rng = np.random.default_rng(43)
    n = 6000
    comp = np.where(rng.random(n) < 0.7, 0, rng.integers(1, 16, n))
    cents = 30.0 * rng.standard_normal((16, 12)).astype(np.float32)
    xb = (cents[comp] + rng.standard_normal((n, 12))).astype(np.float32)
    xq = (cents[rng.integers(0, 16, 5)]
          + rng.standard_normal((5, 12))).astype(np.float32)
    ix = TorchIndexIVFFlat(12, 16, nprobe=3, device="cpu")
    ix._set_centroids(cents)
    ix.add(xb)
    sizes = ix.list_sizes()
    assert sizes.max() > 4 * np.median(sizes[sizes > 0])
    for npb in (1, 3, 7, 16):
        assert (tivf._chunk_budget(sizes, npb)
                == jivf._chunk_budget(sizes, npb, jivf._CHUNK))
    for b in range(1, 300):
        assert tivf._round_budget(b) == jivf._round_budget(b)
    nb = tivf._chunk_budget(sizes, 3)
    probe = np.stack([rng.permutation(16)[:3] for _ in range(9)])
    probe[0] = [0, 0, 5]                  # a repeated list
    c_t, ok_t = tivf._chunk_ids(torch.from_numpy(probe.astype(np.int32)),
                                ix._counts_dev, ix._ctable, nb)
    c_j, ok_j = jivf._chunk_ids(jnp.asarray(probe, jnp.int32),
                                jnp.asarray(ix._counts), jnp.asarray(
                                    ix._ctable_host), jivf._CHUNK, nb, 3)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    D_t, I_t = ix.search(xq, 6)
    refD, refI = ivf_oracle(ix, xb, xq, 6, 3)
    for qi in range(5):
        assert set(I_t[qi][I_t[qi] >= 0]) == set(refI[qi][refI[qi] >= 0])
    ix.nprobe = 16
    _, If = ix.search(xq, 6)
    d2 = ((xq.astype(np.float64)[:, None] - xb[None]) ** 2).sum(-1)
    for qi in range(5):
        assert set(If[qi]) == set(np.argsort(d2[qi], kind="stable")[:6])


@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_rescore_f32_plain_matches_pallas(metric, jmetric):
    """K10's f32-rows mode: the plain version (one fp32 product against
    the stored rows) against ``rescore_groups_pallas`` with f32 rows in
    interpret mode (nine exact bf16 passes), on IVF-style chunk ids (any
    order, repeats, dead positions at chunk 0) and an empty-slot mask,
    within the rescore term of each entry's own row (d·u·Q·‖v‖ each side;
    the rung of two fp32-true scorings). The huge row does not loosen the
    bound of the Gaussian rows: the plain version with the last 4 elements
    of d dropped breaks it on most entries."""
    rng = np.random.default_rng(9)
    npool, nq, nb = 12, 8, 10
    rows = rng.standard_normal((npool * 128, 128)).astype(np.float32)
    rows[5] = 2.0 ** 20
    occ = rng.random(npool * 128) > 0.2
    rows[~occ] = 0.0
    norms = (rows.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.standard_normal((nq, 128)).astype(np.float32)
    g = rng.integers(0, npool, (nq, nb)).astype(np.int32)
    g[:, -3:] = 0
    nv = npool * 128
    s_j = pf.rescore_groups_pallas(
        jnp.asarray(q), jnp.asarray(rows), jnp.asarray(norms),
        jnp.asarray(g), jnp.int32(nv), metric=jmetric, nv_eff=nv,
        interpret=True, ranks_per_step=2, sel=jnp.asarray(occ))
    n_t = torch.from_numpy(norms)
    vn = fused._premask_norms(n_t, nv, nv, metric, torch.from_numpy(occ))
    s_t = kernels.rescore_groups(torch.from_numpy(q), torch.from_numpy(rows),
                                 vn, torch.from_numpy(g), metric=metric)
    assert s_t.shape == (nq, nb * 128)
    eps = rescore_term_rows(torch.from_numpy(q), torch.from_numpy(rows),
                            torch.from_numpy(g), 128, metric).numpy()
    assert_within_eps(s_t.numpy().ravel(), np.asarray(s_j).ravel(),
                      eps.ravel(), "f32 rescore")
    cut = rows.copy()
    cut[:, -4:] = 0.0
    s_cut = kernels.rescore_groups(torch.from_numpy(q), torch.from_numpy(cut),
                                   vn, torch.from_numpy(g),
                                   metric=metric).numpy()
    fin = np.isfinite(s_j)
    assert (np.abs(s_cut - np.asarray(s_j)) > eps)[fin].mean() > 0.5
    empty = ~occ.reshape(npool, 128)[g].reshape(nq, -1)
    assert np.isneginf(s_t.numpy()[empty]).all()


def test_dense_fused_fallback_reruns_on_the_plain_sweep():
    """Duplicated rows tie every score: the bf16 dense fused route's
    certificate fails, wait() re-runs those queries on the plain dense
    sweep (fused_fallbacks 1), and the result equals that sweep's."""
    row = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    xb = np.tile(row, (3000, 1))
    xb[:64] += np.random.default_rng(2).standard_normal((64, D)) * 3
    xq = np.random.default_rng(3).standard_normal((8, D)).astype(np.float32)
    ix = TorchIndexIVFFlat(D, 4, nprobe=4, storage="bf16", device="cpu")
    ix.train(xb[:64])
    ix.add(xb)
    D1, I1 = ix.search(xq, K)
    assert ix.fused_fallbacks >= 1
    packed, nq, fb, _ = ix._search_packed(xq, K, force_plain_dense=True)
    assert fb is None
    np.testing.assert_array_equal(I1, packed[:nq, K:2 * K].contiguous().view(
        torch.int32).numpy())


def test_errors_and_small_surface():
    xb, xq = mixture(700, 3, D, seed=15)
    with pytest.raises(ValueError):
        TorchIndexIVFFlat(D, 4, storage="f16", device="cpu")
    with pytest.raises(ValueError):
        TorchIndexIVFFlat(0, 4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchIndexIVFFlat(D, 4)              # the default device is cuda
    ix = TorchIndexIVFFlat(D, 32, nprobe=1, train_niter=4, device="cpu")
    with pytest.raises(RuntimeError):
        ix.add(xb)
    with pytest.raises(RuntimeError):
        ix.search(xq, 3)
    with pytest.warns(UserWarning):
        ix.train(xb)
    ix.add(xb)
    D_, I_ = ix.search(xq, 200)           # k > any probed list
    assert (I_[:, -1] == -1).all() and np.isinf(D_[I_ == -1]).all()
    with pytest.raises(ValueError):
        ix.search(xq, 0)
    with pytest.raises(ValueError):
        ix.search(xq[:, :5], 3)
    with pytest.raises(ValueError):
        ix.search(xq, 3, params=SearchParams(nprobe=0))
    np.testing.assert_allclose(ix.reconstruct(123), xb[123], rtol=0)
    with pytest.raises(IndexError):
        ix.reconstruct(700)
    np.testing.assert_array_equal(ix.assign(xq, 2), ix.search(xq, 2)[1])
    assert ix.list_sizes().sum() == 700 and ix.pool_bytes() > 0
    ix.reset()
    assert ix.ntotal == 0 and ix.is_trained
    ix.add(xb[:100])
    assert ix.ntotal == 100
