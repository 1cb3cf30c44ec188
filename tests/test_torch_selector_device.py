"""The selectors' device form against their host form, and filtered search
through it against faiss_tpu and against the host evaluation, on the CPU.

``IDSelector.device_member`` evaluates a selector over an id tensor with
torch operations; it must return ``is_member``'s mask bit for bit, over
negative ids, ids past the index, duplicates, empty sets and masks shorter
or longer than the index, nested under Not, And and Or. Every index class
evaluates it over the id vector it keeps on its devices; a selector with
no device form (a user subclass with ``is_member`` alone, ``HostOnly``
here) goes the host way, which is the evaluation the port ran before the
device form: the two must give the same answers bit for bit, and the ids
of faiss_tpu's index for the same selector (``assert_ids_match``; the data
are small integers, so every score is exact and only equal distances may
swap). The counters ``sel.uploads`` and ``sel.host_evals`` are read under
the CPU's profiler.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import faiss_tpu
from faiss_tpu import ShardedIndexFlat as JShardedFlat
from faiss_tpu import ShardedIndexIVFFlat as JShardedIVF
from faiss_tpu import TpuIndexFlat, TpuIndexIDMap, TpuIndexIVFFlat
from faiss_tpu import selector as jsel
import faiss_tpu_torch as ft
from faiss_tpu_torch import (ShardedIndexFlat, TorchIndexFlat,
                             TorchIndexIDMap, load_index, tracing)

from torch_parity import METRIC_IDS, METRICS, assert_ids_match

torch.set_num_threads(2)

D, NV, NQ, NLIST = 16, 3000, 5, 16
EDGE = np.array([-2 ** 63, -7, -1, 0, 1, 2, 3, 5, 7, 8, 9, 17, 999, 2999,
                 3000, 3001, 5000, 2 ** 40, 2 ** 63 - 1, 3, 3, 0],
                dtype=np.int64)


class HostOnly(ft.IDSelector):
    """A user selector with ``is_member`` alone: no device form."""

    def __init__(self, sel):
        self.sel = sel

    def is_member(self, ids):
        return self.sel.is_member(ids)


def _kinds(m):
    """(name, selector) of every kind and nesting, from module ``m``
    (faiss_tpu_torch or faiss_tpu's selector module)."""
    batch = [3, 3, 999, -7, 2999, 3000, 5000, 2 ** 63 - 1, 17]
    short = np.arange(10) % 3 == 0
    long_ = np.arange(4000) % 5 != 1
    return [
        ("range", m.IDSelectorRange(2, 999)),
        ("range_empty", m.IDSelectorRange(9, 9)),
        ("range_reversed", m.IDSelectorRange(9, 2)),
        ("range_negative", m.IDSelectorRange(-8, 4)),
        ("range_wide", m.IDSelectorRange(-2 ** 70, 2 ** 70)),
        ("range_past_int64", m.IDSelectorRange(5, 2 ** 64)),
        ("batch", m.IDSelectorBatch(batch)),
        ("batch_empty", m.IDSelectorBatch([])),
        ("batch_one", m.IDSelectorBatch([0])),
        ("mask_short", m.IDSelectorMask(short)),
        ("mask_long", m.IDSelectorMask(long_)),
        ("mask_empty", m.IDSelectorMask(np.zeros(0, bool))),
        ("not_batch", m.IDSelectorNot(m.IDSelectorBatch(batch))),
        ("and", m.IDSelectorAnd(m.IDSelectorRange(0, 2500),
                                m.IDSelectorNot(m.IDSelectorBatch(batch)))),
        ("or", m.IDSelectorOr(m.IDSelectorMask(short),
                              m.IDSelectorRange(2990, 3005),
                              m.IDSelectorBatch([-7, 17]))),
        ("nested", m.IDSelectorNot(m.IDSelectorOr(
            m.IDSelectorAnd(m.IDSelectorRange(0, 2000),
                            m.IDSelectorMask(long_)),
            m.IDSelectorNot(m.IDSelectorRange(-10, 2900))))),
    ]


KINDS = [name for name, _ in _kinds(ft)]


def _sel(name, m=ft):
    return dict(_kinds(m))[name]


@pytest.mark.parametrize("name", KINDS)
def test_device_form_equals_is_member(name):
    sel = _sel(name)
    assert sel.has_device_form()
    want = sel.is_member(EDGE)
    got = sel.device_member(torch.from_numpy(EDGE))
    assert got.dtype == torch.bool and got.shape == EDGE.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _sel(name, jsel).is_member(EDGE))
    # an int32 id vector (the IVF slot maps, the shards' gid columns)
    small = EDGE[(EDGE >= -2 ** 31) & (EDGE < 2 ** 31)]
    got = sel.device_member(torch.from_numpy(small.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(), sel.is_member(small))
    # the host decision is sound where it decides
    for lo, hi in [(0, 0), (0, 9), (0, NV), (2, 999), (-8, 4), (3000, 3005)]:
        if sel.covers(lo, hi):
            assert sel.is_member(np.arange(lo, hi)).all(), (lo, hi)


@pytest.mark.parametrize("name", KINDS)
def test_positional_equals_is_member(name):
    """The stream over the positions [0, n) (a flat index's) is
    ``is_member`` over them; a Batch keeps it while n stands."""
    sel = _sel(name)
    cpu = torch.device("cpu")
    for n in (0, 1, 9, 17, NV + 7):
        got = sel.positional(n, cpu)
        assert got.dtype == torch.bool and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(),
                                      sel.is_member(np.arange(n)))
        if isinstance(sel, ft.IDSelectorBatch):
            assert sel.positional(n, cpu) is got


def test_covers_decides_the_simple_kinds():
    assert ft.IDSelectorRange(0, NV).covers(0, NV)
    assert not ft.IDSelectorRange(1, NV).covers(0, NV)
    assert ft.IDSelectorBatch(np.arange(NV)).covers(0, NV)
    assert not ft.IDSelectorBatch(np.arange(1, NV + 1)).covers(0, NV)
    # the other kinds are not decided: the filtered search gives the same
    # answer as the unfiltered one
    assert not ft.IDSelectorMask(np.ones(NV + 4, bool)).covers(0, NV)
    assert not (~ft.IDSelectorBatch([])).covers(0, NV)
    assert not ft.IDSelectorOr(ft.IDSelectorBatch([1]),
                               ft.IDSelectorRange(0, NV)).covers(0, NV)
    # an empty range of ids is covered by every selector
    assert ft.IDSelectorBatch([]).covers(5, 5)


def test_a_user_subclass_has_no_device_form():
    assert not HostOnly(ft.IDSelectorRange(0, 5)).has_device_form()
    assert not ft.IDSelectorNot(HostOnly(ft.IDSelectorRange(0, 5))) \
        .has_device_form()
    with pytest.raises(TypeError):
        HostOnly(ft.IDSelectorRange(0, 5)).device_member(torch.arange(4))

    class Overrides(ft.IDSelectorBatch):
        def is_member(self, ids):
            return ~super().is_member(ids)

    assert not Overrides([1]).has_device_form()


def test_the_kept_arrays_are_read_only():
    src = np.array([5, 1, 3], np.int64)
    batch = ft.IDSelectorBatch(src)
    with pytest.raises(ValueError):
        batch.ids[0] = 2
    with pytest.raises(AttributeError):
        batch.ids = np.array([2])
    src[:] = 0
    np.testing.assert_array_equal(batch.ids, [1, 3, 5])
    flags = np.array([True, False, True])
    mask = ft.IDSelectorMask(flags)
    with pytest.raises(ValueError):
        mask.mask[1] = True
    flags[1] = True          # the caller's array is not the kept one
    np.testing.assert_array_equal(mask.device_member(torch.arange(3)),
                                  [True, False, True])


# -- filtered search --------------------------------------------------------


def int_data(nv=NV, nq=NQ, seed=0):
    """Small integers: every score exact in fp32 and f16."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, (nv, D)).astype(np.float32),
            rng.integers(0, 16, (nq, D)).astype(np.float32))


XB, XQ = int_data()
# (port, faiss_tpu) selectors of the filtered searches
SELECTIONS = [("batch", ft.IDSelectorBatch(np.arange(1, NV, 7)),
               jsel.IDSelectorBatch(np.arange(1, NV, 7))),
              ("nested", _sel("nested"), _sel("nested", jsel))]


def _host(sel):
    return ft.SearchParams(sel=HostOnly(sel))


def _same(a, b, what):
    """Two answers of the port equal bit for bit."""
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _admitted(sel, ids, what):
    ok = ids[ids >= 0]
    assert sel.is_member(ok).all(), what


def _matches_jax(t_out, j_out, what):
    (_, I_t), (D_j, I_j) = t_out, j_out
    assert_ids_match(I_t, I_j, D_j, 0.0, what)


def _check(t, j, sel, jsl, k, radius=None, what=""):
    """Filtered search (and range_search) of the port's index ``t``: the
    device form against the host evaluation bit for bit, the ids against
    faiss_tpu's index ``j`` where given, every id admitted."""
    p = ft.SearchParams(sel=sel)
    out = t.search(XQ, k, params=p)
    _same(out, t.search(XQ, k, params=_host(sel)), what)
    _same(out, t.search_async(XQ, k, params=p).wait(), what + " async")
    _admitted(sel, out[1], what)
    if j is not None:
        _matches_jax(out, j.search(XQ, k, params=jsel.SearchParams(jsl)),
                     what)
    if radius is not None:
        got = t.range_search(XQ, radius, params=p)
        _same(got, t.range_search(XQ, radius, params=_host(sel)),
              what + " range")
        _admitted(sel, got[2], what + " range")
        if j is not None:
            want = j.range_search(XQ, radius,
                                  params=jsel.SearchParams(jsl))
            _same(got[:1] + got[2:], want[:1] + want[2:], what + " range")
    return out


def _radius(metric):
    return 600.0 if metric.value == "l2" else 900.0


FLAT_CASES = [(st, m, k) for st in ("f32", "f16") for m in (0, 1)
              for k in (10, 100)]
FLAT_IDS = [f"{st}-{METRIC_IDS[m]}-k{k}" for st, m, k in FLAT_CASES]


@pytest.fixture(scope="module")
def flat_built():
    """{(storage, metric): (port's flat index, faiss_tpu's)}."""
    out = {}
    for st in ("f32", "f16"):
        for m in (0, 1):
            metric, jm = METRICS[m]
            t = TorchIndexFlat(D, metric=metric, storage=st, device="cpu")
            j = TpuIndexFlat(D, metric=jm, storage=st)
            j.set_force_xla(True)
            t.add(XB)
            j.add(XB)
            out[(st, m)] = t, j
    return out


@pytest.mark.parametrize("storage,m,k", FLAT_CASES, ids=FLAT_IDS)
@pytest.mark.parametrize("which", [0, 1], ids=[s[0] for s in SELECTIONS])
def test_flat_filtered_matches_jax_and_the_host(flat_built, storage, m, k,
                                                which):
    t, j = flat_built[(storage, m)]
    _, sel, jsl = SELECTIONS[which]
    _check(t, j, sel, jsl, k, _radius(METRICS[m][0]) if k == 10 else None,
           f"flat {storage} {METRIC_IDS[m]} k={k}")


@pytest.mark.parametrize("storage", ["f32", "f16"])
def test_idmap_filtered_matches_jax_and_the_host(storage):
    ids = (np.arange(NV, dtype=np.int64) * 7 + 1_000_003)[::-1].copy()
    t = TorchIndexIDMap(TorchIndexFlat(D, storage=storage, device="cpu"))
    inner = TpuIndexFlat(D, storage=storage)
    inner.set_force_xla(True)
    j = TpuIndexIDMap(inner)
    for part in (slice(0, 1000), slice(1000, NV)):
        t.add_with_ids(XB[part], ids[part])
        j.add_with_ids(XB[part], ids[part])
    for k in (10, 100):
        for sel, jsl in [
                (ft.IDSelectorBatch(ids[::5]), jsel.IDSelectorBatch(ids[::5])),
                (~ft.IDSelectorRange(ids[2000], ids[0] + 1),
                 ~jsel.IDSelectorRange(ids[2000], ids[0] + 1))]:
            _check(t, j, sel, jsl, k, 600.0 if k == 10 else None,
                   f"idmap {storage} k={k}")
    # a selector that admits every custom id gives the unfiltered answer
    every = ft.SearchParams(sel=ft.IDSelectorRange(ids.min(), ids.max() + 1))
    _same(t.search(XQ, 10, params=every), t.search(XQ, 10), "idmap every")


@pytest.mark.parametrize("storage", ["f32", "f16"])
@pytest.mark.parametrize("metric,jmetric", METRICS, ids=METRIC_IDS)
def test_sharded_flat_filtered_matches_jax_and_the_host(storage, metric,
                                                        jmetric):
    t = ShardedIndexFlat(D, metric=metric, storage=storage, num_shards=2,
                         devices=["cpu"] * 2)
    j = JShardedFlat(D, metric=jmetric, storage=storage, num_shards=2)
    j.set_force_xla(True)
    t.add(XB[:1800])
    j.add(XB[:1800])
    t.add(XB[1800:])
    j.add(XB[1800:])
    for k in (10, 100):
        for name, sel, jsl in SELECTIONS:
            _check(t, j, sel, jsl, k, _radius(metric) if k == 10 else None,
                   f"sharded {storage} {name} k={k}")


@pytest.mark.parametrize("shards,rows", [(2, 1), (3, 2)])
def test_sharded_flat_with_shards_that_never_held_a_row(shards, rows):
    """A first add of fewer rows than shards leaves a shard with no gid
    column: filtered searches skip it, as unfiltered ones do."""
    t = ShardedIndexFlat(D, num_shards=shards, devices=["cpu"] * shards)
    j = JShardedFlat(D, num_shards=shards)
    j.set_force_xla(True)
    t.add(XB[:rows])
    j.add(XB[:rows])
    assert any(s.gids is None for s in t.shards)
    for ids in ([5], [0, 5], [1]):
        _check(t, j, ft.IDSelectorBatch(ids), jsel.IDSelectorBatch(ids), 10,
               _radius(METRICS[0][0]), f"{shards} shards {rows} rows {ids}")


@pytest.fixture(scope="module")
def ivf_built(tmp_path_factory):
    """{storage: (port's IVF index, faiss_tpu's)}: faiss_tpu trains, the
    port loads the trained file (the same centroids), then the same adds."""
    root = tmp_path_factory.mktemp("ivf")
    out = {}
    for st in ("f32", "bf16"):
        j = TpuIndexIVFFlat(D, NLIST, nprobe=4, storage=st, seed=7)
        j.train(XB)
        path = str(root / f"{st}.npz")
        faiss_tpu.save_index(j, path)
        t = load_index(path, device="cpu")
        for idx in (j, t):
            idx.add(XB[:1200])
            idx.add(XB[1200:])
        out[st] = t, j
    return out


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_ivf_filtered_matches_jax_and_the_host(ivf_built, storage):
    t, j = ivf_built[storage]
    for k in (10, 100):
        for name, sel, jsl in SELECTIONS:
            # faiss_tpu's IVF holds bf16 lists to the ladder, not to the
            # same ids: the host evaluation alone there
            _check(t, j if storage == "f32" else None, sel, jsl, k,
                   600.0 if k == 10 else None, f"ivf {storage} {name} k={k}")
    t.nprobe = NLIST        # the dense route
    try:
        _check(t, None, SELECTIONS[0][1], None, 10, None, "ivf dense")
    finally:
        t.nprobe = 4


def test_sharded_ivf_filtered_matches_jax_and_the_host(tmp_path):
    j = JShardedIVF(D, NLIST, nprobe=4, num_shards=2, seed=3)
    j.train(XB)
    faiss_tpu.save_index(j, str(tmp_path / "s.npz"))
    t = load_index(str(tmp_path / "s.npz"), sharded=True,
                   devices=["cpu"] * 2, num_shards=2)
    for idx in (j, t):
        idx.add(XB[:1700])
        idx.add(XB[1700:])
    for k in (10, 100):
        for name, sel, jsl in SELECTIONS:
            _check(t, j, sel, jsl, k, None, f"sharded ivf {name} k={k}")


def test_mutations_between_filtered_searches(flat_built):
    """One selector object reused across add and remove_ids: the device
    form reads the index's ids as they are, on every class."""
    sel = ft.IDSelectorBatch(np.arange(0, 2 * NV, 3))
    xb2, _ = int_data(700, 1, seed=9)
    flat = TorchIndexFlat(D, device="cpu")
    jflat = TpuIndexFlat(D)
    jflat.set_force_xla(True)
    idmap = TorchIndexIDMap(TorchIndexFlat(D, device="cpu"))
    sharded = ShardedIndexFlat(D, num_shards=3, devices=["cpu"] * 3)
    ivf = _ivf_twin()
    for step in range(3):
        if step == 0:
            for ix in (flat, jflat, sharded, ivf):
                ix.add(XB)
            idmap.add_with_ids(XB, np.arange(NV, dtype=np.int64) * 2)
        elif step == 1:
            for ix in (flat, jflat, sharded, ivf):
                ix.add(xb2)
            idmap.add_with_ids(xb2, np.arange(700, dtype=np.int64) * 2 + 1)
        else:
            rm = np.arange(5, NV, 4)
            for ix in (flat, jflat, sharded, ivf):
                assert ix.remove_ids(rm) == rm.size
            idmap.remove_ids(rm * 2)
        what = f"step {step}"
        _check(flat, jflat, sel, jsel.IDSelectorBatch(np.arange(0, 2 * NV, 3)),
               10, 600.0, what)
        for ix in (idmap, sharded, ivf):
            _check(ix, None, sel, None, 10, None, f"{what} {type(ix)}")


def _ivf_twin():
    """An empty IVF index with the centroids faiss_tpu trains (f32)."""
    j = TpuIndexIVFFlat(D, NLIST, nprobe=4, seed=7)
    j.train(XB)
    t = ft.TorchIndexIVFFlat(D, NLIST, nprobe=4, device="cpu")
    t._set_centroids(np.stack([j.quantizer.reconstruct(i)
                               for i in range(NLIST)]))
    return t


# -- the counters -------------------------------------------------------------


def _counted(fn):
    """{counter: total} of ``fn()`` run under the CPU's profiler."""
    tracing.span("index.search_async")  # unprofiled: a new stretch follows
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    out = {}
    for c in tracing.counts():
        out[c.name] = out.get(c.name, 0) + c.value
    return out


def test_one_upload_a_device_for_a_reused_batch(flat_built):
    t, _ = flat_built[("f32", 0)]
    sh = ShardedIndexFlat(D, num_shards=2, devices=["cpu"] * 2)
    sh.add(XB)
    for ix in (t, sh):
        sel = ft.IDSelectorBatch(np.arange(2, NV, 11))
        p = ft.SearchParams(sel=sel)
        got = _counted(lambda: [ix.search(XQ, 10, params=p)
                                for _ in range(10)])
        assert got == {"sel.uploads": 1}, (type(ix), got)
        # the copy is kept: later calls upload nothing
        assert _counted(lambda: ix.search(XQ, 10, params=p)) == {}
        assert "sel.uploads" in tracing.HOST_COUNTERS


def test_a_user_subclass_filters_on_the_host(flat_built):
    t, _ = flat_built[("f32", 1)]
    inner = ft.IDSelectorRange(100, 1400)
    p = ft.SearchParams(sel=HostOnly(inner))
    got = _counted(lambda: [t.search(XQ, 10, params=p) for _ in range(4)])
    assert got == {"sel.host_evals": 4}
    D_h, I_h = t.search(XQ, 10, params=p)
    assert ((I_h >= 100) & (I_h < 1400)).all()
    _same((D_h, I_h), t.search(XQ, 10, params=ft.SearchParams(sel=inner)),
          "subclass")
    # a device form evaluates nothing on the host
    got = _counted(lambda: t.search(XQ, 10, params=ft.SearchParams(
        sel=ft.IDSelectorAnd(inner, ~ft.IDSelectorMask([True] * 9)))))
    assert "sel.host_evals" not in got
    assert "sel.host_evals" in tracing.HOST_COUNTERS


def test_nothing_is_counted_unprofiled_or_unfiltered(flat_built):
    t, _ = flat_built[("f32", 0)]
    p = ft.SearchParams(sel=HostOnly(ft.IDSelectorRange(0, 50)))
    t.search(XQ, 10, params=p)
    assert _counted(lambda: t.search(XQ, 10)) == {}
    # an all-admitting selector runs the unfiltered search: no stream
    every = ft.SearchParams(sel=ft.IDSelectorBatch(np.arange(NV)))
    assert t._sel_stream(every) is None
    _same(t.search(XQ, 10, params=every), t.search(XQ, 10), "every")


# -- the streams, against the host placement they replace -------------------


def _host_streams(ix, sel):
    """The streams the host evaluation placed before the device form: the
    mask over the ids [0, ntotal) written into each index's layout."""
    mask = sel.is_member(np.arange(ix.ntotal, dtype=np.int64))
    if isinstance(ix, TorchIndexFlat):
        s = torch.zeros(ix.store.capacity, dtype=torch.bool)
        s[:ix.ntotal] = torch.from_numpy(mask)
        return s
    if isinstance(ix, ShardedIndexFlat):
        out = []
        for sh in ix.shards:
            s = torch.zeros(sh.store.capacity, dtype=torch.bool)
            s[:sh.gids_host.size] = torch.from_numpy(mask[sh.gids_host])
            out.append(s)
        return out
    if isinstance(ix, ft.TorchIndexIVFFlat):
        s = torch.zeros(ix._ids.shape[0], dtype=torch.bool)
        s[torch.from_numpy(ix._slot_of[mask])] = True
        return s
    gids = np.nonzero(mask)[0]
    out = []
    for i, sh in enumerate(ix.shards):
        s = torch.zeros(sh._ids.shape[0], dtype=torch.bool)
        mine = gids[ix._id_shard[gids] == i]
        s[torch.from_numpy(sh._slot_of[ix._id_local[mine]])] = True
        out.append(s)
    return out


def _valid(ix):
    """How much of each of ``ix``'s streams the placement decides: a flat
    stream's rows below ntotal, the IVF's whole slot range."""
    if isinstance(ix, TorchIndexFlat):
        return [ix.ntotal]
    if isinstance(ix, ShardedIndexFlat):
        return [s.store.ntotal for s in ix.shards]
    if isinstance(ix, ft.TorchIndexIVFFlat):
        return [None]
    return [None] * len(ix.shards)


def test_streams_equal_the_host_placement(flat_built, ivf_built, tmp_path):
    """Every class's stream, the device form's and the host way's, bit
    for bit equal to the host placement the port made before."""
    sharded = ShardedIndexFlat(D, num_shards=3, devices=["cpu"] * 3)
    sharded.add(XB[:1000])
    sharded.add(XB[1000:])
    ft.save_index(_ivf_twin(), str(tmp_path / "s.npz"))
    sivf = load_index(str(tmp_path / "s.npz"), sharded=True,
                      devices=["cpu"] * 2, num_shards=2)
    sivf.add(XB[:1700])
    sivf.add(XB[1700:])
    for ix in (flat_built[("f32", 0)][0], sharded, ivf_built["f32"][0],
               sivf):
        for name in KINDS:
            sel = _sel(name)
            want = _host_streams(ix, sel)
            for p in (ft.SearchParams(sel=sel), _host(sel)):
                got = ix._sel_stream(p)
                if got is None:     # a selector that admits every id
                    assert sel.is_member(np.arange(ix.ntotal)).all(), name
                    continue
                for g, w, n in zip(
                        got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want],
                        _valid(ix)):
                    # the flat streams leave the rows past ntotal to the
                    # search, which masks them
                    assert torch.equal(g[:n], w[:n]), (type(ix), name)
