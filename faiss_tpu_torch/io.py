"""Saving and loading flat and IVF indexes in ``faiss_tpu``'s ``.npz``
format.

The file holds ``meta`` (JSON: format, d, metric, storage, ntotal,
wrapper), ``vectors`` (float32 rows, the stored bf16 or f16 bit patterns
as uint16, or the int8 codes), ``norms`` (the fp32 stored norms:
pre-quantization, or of the decoded rows for int8), for int8 ``scales``
(the frozen per-dimension scales) and, for an IDMap / IDMap2 wrapper,
``id_map`` (int64). ``save_index`` writes it as ``faiss_tpu.save_index``
does (pair-only f32 from the host master), so either package loads what
the other wrote. Rows, norms and scales are restored bit for bit, so the
port searches the same stored database as the JAX package: parity does not
depend on two implementations of RNE rounding and of the norm sum. (The
JAX loader re-adds f32 rows and recomputes their norms; the port keeps the
file's.) What the JAX loader derives from the rows, the port derives too:
the f32 planes and split statistics, the f16 split statistics and
dirty-pattern count, and the int8 ``int_norm_max``. Only numpy reads and
writes the file.

An IVF file (meta ``kind="ivf"``, ``nlist``, ``nprobe``) also holds the
``centroids`` (nlist, d) and ``assign``, the list of every row; its rows
and norms are in insertion-id order. Loading installs the centroids and
restores each row into its saved list (``_add_preassigned``), never
re-routing it, so an index built by ``faiss_tpu`` routes and searches the
same lists here.

The sharded classes save to the same single-index formats, their rows in
global-id order (the file holds no shard structure: results do not depend
on the shard count). ``load_index(sharded=True)`` redistributes the rows
over ``devices`` in balanced contiguous splits (shard i the next
⌈n/P⌉ or ⌊n/P⌋ rows, the longer ones first), ids kept, bits, norms,
scales and the saved routing carried, as ``faiss_tpu.load_index(sharded=
True)`` does.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .dtypes import MetricType, StorageType
from .idmap import TorchIndexIDMap, TorchIndexIDMap2
from .index import TorchIndexFlat
from .ivf import TorchIndexIVFFlat
from .parallel import ShardedIndexFlat, ShardedIndexIVFFlat
from .parallel.sharded import balanced_counts

_FORMAT_VERSION = 1

# the torch dtype a file's raw rows are viewed as, by storage
_ROWS = {StorageType.BFLOAT16: (np.int16, torch.bfloat16),
         StorageType.FLOAT16: (np.int16, torch.float16),
         StorageType.INT8: (np.int8, torch.int8),
         StorageType.FLOAT32: (np.float32, torch.float32)}


def _host_rows(rows: torch.Tensor) -> np.ndarray:
    """Stored rows as the file holds them: f32 and int8 as they are, bf16
    and f16 as their uint16 bit patterns."""
    rows = rows.cpu()
    if rows.dtype in (torch.bfloat16, torch.float16):
        return rows.view(torch.int16).numpy().view(np.uint16)
    return rows.numpy()


def _ivf_arrays(index):
    """(meta fields, arrays) of an IVF index, sharded or not: the
    centroids, the saved routing, the stored rows and norms in (global)
    id order."""
    if not index.is_trained:
        raise ValueError("cannot save an untrained IVF index")
    d = index.d
    shards = (index.shards if isinstance(index, ShardedIndexIVFFlat)
              else [index])
    extra = {"centroids": shards[0]._centroids}
    if index.storage_type is StorageType.INT8:
        extra["scales"] = shards[0]._scales[:d].cpu().numpy()
    if isinstance(index, ShardedIndexIVFFlat):
        where = (index._id_shard, index._id_local)
    else:
        where = (np.zeros(index.ntotal, np.int16),
                 np.arange(index.ntotal, dtype=np.int64))
    vectors = norms = None
    assign = np.zeros((index.ntotal,), np.int64)
    for si, sh in enumerate(shards):
        g = np.nonzero(where[0] == si)[0]
        if g.size == 0:
            continue
        rows, nrm = sh._rows_by_id()
        rows, nrm = _host_rows(rows[:, :d]), nrm.cpu().numpy()
        if vectors is None:
            vectors = np.zeros((index.ntotal, d), rows.dtype)
            norms = np.zeros((index.ntotal,), np.float32)
        loc = where[1][g]
        vectors[g], norms[g] = rows[loc], nrm[loc]
        assign[g] = sh._assignments()[loc]
    if vectors is None:
        vectors = np.zeros((0, d), np.float32)
        norms = np.zeros((0,), np.float32)
    extra["assign"] = assign
    return (dict(kind="ivf", nlist=index.nlist, nprobe=index.nprobe),
            vectors, norms, extra)


def _flat_arrays(shards, d: int, nt: int):
    """(vectors, norms) of flat stores in global-id order: ``shards`` =
    [(store, its rows' global ids)]."""
    parts, norms, gids = [], [], []
    for st, g in shards:
        n = st.ntotal
        if n == 0:
            continue
        norms.append(st.norms[:n].cpu().numpy())
        if st.pair_only:
            parts.append(st.reconstruct_n(0, n))     # the exact host master
        else:
            parts.append(_host_rows(st.db[:n, :d]))
        gids.append(g)
    if not parts:
        return np.zeros((0, d), np.float32), np.zeros((0,), np.float32)
    order = np.argsort(np.concatenate(gids), kind="stable")
    assert order.size == nt
    return np.concatenate(parts)[order], np.concatenate(norms)[order]


def save_index(index, path: str) -> None:
    """Write a TorchIndexFlat or TorchIndexIVFFlat, a sharded one, or a
    TorchIndexIDMap(2) over one, to ``path`` (.npz), exactly: the stored
    bits and norms, not a decoded copy (an IVF index also its centroids
    and routing); a sharded index in the single-index format, its rows in
    global-id order."""
    wrapper = id_map = None
    if isinstance(index, TorchIndexIDMap):
        wrapper = "idmap2" if isinstance(index, TorchIndexIDMap2) else "idmap"
        id_map = np.asarray(index.id_map, np.int64)
        index = index.index
    if not isinstance(index, (TorchIndexFlat, TorchIndexIVFFlat,
                              ShardedIndexFlat, ShardedIndexIVFFlat)):
        raise TypeError(f"save_index takes a TorchIndexFlat, a "
                        f"TorchIndexIVFFlat, a sharded one or an IDMap over "
                        f"one, got {type(index).__name__}")
    nt, d = index.ntotal, index.d
    meta = {"format": _FORMAT_VERSION, "d": d, "metric": index.metric.value,
            "storage": index.storage_type.value, "ntotal": nt,
            "wrapper": wrapper}
    if isinstance(index, (TorchIndexIVFFlat, ShardedIndexIVFFlat)):
        fields, vectors, norms, extra = _ivf_arrays(index)
        meta.update(fields)
        if id_map is not None:
            extra["id_map"] = id_map
        np.savez_compressed(path, meta=json.dumps(meta), vectors=vectors,
                            norms=norms, **extra)
        return
    if isinstance(index, ShardedIndexFlat):
        st = index.shards[0].store
        vectors, norms = _flat_arrays(
            [(s.store, s.gids_host) for s in index.shards], d, nt)
    else:
        st = index.store
        vectors, norms = _flat_arrays(
            [(st, np.arange(nt, dtype=np.int64))], d, nt)
    extra = {}
    if index.storage_type is StorageType.INT8:
        extra["scales"] = st.scales[:d].cpu().numpy()
    if id_map is not None:
        extra["id_map"] = id_map
    np.savez_compressed(path, meta=json.dumps(meta), vectors=vectors,
                        norms=norms, **extra)


def _ivf_from_arrays(meta: dict, vectors, norms, device, scales,
                     centroids, assign, sharding=None, resources=None):
    """A TorchIndexIVFFlat with the file's centroids (and int8 scales),
    each row restored into its saved list, bits and norms as stored; with
    ``sharding`` = (devices, num_shards) a ShardedIndexIVFFlat holding the
    rows in balanced contiguous splits under their ids."""
    if centroids is None or assign is None:
        raise ValueError("an IVF file needs its centroids and assign")
    kw = dict(metric=MetricType.coerce(meta["metric"]),
              storage=StorageType.coerce(meta["storage"]),
              nprobe=int(meta["nprobe"]), resources=resources)
    if sharding is None:
        idx = TorchIndexIVFFlat(int(meta["d"]), int(meta["nlist"]),
                                device=device, **kw)
        shards = [idx]
    else:
        idx = ShardedIndexIVFFlat(int(meta["d"]), int(meta["nlist"]),
                                  devices=sharding[0],
                                  num_shards=sharding[1], **kw)
        shards = idx.shards
    if idx.storage_type is StorageType.INT8:
        if scales is None:
            raise ValueError("an int8 file needs its scales")
        shards[0]._set_scales(scales)
    shards[0]._set_centroids(np.asarray(centroids, np.float32))
    n = int(meta["ntotal"])
    rows = norms_t = None
    assign = np.asarray(assign, np.int64)
    if n:
        np_dtype, dtype = _ROWS[idx.storage_type]
        rows = torch.zeros((n, shards[0].d_pad), dtype=dtype)
        rows[:, : idx.d] = torch.from_numpy(
            np.ascontiguousarray(vectors).view(np_dtype)).view(dtype)
        norms_t = torch.from_numpy(np.ascontiguousarray(norms, np.float32))
    if sharding is None:
        if n:
            idx._add_preassigned(rows, norms_t, assign)
        return idx
    idx._install_from_shard0()
    if n:
        idx._place(balanced_counts(n, idx.num_shards, 0),
                   lambda sh, lo, hi, gids: sh._add_preassigned(
                       rows[lo:hi], norms_t[lo:hi], assign[lo:hi],
                       global_ids=gids))
        idx._next_shard = n % idx.num_shards
    return idx


def _flat_from_arrays(meta: dict, vectors, norms, device, keep_master,
                      scales, sharding=None, resources=None):
    """A TorchIndexFlat holding the file's rows, bits and norms as stored
    (int8: its scales); with ``sharding`` = (devices, num_shards) a
    ShardedIndexFlat holding them in balanced contiguous splits."""
    kw = dict(metric=MetricType.coerce(meta["metric"]),
              storage=StorageType.coerce(meta["storage"]),
              keep_master=keep_master, resources=resources)
    if sharding is None:
        idx = TorchIndexFlat(int(meta["d"]), device=device, **kw)
        stores = [idx.store]
    else:
        idx = ShardedIndexFlat(int(meta["d"]), devices=sharding[0],
                               num_shards=sharding[1], **kw)
        stores = [s.store for s in idx.shards]
    if idx.storage_type is StorageType.INT8:
        if scales is None:
            raise ValueError("an int8 file needs its scales")
        for st in stores:
            st.set_scales(scales)   # frozen, also for an empty index
    n = int(meta["ntotal"])
    if n == 0:
        return idx
    np_dtype, dtype = _ROWS[idx.storage_type]
    rows = torch.from_numpy(
        np.ascontiguousarray(vectors).view(np_dtype)).view(dtype)
    norms_t = torch.from_numpy(np.ascontiguousarray(norms, np.float32))
    if sharding is None:
        idx.store.add_raw(rows, norms_t)
        return idx
    idx._append(lambda s, lo, hi: s.store.add_raw(rows[lo:hi],
                                                  norms_t[lo:hi]),
                balanced_counts(n, idx.num_shards, 0))
    idx._next_shard = n % idx.num_shards
    return idx


def index_from_arrays(meta: dict, vectors: np.ndarray, norms: np.ndarray,
                      device=None, keep_master: bool = True,
                      scales: np.ndarray = None, id_map: np.ndarray = None,
                      centroids: np.ndarray = None,
                      assign: np.ndarray = None, sharded: bool = False,
                      devices=None, num_shards: int = None,
                      resources=None):
    """TorchIndexFlat, or TorchIndexIVFFlat for an IVF file (``centroids``
    and ``assign``), from the arrays of a saved index (``scales``: int8
    only), inside its TorchIndexIDMap(2) when the file has one
    (``id_map``). ``keep_master=False`` loads flat f32 rows into pair-only
    storage. ``sharded=True``: a ShardedIndexFlat or ShardedIndexIVFFlat
    over ``devices`` (default: every visible CUDA device) and
    ``num_shards``, the rows redistributed in balanced contiguous splits.
    ``resources``: the TorchResources of every index built (``device``,
    default its default device, and ``devices``, default its devices,
    must be among its devices). The arrays of a ``faiss_tpu`` file carry
    its state across: an IVF index routes every row to the list the JAX
    index put it in."""
    if meta.get("format") != _FORMAT_VERSION:
        raise ValueError(f"unsupported index format {meta.get('format')}")
    kind = meta.get("kind", "flat")
    if kind not in ("flat", "ivf"):
        raise ValueError(f"unknown index kind {kind!r}")
    wrapper = meta.get("wrapper")
    if wrapper not in (None, "idmap", "idmap2"):
        raise ValueError(f"unknown wrapper {wrapper!r}")
    if wrapper is not None and id_map is None:
        raise ValueError("an IDMap file needs its id_map")
    n = int(meta["ntotal"])
    if vectors.shape != (n, int(meta["d"])) or norms.shape != (n,):
        raise ValueError(
            f"arrays disagree with meta: vectors {vectors.shape}, "
            f"norms {norms.shape}, ntotal {n}, d {meta['d']}")
    sharding = (devices, num_shards) if sharded else None
    if kind == "ivf":
        idx = _ivf_from_arrays(meta, vectors, norms, device, scales,
                               centroids, assign, sharding, resources)
    else:
        idx = _flat_from_arrays(meta, vectors, norms, device, keep_master,
                                scales, sharding, resources)
    if wrapper is None:
        return idx
    out = (TorchIndexIDMap2 if wrapper == "idmap2" else TorchIndexIDMap)(idx)
    out.id_map = np.asarray(id_map, np.int64)
    return out


def load_index(path: str, device=None, keep_master: bool = True,
               sharded: bool = False, devices=None, num_shards: int = None,
               resources=None):
    """Load a flat or IVF index, or an IDMap / IDMap2 over one, written by
    ``save_index`` or ``faiss_tpu.save_index`` (any storage, sharded or
    not), on ``device`` (default "cuda", or the default device of
    ``resources``). ``sharded=True`` loads it into a ShardedIndexFlat or
    ShardedIndexIVFFlat over ``devices`` (a list of torch devices, default
    the devices of ``resources``, else every visible CUDA device;
    ``device`` is then unused) and ``num_shards``. ``resources``: the
    TorchResources whose program cache the index's searches go through
    (faiss_tpu's ``resources=``)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {name: z[name] if name in z.files else None
                  for name in ("scales", "id_map", "centroids", "assign")}
        vectors, norms = z["vectors"], z["norms"]
    return index_from_arrays(meta, vectors, norms, device=device,
                             keep_master=keep_master, sharded=sharded,
                             devices=devices, num_shards=num_shards,
                             resources=resources, **arrays)
