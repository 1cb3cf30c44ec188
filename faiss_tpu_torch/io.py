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
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .dtypes import MetricType, StorageType
from .idmap import TorchIndexIDMap, TorchIndexIDMap2
from .index import TorchIndexFlat
from .ivf import TorchIndexIVFFlat

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


def _ivf_arrays(index: TorchIndexIVFFlat):
    """(meta fields, arrays) of an IVF index: the centroids, the saved
    routing, the stored rows and norms in insertion-id order."""
    if not index.is_trained:
        raise ValueError("cannot save an untrained IVF index")
    d = index.d
    extra = {"centroids": index._centroids}
    if index.storage_type is StorageType.INT8:
        extra["scales"] = index._scales[:d].cpu().numpy()
    if index.ntotal:
        rows, norms = index._rows_by_id()
        vectors, norms = _host_rows(rows[:, :d]), norms.cpu().numpy()
    else:
        vectors = np.zeros((0, d), np.float32)
        norms = np.zeros((0,), np.float32)
    extra["assign"] = index._assignments()
    return (dict(kind="ivf", nlist=index.nlist, nprobe=index.nprobe),
            vectors, norms, extra)


def save_index(index, path: str) -> None:
    """Write a TorchIndexFlat or TorchIndexIVFFlat, or a TorchIndexIDMap(2)
    over one, to ``path`` (.npz), exactly: the stored bits and norms, not
    a decoded copy (an IVF index also its centroids and routing)."""
    wrapper = id_map = None
    if isinstance(index, TorchIndexIDMap):
        wrapper = "idmap2" if isinstance(index, TorchIndexIDMap2) else "idmap"
        id_map = np.asarray(index.id_map, np.int64)
        index = index.index
    if not isinstance(index, (TorchIndexFlat, TorchIndexIVFFlat)):
        raise TypeError(f"save_index takes a TorchIndexFlat, a "
                        f"TorchIndexIVFFlat or an IDMap over one, got "
                        f"{type(index).__name__}")
    nt, d = index.ntotal, index.d
    meta = {"format": _FORMAT_VERSION, "d": d, "metric": index.metric.value,
            "storage": index.storage_type.value, "ntotal": nt,
            "wrapper": wrapper}
    if isinstance(index, TorchIndexIVFFlat):
        fields, vectors, norms, extra = _ivf_arrays(index)
        meta.update(fields)
        if id_map is not None:
            extra["id_map"] = id_map
        np.savez_compressed(path, meta=json.dumps(meta), vectors=vectors,
                            norms=norms, **extra)
        return
    st = index.store
    if nt == 0:
        vectors = np.zeros((0, d), np.float32)
        norms = np.zeros((0,), np.float32)
    else:
        norms = st.norms[:nt].cpu().numpy()
        if st.pair_only:
            vectors = st.reconstruct_n(0, nt)     # the exact host master
        else:
            vectors = _host_rows(st.db[:nt, :d])
    extra = {}
    if index.storage_type is StorageType.INT8:
        extra["scales"] = st.scales[:d].cpu().numpy()
    if id_map is not None:
        extra["id_map"] = id_map
    np.savez_compressed(path, meta=json.dumps(meta), vectors=vectors,
                        norms=norms, **extra)


def _ivf_from_arrays(meta: dict, vectors, norms, device, scales,
                     centroids, assign) -> TorchIndexIVFFlat:
    """A TorchIndexIVFFlat with the file's centroids (and int8 scales),
    each row restored into its saved list, bits and norms as stored."""
    if centroids is None or assign is None:
        raise ValueError("an IVF file needs its centroids and assign")
    idx = TorchIndexIVFFlat(
        int(meta["d"]), int(meta["nlist"]),
        metric=MetricType.coerce(meta["metric"]),
        storage=StorageType.coerce(meta["storage"]),
        nprobe=int(meta["nprobe"]), device=device)
    if idx.storage_type is StorageType.INT8:
        if scales is None:
            raise ValueError("an int8 file needs its scales")
        idx._set_scales(scales)
    idx._set_centroids(np.asarray(centroids, np.float32))
    n = int(meta["ntotal"])
    if n:
        np_dtype, dtype = _ROWS[idx.storage_type]
        rows = torch.zeros((n, idx.d_pad), dtype=dtype)
        rows[:, : idx.d] = torch.from_numpy(
            np.ascontiguousarray(vectors).view(np_dtype)).view(dtype)
        idx._add_preassigned(
            rows, torch.from_numpy(np.ascontiguousarray(norms, np.float32)),
            np.asarray(assign, np.int64))
    return idx


def index_from_arrays(meta: dict, vectors: np.ndarray, norms: np.ndarray,
                      device="cuda", keep_master: bool = True,
                      scales: np.ndarray = None, id_map: np.ndarray = None,
                      centroids: np.ndarray = None,
                      assign: np.ndarray = None):
    """TorchIndexFlat, or TorchIndexIVFFlat for an IVF file (``centroids``
    and ``assign``), from the arrays of a saved index (``scales``: int8
    only), inside its TorchIndexIDMap(2) when the file has one
    (``id_map``). ``keep_master=False`` loads flat f32 rows into pair-only
    storage. The arrays of a ``faiss_tpu`` file carry its state across: an
    IVF index routes every row to the list the JAX index put it in."""
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
    if kind == "ivf":
        idx = _ivf_from_arrays(meta, vectors, norms, device, scales,
                               centroids, assign)
    else:
        idx = TorchIndexFlat(int(meta["d"]),
                             metric=MetricType.coerce(meta["metric"]),
                             storage=StorageType.coerce(meta["storage"]),
                             device=device, keep_master=keep_master)
        if idx.storage_type is StorageType.INT8:
            if scales is None:
                raise ValueError("an int8 file needs its scales")
            idx.store.set_scales(scales)  # frozen, also for an empty index
        if n:
            np_dtype, dtype = _ROWS[idx.storage_type]
            rows = np.ascontiguousarray(vectors).view(np_dtype)
            idx.store.add_raw(torch.from_numpy(rows).view(dtype),
                              torch.from_numpy(np.ascontiguousarray(
                                  norms, np.float32)))
    if wrapper is None:
        return idx
    out = (TorchIndexIDMap2 if wrapper == "idmap2" else TorchIndexIDMap)(idx)
    out.id_map = np.asarray(id_map, np.int64)
    return out


def load_index(path: str, device="cuda", keep_master: bool = True):
    """Load a flat or IVF index, or an IDMap / IDMap2 over one, written by
    ``save_index`` or ``faiss_tpu.save_index`` (any storage)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {name: z[name] if name in z.files else None
                  for name in ("scales", "id_map", "centroids", "assign")}
        vectors, norms = z["vectors"], z["norms"]
    return index_from_arrays(meta, vectors, norms, device=device,
                             keep_master=keep_master, **arrays)
