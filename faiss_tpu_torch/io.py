"""Saving and loading flat indexes in ``faiss_tpu``'s ``.npz`` format.

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
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .dtypes import MetricType, StorageType
from .idmap import TorchIndexIDMap, TorchIndexIDMap2
from .index import TorchIndexFlat

_FORMAT_VERSION = 1

# the torch dtype a file's raw rows are viewed as, by storage
_ROWS = {StorageType.BFLOAT16: (np.int16, torch.bfloat16),
         StorageType.FLOAT16: (np.int16, torch.float16),
         StorageType.INT8: (np.int8, torch.int8),
         StorageType.FLOAT32: (np.float32, torch.float32)}


def save_index(index, path: str) -> None:
    """Write a TorchIndexFlat, or a TorchIndexIDMap(2) over one, to ``path``
    (.npz), exactly: the stored bits and norms, not a decoded copy."""
    wrapper = id_map = None
    if isinstance(index, TorchIndexIDMap):
        wrapper = "idmap2" if isinstance(index, TorchIndexIDMap2) else "idmap"
        id_map = np.asarray(index.id_map, np.int64)
        index = index.index
    if not isinstance(index, TorchIndexFlat):
        raise TypeError(f"save_index takes a TorchIndexFlat or an IDMap "
                        f"over one, got {type(index).__name__}")
    st, nt, d = index.store, index.ntotal, index.d
    meta = {"format": _FORMAT_VERSION, "d": d, "metric": index.metric.value,
            "storage": index.storage_type.value, "ntotal": nt,
            "wrapper": wrapper}
    if nt == 0:
        vectors = np.zeros((0, d), np.float32)
        norms = np.zeros((0,), np.float32)
    else:
        norms = st.norms[:nt].cpu().numpy()
        if st.pair_only:
            vectors = st.reconstruct_n(0, nt)     # the exact host master
        else:
            vectors = st.db[:nt, :d].cpu()
            if vectors.dtype in (torch.bfloat16, torch.float16):
                vectors = vectors.view(torch.int16).numpy().view(np.uint16)
            else:
                vectors = vectors.numpy()
    extra = {}
    if index.storage_type is StorageType.INT8:
        extra["scales"] = st.scales[:d].cpu().numpy()
    if id_map is not None:
        extra["id_map"] = id_map
    np.savez_compressed(path, meta=json.dumps(meta), vectors=vectors,
                        norms=norms, **extra)


def index_from_arrays(meta: dict, vectors: np.ndarray, norms: np.ndarray,
                      device="cuda", keep_master: bool = True,
                      scales: np.ndarray = None, id_map: np.ndarray = None):
    """TorchIndexFlat from the arrays of a saved flat index (``scales``:
    int8 only), inside its TorchIndexIDMap(2) when the file has one
    (``id_map``). ``keep_master=False`` loads f32 rows into pair-only
    storage."""
    if meta.get("format") != _FORMAT_VERSION:
        raise ValueError(f"unsupported index format {meta.get('format')}")
    if meta.get("kind", "flat") != "flat":
        raise NotImplementedError(
            f"only flat indexes load into the port so far, not "
            f"{meta.get('kind')!r}")
    wrapper = meta.get("wrapper")
    if wrapper not in (None, "idmap", "idmap2"):
        raise ValueError(f"unknown wrapper {wrapper!r}")
    if wrapper is not None and id_map is None:
        raise ValueError("an IDMap file needs its id_map")
    idx = TorchIndexFlat(int(meta["d"]), metric=MetricType.coerce(meta["metric"]),
                         storage=StorageType.coerce(meta["storage"]),
                         device=device, keep_master=keep_master)
    n = int(meta["ntotal"])
    if vectors.shape != (n, idx.d) or norms.shape != (n,):
        raise ValueError(
            f"arrays disagree with meta: vectors {vectors.shape}, "
            f"norms {norms.shape}, ntotal {n}, d {idx.d}")
    if idx.storage_type is StorageType.INT8:
        if scales is None:
            raise ValueError("an int8 file needs its scales")
        idx.store.set_scales(scales)    # frozen, also for an empty index
    if n:
        np_dtype, dtype = _ROWS[idx.storage_type]
        rows = np.ascontiguousarray(vectors).view(np_dtype)
        idx.store.add_raw(torch.from_numpy(rows).view(dtype),
                          torch.from_numpy(np.ascontiguousarray(norms,
                                                                np.float32)))
    if wrapper is None:
        return idx
    out = (TorchIndexIDMap2 if wrapper == "idmap2" else TorchIndexIDMap)(idx)
    out.id_map = np.asarray(id_map, np.int64)
    return out


def load_index(path: str, device="cuda", keep_master: bool = True):
    """Load a flat index, or an IDMap / IDMap2 over one, written by
    ``save_index`` or ``faiss_tpu.save_index`` (any storage)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        vectors, norms = z["vectors"], z["norms"]
        scales = z["scales"] if "scales" in z.files else None
        id_map = z["id_map"] if "id_map" in z.files else None
    return index_from_arrays(meta, vectors, norms, device=device,
                             keep_master=keep_master, scales=scales,
                             id_map=id_map)
