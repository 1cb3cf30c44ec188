"""Loading a flat index saved by ``faiss_tpu.save_index``.

The ``.npz`` holds ``meta`` (JSON: format, d, metric, storage, ntotal,
wrapper), ``vectors`` (float32 rows, the stored bf16 or f16 bit patterns as
uint16, or the int8 codes), ``norms`` (the fp32 stored norms:
pre-quantization, or of the decoded rows for int8) and, for int8,
``scales`` (the frozen per-dimension scales). Rows, norms and scales are
restored bit for bit, so the port searches the same stored database as the
JAX package: parity no longer depends on two implementations of RNE
rounding and of the norm sum. (The JAX loader re-adds f32 rows and
recomputes their norms; the port keeps the file's.) What the JAX loader
derives from the rows, the port derives too: the f32 planes and split
statistics, the f16 split statistics and dirty-pattern count, and the int8
``int_norm_max``. Only numpy reads the file.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .dtypes import MetricType, StorageType
from .index import TorchIndexFlat

_FORMAT_VERSION = 1

# the torch dtype a file's raw rows are viewed as, by storage
_ROWS = {StorageType.BFLOAT16: (np.int16, torch.bfloat16),
         StorageType.FLOAT16: (np.int16, torch.float16),
         StorageType.INT8: (np.int8, torch.int8),
         StorageType.FLOAT32: (np.float32, torch.float32)}


def index_from_arrays(meta: dict, vectors: np.ndarray, norms: np.ndarray,
                      device="cuda", keep_master: bool = True,
                      scales: np.ndarray = None) -> TorchIndexFlat:
    """TorchIndexFlat from the arrays of a saved flat index (``scales``:
    int8 only). ``keep_master=False`` loads f32 rows into pair-only
    storage."""
    if meta.get("format") != _FORMAT_VERSION:
        raise ValueError(f"unsupported index format {meta.get('format')}")
    if meta.get("kind", "flat") != "flat" or meta.get("wrapper") is not None:
        raise NotImplementedError(
            "only flat indexes without an id map load into the port so far")
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
    return idx


def load_index(path: str, device="cuda",
               keep_master: bool = True) -> TorchIndexFlat:
    """Load a flat index written by ``faiss_tpu.save_index`` (any storage)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        vectors, norms = z["vectors"], z["norms"]
        scales = z["scales"] if "scales" in z.files else None
    return index_from_arrays(meta, vectors, norms, device=device,
                             keep_master=keep_master, scales=scales)
