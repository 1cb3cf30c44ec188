"""Loading a flat bf16 index saved by ``faiss_tpu.save_index``.

The ``.npz`` holds ``meta`` (JSON: format, d, metric, storage, ntotal,
wrapper), ``vectors`` (the stored bf16 bit patterns as uint16) and ``norms``
(the fp32 pre-quantization norms). Both are restored bit for bit, so the
port searches the same stored database as the JAX package: parity no longer
depends on two implementations of RNE rounding and of the norm sum.
Only numpy reads the file.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .dtypes import MetricType, StorageType
from .index import TorchIndexFlat

_FORMAT_VERSION = 1


def index_from_arrays(meta: dict, vectors: np.ndarray, norms: np.ndarray,
                      device="cuda") -> TorchIndexFlat:
    """TorchIndexFlat from the arrays of a saved flat bf16 index."""
    if meta.get("format") != _FORMAT_VERSION:
        raise ValueError(f"unsupported index format {meta.get('format')}")
    if meta.get("kind", "flat") != "flat" or meta.get("wrapper") is not None:
        raise NotImplementedError(
            "only flat indexes without an id map load into the port so far")
    storage = StorageType.coerce(meta["storage"])
    if storage is not StorageType.BFLOAT16:
        raise NotImplementedError(
            f"storage {storage.value}: the port stores bf16 only so far")
    idx = TorchIndexFlat(int(meta["d"]), metric=MetricType.coerce(meta["metric"]),
                         storage=storage, device=device)
    n = int(meta["ntotal"])
    if vectors.shape != (n, idx.d) or norms.shape != (n,):
        raise ValueError(
            f"arrays disagree with meta: vectors {vectors.shape}, "
            f"norms {norms.shape}, ntotal {n}, d {idx.d}")
    if n:
        bits = np.ascontiguousarray(vectors, dtype=np.uint16).view(np.int16)
        rows = torch.from_numpy(bits).view(torch.bfloat16)
        idx.store.add_raw(rows, torch.from_numpy(
            np.ascontiguousarray(norms, dtype=np.float32)))
    return idx


def load_index(path: str, device="cuda") -> TorchIndexFlat:
    """Load a flat bf16 index written by ``faiss_tpu.save_index``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        vectors, norms = z["vectors"], z["norms"]
    return index_from_arrays(meta, vectors, norms, device=device)
