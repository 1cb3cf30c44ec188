"""Loading a flat f32 or bf16 index saved by ``faiss_tpu.save_index``.

The ``.npz`` holds ``meta`` (JSON: format, d, metric, storage, ntotal,
wrapper), ``vectors`` (float32 rows, or the stored bf16 bit patterns as
uint16) and ``norms`` (the fp32 pre-quantization norms). Rows and norms are
restored bit for bit, so the port searches the same stored database as the
JAX package: parity no longer depends on two implementations of RNE
rounding and of the norm sum. (The JAX loader re-adds f32 rows and
recomputes their norms; the port keeps the file's.) The f32 planes and
split statistics are derived from the rows on load. Only numpy reads the
file.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .dtypes import MetricType, StorageType
from .index import TorchIndexFlat

_FORMAT_VERSION = 1


def index_from_arrays(meta: dict, vectors: np.ndarray, norms: np.ndarray,
                      device="cuda", keep_master: bool = True
                      ) -> TorchIndexFlat:
    """TorchIndexFlat from the arrays of a saved flat f32 or bf16 index.
    ``keep_master=False`` loads f32 rows into pair-only storage."""
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
    if n:
        norms_t = torch.from_numpy(np.ascontiguousarray(norms, np.float32))
        if idx.storage_type is StorageType.FLOAT32:
            idx.store.add_raw_f32(torch.from_numpy(
                np.ascontiguousarray(vectors, np.float32)), norms_t)
        else:
            bits = np.ascontiguousarray(vectors, np.uint16).view(np.int16)
            idx.store.add_raw(torch.from_numpy(bits).view(torch.bfloat16),
                              norms_t)
    return idx


def load_index(path: str, device="cuda",
               keep_master: bool = True) -> TorchIndexFlat:
    """Load a flat f32 or bf16 index written by ``faiss_tpu.save_index``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        vectors, norms = z["vectors"], z["norms"]
    return index_from_arrays(meta, vectors, norms, device=device,
                             keep_master=keep_master)
