"""Bulk ingestion: stream large datasets from disk into an index, after
``faiss_tpu/loader.py``.

Disk → host batch → (the native host conversion for bf16 and f16 batches,
storage.NATIVE_CONVERT_MIN_ELEMS) → the device, batch by batch, so a large
build never holds the fp32 dataset in host memory. `.npy`, and the
`.fvecs` / `.bvecs` formats of the ANN benchmarks (SIFT1M, BIGANN). The
readers are ``faiss_tpu``'s, unchanged; ``build_index_from_file`` takes a
torch ``device`` (or a list of ``devices`` when sharded) where
``faiss_tpu`` takes its resources.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Optional

import numpy as np

DEFAULT_BATCH_ROWS = 262_144


def iter_npy_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                     ) -> Iterator[np.ndarray]:
    """Yield fp32 (rows, d) batches from a .npy file via memmap."""
    mm = np.load(path, mmap_mode="r")
    if mm.ndim != 2:
        raise ValueError(f"expected a 2-D array in {path}, got {mm.shape}")
    for lo in range(0, mm.shape[0], batch_rows):
        yield np.asarray(mm[lo : lo + batch_rows], dtype=np.float32)


def iter_fvecs_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                       ) -> Iterator[np.ndarray]:
    """Yield batches from an .fvecs file (TexMex format: per row, int32 d
    then d float32s — the SIFT/GIST benchmark format)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 1)
    if head.size == 0:
        return
    d = int(head[0])
    row_bytes = 4 * (d + 1)
    if size % row_bytes:
        raise ValueError(f"{path}: not a whole number of {d}-d fvecs rows")
    n = size // row_bytes
    mm = np.memmap(path, np.float32, "r", shape=(n, d + 1))
    for lo in range(0, n, batch_rows):
        yield np.ascontiguousarray(mm[lo : lo + batch_rows, 1:],
                                   dtype=np.float32)


def iter_bvecs_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                       ) -> Iterator[np.ndarray]:
    """Yield batches from a .bvecs file (int32 d then d uint8s per row)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 1)
    if head.size == 0:
        return
    d = int(head[0])
    row_bytes = 4 + d
    if size % row_bytes:
        raise ValueError(f"{path}: not a whole number of {d}-d bvecs rows")
    n = size // row_bytes
    mm = np.memmap(path, np.uint8, "r", shape=(n, row_bytes))
    for lo in range(0, n, batch_rows):
        yield mm[lo : lo + batch_rows, 4:].astype(np.float32)


_READERS = {
    ".npy": iter_npy_batches,
    ".fvecs": iter_fvecs_batches,
    ".bvecs": iter_bvecs_batches,
}


def iter_file_batches(path: str, batch_rows: int = DEFAULT_BATCH_ROWS
                      ) -> Iterator[np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    try:
        reader = _READERS[ext]
    except KeyError:
        raise ValueError(
            f"unsupported dataset format {ext!r} (supported: {sorted(_READERS)})"
        ) from None
    return reader(path, batch_rows)


def add_batches(index, batches: Iterable[np.ndarray]) -> int:
    """Stream batches into any index with .add(); the device work of one
    batch is enqueued before the next is read. Returns rows added."""
    n = 0
    for b in batches:
        index.add(b)
        n += b.shape[0]
    return n


def build_index_from_file(
    path: str,
    metric="l2",
    storage="float32",
    sharded: bool = False,
    device=None,
    devices=None,
    batch_rows: int = DEFAULT_BATCH_ROWS,
    d: Optional[int] = None,
    resources=None,
):
    """Build a TorchIndexFlat on ``device`` (None: "cuda", or the default
    device of ``resources``), or with ``sharded=True`` a ShardedIndexFlat
    over ``devices`` (None: the devices of ``resources``, else every
    visible CUDA device), by streaming a dataset file. ``resources``: the
    TorchResources of the index built (faiss_tpu's ``resources=``)."""
    from .index import TorchIndexFlat
    from .parallel.sharded import ShardedIndexFlat

    batches = iter_file_batches(path, batch_rows)
    first = next(iter(batches), None)
    if first is None and d is None:
        raise ValueError(f"{path} is empty and no d was given")
    dim = first.shape[1] if first is not None else d
    if sharded:
        idx = ShardedIndexFlat(dim, metric=metric, storage=storage,
                               devices=devices, resources=resources)
    else:
        idx = TorchIndexFlat(dim, metric=metric, storage=storage,
                             device=device, resources=resources)
    if first is not None:
        idx.add(first)
        add_batches(idx, batches)
    return idx
