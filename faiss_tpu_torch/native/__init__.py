"""ctypes bindings for the native C++ host runtime, after
``faiss_tpu/native/__init__.py``.

The port's own copy of ``faiss_tpu``'s runtime (``src/faiss_tpu_native.cpp``,
the same C API and arithmetic): importing ``faiss_tpu.native`` would import
jax. At first call the source compiles with g++ and JAX's flags into
``faiss_tpu_torch/_build/`` (rebuilt when the source is newer than the
library) and loads through ctypes. Importing this module builds nothing.

  * ``f32_to_bf16`` / ``f32_to_f16``: round-to-nearest-even conversion on
    host threads. bf16 keeps a NaN's high payload bits (sign | (x >> 16) |
    0x40: 0x7fa00001 becomes 0x7fe0, where ``storage.f32_to_bf16`` gives
    0x7fc0); f16 gives sign | 0x7c00 | 0x200 | mantissa >> 13.
  * ``l2_norms``: row ‖v‖² accumulated in double on host threads.
  * ``merge_topk``: the two-pointer merge of two best-first k-lists. It
    assumes both lists are sorted, so ``multi.merge_search_results`` does
    not use it (see multi.py).
  * ``AlignedBuffer``: page-aligned host memory; ``fill_sentinels``: the
    sentinel fill of ranks [k_eff, k).

Every wrapper has a numpy version beside it, which it uses where g++ is
absent, as JAX's do. Where g++ exists and the compile fails, the first call
raises with the compiler's errors (JAX falls back to numpy silently).
``calls`` counts the calls that went to the library (never the numpy
versions), so a run can show which route it took.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "src" / "faiss_tpu_native.cpp"
BUILD_DIR = _HERE.parent / "_build"
LIB_NAME = "libfaiss_tpu_native.so"
# faiss_tpu/native/__init__.py's command line
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-march=native")

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_no_compiler = False

calls = {"f32_to_bf16": 0, "f32_to_f16": 0, "l2_norms": 0, "merge_topk": 0,
         "alloc_aligned": 0, "fill_sentinels": 0}


def reset_calls() -> None:
    for name in calls:
        calls[name] = 0


def build(build_dir=BUILD_DIR) -> Optional[Path]:
    """Compile the source into ``build_dir`` unless a library at least as
    new as the source is there; None where g++ is absent. Each process
    compiles to its own temporary name and renames it into place, so
    processes building at once never load a half-written library. A
    failed compile raises with the compiler's errors."""
    build_dir = Path(build_dir)
    so = build_dir / LIB_NAME
    if so.exists() and so.stat().st_mtime >= SRC.stat().st_mtime:
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=LIB_NAME + ".", suffix=".tmp",
                               dir=build_dir)
    os.close(fd)
    try:
        r = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", tmp],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}) on {SRC}:\n"
                               f"{r.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.ft_alloc_aligned.restype = c.c_void_p
    lib.ft_alloc_aligned.argtypes = [c.c_size_t]
    lib.ft_free_aligned.argtypes = [c.c_void_p]
    lib.ft_f32_to_bf16.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_int]
    lib.ft_f32_to_f16.argtypes = [c.c_void_p, c.c_void_p, c.c_int64, c.c_int]
    lib.ft_l2_norms_f32.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int]
    lib.ft_merge_topk_f32.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_int64,
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64,
        c.c_int, c.c_int]
    lib.ft_fill_sentinels.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int64,
        c.c_float, c.c_int64]
    lib.ft_version.restype = c.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _no_compiler
    with _lib_lock:
        if _lib is not None or _no_compiler:
            return _lib
        so = build()
        if so is None:
            _no_compiler = True
            return None
        _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def available() -> bool:
    return _load() is not None


def _nthreads() -> int:
    return max(1, os.cpu_count() or 1)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# numpy versions (faiss_tpu.native's fallbacks)
# ---------------------------------------------------------------------------

def f32_to_bf16_numpy(x: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    rne = ((u + bias) >> np.uint32(16)).astype(np.uint16)
    qnan = (u >> np.uint32(16)).astype(np.uint16) | np.uint16(0x0040)
    return np.where(nan, qnan, rne)


def f32_to_f16_numpy(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).astype(np.float16)  # RNE


def l2_norms_numpy(x: np.ndarray) -> np.ndarray:
    return (np.asarray(x, np.float32).astype(np.float64) ** 2).sum(1).astype(
        np.float32)


def merge_topk_numpy(va, ia, vb, ib, k: int, largest: bool = True):
    vals = np.concatenate([va, vb], axis=1)
    ids = np.concatenate([ia, ib], axis=1)
    order = (np.argsort(-vals, axis=1, kind="stable") if largest
             else np.argsort(vals, axis=1, kind="stable"))[:, :k]
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


# ---------------------------------------------------------------------------
# public wrappers (the library, or the numpy version where g++ is absent)
# ---------------------------------------------------------------------------

def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32→bf16; returns the uint16 bits (a torch
    bfloat16 tensor: ``bf16_tensor``)."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return f32_to_bf16_numpy(x)
    out = np.empty(x.shape, np.uint16)
    lib.ft_f32_to_bf16(_ptr(x), _ptr(out), x.size, _nthreads())
    calls["f32_to_bf16"] += 1
    return out


def bf16_tensor(bits: np.ndarray):
    """uint16 bf16 bits → a torch.bfloat16 CPU tensor over the same memory
    (the port has no ml_dtypes)."""
    import torch

    return torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def f32_to_f16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32→f16 (IEEE half), returned as np.float16."""
    x = np.ascontiguousarray(x, np.float32)
    lib = _load()
    if lib is None:
        return f32_to_f16_numpy(x)
    out = np.empty(x.shape, np.uint16)
    lib.ft_f32_to_f16(_ptr(x), _ptr(out), x.size, _nthreads())
    calls["f32_to_f16"] += 1
    return out.view(np.float16)


def l2_norms(x: np.ndarray) -> np.ndarray:
    """Row-wise ‖v‖² of an (n, d) fp32 matrix (double accumulation)."""
    x = np.ascontiguousarray(x, np.float32)
    assert x.ndim == 2
    lib = _load()
    if lib is None:
        return l2_norms_numpy(x)
    out = np.empty(x.shape[0], np.float32)
    lib.ft_l2_norms_f32(_ptr(x), _ptr(out), x.shape[0], x.shape[1],
                        _nthreads())
    calls["l2_norms"] += 1
    return out


def merge_topk(va, ia, vb, ib, k: int, largest: bool = True):
    """Merge two best-first-sorted per-row k-lists into one (nq, k) list
    (a two-pointer merge: on unsorted lists it is not the top k)."""
    va = np.ascontiguousarray(va, np.float32)
    vb = np.ascontiguousarray(vb, np.float32)
    ia = np.ascontiguousarray(ia, np.int64)
    ib = np.ascontiguousarray(ib, np.int64)
    lib = _load()
    if lib is None:
        return merge_topk_numpy(va, ia, vb, ib, k, largest)
    nq, ka = va.shape
    kb = vb.shape[1]
    vo = np.empty((nq, k), np.float32)
    io = np.empty((nq, k), np.int64)
    lib.ft_merge_topk_f32(_ptr(va), _ptr(ia), ka, _ptr(vb), _ptr(ib), kb,
                          _ptr(vo), _ptr(io), k, nq,
                          1 if largest else 0, _nthreads())
    calls["merge_topk"] += 1
    return vo, io


def fill_sentinels(dists: np.ndarray, labels: np.ndarray, k_eff: int,
                   sentinel_dist: float, sentinel_label: int = -1) -> None:
    """In place: ranks [k_eff, k) of every row of the (nq, k) float32
    ``dists`` and int64 ``labels`` to the sentinels (``ft_fill_sentinels``;
    faiss_tpu binds it and wraps it nowhere)."""
    if (dists.dtype != np.float32 or labels.dtype != np.int64
            or dists.shape != labels.shape or dists.ndim != 2
            or not dists.flags.c_contiguous
            or not labels.flags.c_contiguous):
        raise ValueError("expected C-contiguous (nq, k) float32 dists and "
                         "int64 labels")
    lib = _load()
    if lib is None:
        dists[:, k_eff:] = sentinel_dist
        labels[:, k_eff:] = sentinel_label
        return
    nq, k = dists.shape
    lib.ft_fill_sentinels(_ptr(dists), _ptr(labels), nq, k, k_eff,
                          sentinel_dist, sentinel_label)
    calls["fill_sentinels"] += 1


class AlignedBuffer:
    """Page-aligned host buffer (≈ alloc_aligned, MetalResources.h:20-33)."""

    def __init__(self, nbytes: int):
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._ptr = lib.ft_alloc_aligned(nbytes)
            if not self._ptr:
                raise MemoryError(f"ft_alloc_aligned({nbytes}) failed")
            calls["alloc_aligned"] += 1
            self.array = np.ctypeslib.as_array(
                ctypes.cast(self._ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(nbytes,),
            )
        else:
            self._ptr = None
            self.array = np.empty(nbytes, np.uint8)

    def view(self, dtype, shape) -> np.ndarray:
        return self.array.view(dtype)[: int(np.prod(shape))].reshape(shape)

    def close(self):
        if self._ptr:
            self._lib.ft_free_aligned(self._ptr)
            self._ptr = None
            self.array = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
