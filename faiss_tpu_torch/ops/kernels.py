"""The fused path's CUDA kernels: build, ctypes bindings, wrappers, counts.

The four kernels live in ``faiss_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use they are compiled with ``nvcc`` for ``sm_90a`` into
one shared library under ``faiss_tpu_torch/_build/``, named by a hash of the
sources and flags (written to a temporary file, then renamed, so a reader
never sees half a library), and loaded with ``ctypes``. Importing this
module builds nothing.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the kernel's plain PyTorch version in ``ops/fused.py``; a CUDA tensor goes
to the kernel, or the wrapper raises. There is no fallback from one to the
other. A launch runs on PyTorch's current stream, does not synchronise, and
writes into outputs the wrapper allocates; the C entry point returns
``cudaGetLastError()`` and the wrapper raises if it is not 0.

``launches`` counts kernel launches per wrapper (never the plain versions),
so a run can show that the main path went through each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from ..dtypes import MetricType

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

GROUP = 128   # rows per candidate group (csrc/common.cuh ft::GROUP)

# the one piece of module state besides the counts: the loaded library
_lib_handle: Optional[ctypes.CDLL] = None

launches = {
    "sweep_groupmax_1": 0,   # one query plane  (replaces _kernel_q1)
    "sweep_groupmax_2": 0,   # two query planes (replaces _kernel_qpair)
    "select_groups": 0,
    "rescore_groups": 0,
    "final_select": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        from torch.utils.cpp_extension import CUDA_HOME
        if CUDA_HOME is not None:
            exe = os.path.join(CUDA_HOME, "bin", "nvcc")
    if exe is None or not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def library_path() -> Path:
    """Where the library of the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfaiss_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library (once per source hash)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {
            "ft_sweep_groupmax": [P, P, I, P, P, P, I, I, I, I, P],
            "ft_select_groups": [P, P, P, I, I, I, P],
            "ft_rescore_groups": [P, P, P, P, P, I, I, I, I, I, P],
            "ft_final_select": [P, P, P, I, I, I, P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        lib.ft_error_string.argtypes = [I]
        lib.ft_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device}, {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _int32(v: int, name: str) -> int:
    if not 0 < v < 2 ** 31:
        raise ValueError(f"{name}={v} does not fit the kernels' int32")
    return v


def _launch(name: str, fn_name: str, *args) -> None:
    lib = _lib()
    rc = getattr(lib, fn_name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{fn_name} failed: {lib.ft_error_string(rc).decode()} ({rc})")
    launches[name] += 1


def sweep_groupmax(q_hi: torch.Tensor, q_lo: Optional[torch.Tensor],
                   db: torch.Tensor, vn: torch.Tensor, *,
                   metric: MetricType) -> torch.Tensor:
    """(nq, nv_eff/128) group maxes of the masked sweep scores, with
    nv_eff = len(vn); one query plane when ``q_lo`` is None, else two."""
    planes = (q_hi,) if q_lo is None else (q_hi, q_lo)
    if not _on_cuda(*planes, db, vn):
        from .fused import sweep_groupmax_plain
        return sweep_groupmax_plain(q_hi, q_lo, db, vn, metric=metric)
    for i, p in enumerate(planes):
        _check(p, f"q_plane{i}", torch.bfloat16, 2)
    _check(db, "db", torch.bfloat16, 2)
    _check(vn, "vn", torch.float32, 1)
    nq, d = q_hi.shape
    nv_eff = vn.shape[0]
    if any(p.shape != q_hi.shape for p in planes) or db.shape[1] != d:
        raise ValueError("query planes and db disagree on shape")
    if d % 8 or nv_eff % GROUP or nv_eff > db.shape[0]:
        raise ValueError(f"need d % 8 == 0 and 128 | nv_eff ≤ capacity "
                         f"(d={d}, nv_eff={nv_eff}, cap={db.shape[0]})")
    ngroups = nv_eff // GROUP
    gm = torch.empty((nq, ngroups), dtype=torch.float32, device=db.device)
    with torch.cuda.device(db.device):
        _launch(f"sweep_groupmax_{len(planes)}", "ft_sweep_groupmax",
                q_hi.data_ptr(), planes[-1].data_ptr(), len(planes),
                db.data_ptr(), vn.data_ptr(), gm.data_ptr(),
                _int32(nq, "nq"), _int32(d, "d"), _int32(ngroups, "ngroups"),
                int(metric is MetricType.L2))
    return gm


def select_groups(gm: torch.Tensor, kg: int):
    """(ascending top-kg group ids (nq, kg) int32, threshold t (nq,) f32)."""
    if not _on_cuda(gm):
        from .fused import select_groups_plain
        return select_groups_plain(gm, kg)
    _check(gm, "gm", torch.float32, 2)
    nq, ngroups = gm.shape
    if not 0 < kg <= ngroups <= 16384:
        raise ValueError(f"need 0 < kg ≤ ngroups ≤ 16384 "
                         f"(kg={kg}, ngroups={ngroups})")
    gidx = torch.empty((nq, kg), dtype=torch.int32, device=gm.device)
    t = torch.empty((nq,), dtype=torch.float32, device=gm.device)
    with torch.cuda.device(gm.device):
        _launch("select_groups", "ft_select_groups", gm.data_ptr(),
                gidx.data_ptr(), t.data_ptr(), _int32(nq, "nq"), ngroups, kg)
    return gidx, t


def rescore_groups(queries: torch.Tensor, db: torch.Tensor, vn: torch.Tensor,
                   gidx: torch.Tensor, *, metric: MetricType) -> torch.Tensor:
    """(nq, kg·128) fp32 scores of each query's nominated groups."""
    if not _on_cuda(queries, db, vn, gidx):
        from .fused import rescore_groups_plain
        return rescore_groups_plain(queries, db, vn, gidx, metric=metric)
    _check(queries, "queries", torch.float32, 2)
    _check(db, "db", torch.bfloat16, 2)
    _check(vn, "vn", torch.float32, 1)
    _check(gidx, "gidx", torch.int32, 2)
    nq, d = queries.shape
    kg = gidx.shape[1]
    nv_eff = vn.shape[0]
    if db.shape[1] != d or gidx.shape[0] != nq:
        raise ValueError("queries, db and gidx disagree on shape")
    if d % 8 or nv_eff % GROUP or nv_eff > db.shape[0] or kg == 0:
        raise ValueError(f"need d % 8 == 0, 128 | nv_eff ≤ capacity, kg > 0 "
                         f"(d={d}, nv_eff={nv_eff}, kg={kg})")
    out = torch.empty((nq, kg * GROUP), dtype=torch.float32,
                      device=db.device)
    with torch.cuda.device(db.device):
        _launch("rescore_groups", "ft_rescore_groups", queries.data_ptr(),
                db.data_ptr(), vn.data_ptr(), gidx.data_ptr(), out.data_ptr(),
                _int32(nq, "nq"), _int32(d, "d"), _int32(kg, "kg"),
                _int32(nv_eff // GROUP, "ngroups"),
                int(metric is MetricType.L2))
    return out


def final_select(s: torch.Tensor, k: int):
    """(descending top-k values (nq, k) f32, their columns (nq, k) int32)."""
    if not _on_cuda(s):
        from .fused import final_select_plain
        return final_select_plain(s, k)
    _check(s, "s", torch.float32, 2)
    nq, ncand = s.shape
    if not 0 < k <= ncand <= 16384:
        raise ValueError(f"need 0 < k ≤ ncand ≤ 16384 (k={k}, ncand={ncand})")
    vals = torch.empty((nq, k), dtype=torch.float32, device=s.device)
    pos = torch.empty((nq, k), dtype=torch.int32, device=s.device)
    with torch.cuda.device(s.device):
        _launch("final_select", "ft_final_select", s.data_ptr(),
                vals.data_ptr(), pos.data_ptr(), _int32(nq, "nq"), ncand, k)
    return vals, pos
