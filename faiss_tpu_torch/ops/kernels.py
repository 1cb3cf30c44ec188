"""The fused path's CUDA kernels: build, ctypes bindings, wrappers, counts.

The kernels live in ``faiss_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use they are compiled with ``nvcc`` for ``sm_90a``, one
nvcc per source, all started together, and linked into one shared library
under ``faiss_tpu_torch/_build/``, named by a hash of the sources and flags
(written to a temporary file, then renamed, so a reader never sees half a
library), and loaded with ``ctypes``. Importing this module builds
nothing.

Each wrapper dispatches on the device of its tensors: a CPU tensor goes to
the kernel's plain PyTorch version in ``ops/fused.py`` (the IVF budget
select's, ``budget_select_plain``, sits beside its wrapper here); a CUDA
tensor goes to the kernel, or the wrapper raises. There is no fallback
from one to the other. A launch runs on PyTorch's current stream, does not
synchronise, and writes into outputs the wrapper allocates; the C entry
point returns ``cudaGetLastError()`` and the wrapper raises if it is not
0.

``launches`` counts kernel launches per wrapper (never the plain versions),
so a run can show that the main path went through each kernel. A replay
of a captured search (``programs.py``) runs no wrapper: the program adds
the counts its capture recorded, once per replay.
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
from .topk import topk_scores

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")       # per source, with -c

GROUP = 128   # rows per candidate group (csrc/common.cuh ft::GROUP)

# the one piece of module state besides the counts: the loaded library
_lib_handle: Optional[ctypes.CDLL] = None

launches = {
    # every sweep runs on the tensor cores (csrc/sweep_split_mma.cu)
    "sweep_groupmax_1": 0,   # bf16 rows, one query plane  (_kernel_q1)
    "sweep_groupmax_2": 0,   # bf16 rows, two query planes (_kernel_qpair)
    "sweep_split_3": 0,      # f32 (hi, lo) planes, 3 terms (_kernel_split)
    "sweep_split_2": 0,      # f32 (hi, lo) planes, 2 terms (_kernel_split2)
    "sweep_int8": 0,         # int8 codes, two exact passes (_kernel_int8)
    "sweep_f16_2": 0,        # f16 rows, f16 query planes, 2 terms
                             # (_kernel_f16_pair)
    "sweep_f16_1": 0,        # f16 bits decoded, 2 terms (_kernel_f16_1)
    "select_groups": 0,
    "rescore_groups": 0,     # bf16 rows (_rescore_kernel)
    "rescore_groups_pair": 0,  # f32 hi + lo planes (_rescore_kernel, db2),
                               # streamed (rescore_stream_kernel)
    "rescore_groups_int8": 0,  # int8 codes against q∘s (_rescore_kernel)
    "rescore_groups_f16": 0,   # f16 bits (_rescore_kernel, int16 mode),
                               # streamed (rescore_stream_kernel)
    "rescore_groups_f32": 0,   # f32 rows: the IVF fine scan (f32 mode)
    "final_select": 0,
    "budget_select": 0,        # the IVF fine scan's top-k (no TPU kernel)
    # rescore + final top-k in one kernel (_rescore_select_kernel), by rows
    "rescore_select": 0,       # bf16 rows
    "rescore_select_int8": 0,  # int8 codes against q∘s
    "rescore_select_f16": 0,   # f16 bits
    # every sweep launch above that also wrote the supergroup maxes (the
    # _epilogue's second output), counted beside the sweep's own count
    "sweep_block_max": 0,
}

# ft_rescore_groups' row formats (csrc/rescore_groups.cu enum Rows), their
# launch counters and the row width d must be a multiple of (16-byte
# vectors), by the dtype of the rows; the pair mode apart
_RESCORE_FMT = {torch.bfloat16: (0, "rescore_groups", 8),
                torch.int8: (2, "rescore_groups_int8", 16),
                torch.float16: (3, "rescore_groups_f16", 8),
                torch.float32: (4, "rescore_groups_f32", 4)}
_RESCORE_PAIR = (1, "rescore_groups_pair", 8)
# ft_rescore_select's formats and counters (csrc/rescore_select.cu)
_SELECT_FMT = {torch.bfloat16: (0, "rescore_select"),
               torch.int8: (2, "rescore_select_int8"),
               torch.float16: (3, "rescore_select_f16")}
# ft_sweep_mma's row formats (csrc/sweep_split_mma.cu enum Fmt)
MMA_BF16_ROWS, MMA_F32_PLANES, MMA_F16_BITS, MMA_INT8_CODES = 0, 1, 2, 3
SUPERGROUP = 8   # groups per block-max entry (faiss_tpu SUPERGROUP)
RESCORE_SELECT_MAX_CAND = 36 * GROUP   # csrc/rescore_select.cu MAX_CAND
# positions of one chunk a block of the f32 rescore scores against one read
# of it (csrc/rescore_groups.cu F32_CAP)
RESCORE_F32_CAP = 16
FINAL_SELECT_MAX_K = 40   # csrc/final_select.cu MAX_K (fused.SELECT_MAX_KG)
BUDGET_SELECT_MAX_K = 40  # csrc/budget_select.cu MAX_K
# what the group select takes (csrc/select_groups.cu MAX_KG, MAX_COLS):
# faiss_tpu's SELECT_MAX_KG and SELECT_MAX_GROUPS
SELECT_MAX_KG = 40
SELECT_MAX_GROUPS = 16384


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


def _run_all(cmds) -> None:
    """Run the commands side by side; once all have ended, raise with the
    first failure's command and errors."""
    procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True))
             for c in cmds]
    failed = []
    for c, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{err}")
    if failed:
        raise RuntimeError(failed[0])


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link them into one
    library, once per source hash."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        srcs = [p for p in _sources() if p.suffix == ".cu"]
        objs = [os.path.join(tmp, p.stem + ".o") for p in srcs]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                  for p, o in zip(srcs, objs)])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {
            "ft_sweep_mma": [I, P, P, P, P, P, P, P, P, I, I, I, I, P],
            "ft_select_groups": [P, P, P, I, I, I, P],
            "ft_rescore_groups": [P, P, P, P, P, P, I, I, I, I, I, I, P,
                                  P],
            "ft_final_select": [P, P, P, I, I, I, P],
            "ft_budget_select": [P, P, P, P, P, I, I, I, P],
            "ft_rescore_select": [P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                  P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = I
        lib.ft_error_string.argtypes = [I]
        lib.ft_error_string.restype = ctypes.c_char_p
        lib.ft_rescore_f32_work.argtypes = [I, I, I]
        lib.ft_rescore_f32_work.restype = ctypes.c_longlong
        lib.ft_budget_select_work.argtypes = [I, I, I]
        lib.ft_budget_select_work.restype = ctypes.c_longlong
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


def _sweep_outputs(nq: int, ngroups: int, device, with_block_max: bool):
    """The group-max output and, with ``with_block_max``, the supergroup
    maxes (the kernel writes every entry of both); None otherwise."""
    gm = torch.empty((nq, ngroups), dtype=torch.float32, device=device)
    if not with_block_max:
        return gm, None
    if ngroups % SUPERGROUP:
        raise ValueError(f"block max needs ngroups % {SUPERGROUP} == 0 "
                         f"(ngroups={ngroups})")
    return gm, torch.empty((nq, ngroups // SUPERGROUP), dtype=torch.float32,
                           device=device)


def _sweep_result(gm, bmax):
    if bmax is None:
        return gm
    launches["sweep_block_max"] += 1
    return gm, bmax


def _check_sweep(planes, dbs, vn, *, q_dtype, db_dtype, align: int):
    """The checks every sweep wrapper shares; returns (nq, d, ngroups)."""
    for i, p in enumerate(planes):
        _check(p, f"q_plane{i}", q_dtype, 2)
    for i, p in enumerate(dbs):
        _check(p, f"db_plane{i}", db_dtype, 2)
    _check(vn, "vn", torch.float32, 1)
    nq, d = planes[0].shape
    db = dbs[0]
    nv_eff = vn.shape[0]
    if any(p.shape != planes[0].shape for p in planes) \
            or any(p.shape != db.shape for p in dbs) or db.shape[1] != d:
        raise ValueError("query planes and db planes disagree on shape")
    if d % align or nv_eff % GROUP or nv_eff > db.shape[0]:
        raise ValueError(f"need d % {align} == 0 and 128 | nv_eff ≤ capacity "
                         f"(d={d}, nv_eff={nv_eff}, cap={db.shape[0]})")
    return _int32(nq, "nq"), _int32(d, "d"), _int32(nv_eff // GROUP, "ngroups")


# Every sweep wrapper returns the (nq, nv_eff/128) group maxes gm, or with
# ``with_block_max`` the pair (gm, bmax), bmax (nq, nv_eff/1024) the max of
# each 8 consecutive groups, written by the same launch (ngroups % 8 == 0).


def sweep_groupmax(q_hi: torch.Tensor, q_lo: Optional[torch.Tensor],
                   db: torch.Tensor, vn: torch.Tensor, *,
                   metric: MetricType, with_block_max: bool = False):
    """Group maxes of the masked sweep scores over bf16 rows, with
    nv_eff = len(vn), on the tensor cores (certify with
    ``_sweep_eps(accum="mma")``): q1·v with one query plane when ``q_lo`` is
    None (K2), qh·v + ql·v with two (K1)."""
    planes = (q_hi,) if q_lo is None else (q_hi, q_lo)
    if not _on_cuda(*planes, db, vn):
        from .fused import sweep_groupmax_plain
        return sweep_groupmax_plain(q_hi, q_lo, db, vn, metric=metric,
                                    with_block_max=with_block_max)
    return _sweep_mma(f"sweep_groupmax_{len(planes)}", MMA_BF16_ROWS, planes,
                      (db,), vn, metric, with_block_max)


def sweep_split(q_hi: torch.Tensor, q_lo: Optional[torch.Tensor],
                db_hi: torch.Tensor, db_lo: torch.Tensor, vn: torch.Tensor,
                *, metric: MetricType, with_block_max: bool = False):
    """Group maxes of the f32 pair sweep over the bf16 (hi, lo) planes, on
    the tensor cores (certify with ``_sweep_eps(accum="mma")``): qh·dh +
    qh·dl + ql·dh with two query planes (3 terms, K3), q1·dh + q1·dl when
    ``q_lo`` is None (2 terms, each in its own accumulator, added once:
    K4)."""
    planes = (q_hi,) if q_lo is None else (q_hi, q_lo)
    if not _on_cuda(*planes, db_hi, db_lo, vn):
        from .fused import sweep_split_plain
        return sweep_split_plain(q_hi, q_lo, db_hi, db_lo, vn, metric=metric,
                                 with_block_max=with_block_max)
    return _sweep_mma(f"sweep_split_{len(planes) + 1}", MMA_F32_PLANES,
                      planes, (db_hi, db_lo), vn, metric, with_block_max)


# ft_sweep_mma's formats: (query dtype, row dtype, d multiple); the f16
# rows' two query planes are f16 (K6), their one plane bf16 (K7)
_MMA_DTYPES = {MMA_BF16_ROWS: (torch.bfloat16, torch.bfloat16, 8),
               MMA_F32_PLANES: (torch.bfloat16, torch.bfloat16, 8),
               MMA_F16_BITS: (torch.bfloat16, torch.float16, 8),
               MMA_INT8_CODES: (torch.int8, torch.int8, 16)}


def _sweep_mma(counter, fmt, planes, dbs, vn, metric, with_block_max,
               beta=None):
    """Launch ft_sweep_mma, the tensor-core sweep over the query
    ``planes`` in row format ``fmt``: bf16 rows (K1; K2 with one plane), the
    f32 planes ``dbs`` = (hi, lo) (K3; K4 with one plane), f16 bits (K6
    against two f16 planes scaled by ``beta``; K7 with one plane), or int8
    codes against (q₁, q₂) with ``beta`` (K5). Its float accumulation is
    what ``_sweep_eps(accum="mma")`` charges; K5's sums are exact."""
    q_dtype, db_dtype, align = _MMA_DTYPES[fmt]
    if fmt == MMA_F16_BITS and len(planes) == 2:
        q_dtype = torch.float16
    nq, d, ngroups = _check_sweep(planes, dbs, vn, q_dtype=q_dtype,
                                  db_dtype=db_dtype, align=align)
    _int32(ngroups * GROUP, "nv_eff")
    if beta is not None:
        _check(beta, "beta", torch.float32, 2)
        if beta.shape != (nq, 2):
            raise ValueError(f"beta: expected ({nq}, 2), got "
                             f"{tuple(beta.shape)}")
    gm, bmax = _sweep_outputs(nq, ngroups, dbs[0].device, with_block_max)
    with torch.cuda.device(dbs[0].device):
        _launch(counter, "ft_sweep_mma", fmt, planes[0].data_ptr(),
                planes[1].data_ptr() if len(planes) == 2 else None,
                dbs[0].data_ptr(),
                dbs[1].data_ptr() if len(dbs) == 2 else None, vn.data_ptr(),
                None if beta is None else beta.data_ptr(), gm.data_ptr(),
                None if bmax is None else bmax.data_ptr(), nq, d, ngroups,
                int(metric is MetricType.L2))
    return _sweep_result(gm, bmax)


def sweep_f16(q_hi: torch.Tensor, q_lo: Optional[torch.Tensor],
              db: torch.Tensor, vn: torch.Tensor, *,
              metric: MetricType, with_block_max: bool = False,
              scales: Optional[torch.Tensor] = None):
    """Group maxes over f16 rows (float16, the stored bits) on the tensor
    cores (certify with ``_sweep_eps(accum="mma")``, given the f16 planes
    as ``f16_planes``). Two f16 query planes with their (nq, 2) f32 powers
    of two ``scales`` (``storage.split_f32_f16``):
    fl(fl(2^-eh·(qh·v)) + fl(2^-el·(ql·v))) over the stored rows as they are, an f16 wgmma with no decode
    (_kernel_f16_pair, K6). One bf16 plane q1 (``q_lo`` None): q1·dh +
    q1·dl over each row's exact (hi, lo) bf16 pair, decoded in the kernel
    (_kernel_f16_1, K7). The plain version also takes two bf16 planes (the
    CPU route's split): qh·dh + qh·dl + ql·dh over the decoded pair."""
    planes = (q_hi,) if q_lo is None else (q_hi, q_lo)
    if not _on_cuda(*planes, db, vn):
        from .fused import sweep_f16_plain
        return sweep_f16_plain(q_hi, q_lo, db, vn, metric=metric,
                               with_block_max=with_block_max, scales=scales)
    if q_lo is not None and scales is None:
        raise ValueError("two f16 query planes need their scales "
                         "(storage.split_f32_f16)")
    return _sweep_mma(f"sweep_f16_{len(planes)}", MMA_F16_BITS, planes, (db,),
                      vn, metric, with_block_max,
                      beta=None if q_lo is None else scales)


def sweep_int8(q1: torch.Tensor, q2: torch.Tensor, db: torch.Tensor,
               vn: torch.Tensor, beta: torch.Tensor, *,
               metric: MetricType, with_block_max: bool = False):
    """Group maxes over int8 codes of β₁·(q₁·v) + β₂·(q₂·v), the two
    integer dots exact (_kernel_int8, on the integer tensor cores); ``beta``
    is (nq, 2) f32."""
    if not _on_cuda(q1, q2, db, vn, beta):
        from .fused import sweep_int8_plain
        return sweep_int8_plain(q1, q2, db, vn, beta, metric=metric,
                                with_block_max=with_block_max)
    return _sweep_mma("sweep_int8", MMA_INT8_CODES, (q1, q2), (db,), vn,
                      metric, with_block_max, beta=beta)


def select_groups(gm: torch.Tensor, kg: int):
    """(ascending top-kg group ids (nq, kg) int32, threshold t (nq,) f32,
    the lowest unnominated column's own value at their max)."""
    if not _on_cuda(gm):
        from .fused import select_groups_plain
        return select_groups_plain(gm, kg)
    _check(gm, "gm", torch.float32, 2)
    nq, ngroups = gm.shape
    if not (0 < kg <= SELECT_MAX_KG and kg <= ngroups <= SELECT_MAX_GROUPS):
        raise ValueError(f"need 0 < kg ≤ {SELECT_MAX_KG}, kg ≤ ngroups ≤ "
                         f"{SELECT_MAX_GROUPS} (kg={kg}, ngroups={ngroups})")
    gidx = torch.empty((nq, kg), dtype=torch.int32, device=gm.device)
    t = torch.empty((nq,), dtype=torch.float32, device=gm.device)
    with torch.cuda.device(gm.device):
        _launch("select_groups", "ft_select_groups", gm.data_ptr(),
                gidx.data_ptr(), t.data_ptr(), _int32(nq, "nq"), ngroups, kg)
    return gidx, t


def rescore_groups(queries: torch.Tensor, db: torch.Tensor, vn: torch.Tensor,
                   gidx: torch.Tensor, *, metric: MetricType,
                   db2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(nq, kg·128) fp32 scores of each query's nominated groups, against
    the rows ``db``: bf16 rows, int8 codes (pass the queries times the
    scales), f16 bits decoded exactly, f32 rows (the IVF fine scan: gidx
    holds pool chunk ids, in any order, repeated; the kernel reads each
    distinct chunk once a launch, after a grouping pass on the card into
    scratch this wrapper allocates), or hi + lo when ``db2`` (the lo plane
    of f32 storage) is given with the bf16 hi plane (stage 3a). The pair
    and the f16 bits stream by TMA, the thread-per-row kernel's scores bit
    for bit. A group id outside [0, nv_eff/128) is clamped into range."""
    dbs = (db,) if db2 is None else (db, db2)
    if not _on_cuda(queries, *dbs, vn, gidx):
        from .fused import rescore_groups_plain
        return rescore_groups_plain(queries, db, vn, gidx, metric=metric,
                                    db2=db2)
    if db.dtype not in _RESCORE_FMT or (db2 is not None
                                        and db.dtype != torch.bfloat16):
        raise TypeError(f"rescore_groups takes bf16, int8, float16 or "
                        f"float32 rows (a lo plane with bf16 only), got "
                        f"{db.dtype}")
    fmt, counter, align = _RESCORE_FMT[db.dtype] if db2 is None \
        else _RESCORE_PAIR
    _check(queries, "queries", torch.float32, 2)
    for i, p in enumerate(dbs):
        _check(p, f"db_plane{i}", db.dtype, 2)
    _check(vn, "vn", torch.float32, 1)
    _check(gidx, "gidx", torch.int32, 2)
    nq, d = queries.shape
    kg = gidx.shape[1]
    nv_eff = vn.shape[0]
    if any(p.shape != db.shape for p in dbs) or db.shape[1] != d \
            or gidx.shape[0] != nq:
        raise ValueError("queries, db planes and gidx disagree on shape")
    if d % align or nv_eff % GROUP or nv_eff > db.shape[0] or kg == 0:
        raise ValueError(f"need d % {align} == 0, 128 | nv_eff ≤ capacity, "
                         f"kg > 0 (d={d}, nv_eff={nv_eff}, kg={kg})")
    _int32(nq * kg, "nq·kg")
    ngroups = _int32(nv_eff // GROUP, "ngroups")
    out = torch.empty((nq, kg * GROUP), dtype=torch.float32,
                      device=db.device)
    with torch.cuda.device(db.device):
        work = None
        if fmt == _RESCORE_FMT[torch.float32][0]:
            work = torch.empty((_lib().ft_rescore_f32_work(nq, kg, ngroups),),
                               dtype=torch.int32, device=db.device)
        _launch(counter, "ft_rescore_groups", queries.data_ptr(), db.data_ptr(),
                None if db2 is None else db2.data_ptr(), vn.data_ptr(),
                gidx.data_ptr(), out.data_ptr(),
                _int32(nq, "nq"), _int32(d, "d"), _int32(kg, "kg"), ngroups,
                int(metric is MetricType.L2), fmt,
                None if work is None else work.data_ptr())
    return out


def final_select(s: torch.Tensor, k: int):
    """(descending top-k values (nq, k) f32, their columns (nq, k) int32),
    ties to the lowest column; each value is its column's own score."""
    if not _on_cuda(s):
        from .fused import final_select_plain
        return final_select_plain(s, k)
    _check(s, "s", torch.float32, 2)
    nq, ncand = s.shape
    if not (0 < k <= FINAL_SELECT_MAX_K and k <= ncand <= 16384):
        raise ValueError(f"need 0 < k ≤ {FINAL_SELECT_MAX_K}, k ≤ ncand ≤ "
                         f"16384 (k={k}, ncand={ncand})")
    vals = torch.empty((nq, k), dtype=torch.float32, device=s.device)
    pos = torch.empty((nq, k), dtype=torch.int32, device=s.device)
    with torch.cuda.device(s.device):
        _launch("final_select", "ft_final_select", s.data_ptr(),
                vals.data_ptr(), pos.data_ptr(), _int32(nq, "nq"), ncand, k)
    return vals, pos


def budget_select_plain(s: torch.Tensor, okc: torch.Tensor, k: int):
    """The IVF fine scan's top-k: ``topk_scores`` of the budget scores ``s``
    (nq, nbudget·128) with the columns of the dead chunks (``okc`` (nq,
    nbudget) False) set to −inf. (Descending values (nq, k) f32, their
    columns (nq, k) int32) in the fp32 total order, ties to the lowest
    column."""
    dead = ~okc.repeat_interleave(GROUP, dim=1)
    return topk_scores(s.masked_fill(dead, float("-inf")), k)


def budget_select(s: torch.Tensor, okc: torch.Tensor, k: int):
    """``budget_select_plain`` bit for bit, 0 < k ≤ 40, in one hand-written
    select (csrc/budget_select.cu) that reads no column of a dead chunk."""
    if not _on_cuda(s, okc):
        return budget_select_plain(s, okc, k)
    _check(s, "s", torch.float32, 2)
    _check(okc, "okc", torch.bool, 2)
    nq, ncols = s.shape
    nbudget = okc.shape[1]
    if okc.shape[0] != nq or ncols != nbudget * GROUP:
        raise ValueError(f"s {tuple(s.shape)} and okc {tuple(okc.shape)} "
                         f"disagree: need s (nq, nbudget·{GROUP})")
    if not 0 < k <= BUDGET_SELECT_MAX_K:
        raise ValueError(f"need 0 < k ≤ {BUDGET_SELECT_MAX_K} (k={k})")
    _int32(nq * ncols, "nq·ncols")
    vals = torch.empty((nq, k), dtype=torch.float32, device=s.device)
    pos = torch.empty((nq, k), dtype=torch.int32, device=s.device)
    with torch.cuda.device(s.device):
        work = torch.empty((_lib().ft_budget_select_work(nq, nbudget, k),),
                           dtype=torch.int32, device=s.device)
        _launch("budget_select", "ft_budget_select", s.data_ptr(),
                okc.data_ptr(), vals.data_ptr(), pos.data_ptr(),
                work.data_ptr(), _int32(nq, "nq"), nbudget, k)
    return vals, pos


def rescore_select_groups(queries: torch.Tensor, db: torch.Tensor,
                          vn: torch.Tensor, gidx: torch.Tensor, ntotal: int,
                          *, k: int, metric: MetricType):
    """(descending top-k scores (nq, k) f32, their row ids (nq, k) int32)
    of each query's nominated groups (ascending ``gidx``), rescored against
    bf16 rows, int8 codes (pass the queries times the scales) or f16 bits:
    ``rescore_groups`` → the mask of ``fused.candidate_drop`` →
    ``final_select`` → the row ids, in one kernel
    (_rescore_select_kernel; a thread-block cluster a query)."""
    if not _on_cuda(queries, db, vn, gidx):
        from .fused import rescore_select_groups_plain
        return rescore_select_groups_plain(queries, db, vn, gidx, ntotal,
                                           k=k, metric=metric)
    if db.dtype not in _SELECT_FMT:
        raise TypeError(f"rescore_select_groups takes bf16, int8 or float16 "
                        f"rows, got {db.dtype}")
    fmt, counter = _SELECT_FMT[db.dtype]
    align = 16 if db.dtype == torch.int8 else 8
    _check(queries, "queries", torch.float32, 2)
    _check(db, "db", db.dtype, 2)
    _check(vn, "vn", torch.float32, 1)
    _check(gidx, "gidx", torch.int32, 2)
    nq, d = queries.shape
    kg = gidx.shape[1]
    nv_eff = vn.shape[0]
    if db.shape[1] != d or gidx.shape[0] != nq:
        raise ValueError("queries, db and gidx disagree on shape")
    if (d % align or d > 2048 or nv_eff % GROUP or nv_eff > db.shape[0]
            or not 0 < kg * GROUP <= RESCORE_SELECT_MAX_CAND
            or not 0 < k <= kg * GROUP):
        raise ValueError(f"need d % {align} == 0, d ≤ 2048, 128 | nv_eff ≤ "
                         f"capacity, kg ≤ 36, 0 < k ≤ kg·128 (d={d}, "
                         f"nv_eff={nv_eff}, kg={kg}, k={k})")
    vals = torch.empty((nq, k), dtype=torch.float32, device=db.device)
    ids = torch.empty((nq, k), dtype=torch.int32, device=db.device)
    with torch.cuda.device(db.device):
        _launch(counter, "ft_rescore_select", queries.data_ptr(),
                db.data_ptr(), vn.data_ptr(), gidx.data_ptr(),
                vals.data_ptr(), ids.data_ptr(), _int32(nq, "nq"), d, kg,
                _int32(nv_eff // GROUP, "ngroups"), max(0, min(ntotal, nv_eff)),
                k, int(metric is MetricType.L2), fmt)
    return vals, ids
