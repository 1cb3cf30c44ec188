"""Device-side vector storage with amortized growth.

Counterpart of the bf16 and f32 parts of ``faiss_tpu/storage.py``:
  * capacity grows by doubling from a 1024-row floor, copying old rows;
    rows past ntotal are zero;
  * norms are fp32 ``‖x‖²`` of the fp32 input, taken BEFORE any
    quantization, for both metrics (the fused path's certificate bounds its
    sweep error with max‖v‖, ops/fused._sweep_eps);
  * bf16 conversion is ``Tensor.to(torch.bfloat16)``, round-to-nearest-even.

Device layout by storage mode (bytes per vector element):
  bf16                 db bf16                                      2 B
  f32, keep_master     db f32 master + db_hi, db_lo bf16 planes     8 B
  f32, ~keep_master    db_hi, db_lo only ("pair only"); the exact
                       f32 master lives in host memory for
                       reconstruct                                  4 B
The f32 planes are the bit-mask split of ``split_f32_bf16`` (hi truncated,
lo the RNE remainder), kept as two separate arrays: the fused path's sweep
reads both, and on integer-valued data (split statistics exactly zero) it
hands ``db_hi`` alone to the bf16 kernels. ``split_stats`` holds the exact
running ``[max‖v_lo‖, max‖v − hi − lo‖]`` the certificate charges.

Layout: the JAX package pads d to the 128-lane TPU tile, a Mosaic rule. Here
d pads to a multiple of ``D_ALIGN`` = 8 elements, so that every bf16 row
starts on a 16-byte boundary and the kernels read rows as 16-byte vectors.
Padding columns are zero, so dot products and norms are unchanged by them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import StorageType

MIN_CAPACITY = 1024     # first allocation floor, then doubling
ROW_TILE = 1024         # capacity granularity (a multiple of the 128-row group)
D_ALIGN = 8             # bf16 elements per 16-byte row chunk

_HI_MASK = -65536       # 0xFFFF0000 as int32: keep sign, exponent, 7 mantissa bits


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _trunc_bf16(x: torch.Tensor) -> torch.Tensor:
    """x truncated to a bf16-representable fp32 value (bit mask)."""
    return (x.contiguous().view(torch.int32) & _HI_MASK).view(torch.float32)


def split_f32_bf16(x: torch.Tensor):
    """Split fp32 into (hi, lo) bf16 with hi + lo ≈ x to ~2^-16 relative.

    ``hi`` is x TRUNCATED to bf16 by masking the low 16 bits of its int32
    view; ``lo`` is the exact fp32 remainder rounded (RNE) to bf16. Bit for
    bit the split of ``faiss_tpu.storage.split_f32_bf16``. The fp32 sum
    hi + lo is exact: both lie on the grid of x's last bit."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    hi32 = _trunc_bf16(x)
    return hi32.to(torch.bfloat16), (x - hi32).to(torch.bfloat16)


def split3_f32_bf16(x: torch.Tensor):
    """EXACT 3-way split: x == hi + mid + lo, each a bf16 value.

    fp32 has 24 significand bits = 3 × bf16's 8; truncating twice leaves a
    remainder with ≤ 8 significant bits, so the last term is exact."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    hi32 = _trunc_bf16(x)
    r1 = x - hi32
    mid32 = _trunc_bf16(r1)
    return (hi32.to(torch.bfloat16), mid32.to(torch.bfloat16),
            (r1 - mid32).to(torch.bfloat16))


def split_stats(v32: torch.Tensor, hi: torch.Tensor,
                lo: torch.Tensor) -> torch.Tensor:
    """(2,) f32 [max‖v_lo‖, max‖v − hi − lo‖] over the rows of one batch:
    the port of ``faiss_tpu.storage._split_stats_fn`` without its running
    max. Both are exact statistics (the subtraction is exact), and both are
    0 on integer-valued data, which the index's hi_exact dispatch reads."""
    lo32 = lo.to(torch.float32)
    resid = v32 - hi.to(torch.float32) - lo32
    return torch.stack([
        torch.amax(torch.sqrt(torch.sum(lo32 * lo32, dim=-1))),
        torch.amax(torch.sqrt(torch.sum(resid * resid, dim=-1)))])


class DeviceStore:
    """Growable (capacity, d_pad) device rows + (capacity,) fp32 norms on
    one device, in one of the layouts of the module docstring. ``ntotal``
    is the host-side count of stored rows."""

    def __init__(self, d: int, device, storage=StorageType.FLOAT32,
                 keep_master: bool = True):
        if d <= 0:
            raise ValueError(f"d must be positive, got {d}")
        self.storage = StorageType.coerce(storage)
        if self.storage not in (StorageType.FLOAT32, StorageType.BFLOAT16):
            raise NotImplementedError(
                f"storage {self.storage.value}: the port stores f32 and "
                "bf16 only so far")
        self.d = int(d)
        self.d_pad = _round_up(self.d, D_ALIGN)
        self.device = torch.device(device)
        self.keep_master = bool(keep_master)
        self.ntotal = 0
        self.capacity = 0
        # (capacity, d_pad): bf16 rows, the f32 master, or None (pair only)
        self.db: Optional[torch.Tensor] = None
        self.norms: Optional[torch.Tensor] = None   # (capacity,) f32 ‖v‖²
        self.db_hi: Optional[torch.Tensor] = None   # f32 only: bf16 planes
        self.db_lo: Optional[torch.Tensor] = None
        self.split_stats: Optional[torch.Tensor] = None   # (2,) f32 running max
        self._split_stats_host: Optional[Tuple[float, float]] = None
        self._host_rows: list = []   # pair only: the exact f32 master rows

    @property
    def has_split(self) -> bool:
        return self.storage is StorageType.FLOAT32

    @property
    def pair_only(self) -> bool:
        """True when the device holds only the bf16 (hi, lo) planes (f32
        storage with keep_master=False), as in the JAX package."""
        return self.has_split and not self.keep_master

    def _buffers(self):
        """(name, dtype, row shape) of every per-row device buffer."""
        rows = (self.d_pad,)
        out = [("norms", torch.float32, ())]
        if not self.has_split:
            out.append(("db", torch.bfloat16, rows))
        else:
            if self.keep_master:
                out.append(("db", torch.float32, rows))
            out += [("db_hi", torch.bfloat16, rows),
                    ("db_lo", torch.bfloat16, rows)]
        return out

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = max(MIN_CAPACITY, _round_up(needed, ROW_TILE))
        if self.capacity:
            new_cap = max(new_cap, 2 * self.capacity)  # amortized doubling
        for name, dtype, shape in self._buffers():
            buf = torch.zeros((new_cap,) + shape, dtype=dtype,
                              device=self.device)
            if self.capacity:
                buf[: self.capacity] = getattr(self, name)
            setattr(self, name, buf)
        self.capacity = new_cap

    def _check_rows(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) fp32 array, got {x.shape}")
        if self.ntotal + x.shape[0] > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors (int32 ids)")
        return x

    def add(self, x: np.ndarray) -> None:
        """Append n fp32 vectors: fp32 norms first, then the stored form
        (RNE to bf16, or the f32 master and its split planes)."""
        x = self._check_rows(x)
        if x.shape[0] == 0:
            return
        xd = torch.from_numpy(x).to(self.device)
        norms = torch.sum(xd * xd, dim=-1)
        if self.has_split:
            self._append_f32(xd, norms)
        else:
            self._append(norms, db=xd.to(torch.bfloat16))

    def add_raw(self, rows: torch.Tensor, norms: torch.Tensor) -> None:
        """Append already-quantized bf16 rows with their stored fp32 norms,
        bit for bit (the state carried from a saved bf16 index)."""
        if self.has_split:
            raise TypeError("add_raw takes bf16 rows; use add_raw_f32")
        self._check_raw(rows, norms, torch.bfloat16)
        if rows.shape[0]:
            self._append(norms.to(self.device), db=rows.to(self.device))

    def add_raw_f32(self, rows: torch.Tensor, norms: torch.Tensor) -> None:
        """Append f32 rows with their stored fp32 norms kept bit for bit
        (the state carried from a saved f32 index); the planes and the split
        statistics are derived from the rows."""
        if not self.has_split:
            raise TypeError("add_raw_f32 takes f32 rows; use add_raw")
        self._check_raw(rows, norms, torch.float32)
        if rows.shape[0]:
            self._append_f32(rows.to(self.device), norms.to(self.device))

    def _check_raw(self, rows, norms, dtype) -> None:
        if rows.dtype != dtype or rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(
                f"expected (n, {self.d}) {dtype} rows, got "
                f"{tuple(rows.shape)} {rows.dtype}")
        if norms.dtype != torch.float32 or norms.shape != rows.shape[:1]:
            raise ValueError("expected (n,) float32 norms")
        if self.ntotal + rows.shape[0] > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors (int32 ids)")

    def _append_f32(self, v32: torch.Tensor, norms: torch.Tensor) -> None:
        """f32 rows: the planes, the running split statistics (mirrored to
        the host once per batch, so no search ever waits on the device for
        them), the master on the device or, pair only, on the host."""
        hi, lo = split_f32_bf16(v32)
        batch = split_stats(v32, hi, lo)
        self.split_stats = batch if self.split_stats is None \
            else torch.maximum(self.split_stats, batch)
        s = self.split_stats.cpu().tolist()
        self._split_stats_host = (float(s[0]), float(s[1]))
        if self.keep_master:
            self._append(norms, db=v32, db_hi=hi, db_lo=lo)
        else:
            self._host_rows.append(v32.cpu().numpy().copy())
            self._append(norms, db_hi=hi, db_lo=lo)

    def _append(self, norms: torch.Tensor, **rows: torch.Tensor) -> None:
        n = norms.shape[0]
        self._ensure_capacity(self.ntotal + n)
        for name, vecs in rows.items():
            getattr(self, name)[self.ntotal: self.ntotal + n, : self.d] = vecs
        self.norms[self.ntotal: self.ntotal + n] = norms
        self.ntotal += n

    def split_stats_host(self) -> Tuple[float, float]:
        """Host copy of the exact (max‖v_lo‖, max‖v − hi − lo‖), refreshed
        by every add; (inf, inf) while nothing is stored or for bf16. (0, 0)
        proves the lo and residual planes all-zero (integer-valued data)."""
        if self._split_stats_host is None:
            return (float("inf"), float("inf"))
        return self._split_stats_host

    def reset(self) -> None:
        """Drop all vectors and release the device memory."""
        for name, _, _ in self._buffers():
            setattr(self, name, None)
        self.split_stats = self._split_stats_host = None
        self._host_rows = []
        self.ntotal = self.capacity = 0

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        """(n, d) fp32 decode of stored rows [i0, i0 + n): the bf16 values,
        or the exact f32 master (from the host when pair only)."""
        if not (0 <= i0 and n >= 0 and i0 + n <= self.ntotal):
            raise IndexError(f"range [{i0}, {i0 + n}) out of [0, {self.ntotal})")
        if self.pair_only:
            if len(self._host_rows) != 1:   # consolidate lazily
                self._host_rows = [np.concatenate(
                    self._host_rows or [np.zeros((0, self.d), np.float32)])]
            return self._host_rows[0][i0: i0 + n].copy()
        rows = self.db[i0: i0 + n, : self.d].to(torch.float32)
        return rows.cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        if not (0 <= key < self.ntotal):
            raise IndexError(f"key {key} out of range [0, {self.ntotal})")
        return self.reconstruct_n(key, 1)[0]

    def nbytes(self) -> int:
        """Device bytes of every stored buffer."""
        bufs = [getattr(self, name) for name, _, _ in self._buffers()]
        return sum(b.numel() * b.element_size() for b in bufs if b is not None)
