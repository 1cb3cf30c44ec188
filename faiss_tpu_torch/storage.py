"""Device-side bf16 vector storage with amortized growth.

Counterpart of the bf16 part of ``faiss_tpu/storage.py``:
  * capacity grows by doubling from a 1024-row floor, copying old rows;
    rows past ntotal are zero;
  * norms are fp32 ``‖x‖²`` of the fp32 input, taken BEFORE the RNE
    quantization to bf16, for both metrics (the fused path's certificate
    bounds its sweep error with max‖v‖, ops/fused._sweep_eps);
  * bf16 conversion is ``Tensor.to(torch.bfloat16)``, round-to-nearest-even.

Layout: the JAX package pads d to the 128-lane TPU tile, a Mosaic rule. Here
d pads to a multiple of ``D_ALIGN`` = 8 elements, so that every row starts on
a 16-byte boundary and the kernels read rows as 16-byte vectors. Padding
columns are zero, so dot products and norms are unchanged by them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

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
    bit the split of ``faiss_tpu.storage.split_f32_bf16``."""
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


class DeviceStore:
    """Growable (capacity, d_pad) bf16 matrix + (capacity,) fp32 norms on
    one device. ``ntotal`` is the host-side count of stored rows."""

    def __init__(self, d: int, device):
        if d <= 0:
            raise ValueError(f"d must be positive, got {d}")
        self.d = int(d)
        self.d_pad = _round_up(self.d, D_ALIGN)
        self.device = torch.device(device)
        self.ntotal = 0
        self.capacity = 0
        self.db: Optional[torch.Tensor] = None      # (capacity, d_pad) bf16
        self.norms: Optional[torch.Tensor] = None   # (capacity,) f32 ‖v‖²

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = max(MIN_CAPACITY, _round_up(needed, ROW_TILE))
        if self.capacity:
            new_cap = max(new_cap, 2 * self.capacity)  # amortized doubling
        db = torch.zeros((new_cap, self.d_pad), dtype=torch.bfloat16,
                         device=self.device)
        norms = torch.zeros((new_cap,), dtype=torch.float32,
                            device=self.device)
        if self.capacity:
            db[: self.capacity] = self.db
            norms[: self.capacity] = self.norms
        self.db, self.norms, self.capacity = db, norms, new_cap

    def _check_rows(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) fp32 array, got {x.shape}")
        if self.ntotal + x.shape[0] > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors (int32 ids)")
        return x

    def add(self, x: np.ndarray) -> None:
        """Append n fp32 vectors: fp32 norms first, then RNE to bf16."""
        x = self._check_rows(x)
        if x.shape[0] == 0:
            return
        xd = torch.from_numpy(x).to(self.device)
        norms = torch.sum(xd * xd, dim=-1)
        self._append(xd.to(torch.bfloat16), norms)

    def add_raw(self, rows: torch.Tensor, norms: torch.Tensor) -> None:
        """Append already-quantized bf16 rows with their stored fp32 norms,
        bit for bit (the state carried from a saved index)."""
        if rows.dtype != torch.bfloat16 or rows.ndim != 2 \
                or rows.shape[1] != self.d:
            raise ValueError(
                f"expected (n, {self.d}) bf16 rows, got {tuple(rows.shape)} "
                f"{rows.dtype}")
        if norms.dtype != torch.float32 or norms.shape != rows.shape[:1]:
            raise ValueError("expected (n,) float32 norms")
        if rows.shape[0] == 0:
            return
        self._append(rows.to(self.device), norms.to(self.device))

    def _append(self, vecs: torch.Tensor, norms: torch.Tensor) -> None:
        n = vecs.shape[0]
        self._ensure_capacity(self.ntotal + n)
        self.db[self.ntotal: self.ntotal + n, : self.d] = vecs
        self.norms[self.ntotal: self.ntotal + n] = norms
        self.ntotal += n

    def reset(self) -> None:
        """Drop all vectors and release the device memory."""
        self.db = self.norms = None
        self.ntotal = self.capacity = 0

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        """(n, d) fp32 decode of stored rows [i0, i0 + n)."""
        if not (0 <= i0 and n >= 0 and i0 + n <= self.ntotal):
            raise IndexError(f"range [{i0}, {i0 + n}) out of [0, {self.ntotal})")
        rows = self.db[i0: i0 + n, : self.d].to(torch.float32)
        return rows.cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        if not (0 <= key < self.ntotal):
            raise IndexError(f"key {key} out of range [0, {self.ntotal})")
        return self.reconstruct_n(key, 1)[0]

    def nbytes(self) -> int:
        if self.db is None:
            return 0
        return self.db.numel() * 2 + self.norms.numel() * 4
