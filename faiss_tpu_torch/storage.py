"""Device-side vector storage with amortized growth.

Counterpart of ``faiss_tpu/storage.py``:
  * capacity grows by doubling from a 1024-row floor, copying old rows;
    rows past ntotal are zero;
  * norms are fp32 ``‖x‖²`` of the fp32 input, taken BEFORE any
    quantization, for both metrics (the fused path's certificate bounds its
    sweep error with max‖v‖, ops/fused._sweep_eps); int8 storage keeps the
    norms of the DECODED rows instead (see below);
  * bf16 conversion is ``f32_to_bf16`` (round to nearest even, every NaN
    to sign | 0x7fc0, bit for bit ``jnp.astype(jnp.bfloat16)`` on the CPU
    and on the card); f16 conversion is ``encode_f16_bits``, round to
    nearest even with the NaN lanes written from the input's bits;
  * a bf16 or f16 add batch of at least ``NATIVE_CONVERT_MIN_ELEMS``
    elements converts on the host instead, as ``faiss_tpu``'s does
    (``faiss_tpu/storage.py:540-543``, ``:647-662``): norms by
    ``native.l2_norms`` (double accumulation), the rows padded to d_pad and
    converted by the native runtime, one 2-byte upload. Its bf16 NaN lanes
    keep the native runtime's bits (sign | (x >> 16) | 0x40, payload kept),
    which is what ``faiss_tpu`` stores at that batch size.

Device layout by storage mode (bytes per vector element):
  bf16                 db bf16                                      2 B
  f16                  db float16: the f16 bit patterns, which the
                       kernels read as uint16 and decode in-register 2 B
  int8                 db int8 codes + (d_pad,) f32 per-dimension
                       scales                                       1 B
  f32, keep_master     db f32 master + db_hi, db_lo bf16 planes     8 B
  f32, ~keep_master    db_hi, db_lo only ("pair only"); the exact
                       f32 master lives in host memory for
                       reconstruct                                  4 B
The f32 planes are the bit-mask split of ``split_f32_bf16`` (hi truncated,
lo the RNE remainder), kept as two separate arrays: the fused path's sweep
reads both, and on integer-valued data (split statistics exactly zero) it
hands ``db_hi`` alone to the bf16 kernels. ``split_stats`` holds the exact
running ``[max‖v_lo‖, max‖v − hi − lo‖]`` the certificate charges (f32,
and f16 over the decoded (hi, lo) pair).

f16: subnormal patterns are flushed to ±0 at ingest (the JAX package's
contract, kept so that both store the same bits), and every e=31 pattern,
NaN included, decodes to ±inf (``decode_f16_bits``). A running count of
those patterns says whether the stored bits are clean (``f16_clean``).

int8: per-dimension symmetric scales, frozen by ``train`` (or on the first
add batch); codes round(x / s) clipped to ±127. The norms are those of the
decoded rows s∘v_q, so that the sweep and the rescore subtract the same
value and a search returns the exact top-k of the decoded database;
``int_norm_max`` (max ‖v_q‖, a device scalar) bounds the certificate.

Layout: the JAX package pads d to the 128-lane TPU tile, a Mosaic rule. Here
d pads to a multiple of ``D_ALIGN`` = 8 elements (16 for int8), so that
every row starts on a 16-byte boundary and the kernels read rows as 16-byte
vectors. Padding columns are zero, so dot products and norms are unchanged
by them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import native
from .dtypes import StorageType

MIN_CAPACITY = 1024     # first allocation floor, then doubling
# bf16 and f16 add batches of at least this many elements convert on the
# host (native/): faiss_tpu's NATIVE_CONVERT_MIN_ELEMS
NATIVE_CONVERT_MIN_ELEMS = 1 << 20
ROW_TILE = 1024         # capacity granularity (a multiple of the 128-row group)
D_ALIGN = 8             # bf16 / f16 elements per 16-byte row chunk
D_ALIGN_INT8 = 16       # int8 codes per 16-byte row chunk

_HI_MASK = -65536       # 0xFFFF0000 as int32: keep sign, exponent, 7 mantissa bits
_BF16_QNAN = 0x7FC0     # the bf16 NaN of jnp.astype, under the input's sign

_ROW_DTYPE = {
    StorageType.FLOAT32: torch.float32,
    StorageType.BFLOAT16: torch.bfloat16,
    StorageType.FLOAT16: torch.float16,
    StorageType.INT8: torch.int8,
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def f32_to_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 → bf16, bit for bit ``jnp.asarray(x).astype(jnp.bfloat16)``:
    round to nearest even, and every NaN, whatever its payload, to
    sign | 0x7fc0. ``Tensor.to`` rounds the rest alike on the CPU and on
    the card but gives NaN another pattern (0xffff on the CPU), so the NaN
    lanes are written here from the input's sign bit: the result depends on
    neither library's conversion of a NaN."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    x = x.contiguous()
    # each value's high 16 bits (sign first), a view: both devices are
    # little-endian. Five elementwise kernels in all: this runs on the
    # queries in every search.
    high = x.reshape(-1).view(torch.int16)[1::2].view(x.shape)
    return torch.where(torch.isnan(x), (high & -0x8000) | _BF16_QNAN,
                       x.to(torch.bfloat16).view(torch.int16)
                       ).view(torch.bfloat16)


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
    return f32_to_bf16(hi32), f32_to_bf16(x - hi32)


def split3_f32_bf16(x: torch.Tensor):
    """EXACT 3-way split: x == hi + mid + lo, each a bf16 value.

    fp32 has 24 significand bits = 3 × bf16's 8; truncating twice leaves a
    remainder with ≤ 8 significant bits, so the last term is exact."""
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    hi32 = _trunc_bf16(x)
    r1 = x - hi32
    mid32 = _trunc_bf16(r1)
    return (f32_to_bf16(hi32), f32_to_bf16(mid32), f32_to_bf16(r1 - mid32))


def encode_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """fp32 → f16 (round to nearest even), as a float16 tensor whose bits
    are those of ``faiss_tpu.storage.encode_f16_bits``. ``Tensor.to``
    rounds alike on the CPU and on the card, but the card turns every NaN
    into 0x7fff, which the f16 contract decodes to +inf whatever the NaN's
    sign. The NaN lanes are written here from the input's bits, sign |
    0x7c00 | 0x200 | mantissa >> 13, as XLA, the CPU and the native
    ``f32_to_f16`` write them."""
    x = x.to(torch.float32).contiguous()
    u = x.view(torch.int32)
    nan = (((u >> 16) & -0x8000) | 0x7E00 | ((u >> 13) & 0x3FF)).to(
        torch.int16)
    return torch.where(torch.isnan(x), nan,
                       x.to(torch.float16).view(torch.int16)
                       ).view(torch.float16)


def flush_f16_subnormals(x: torch.Tensor) -> torch.Tensor:
    """f16 subnormal patterns (exponent 0, mantissa ≠ 0) → ±0, keeping the
    sign: the ingest flush of ``faiss_tpu.storage.DeviceStore._append``."""
    bits = x.view(torch.int16)
    sub = ((bits & 0x7C00) == 0) & ((bits & 0x3FF) != 0)
    return torch.where(sub, bits & -0x8000, bits).view(torch.float16)


def _f16_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """True on the e=31 patterns (±inf, NaN) of a float16 tensor."""
    return (x.view(torch.int16) & 0x7C00) == 0x7C00


def decode_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """float16 patterns → their EXACT fp32 values, with every e=31 pattern
    (±inf and NaN alike) mapped to ±inf by its sign bit, as
    ``faiss_tpu.storage.decode_f16_bits`` does. (A plain conversion would
    keep NaN as NaN.)"""
    inf = torch.where(x.view(torch.int16) < 0, float("-inf"), float("inf"))
    return torch.where(_f16_nonfinite(x), inf, x.to(torch.float32))


def split_f16_bits(x: torch.Tensor):
    """f16 patterns → the EXACT (hi, lo) bf16 pair: hi the truncated decode,
    lo = decode − hi (≤ 3 significant bits, exact), 0 where the decode is
    not finite. ``faiss_tpu.storage.split_f16_bits``, bit for bit."""
    f = decode_f16_bits(x)
    hi32 = _trunc_bf16(f)
    lo = torch.where(torch.isfinite(f), f - hi32, torch.zeros_like(f))
    return f32_to_bf16(hi32), f32_to_bf16(lo)


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


def quantize_int8(x: torch.Tensor, scales: torch.Tensor):
    """Per-dimension symmetric int8 quantization, the port of
    ``faiss_tpu.storage._quantize_int8_fn``: (codes int8, fp32 norms of the
    DECODED rows, the batch max ‖v_q‖, the count of clipped elements as an
    f32 scalar). ``x`` and ``scales`` have the same width."""
    raw = torch.round(x / scales[None, :])
    clipped = torch.sum((torch.abs(raw) > 127.0).to(torch.float32))
    q = torch.clamp(raw, -127.0, 127.0)
    dec = q * scales[None, :]
    norms = torch.sum(dec * dec, dim=-1)
    vq_norm = torch.sqrt(torch.amax(torch.sum(q * q, dim=-1)))
    return q.to(torch.int8), norms, vq_norm, clipped


class DeviceStore:
    """Growable (capacity, d_pad) device rows + (capacity,) fp32 norms on
    one device, in one of the layouts of the module docstring. ``ntotal``
    is the host-side count of stored rows."""

    def __init__(self, d: int, device, storage=StorageType.FLOAT32,
                 keep_master: bool = True):
        if d <= 0:
            raise ValueError(f"d must be positive, got {d}")
        self.storage = StorageType.coerce(storage)
        self.d = int(d)
        align = D_ALIGN_INT8 if self.storage is StorageType.INT8 else D_ALIGN
        self.d_pad = _round_up(self.d, align)
        self.device = torch.device(device)
        self.keep_master = bool(keep_master)
        self.ntotal = 0
        self.capacity = 0
        # (capacity, d_pad): stored rows, the f32 master, or None (pair only)
        self.db: Optional[torch.Tensor] = None
        self.norms: Optional[torch.Tensor] = None   # (capacity,) f32 ‖v‖²
        self.db_hi: Optional[torch.Tensor] = None   # f32 only: bf16 planes
        self.db_lo: Optional[torch.Tensor] = None
        self.split_stats: Optional[torch.Tensor] = None   # (2,) f32 running max
        self._split_stats_host: Optional[Tuple[float, float]] = None
        self._host_rows: list = []   # pair only: the exact f32 master rows
        # f16: running count of e=31 patterns (f32 device scalar)
        self._f16_dirty: Optional[torch.Tensor] = None
        self._f16_clean_host: Optional[bool] = None
        # int8: frozen (d_pad,) scales, running max ‖v_q‖ and clipped count
        # (f32 device scalars, so that an add or a search never waits)
        self.scales: Optional[torch.Tensor] = None
        self.int_norm_max: Optional[torch.Tensor] = None
        self._int8_clipped: Optional[torch.Tensor] = None
        self._int8_elems = 0

    @property
    def row_dtype(self) -> torch.dtype:
        return _ROW_DTYPE[self.storage]

    @property
    def has_split(self) -> bool:
        return self.storage is StorageType.FLOAT32

    @property
    def pair_only(self) -> bool:
        """True when the device holds only the bf16 (hi, lo) planes (f32
        storage with keep_master=False), as in the JAX package."""
        return self.has_split and not self.keep_master

    @property
    def is_trained(self) -> bool:
        return self.storage is not StorageType.INT8 or self.scales is not None

    def train(self, x: np.ndarray) -> None:
        """int8: freeze per-dimension scales max|x| / 127 (floored at
        1e-12; padding dimensions 1) from a sample, as
        ``faiss_tpu.storage.DeviceStore.train``. A no-op for the other
        storage modes; a second train raises (reset keeps the scales)."""
        if self.storage is not StorageType.INT8:
            return
        if self.is_trained:
            raise RuntimeError(
                "int8 scales are frozen once trained (reset() does not "
                "clear them; build a new index to retrain)")
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) fp32 array, got {x.shape}")
        amax = np.abs(x).max(axis=0)
        s = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
        self.set_scales(s)

    def set_scales(self, scales: np.ndarray) -> None:
        """Freeze the int8 scales to ``scales[:d]`` exactly (the state
        carried from a saved int8 index)."""
        sp = np.ones((self.d_pad,), np.float32)
        sp[: self.d] = np.asarray(scales, np.float32)[: self.d]
        self.scales = torch.from_numpy(sp).to(self.device)

    def _buffers(self):
        """(name, dtype, row shape) of every per-row device buffer."""
        rows = (self.d_pad,)
        out = [("norms", torch.float32, ())]
        if not self.has_split:
            out.append(("db", self.row_dtype, rows))
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

    def _check_count(self, n: int) -> None:
        if self.ntotal + n > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors (int32 ids)")

    def add(self, x: np.ndarray) -> None:
        """Append n fp32 vectors in the stored form: fp32 norms first, then
        RNE to bf16 or f16, the f32 master and its planes, or the int8
        codes (training the scales on the first batch)."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) fp32 array, got {x.shape}")
        self._check_count(x.shape[0])
        if x.shape[0] == 0:
            return
        if self.storage is StorageType.INT8:
            if not self.is_trained:
                self.train(x)   # auto-train on the first batch, as JAX does
            self._append_int8(torch.from_numpy(x).to(self.device))
            return
        if (self.storage in (StorageType.BFLOAT16, StorageType.FLOAT16)
                and x.size >= NATIVE_CONVERT_MIN_ELEMS
                and native.available()):
            rows, norms = self._convert_host(x)
            if self.storage is StorageType.FLOAT16:
                self._append_f16(rows, norms)
            else:
                self._append(norms, db=rows)
            return
        xd = torch.from_numpy(x).to(self.device)
        norms = torch.sum(xd * xd, dim=-1)
        if self.has_split:
            self._append_f32(xd, norms)
        elif self.storage is StorageType.FLOAT16:
            self._append_f16(encode_f16_bits(xd), norms)
        else:
            self._append(norms, db=f32_to_bf16(xd))

    def _convert_host(self, x: np.ndarray):
        """The native route: fp32 norms of the unpadded rows in double,
        then the rows padded to d_pad and converted on host threads, and
        one upload of 2 bytes an element (rows, then norms)."""
        norms = native.l2_norms(x)
        if self.d_pad != self.d:
            xp = np.zeros((x.shape[0], self.d_pad), np.float32)
            xp[:, : self.d] = x
            x = xp
        if self.storage is StorageType.BFLOAT16:
            rows = native.bf16_tensor(native.f32_to_bf16(x))
        else:
            rows = torch.from_numpy(native.f32_to_f16(x))
        return rows.to(self.device), torch.from_numpy(norms).to(self.device)

    def add_raw(self, rows: torch.Tensor, norms: torch.Tensor) -> None:
        """Append rows already in the stored dtype (f32, bf16, f16 bits or
        int8 codes) with their stored fp32 norms kept bit for bit: the
        state carried from a saved index. The f32 planes, the split
        statistics, the f16 ingest flush and int_norm_max are derived from
        the rows, as the JAX loader derives them; int8 needs its scales set
        first (``set_scales``)."""
        dtype = self.row_dtype
        if rows.dtype != dtype or rows.ndim != 2 or rows.shape[1] != self.d:
            raise ValueError(
                f"expected (n, {self.d}) {dtype} rows, got "
                f"{tuple(rows.shape)} {rows.dtype}")
        if norms.dtype != torch.float32 or norms.shape != rows.shape[:1]:
            raise ValueError("expected (n,) float32 norms")
        if not self.is_trained:
            raise RuntimeError("int8 rows need the scales: set_scales first")
        self._check_count(rows.shape[0])
        if not rows.shape[0]:
            return
        rows, norms = rows.to(self.device), norms.to(self.device)
        if self.has_split:
            self._append_f32(rows, norms)
        elif self.storage is StorageType.FLOAT16:
            self._append_f16(rows, norms)
        elif self.storage is StorageType.INT8:
            q = rows.to(torch.float32)
            self._bump_int_norm(torch.sqrt(torch.amax(torch.sum(q * q, -1))))
            self._append(norms, db=rows)
        else:
            self._append(norms, db=rows)

    def _bump_split_stats(self, batch: torch.Tensor) -> None:
        self.split_stats = batch if self.split_stats is None \
            else torch.maximum(self.split_stats, batch)
        self._split_stats_host = None

    def _append_f32(self, v32: torch.Tensor, norms: torch.Tensor) -> None:
        """f32 rows: the planes, the running split statistics (mirrored to
        the host once per batch, so no search ever waits on the device for
        them), the master on the device or, pair only, on the host."""
        hi, lo = split_f32_bf16(v32)
        self._bump_split_stats(split_stats(v32, hi, lo))
        self.split_stats_host()
        if self.keep_master:
            self._append(norms, db=v32, db_hi=hi, db_lo=lo)
        else:
            self._host_rows.append(v32.cpu().numpy().copy())
            self._append(norms, db_hi=hi, db_lo=lo)

    def _append_f16(self, bits: torch.Tensor, norms: torch.Tensor) -> None:
        """f16 rows: flush subnormals, then the split statistics over the
        decoded pair (exact: an f16 value splits into hi + lo exactly) and
        the count of e=31 patterns, both running on the device."""
        bits = flush_f16_subnormals(bits)
        v32 = decode_f16_bits(bits)
        self._bump_split_stats(split_stats(v32, *split_f32_bf16(v32)))
        dirty = torch.sum(_f16_nonfinite(bits).to(torch.float32))
        self._f16_dirty = dirty if self._f16_dirty is None \
            else self._f16_dirty + dirty
        self._f16_clean_host = None
        self._append(norms, db=bits)

    def _append_int8(self, xd: torch.Tensor) -> None:
        codes, norms, batch_qn, clipped = quantize_int8(
            xd, self.scales[: self.d])
        self._bump_int_norm(batch_qn)
        self._int8_clipped = clipped if self._int8_clipped is None \
            else self._int8_clipped + clipped
        self._int8_elems += xd.numel()
        self._append(norms, db=codes)

    def _bump_int_norm(self, batch_qn: torch.Tensor) -> None:
        self.int_norm_max = batch_qn if self.int_norm_max is None \
            else torch.maximum(self.int_norm_max, batch_qn)

    def _append(self, norms: torch.Tensor, **rows: torch.Tensor) -> None:
        n = norms.shape[0]
        self._ensure_capacity(self.ntotal + n)
        for name, vecs in rows.items():   # d or d_pad columns
            getattr(self, name)[self.ntotal: self.ntotal + n,
                                : vecs.shape[1]] = vecs
        self.norms[self.ntotal: self.ntotal + n] = norms
        self.ntotal += n

    def split_stats_host(self) -> Tuple[float, float]:
        """Host copy of the exact (max‖v_lo‖, max‖v − hi − lo‖); (inf, inf)
        while nothing is stored or for bf16 and int8. f32 refreshes it in
        every add; f16 reads the device once per add batch, on first use.
        (0, 0) proves the lo and residual planes all-zero."""
        if self.split_stats is None:
            return (float("inf"), float("inf"))
        if self._split_stats_host is None:
            s = self.split_stats.cpu().tolist()
            self._split_stats_host = (float(s[0]), float(s[1]))
        return self._split_stats_host

    def f16_clean(self) -> bool:
        """True when every stored f16 pattern is a normal or ±0 (no inf or
        NaN; subnormals were flushed at ingest): the exact running count,
        read from the device once per add batch, on first use."""
        if self.storage is not StorageType.FLOAT16 or self._f16_dirty is None:
            return False
        if self._f16_clean_host is None:
            self._f16_clean_host = float(self._f16_dirty) == 0.0
        return self._f16_clean_host

    @property
    def int8_clipped_fraction(self) -> float:
        """Fraction of the int8 elements added that clipped to ±127: a
        later batch outgrew the frozen training range. Search stays exact
        against the decoded database; recall against the original data
        drops. Reads the device counter."""
        if not self._int8_elems or self._int8_clipped is None:
            return 0.0
        return float(self._int8_clipped) / self._int8_elems

    def reset(self) -> None:
        """Drop all vectors and release the device memory. int8 scales
        survive (faiss: is_trained persists)."""
        for name, _, _ in self._buffers():
            setattr(self, name, None)
        self.split_stats = self._split_stats_host = None
        self._f16_dirty = self._f16_clean_host = None
        self.int_norm_max = self._int8_clipped = None
        self._int8_elems = 0
        self._host_rows = []
        self.ntotal = self.capacity = 0

    def merge_storage(self, other: "DeviceStore") -> None:
        """Append ``other``'s rows as they are stored (the device half of
        merge_from): the row bits or planes, the stored norms (so f32, bf16
        and f16 keep their pre-quantization norms), the pair-only host
        master. The statistics union exactly: split_stats and int_norm_max
        as maxima, the f16 dirty count and the int8 clipped count as sums.
        The layouts must match (storage, d, pair_only); int8 needs the same
        scales (an empty untrained store adopts ``other``'s). The host
        mirrors refresh as after an add."""
        if other is self:
            raise ValueError("cannot merge a store into itself")
        if (other.storage is not self.storage or other.d != self.d
                or other.pair_only != self.pair_only):
            raise ValueError("merge: storage layouts differ")
        if self.storage is StorageType.INT8 and other.is_trained:
            theirs = other.scales.to(self.device)
            if not self.is_trained and self.ntotal == 0:
                self.scales = theirs.clone()        # adopt the grid
            elif not torch.equal(self.scales, theirs):
                raise ValueError(
                    "merge: int8 indexes must share the trained scales "
                    "(requantization would not be exact)")
        n = other.ntotal
        if n == 0:
            return
        self._check_count(n)
        host = other.reconstruct_n(0, n) if self.pair_only else None
        rows = {name: getattr(other, name)[:n, : self.d].to(self.device)
                for name, _, _ in self._buffers()
                if name != "norms"}
        if other.split_stats is not None:
            self._bump_split_stats(other.split_stats.to(self.device))
            if self.has_split:
                self.split_stats_host()
        if other._f16_dirty is not None:
            od = other._f16_dirty.to(self.device)
            self._f16_dirty = od if self._f16_dirty is None \
                else self._f16_dirty + od
            self._f16_clean_host = None
        if other.int_norm_max is not None:
            self._bump_int_norm(other.int_norm_max.to(self.device))
        if other._int8_clipped is not None:
            oc = other._int8_clipped.to(self.device)
            self._int8_clipped = oc if self._int8_clipped is None \
                else self._int8_clipped + oc
            self._int8_elems += other._int8_elems
        if host is not None:
            self._host_rows.append(host)
        self._append(other.norms[:n].to(self.device), **rows)

    def remove_rows(self, keep: np.ndarray) -> None:
        """Keep only the rows ``keep`` (ascending, unique) in their order:
        the device half of remove_ids' stable renumbering. Every stored
        buffer compacts in place (survivors to the front, the freed rows
        zeroed), the capacity stays, and so does the pair-only host master.
        The statistics stay as they are: removal can only lower the maxima
        and counts behind them, so they remain sound bounds."""
        keep = np.asarray(keep, np.int64)
        n_new = int(keep.size)
        if n_new == self.ntotal:
            return
        if n_new == 0:
            self.reset()   # keeps the int8 scales
            return
        idx = torch.from_numpy(keep).to(self.device)
        for name, _, _ in self._buffers():
            buf = getattr(self, name)
            buf[:n_new] = buf[idx]
            buf[n_new: self.ntotal] = 0
        if self.pair_only:
            rows = self.reconstruct_n(0, self.ntotal)
            self._host_rows = [rows[keep]]
        self.ntotal = n_new

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        """(n, d) fp32 decode of stored rows [i0, i0 + n): the bf16 or f16
        values, the int8 codes times the scales, or the exact f32 master
        (from the host when pair only)."""
        if not (0 <= i0 and n >= 0 and i0 + n <= self.ntotal):
            raise IndexError(f"range [{i0}, {i0 + n}) out of [0, {self.ntotal})")
        if self.pair_only:
            if len(self._host_rows) != 1:   # consolidate lazily
                self._host_rows = [np.concatenate(
                    self._host_rows or [np.zeros((0, self.d), np.float32)])]
            return self._host_rows[0][i0: i0 + n].copy()
        rows = self.db[i0: i0 + n, : self.d].to(torch.float32)
        if self.storage is StorageType.INT8:
            rows = rows * self.scales[None, : self.d]
        return rows.cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        if not (0 <= key < self.ntotal):
            raise IndexError(f"key {key} out of range [0, {self.ntotal})")
        return self.reconstruct_n(key, 1)[0]

    def reconstruct_batch(self, keys) -> np.ndarray:
        """(len(keys), d) fp32 decode of any stored ids, the bits
        reconstruct returns: one device gather and one copy."""
        keys = np.asarray(keys, np.int64).ravel()
        if keys.size == 0:
            return np.zeros((0, self.d), np.float32)
        if keys.min() < 0 or keys.max() >= self.ntotal:
            raise IndexError(
                f"reconstruct_batch: ids outside [0, {self.ntotal})")
        if self.pair_only:
            return np.ascontiguousarray(
                self.reconstruct_n(0, self.ntotal)[keys])
        idx = torch.from_numpy(keys).to(self.device)
        rows = self.db[idx, : self.d].to(torch.float32)
        if self.storage is StorageType.INT8:
            rows = rows * self.scales[None, : self.d]
        return rows.cpu().numpy()

    def vectors_numpy(self) -> Optional[np.ndarray]:
        """f32 storage: the (ntotal, d) rows as stored; None otherwise."""
        if self.storage is not StorageType.FLOAT32:
            return None
        if self.ntotal == 0:
            return np.zeros((0, self.d), np.float32)
        return self.reconstruct_n(0, self.ntotal)

    def nbytes(self) -> int:
        """Device bytes of every stored buffer."""
        bufs = [getattr(self, name) for name, _, _ in self._buffers()]
        return sum(b.numel() * b.element_size() for b in bufs if b is not None)
