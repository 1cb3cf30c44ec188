"""TorchIndexFlat: the flat (brute-force) exact-search index, bf16 storage.

Counterpart of ``faiss_tpu/index.py``'s TpuIndexFlat (bf16 route):

    faiss_tpu                      faiss_tpu_torch
    ---------                      ---------------
    TpuIndexFlat(d, metric, ...)   TorchIndexFlat(d, metric, device="cuda")
    search / search_async          search / search_async -> TorchSearchToken
    set_force_xla(bool)            set_force_plain(bool)
    index_numpy_to_tpu             index_numpy_to_torch

Behaviour kept:
  * k is clamped to ntotal with sentinel fill beyond (+inf / -inf distance,
    label -1); an empty index returns all sentinels;
  * ids are int32 on the device, int64 at the API;
  * the fused path (ops/fused.py: sweep → select → rescore → final select,
    four CUDA kernels) returns a per-query certificate; uncertified queries
    re-run in two tiers (make_selective_fallback): the two-plane sweep when
    the search ran the one-plane sweep, then the plain path, which is exact
    by construction;
  * the plain path is an fp32 GEMM + stable top-k, chunked over the db.

PyTorch runs eagerly, so there is no compiled-program cache: each search
launches its kernels on the current stream and copies one packed result
tensor back when the token is waited on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .dtypes import MetricType, StorageType, worst_distance
from .ops import distance as dist_ops
from .ops import fused
from .ops import topk as topk_ops
from .resources import KernelTuning, query_device_capabilities
from .storage import ROW_TILE, DeviceStore, _round_up

# queries pad to a multiple of this many rows
NQ_PAD = 8
# cap on nq·nv·d elements for the direct (per-pair, unexpanded) L2 path
DIRECT_PATH_MAX_ELEMS = 1 << 24


def _finalize(vals, ids, ntotal: int, k: int, metric: MetricType):
    """Sentinel mapping and k > nv_eff padding: invalid slots get the
    metric's worst distance and label -1."""
    invalid = (ids < 0) | (ids >= ntotal) | ~(vals > float("-inf"))
    dists = dist_ops.scores_to_distances(vals, metric).masked_fill(
        invalid, worst_distance(metric))
    ids = ids.masked_fill(invalid, -1)
    if ids.shape[1] < k:
        pad = (ids.shape[0], k - ids.shape[1])
        dists = torch.cat([dists, dists.new_full(pad, worst_distance(metric))],
                          dim=1)
        ids = torch.cat([ids, ids.new_full(pad, -1)], dim=1)
    return dists, ids


def _pack(dists, labels, cert):
    """One (nq_pad, 2k+1) f32 tensor holding dists, the int32 labels' bits
    and the certificate, so that a search needs one device-to-host copy."""
    return torch.cat([dists, labels.to(torch.int32).view(torch.float32),
                      cert.to(torch.float32)[:, None]], dim=1)


def _unpack(packed: np.ndarray, k: int):
    d = packed[:, :k]
    i = np.ascontiguousarray(packed[:, k: 2 * k]).view(np.int32)
    return d, i, packed[:, 2 * k] != 0


class TorchSearchToken:
    """Async search handle. ``search_async`` returns once the search is
    enqueued; ``wait()`` makes the one device-to-host copy, runs the
    certificate fallback for the uncertified rows only, and returns (D, I);
    ``is_ready()`` polls a CUDA event recorded after the search."""

    def __init__(self, packed: Optional[torch.Tensor], nq: int, k: int,
                 fallback=None, result=None):
        self._packed = packed
        self._nq, self._k = nq, k
        self._fallback = fallback
        self._result = result
        self._event = None
        if packed is not None and packed.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(packed.device))

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._result is None:
            d, i, cert = _unpack(self._packed.cpu().numpy(), self._k)
            if self._fallback is not None and not cert.all():
                self._result = self._fallback(cert, d, i)
            else:
                self._result = (
                    np.ascontiguousarray(d[: self._nq], np.float32),
                    np.ascontiguousarray(i[: self._nq], np.int64))
            self._packed = self._fallback = self._event = None
        return self._result

    def is_ready(self) -> bool:
        if self._result is not None or self._event is None:
            return True
        return self._event.query()


def make_selective_fallback(index, queries: torch.Tensor, nq: int, k: int, *,
                            pad_unit: int, pin_key: int, reduced: bool):
    """Tier-1/tier-2 fallback for the rows whose certificate failed.

    The failed rows are gathered into a small pad_unit-aligned batch and
    re-run; their results are patched into the certified ones. Tier 1 (only
    when this search ran the one-plane sweep): the two-plane fused sweep,
    and ``pin_key`` is pinned in ``index._no_reduced_sweep`` so the shape
    stops paying tier-1 reruns. Tier 2: the plain path, exact by
    construction. Failures in padding rows alone change nothing and are not
    counted in ``index.fused_fallbacks``."""

    def fallback(cert, d0, i0):
        d_out = np.array(d0[:nq], np.float32)
        i_out = np.array(i0[:nq], np.int64)
        bad = np.nonzero(~cert[:nq])[0]
        if bad.size == 0:
            return d_out, i_out
        index.fused_fallbacks += 1
        nb_pad = max(pad_unit, _round_up(bad.size, pad_unit))
        qb = torch.zeros((nb_pad, queries.shape[1]), dtype=torch.float32,
                         device=queries.device)
        qb[: bad.size] = queries[torch.as_tensor(bad, device=queries.device)]
        todo = np.arange(bad.size)
        if reduced:
            index._no_reduced_sweep.add(pin_key)
            packed, uf2, _ = index._run_search_fn(
                qb, k, nb_pad, force_plain=False, full_sweep=True)
            d2, i2, c2 = _unpack(packed.cpu().numpy(), k)
            ok = todo[c2[todo]] if uf2 else todo
            d_out[bad[ok]] = d2[ok]
            i_out[bad[ok]] = i2[ok]
            todo = todo[~c2[todo]] if uf2 else todo[:0]
            if todo.size == 0:
                return d_out, i_out
        packed, _, _ = index._run_search_fn(qb, k, nb_pad, force_plain=True)
        d2, i2, _ = _unpack(packed.cpu().numpy(), k)
        d_out[bad[todo]] = d2[todo]
        i_out[bad[todo]] = i2[todo]
        return d_out, i_out

    return fallback


class TorchIndexFlat:
    """Flat exact-search index over bf16 rows on one device.

    ``device`` defaults to "cuda" and raises when CUDA is absent; "cpu"
    runs every kernel's plain PyTorch version (how the tests run it)."""

    def __init__(self, d: int, metric=MetricType.L2,
                 storage=StorageType.BFLOAT16, device="cuda",
                 tuning: Optional[KernelTuning] = None):
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        if self.storage_type is not StorageType.BFLOAT16:
            raise NotImplementedError(
                f"storage {self.storage_type.value}: the port stores bf16 "
                "only so far")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain versions of the kernels")
        self.caps = query_device_capabilities(self.device)
        self.tuning = tuning if tuning is not None else self.caps.tuning
        self.store = DeviceStore(d, self.device)
        self._force_plain = False
        # searches whose certificate failed and re-ran on an exact path
        self.fused_fallbacks = 0
        # nq_pad shapes where the one-plane sweep failed to certify on this
        # data: they run the two-plane sweep from then on (reset() clears)
        self._no_reduced_sweep: set = set()

    @property
    def d(self) -> int:
        return self.store.d

    @property
    def ntotal(self) -> int:
        return self.store.ntotal

    def set_force_plain(self, force: bool) -> None:
        """Run the plain path even where the fused path is eligible
        (cross-path testing; the counterpart of set_force_xla)."""
        self._force_plain = bool(force)

    def add(self, x: np.ndarray) -> None:
        self.store.add(x)

    def reset(self) -> None:
        self.store.reset()
        self._no_reduced_sweep.clear()  # new data, new margins

    def reconstruct(self, key: int) -> np.ndarray:
        return self.store.reconstruct(key)

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return self.store.reconstruct_n(i0, n)

    # -- search ------------------------------------------------------------
    def _prep_queries(self, x: np.ndarray):
        """Pad on the host, then make one transfer to the device."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) queries, got {x.shape}")
        nq = x.shape[0]
        nq_pad = max(NQ_PAD, _round_up(nq, NQ_PAD))
        q = torch.zeros((nq_pad, self.store.d_pad), dtype=torch.float32,
                        pin_memory=self.device.type == "cuda")
        q[:nq, : self.d] = torch.from_numpy(x)
        # from pinned memory the copy is asynchronous: enqueueing a search
        # never waits for the device
        return q.to(self.device, non_blocking=True), nq, nq_pad

    def _run_search_fn(self, q: torch.Tensor, k: int, nq_pad: int, *,
                       force_plain: bool, full_sweep: bool = False):
        """Enqueue one search of the padded queries ``q``. Returns (packed
        result tensor, whether the fused path ran, whether it ran the
        one-plane sweep); nothing is copied to the host."""
        nt = self.ntotal
        nv_eff = _round_up(nt, ROW_TILE)
        d_pad = self.store.d_pad
        k_eff = min(k, nv_eff)
        use_direct = (self.metric is MetricType.L2
                      and nv_eff <= dist_ops.DIRECT_PATH_MAX_NV * 4
                      and nq_pad * nv_eff * d_pad <= DIRECT_PATH_MAX_ELEMS)
        use_fused = (not force_plain and not self._force_plain
                     and not use_direct
                     and fused.fused_path_eligible(
                         metric=self.metric, k=k, nv_eff=nv_eff,
                         d_pad=d_pad, nq_pad=nq_pad))
        db, norms = self.store.db, self.store.norms
        if use_fused:
            passes = 2 if (full_sweep or nq_pad in self._no_reduced_sweep) \
                else fused.pick_sweep_passes(nq_pad)
            vals, ids, cert = fused.fused_search(
                q, db, norms, nt, k=k, metric=self.metric, nv_eff=nv_eff,
                sweep_passes=passes)
            if self.metric is MetricType.L2:
                # the kernels' scores omit the rank-invariant −‖q‖²
                vals = vals - torch.sum(q * q, dim=-1)[:, None]
            dists, labels = _finalize(vals, ids, nt, k, self.metric)
            return _pack(dists, labels, cert), True, passes == 1

        def block(start: int, width: int) -> torch.Tensor:
            rows = db[start: start + width]
            if use_direct:
                s = dist_ops.direct_l2_scores(q, rows)
            else:
                s = dist_ops.matmul_scores(q, rows, norms[start: start + width],
                                           self.metric)
            col = torch.arange(start, start + width, device=s.device)
            return s.masked_fill((col >= nt)[None, :], float("-inf"))

        chunk = self.tuning.chunk_v
        if nv_eff > chunk:
            prefix = (nv_eff // chunk) * chunk
            vals, ids = topk_ops.chunked_topk_scores(
                lambda start: block(start, chunk), prefix, chunk, k_eff)
            if nv_eff > prefix:
                tail = nv_eff - prefix
                tv, ti = topk_ops.topk_scores(block(prefix, tail),
                                              min(k_eff, tail))
                vals, ids = topk_ops.merge_topk(vals, ids, tv, ti + prefix,
                                                k_eff)
        else:
            vals, ids = topk_ops.topk_scores(block(0, nv_eff), k_eff)
        dists, labels = _finalize(vals, ids, nt, k, self.metric)
        cert = torch.ones((nq_pad,), dtype=torch.bool, device=q.device)
        return _pack(dists, labels, cert), False, False

    def _empty_result(self, nq: int, k: int):
        return (np.full((nq, k), worst_distance(self.metric), np.float32),
                np.full((nq, k), -1, np.int64))

    def search_async(self, x: np.ndarray, k: int) -> TorchSearchToken:
        """Non-blocking search: returns once the work is enqueued."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        q, nq, nq_pad = self._prep_queries(x)
        if self.ntotal == 0:
            return TorchSearchToken(None, nq, k,
                                    result=self._empty_result(nq, k))
        packed, use_fused, reduced = self._run_search_fn(
            q, k, nq_pad, force_plain=False)
        fallback = None
        if use_fused:
            fallback = make_selective_fallback(
                self, q, nq, k, pad_unit=NQ_PAD, pin_key=nq_pad,
                reduced=reduced)
        return TorchSearchToken(packed, nq, k, fallback=fallback)

    def search(self, x: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k search: (distances f32 (nq, k), labels i64 (nq, k))."""
        return self.search_async(x, k).wait()

    def describe(self) -> str:
        return (
            f"TorchIndexFlat(d={self.d}, metric={self.metric.value}, "
            f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
            f"capacity={self.store.capacity}, d_pad={self.store.d_pad}, "
            f"device={self.device}, force_plain={self._force_plain}, "
            f"fused_fallbacks={self.fused_fallbacks}, "
            f"reduced_sweep_disabled_shapes={sorted(self._no_reduced_sweep)}, "
            f"bytes={self.store.nbytes()})\n" + self.caps.describe())


def index_numpy_to_torch(xb: np.ndarray, metric=MetricType.L2,
                         storage=StorageType.BFLOAT16,
                         device="cuda") -> TorchIndexFlat:
    """Build a TorchIndexFlat directly from an (n, d) fp32 matrix."""
    xb = np.ascontiguousarray(xb, dtype=np.float32)
    idx = TorchIndexFlat(xb.shape[1], metric=metric, storage=storage,
                         device=device)
    idx.add(xb)
    return idx
