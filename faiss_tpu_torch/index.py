"""TorchIndexFlat: the flat (brute-force) exact-search index, with f32,
bf16, f16 and int8 storage.

Counterpart of ``faiss_tpu/index.py``'s TpuIndexFlat:

    faiss_tpu                      faiss_tpu_torch
    ---------                      ---------------
    TpuIndexFlat(d, metric, ...)   TorchIndexFlat(d, metric, device="cuda")
    search / search_async          search / search_async -> TorchSearchToken
      (params=SearchParams(sel))     (params=SearchParams(sel))
    range_search(x, radius)        range_search(x, radius) -> (lims, D, I)
    remove_ids / merge_from        remove_ids / merge_from
    assign / search_and_reconstruct  assign / search_and_reconstruct
    reconstruct(_n) / vectors_numpy  reconstruct(_n) / vectors_numpy
    set_force_xla(bool)            set_force_plain(bool)
    index_numpy_to_tpu             index_numpy_to_torch
    index_cpu_to_tpu / _tpu_to_cpu   index_cpu_to_torch / _torch_to_cpu
    is_float16_storage, is_bfloat16_storage (the same names)

Behaviour kept:
  * k is clamped to ntotal with sentinel fill beyond (+inf / -inf distance,
    label -1); an empty index returns all sentinels;
  * ids are int32 on the device, int64 at the API;
  * storage defaults to f32, as in the JAX package: the f32 master, its
    bf16 (hi, lo) planes and the exact split statistics; keep_master=False
    keeps only the planes on the device and ranks by hi + lo;
  * the fused path (ops/fused.py: sweep → select → rescore → final select,
    CUDA kernels) returns a per-query certificate; uncertified queries
    re-run in two tiers (make_selective_fallback): the two-plane sweep when
    the search ran the one-plane sweep, then the plain path, which is exact
    by construction;
  * f32 storage on integer-valued data (split statistics exactly zero)
    takes the hi_exact dispatch: the fused path sweeps and rescores the hi
    plane alone with the bf16 kernels, the cost gate sees 2 bytes/element,
    and the one-plane sweep policy applies as for bf16;
  * f16 storage follows the bf16 sweep policy (one query plane at
    nq_pad ≥ 32, tier-1 rerun with two) but is certified with the pair ε
    over its decoded (hi, lo) split statistics; int8 storage always sweeps
    two exact integer passes, so it never takes a tier-1 rerun, and needs
    its scales (``train``, or the first add batch);
  * a selector (``params=SearchParams(sel=...)``, ``selector.py``) is
    evaluated on the host over the positional ids and copied to the device
    once per search (from pinned memory, so enqueueing still never waits):
    the fused path folds it into the pre-masked norm stream, the plain path
    and range_search into their block mask, and the fallback's reruns keep
    it;
  * the plain path is an fp32 GEMM + stable top-k, chunked over the db;
    range_search counts and extracts the hits of each chunk of the same
    scores (strict ``s > thr``), at a capacity that reruns once when a
    chunk holds more hits.

PyTorch runs eagerly, so there is no compiled-program cache: each search
launches its kernels on the current stream and copies one packed result
tensor back when the token is waited on.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from . import selector as sel_mod
from .dtypes import MetricType, StorageType, worst_distance
from .ops import distance as dist_ops
from .ops import fused
from .ops import topk as topk_ops
from .resources import KernelTuning, query_device_capabilities
from .storage import ROW_TILE, DeviceStore, _round_up, decode_f16_bits

# queries pad to a multiple of this many rows
NQ_PAD = 8
# cap on nq·nv·d elements for the direct (per-pair, unexpanded) L2 path
DIRECT_PATH_MAX_ELEMS = 1 << 24
# range_search: first per-(query, chunk) hit capacity; one rerun at the next
# power of two when a chunk holds more (its counts are exact either way)
RANGE_CAP0 = 1024


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


class ConcatSearchToken:
    """Handle over the row-chunk tokens of ONE logical search (the IVF
    index splits a query batch whose score array would pass its gather
    budget; ``faiss_tpu``'s ConcatSearchToken). Every chunk is enqueued
    before this is returned; ``wait()`` concatenates their results in query
    order."""

    def __init__(self, toks):
        self._toks = toks
        self._result = None

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._result is None:
            parts = [t.wait() for t in self._toks]
            self._result = (
                np.concatenate([p[0] for p in parts], axis=0),
                np.concatenate([p[1] for p in parts], axis=0))
            self._toks = None
        return self._result

    def is_ready(self) -> bool:
        return self._result is not None or all(
            t.is_ready() for t in self._toks)


def _range_csr(run_range, nq: int, metric: MetricType):
    """range_search's passes and CSR assembly (``faiss_tpu``'s _range_csr):
    ``run_range(cap)`` returns host (counts (nchunks, nq_pad), vals, ids,
    cap used), counts exact whatever the cap, so one rerun at the next
    power of two suffices; then one lexsort keyed (query, score descending,
    id ascending) merges the chunks' runs best-first."""
    counts, vals, ids, cap = run_range(RANGE_CAP0)
    cmax = int(counts[:, :nq].max()) if nq else 0
    if cmax > cap:
        counts, vals, ids, cap = run_range(1 << (cmax - 1).bit_length())
        assert int(counts[:, :nq].max()) <= cap
    counts_q = counts[:, :nq].astype(np.int64)          # (nchunks, nq)
    lims = np.zeros(nq + 1, np.int64)
    np.cumsum(counts_q.sum(axis=0), out=lims[1:])
    valid = np.arange(cap)[None, None, :] < counts_q.T[:, :, None]
    qq, ch, pp = np.nonzero(valid)                      # CSR segment order
    D = vals[ch, qq, pp].astype(np.float32, copy=False)
    I = ids[ch, qq, pp].astype(np.int64)
    order = np.lexsort((I, -D, qq))
    D, I = D[order], I[order]
    if metric is MetricType.L2:
        np.negative(D, out=D)  # scores → squared distances
    return lims, D, I


def make_selective_fallback(index, queries: torch.Tensor, nq: int, k: int, *,
                            pad_unit: int, pin_key: int, reduced: bool,
                            sel: Optional[torch.Tensor] = None):
    """Tier-1/tier-2 fallback for the rows whose certificate failed.

    The failed rows are gathered into a small pad_unit-aligned batch and
    re-run; their results are patched into the certified ones. Tier 1 (only
    when this search ran the one-plane sweep): the two-plane fused sweep,
    and ``pin_key`` is pinned in ``index._no_reduced_sweep`` so the shape
    stops paying tier-1 reruns. Tier 2: the plain path, exact by
    construction. Both tiers take the search's selector stream ``sel``, so
    a rerun keeps filtering. Failures in padding rows alone change nothing
    and are not counted in ``index.fused_fallbacks``."""

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
                qb, k, nb_pad, force_plain=False, full_sweep=True, sel=sel)
            d2, i2, c2 = _unpack(packed.cpu().numpy(), k)
            ok = todo[c2[todo]] if uf2 else todo
            d_out[bad[ok]] = d2[ok]
            i_out[bad[ok]] = i2[ok]
            todo = todo[~c2[todo]] if uf2 else todo[:0]
            if todo.size == 0:
                return d_out, i_out
        packed, _, _ = index._run_search_fn(qb, k, nb_pad, force_plain=True,
                                            sel=sel)
        d2, i2, _ = _unpack(packed.cpu().numpy(), k)
        d_out[bad[todo]] = d2[todo]
        i_out[bad[todo]] = i2[todo]
        return d_out, i_out

    return fallback


class TorchIndexFlat:
    """Flat exact-search index over f32, bf16, f16 or int8 rows on one
    device.

    ``device`` defaults to "cuda" and raises when CUDA is absent; "cpu"
    runs every kernel's plain PyTorch version (how the tests run it).
    ``keep_master=False`` (f32 only) keeps the exact rows in host memory
    for reconstruct and only the bf16 (hi, lo) planes on the device."""

    def __init__(self, d: int, metric=MetricType.L2,
                 storage=StorageType.FLOAT32, device="cuda",
                 tuning: Optional[KernelTuning] = None,
                 keep_master: bool = True):
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the plain versions of the kernels")
        self.caps = query_device_capabilities(self.device)
        self.tuning = tuning if tuning is not None else self.caps.tuning
        self.store = DeviceStore(d, self.device, self.storage_type,
                                 keep_master=keep_master)
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

    @property
    def is_trained(self) -> bool:
        """Float storage needs no training; int8 is trained once its scales
        are frozen (``train``, or auto-train on the first add batch)."""
        return self.store.is_trained

    def train(self, x: np.ndarray) -> None:
        """Freeze int8 per-dimension scales from a sample (a no-op for float
        storage; a second train raises)."""
        self.store.train(x)

    def is_float16_storage(self) -> bool:
        return self.storage_type is StorageType.FLOAT16

    def is_bfloat16_storage(self) -> bool:
        return self.storage_type is StorageType.BFLOAT16

    def set_force_plain(self, force: bool) -> None:
        """Run the plain path even where the fused path is eligible
        (cross-path testing; the counterpart of set_force_xla)."""
        self._force_plain = bool(force)

    def add(self, x: np.ndarray) -> None:
        self.store.add(x)

    def reset(self) -> None:
        self.store.reset()
        self._no_reduced_sweep.clear()  # new data, new margins

    def remove_ids(self, ids) -> int:
        """Remove the given positional ids; the others keep their order and
        renumber down (faiss::IndexFlat::remove_ids). Duplicates count
        once; ids out of range raise IndexError. Returns the number
        removed. The stored rows compact on the device, in place."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.ntotal:
            raise IndexError(f"remove_ids: ids outside [0, {self.ntotal}): "
                             f"[{ids[0]}, {ids[-1]}]")
        keep = np.setdiff1d(np.arange(self.ntotal, dtype=np.int64), ids,
                            assume_unique=True)
        self.store.remove_rows(keep)
        self._no_reduced_sweep.clear()  # new data, new margins
        return int(ids.size)

    def merge_from(self, other: "TorchIndexFlat") -> None:
        """Append ``other``'s rows (their ids continue at ntotal, in order)
        and reset ``other`` (faiss::IndexFlat::merge_from). Stored bits,
        norms and certificate statistics move as they are, so a search of
        the merged index equals that of one built by the same adds."""
        if other is self:
            raise ValueError("cannot merge an index into itself")
        if other.d != self.d or other.metric is not self.metric:
            raise ValueError(
                f"merge_from: d/metric mismatch (({self.d}, {self.metric}) "
                f"vs ({other.d}, {other.metric}))")
        self.store.merge_storage(other.store)
        self._no_reduced_sweep.clear()  # new data, new margins
        other.reset()

    def reconstruct(self, key: int) -> np.ndarray:
        return self.store.reconstruct(key)

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return self.store.reconstruct_n(i0, n)

    def vectors_numpy(self) -> Optional[np.ndarray]:
        """The f32 rows as stored (None for bf16, f16 and int8 storage)."""
        return self.store.vectors_numpy()

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

    def _use_direct(self, nv_eff: int, nq_pad: int) -> bool:
        """The plain path's direct (unexpanded) L2 form, for small shapes."""
        return (self.metric is MetricType.L2
                and self.store.storage is not StorageType.INT8
                and nv_eff <= dist_ops.DIRECT_PATH_MAX_NV * 4
                and nq_pad * nv_eff * self.store.d_pad <= DIRECT_PATH_MAX_ELEMS)

    def _scores_block(self, q: torch.Tensor, start: int, width: int, *,
                      use_direct: bool,
                      sel: Optional[torch.Tensor]) -> torch.Tensor:
        """(nq_pad, width) plain-path scores of rows [start, start + width),
        fp32-true against the stored rows, −inf past ntotal and on the rows
        ``sel`` filters out: the one criterion of the plain search and of
        range_search (``faiss_tpu``'s _masked_scores_block)."""
        st = self.store
        end = start + width
        norms = st.norms[start:end]
        if st.pair_only:
            hi, lo = st.db_hi[start:end], st.db_lo[start:end]
            if use_direct:
                s = dist_ops.direct_l2_scores(
                    q, hi.to(torch.float32) + lo.to(torch.float32))
            else:
                s = dist_ops.pair_scores(q, hi, lo, norms, self.metric)
        elif st.storage is StorageType.INT8:
            s = dist_ops.int8_scores(q, st.scales, st.db[start:end], norms,
                                     self.metric)
        elif st.storage is StorageType.FLOAT16:
            rows = st.db[start:end]
            if use_direct:
                s = dist_ops.direct_l2_scores(q, decode_f16_bits(rows))
            else:
                s = dist_ops.f16_scores(q, rows, norms, self.metric)
        elif use_direct:
            s = dist_ops.direct_l2_scores(q, st.db[start:end])
        else:
            s = dist_ops.matmul_scores(q, st.db[start:end], norms,
                                       self.metric)
        drop = torch.arange(start, end, device=s.device) >= self.ntotal
        if sel is not None:
            drop |= ~sel[start:end]
        return s.masked_fill(drop[None, :], float("-inf"))

    def _run_search_fn(self, q: torch.Tensor, k: int, nq_pad: int, *,
                       force_plain: bool, full_sweep: bool = False,
                       sel: Optional[torch.Tensor] = None):
        """Enqueue one search of the padded queries ``q`` over the rows the
        selector stream ``sel`` admits (None: all). Returns (packed result
        tensor, whether the fused path ran, whether it ran the one-plane
        sweep); nothing is copied to the host."""
        st = self.store
        nt = self.ntotal
        nv_eff = _round_up(nt, ROW_TILE)
        is_int8 = st.storage is StorageType.INT8
        use_direct = self._use_direct(nv_eff, nq_pad)
        # hi_exact: the exact split statistics (mirrored to the host by
        # add, so reading them here waits for nothing) prove the lo and
        # residual planes zero; the sweep then reads 2 bytes per element
        stats_zero = st.has_split and st.split_stats_host() == (0.0, 0.0)
        pair_sweep = st.has_split and not stats_zero
        use_fused = (not force_plain and not self._force_plain
                     and not use_direct
                     and fused.fused_path_eligible(
                         metric=self.metric, k=k, nv_eff=nv_eff,
                         d_pad=st.d_pad, nq_pad=nq_pad,
                         itemsize=4 if pair_sweep else 1 if is_int8 else 2,
                         dtype=st.row_dtype))
        # f16 is not pair storage for this policy (one plane at large
        # nq_pad, as bf16), though its certificate is the pair ε
        passes = 2 if (full_sweep or nq_pad in self._no_reduced_sweep) \
            else fused.pick_sweep_passes(nq_pad, pair_sweep or is_int8)
        vals, ids, cert = self._search_local(
            q, k, use_fused=use_fused, passes=passes, hi_exact=stats_zero,
            use_direct=use_direct, sel=sel)
        dists, labels = _finalize(vals, ids, nt, k, self.metric)
        return (_pack(dists, labels, cert), use_fused,
                use_fused and passes == 1)

    def _search_local(self, q: torch.Tensor, k: int, *, use_fused: bool,
                      passes: int, hi_exact: bool, use_direct: bool,
                      sel: Optional[torch.Tensor]):
        """One search of the padded queries ``q`` on this index's device,
        the route decided by the caller: (scores (nq_pad, min(k, nv_eff))
        best first, with −‖q‖² for L2; their positional ids; the per-query
        certificate, all True on the plain path). ``hi_exact`` (f32 only)
        takes the hi-plane dispatch where the split statistics allow it.
        The sharded index calls this on every shard with one decision for
        all of them."""
        st = self.store
        nt = self.ntotal
        nv_eff = _round_up(nt, ROW_TILE)
        k_eff = min(k, nv_eff)
        if use_fused:
            split = {}
            if st.has_split:
                split = dict(db_split=(st.db_hi, st.db_lo),
                             pair_only=st.pair_only,
                             split_stats=st.split_stats,
                             hi_exact=hi_exact and st.split_stats_host()
                             == (0.0, 0.0))
            elif st.storage is StorageType.FLOAT16:
                split = dict(split_stats=st.split_stats)
            elif st.storage is StorageType.INT8:
                split = dict(scales=st.scales, int_norm_max=st.int_norm_max)
            vals, ids, cert = fused.fused_search(
                q, st.db if st.db is not None else st.db_hi, st.norms, nt,
                k=k, metric=self.metric, nv_eff=nv_eff, sweep_passes=passes,
                sel=sel, **split)
            if self.metric is MetricType.L2:
                # the kernels' scores omit the rank-invariant −‖q‖²
                vals = vals - torch.sum(q * q, dim=-1)[:, None]
            return vals, ids, cert

        def block(start: int, width: int) -> torch.Tensor:
            return self._scores_block(q, start, width, use_direct=use_direct,
                                      sel=sel)

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
        cert = torch.ones((q.shape[0],), dtype=torch.bool, device=q.device)
        return vals, ids, cert

    def _sel_stream(self, params) -> Optional[torch.Tensor]:
        """``params``' selector over the positional ids, as a (capacity,)
        bool device stream, or None when nothing is filtered (the selector
        that admits every row keeps the unfiltered program: the result is
        the same). Rows past ntotal are False. Evaluated on the host, then
        one copy from pinned memory, so enqueueing does not wait."""
        sel_mod.reject_ivf_params(params)
        # validate first: no id vector for a search without a selector
        if sel_mod.selector_mask(params, np.empty(0, np.int64)) is None:
            return None
        mask = sel_mod.selector_mask(params,
                                     np.arange(self.ntotal, dtype=np.int64))
        if mask.all():
            return None
        pad = torch.zeros((self.store.capacity,), dtype=torch.bool,
                          pin_memory=self.device.type == "cuda")
        pad[: self.ntotal] = torch.from_numpy(mask)
        return pad.to(self.device, non_blocking=True)

    def _empty_result(self, nq: int, k: int):
        return (np.full((nq, k), worst_distance(self.metric), np.float32),
                np.full((nq, k), -1, np.int64))

    def search_async(self, x: np.ndarray, k: int,
                     params=None) -> TorchSearchToken:
        """Non-blocking search: returns once the work is enqueued.
        ``params`` (``SearchParams``): restrict it to the rows its selector
        admits."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        q, nq, nq_pad = self._prep_queries(x)
        if self.ntotal == 0:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return TorchSearchToken(None, nq, k,
                                    result=self._empty_result(nq, k))
        sel = self._sel_stream(params)
        packed, use_fused, reduced = self._run_search_fn(
            q, k, nq_pad, force_plain=False, sel=sel)
        fallback = None
        if use_fused:
            fallback = make_selective_fallback(
                self, q, nq, k, pad_unit=NQ_PAD, pin_key=nq_pad,
                reduced=reduced, sel=sel)
        return TorchSearchToken(packed, nq, k, fallback=fallback)

    def search(self, x: np.ndarray, k: int,
               params=None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k search: (distances f32 (nq, k), labels i64 (nq, k)),
        over the rows ``params``' selector admits."""
        return self.search_async(x, k, params=params).wait()

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        """Labels-only search (faiss::Index::assign), (nq, k) int64. A large
        batch goes in chunks sized so that each keeps about 256 MB of fp32
        scores live (one (nq, nv_eff) block when the index fits one plain
        chunk, else the larger of a (nq, chunk_v) block and the fused
        sweep's (nq, nv_eff/128) group maxes), at most 32 in flight."""
        x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, self.d)
        nv_eff = max(_round_up(max(self.ntotal, 1), ROW_TILE), ROW_TILE)
        budget = 256 << 20
        per_q = 4 * (nv_eff if nv_eff <= self.tuning.chunk_v
                     else max(self.tuning.chunk_v, nv_eff // 128))
        nq_chunk = max(NQ_PAD, (budget // per_q) // NQ_PAD * NQ_PAD)
        if len(x) <= nq_chunk:
            return self.search(x, k)[1]
        max_inflight = 32
        toks: deque = deque()
        out = []
        for i0 in range(0, len(x), nq_chunk):
            if len(toks) >= max_inflight:
                out.append(toks.popleft().wait()[1])
            toks.append(self.search_async(x[i0:i0 + nq_chunk], k))
        out.extend(t.wait()[1] for t in toks)
        return np.concatenate(out, axis=0)

    def search_and_reconstruct(self, x: np.ndarray, k: int, params=None):
        """faiss::Index::search_and_reconstruct: (D, I, R), R (nq, k, d) the
        decoded stored rows of the results (what reconstruct returns), zero
        where the label is −1; one device gather over the unique labels."""
        D, I = self.search(x, k, params=params)
        R = np.zeros((I.shape[0], I.shape[1], self.d), dtype=np.float32)
        pos = I >= 0
        if pos.any():
            uniq, inv = np.unique(I[pos], return_inverse=True)
            R[pos] = self.store.reconstruct_batch(uniq)[inv]
        return D, I, R

    # -- range search ---------------------------------------------------------
    def _run_range(self, q: torch.Tensor, nq_pad: int, thr: float, cap: int,
                   sel: Optional[torch.Tensor],
                   use_direct: Optional[bool] = None):
        """One pass over the plain-path score chunks: per chunk the exact
        count of scores > thr and the top-``cap`` of them. Returns host
        (counts (nchunks, nq_pad), vals, ids (nchunks, nq_pad, cap), cap).
        ``use_direct``: the plain path's form (None: by the shape)."""
        nv_eff = _round_up(self.ntotal, ROW_TILE)
        chunk = min(self.tuning.chunk_v, nv_eff)
        while nv_eff % chunk:       # the largest ≤ chunk_v divisor of nv_eff
            chunk -= ROW_TILE       # that is a ROW_TILE multiple
        cap = min(cap, chunk)
        if (nv_eff // chunk) * nq_pad * cap * 8 > (2 << 30):
            raise ValueError(
                "range_search result buffers would exceed 2 GB "
                f"(~{(nv_eff // chunk) * nq_pad * cap} candidate slots); "
                "split the query batch or tighten the radius")
        if use_direct is None:
            use_direct = self._use_direct(nv_eff, nq_pad)
        counts, vals, ids = [], [], []
        for start in range(0, nv_eff, chunk):
            s = self._scores_block(q, start, chunk, use_direct=use_direct,
                                   sel=sel)
            hit = s > thr   # strict: faiss's dist < radius (L2), > (IP)
            counts.append(hit.sum(dim=-1, dtype=torch.int32))
            v, i = topk_ops.topk_scores(s.masked_fill(~hit, float("-inf")),
                                        cap)
            vals.append(v)
            ids.append(i + start)
        out = [torch.stack(t).cpu().numpy() for t in (counts, vals, ids)]
        return (*out, cap)

    def range_search(self, x: np.ndarray, radius: float, params=None):
        """All rows within ``radius`` of each query, faiss's CSR layout:
        (lims (nq+1,) int64, D (lims[nq],) f32, I (lims[nq],) int64), query
        i's hits in D[lims[i]:lims[i+1]] best first (ties to the lowest
        id). faiss::IndexFlat's strict criterion: squared L2 distance
        < radius, inner product > radius, in the plain path's arithmetic
        (what search would rank for the same rows)."""
        q, nq, nq_pad = self._prep_queries(x)
        if self.ntotal == 0:
            sel_mod.selector_mask(params, np.empty(0, np.int64))  # validate
            return (np.zeros(nq + 1, np.int64), np.empty(0, np.float32),
                    np.empty(0, np.int64))
        sel = self._sel_stream(params)
        thr = float(np.float32(-radius if self.metric is MetricType.L2
                               else radius))
        return _range_csr(
            lambda cap: self._run_range(q, nq_pad, thr, cap, sel), nq,
            self.metric)

    def describe(self) -> str:
        st = self.store
        note = ""
        if st.storage is StorageType.INT8:
            note = f"int8_clipped_fraction={st.int8_clipped_fraction:.2e}, "
        elif st.storage is StorageType.FLOAT16:
            note = f"f16_clean={st.f16_clean()}, "
        elif st.has_split and self.ntotal:
            note = f"hi_exact={st.split_stats_host() == (0.0, 0.0)}, "
        return (
            f"TorchIndexFlat(d={self.d}, metric={self.metric.value}, "
            f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
            f"capacity={st.capacity}, d_pad={st.d_pad}, "
            f"device={self.device}, force_plain={self._force_plain}, "
            f"fused_fallbacks={self.fused_fallbacks}, "
            f"reduced_sweep_disabled_shapes={sorted(self._no_reduced_sweep)}, "
            f"{note}pair_only={st.pair_only}, "
            f"bytes={st.nbytes()})\n" + self.caps.describe())


def index_numpy_to_torch(xb: np.ndarray, metric=MetricType.L2,
                         storage=StorageType.FLOAT32,
                         device="cuda") -> TorchIndexFlat:
    """Build a TorchIndexFlat directly from an (n, d) fp32 matrix."""
    xb = np.ascontiguousarray(xb, dtype=np.float32)
    idx = TorchIndexFlat(xb.shape[1], metric=metric, storage=storage,
                         device=device)
    idx.add(xb)
    return idx


def _faiss():
    try:
        import faiss  # type: ignore
        return faiss
    except ImportError as e:
        raise ImportError(
            "faiss is not installed; use index_numpy_to_torch / "
            "vectors_numpy for numpy-based interchange"
        ) from e


def index_cpu_to_torch(cpu_index, storage=StorageType.FLOAT32,
                       device="cuda") -> TorchIndexFlat:
    """CPU faiss.IndexFlat → TorchIndexFlat (copies the vectors to
    ``device``)."""
    faiss = _faiss()
    metric = (MetricType.L2 if cpu_index.metric_type == faiss.METRIC_L2
              else MetricType.INNER_PRODUCT)
    xb = cpu_index.reconstruct_n(0, cpu_index.ntotal)
    idx = TorchIndexFlat(cpu_index.d, metric=metric, storage=storage,
                         device=device)
    idx.add(np.asarray(xb, dtype=np.float32).reshape(cpu_index.ntotal,
                                                     cpu_index.d))
    return idx


def index_torch_to_cpu(index: TorchIndexFlat):
    """TorchIndexFlat → CPU faiss.IndexFlat. f32 storage round-trips
    exactly; reduced precision goes through the decode (reconstruct_n)."""
    faiss = _faiss()
    metric = (faiss.METRIC_L2 if index.metric is MetricType.L2
              else faiss.METRIC_INNER_PRODUCT)
    cpu = faiss.IndexFlat(index.d, metric)
    if index.ntotal:
        xb = index.vectors_numpy()
        if xb is None:
            xb = index.reconstruct_n(0, index.ntotal)
        cpu.add(xb)
    return cpu
