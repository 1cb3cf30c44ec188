"""TorchIndexFlat: the flat (brute-force) exact-search index, with f32,
bf16, f16 and int8 storage.

Counterpart of ``faiss_tpu/index.py``'s TpuIndexFlat:

    faiss_tpu                      faiss_tpu_torch
    ---------                      ---------------
    TpuIndexFlat(d, metric, ...,   TorchIndexFlat(d, metric, ...,
      resources=TpuResources)        device="cuda", resources=TorchResources)
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

Each search runs through the program that ``self.res`` (a TorchResources)
caches for it (``programs.call``), as ``faiss_tpu``'s searches run through
its compiled programs; every mutation starts a new generation (a graph
bakes the store's addresses and ntotal). The host side of a call (the
upload, the selector stream, the token) is ``calls.py``'s.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from . import calls, programs, tracing
from .calls import NQ_PAD
from .dtypes import MetricType, StorageType
from .ops import distance as dist_ops
from .ops import fused
from .ops import topk as topk_ops
from .resources import (KernelTuning, TorchResources, bind_device,
                        query_device_capabilities)
from .storage import ROW_TILE, DeviceStore, _round_up, decode_f16_bits

# cap on nq·nv·d elements for the direct (per-pair, unexpanded) L2 path
DIRECT_PATH_MAX_ELEMS = 1 << 24


def direct_form(metric: MetricType, store: DeviceStore, nv_eff: int,
                nq_pad: int) -> bool:
    """The plain path's direct (unexpanded) L2 form, for small shapes."""
    return (metric is MetricType.L2
            and store.storage is not StorageType.INT8
            and nv_eff <= dist_ops.DIRECT_PATH_MAX_NV * 4
            and nq_pad * nv_eff * store.d_pad <= DIRECT_PATH_MAX_ELEMS)


def flat_route(stores, metric: MetricType, k: int, nq_pad: int, *,
               plain: bool, full_sweep: bool = False, pinned=(),
               direct: bool = True):
    """The route of a flat search of ``nq_pad`` query rows over ``stores``
    (one index's store, or every live shard's, which then share one
    decision), decided on the host from the shape and the stores' host
    mirrors: (use_fused, passes, hi_exact, use_direct). The cost gate sees
    the largest store. ``plain``: the plain path, whatever the gate says;
    ``full_sweep``: two query planes, as do the shapes in ``pinned``;
    ``direct``: the plain path may take its direct L2 form."""
    st = stores[0]
    # hi_exact: every store's exact split statistics (mirrored to the host
    # by add, so reading them here waits for nothing) prove the lo and
    # residual planes zero; the sweep then reads 2 bytes per element
    nt, stats_zero = 0, st.has_split
    for s in stores:
        nt = max(nt, s.ntotal)
        stats_zero = stats_zero and s.split_stats_host() == (0.0, 0.0)
    nv_eff = _round_up(nt, ROW_TILE)
    is_int8 = st.storage is StorageType.INT8
    use_direct = direct and direct_form(metric, st, nv_eff, nq_pad)
    pair_sweep = st.has_split and not stats_zero
    use_fused = (not plain and not use_direct
                 and fused.fused_path_eligible(
                     metric=metric, k=k, nv_eff=nv_eff, d_pad=st.d_pad,
                     nq_pad=nq_pad,
                     itemsize=4 if pair_sweep else 1 if is_int8 else 2,
                     dtype=st.row_dtype))
    # f16 is not pair storage for this policy (one plane at large nq_pad,
    # as bf16), though its certificate is the pair ε
    passes = 2 if (full_sweep or nq_pad in pinned) \
        else fused.pick_sweep_passes(nq_pad, pair_sweep or is_int8)
    return use_fused, passes, stats_zero, use_direct


def make_selective_fallback(index, queries: torch.Tensor, nq: int, k: int, *,
                            pad_unit: int, pin_key: int, reduced: bool,
                            sel=None):
    """Tier-1/tier-2 fallback of a flat search (``index`` a TorchIndexFlat
    or a ShardedIndexFlat) for the rows whose certificate failed
    (``calls.certificate_fallback``).

    The failed rows are gathered into a small pad_unit-aligned batch and
    re-run. Tier 1 (only when this search ran the one-plane sweep): the
    two-plane fused sweep, and ``pin_key`` is pinned in
    ``index._no_reduced_sweep`` so the shape stops paying tier-1 reruns.
    Tier 2, for the rows tier 1 left uncertified: the plain path, exact by
    construction. Both tiers take the search's selector stream ``sel``, so
    a rerun keeps filtering. Under the profiler each tier is a span
    (``fallback.tier1``, ``fallback.tier2``) and counts the queries it
    re-ran (``flat.tier1_rows``, ``flat.tier2_rows``), and a new pin counts
    in ``flat.reduced_pins``, under the call of the wait that ran it."""

    def rerun(bad):
        nb_pad = max(pad_unit, _round_up(bad.size, pad_unit))
        qb = torch.zeros((nb_pad, queries.shape[1]), dtype=torch.float32,
                         device=queries.device)
        qb[: bad.size] = queries[torch.as_tensor(bad, device=queries.device)]
        call = tracing.current_call()
        todo = bad
        if reduced:
            with tracing.span("fallback.tier1"):
                tracing.count("flat.tier1_rows", bad.size, call)
                if pin_key not in index._no_reduced_sweep:
                    index._no_reduced_sweep.add(pin_key)
                    tracing.count("flat.reduced_pins", 1, call)
                packed, fused_ran, _ = index._run_search_fn(
                    qb, k, nb_pad, force_plain=False, full_sweep=True,
                    sel=sel)
                d, i, cert = calls.unpack(packed.cpu().numpy(), k)
            if not fused_ran:
                return d, i
            todo = np.nonzero(~cert[: bad.size])[0]
            if todo.size == 0:
                return d, i
        with tracing.span("fallback.tier2"):
            tracing.count("flat.tier2_rows", todo.size, call)
            packed, _, _ = index._run_search_fn(qb, k, nb_pad,
                                                force_plain=True, sel=sel)
            d2, i2, _ = calls.unpack(packed.cpu().numpy(), k)
        if not reduced:
            return d2, i2
        d[todo], i[todo] = d2[todo], i2[todo]
        return d, i

    return calls.certificate_fallback(index, nq, rerun)


class FlatCalls(calls.SearchCalls):
    """The call layer of the flat indexes (TorchIndexFlat,
    ShardedIndexFlat) over their ``_prep_queries``, ``_sel_stream``,
    ``_run_search_fn`` and ``_run_range``: a query batch pads to NQ_PAD
    rows for each of ``num_replicas`` groups."""

    num_replicas = 1

    def _search_packed(self, x: np.ndarray, k: int, params=None):
        """Enqueue one search (``calls.SearchCalls``): (packed result or
        None for the empty index, nq, the certificate fallback or None, no
        counters)."""
        q, nq, nq_pad = self._prep_queries(x)
        sel = self._sel_stream(params)
        if self.ntotal == 0:
            return None, nq, None, ()
        packed, use_fused, reduced = self._run_search_fn(
            q, k, nq_pad, force_plain=False, sel=sel)
        if not use_fused:
            return packed, nq, None, ()
        r = self.num_replicas
        return packed, nq, make_selective_fallback(
            self, q, nq, k, pad_unit=NQ_PAD * r, pin_key=nq_pad // r,
            reduced=reduced, sel=sel), ()

    def range_search(self, x: np.ndarray, radius: float, params=None):
        """All rows within ``radius`` of each query, faiss's CSR layout:
        (lims (nq+1,) int64, D (lims[nq],) f32, I (lims[nq],) int64), query
        i's hits in D[lims[i]:lims[i+1]] best first (ties to the lowest
        id). faiss::IndexFlat's strict criterion: squared L2 distance
        < radius, inner product > radius, in the plain path's arithmetic
        (what search would rank for the same rows)."""
        q, nq, nq_pad = self._prep_queries(x)
        sel = self._sel_stream(params)
        if self.ntotal == 0:
            return calls.empty_range(nq)
        thr = calls.range_threshold(radius, self.metric)
        return calls.range_csr(
            lambda cap: self._run_range(q, nq_pad, thr, cap, sel), nq,
            self.metric)


class TorchIndexFlat(FlatCalls):
    """Flat exact-search index over f32, bf16, f16 or int8 rows on one
    device.

    ``device`` defaults to "cuda" (the default device of ``resources``
    where given) and raises when CUDA is absent; "cpu" runs every kernel's
    plain PyTorch version (how the tests run it).
    ``keep_master=False`` (f32 only) keeps the exact rows in host memory
    for reconstruct and only the bf16 (hi, lo) planes on the device.
    ``resources``: the TorchResources whose program cache the searches
    go through (``device`` must be one of its devices); by default the
    process-wide one of the device's type."""

    def __init__(self, d: int, metric=MetricType.L2,
                 storage=StorageType.FLOAT32, device=None,
                 tuning: Optional[KernelTuning] = None,
                 keep_master: bool = True,
                 resources: Optional[TorchResources] = None):
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        self.device, self.res = bind_device(device, resources)
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
        self._owner = programs.new_owner(self)
        self._gen = 0
        self._store_version = self.store.version

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
        self._mutated()

    def is_float16_storage(self) -> bool:
        return self.storage_type is StorageType.FLOAT16

    def is_bfloat16_storage(self) -> bool:
        return self.storage_type is StorageType.BFLOAT16

    def set_force_plain(self, force: bool) -> None:
        """Run the plain path even where the fused path is eligible
        (cross-path testing; the counterpart of set_force_xla)."""
        self._force_plain = bool(force)
        self._mutated()

    def add(self, x: np.ndarray) -> None:
        self.store.add(x)
        self._mutated()

    def reset(self) -> None:
        self.store.reset()
        self._no_reduced_sweep.clear()  # new data, new margins
        self._mutated()

    def _mutated(self) -> None:
        """A new generation: the captured programs baked the old store's
        addresses, ntotal and statistics, so the index's entries go."""
        self._gen += 1
        self._store_version = self.store.version
        self.res.discard(programs.owned_by(self._owner))

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
        self._mutated()
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
        self._mutated()
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
        """(queries padded to NQ_PAD rows on the device, nq, nq_pad)."""
        return calls.prep_queries(x, self.d, self.store.d_pad, self.device)

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
        selector stream ``sel`` admits (None: all), through the program
        cached for its shape and route. Returns (packed result tensor,
        whether the fused path ran, whether it ran the one-plane sweep);
        nothing is copied to the host."""
        route = flat_route([self.store], self.metric, k, nq_pad,
                           plain=force_plain or self._force_plain,
                           full_sweep=full_sweep,
                           pinned=self._no_reduced_sweep)
        if self.store.version != self._store_version:
            self._mutated()    # the store changed under the index
        packed = programs.call(self, "flat_search", TorchIndexFlat._packed,
                               (int(k), *route),
                               (q,) if sel is None else (q, sel))
        return packed, route[0], route[0] and route[1] == 1

    def _packed(self, k: int, use_fused: bool, passes: int, hi_exact: bool,
                use_direct: bool, q: torch.Tensor,
                sel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One search on the route, packed (no host synchronisation)."""
        vals, ids, cert = self._search_local(
            q, k, use_fused=use_fused, passes=passes, hi_exact=hi_exact,
            use_direct=use_direct, sel=sel)
        dists, labels = calls.finalize(vals, ids, self.ntotal, k, self.metric)
        return calls.pack(dists, labels, cert)

    def _search_local(self, q: torch.Tensor, k: int, *, use_fused: bool,
                      passes: int, hi_exact: bool, use_direct: bool,
                      sel: Optional[torch.Tensor]):
        """One search of the padded queries ``q`` on this index's device,
        the route decided by the caller: (scores (nq_pad, min(k, nv_eff))
        best first, with −‖q‖² for L2; their positional ids; the per-query
        certificate, all True on the plain path). ``hi_exact`` (f32 only):
        the hi-plane dispatch, which the caller takes only where the split
        statistics are zero. The sharded index calls this on every shard
        with one decision for all of them."""
        st = self.store
        nt = self.ntotal
        nv_eff = _round_up(nt, ROW_TILE)
        k_eff = min(k, nv_eff)
        if use_fused:
            split = {}
            if st.has_split:
                # hi_exact: the caller read the split statistics on the
                # host (a read here would be a host sync inside a capture)
                split = dict(db_split=(st.db_hi, st.db_lo),
                             pair_only=st.pair_only,
                             split_stats=st.split_stats, hi_exact=hi_exact)
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
        bool device stream (False past ntotal), or None when nothing is
        filtered (``calls.selector_streams``)."""
        return calls.selector_streams(
            params, self.ntotal, lambda mask: calls.bool_stream(
                self.store.capacity, self.device, slice(0, self.ntotal),
                mask), flat=True)

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
        """One pass over the plain-path score chunks (``_range_packed``),
        then one copy back: host (counts (nchunks, nq_pad), vals, ids
        (nchunks, nq_pad, cap), cap used)."""
        packed, cap = self._range_packed(q, nq_pad, thr, cap, sel,
                                         use_direct)
        return (*calls.unpack_range(packed.cpu().numpy(), cap), cap)

    def _range_packed(self, q: torch.Tensor, nq_pad: int, thr: float,
                      cap: int, sel: Optional[torch.Tensor],
                      use_direct: Optional[bool] = None):
        """One range pass through the program cached for its shape: per
        chunk the exact count of scores > thr and the top-``cap`` of them,
        packed on the device (``calls.pack_range``), and the capacity used.
        ``thr`` enters the program as a 0-d tensor, so one program serves
        every radius. ``use_direct``: the plain path's form (None: by the
        shape)."""
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
            use_direct = direct_form(self.metric, self.store, nv_eff, nq_pad)
        if self.store.version != self._store_version:
            self._mutated()    # the store changed under the index
        inputs = (q, torch.full((), thr, dtype=torch.float32,
                                device=self.device))
        inputs += () if sel is None else (sel,)
        return programs.call(self, "range_search", TorchIndexFlat._range_pass,
                             (nv_eff, chunk, cap, use_direct), inputs), cap

    def _range_pass(self, nv_eff: int, chunk: int, cap: int,
                    use_direct: bool, q: torch.Tensor, thr: torch.Tensor,
                    sel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The range pass over the first ``nv_eff`` rows in chunks of
        ``chunk``, packed (counts, vals, ids)."""
        counts, vals, ids = [], [], []
        for start in range(0, nv_eff, chunk):
            s = self._scores_block(q, start, chunk, use_direct=use_direct,
                                   sel=sel)
            hit = s > thr   # strict: faiss's dist < radius (L2), > (IP)
            counts.append(hit.sum(dim=-1, dtype=torch.int32))
            v, i = topk_ops.topk_scores(
                s.masked_fill(~hit, float("-inf")), cap)
            vals.append(v)
            ids.append(i + start)
        return calls.pack_range(torch.stack(counts), torch.stack(vals),
                                torch.stack(ids))

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
            f"bytes={st.nbytes()})\n" + self.res.describe())


def index_numpy_to_torch(xb: np.ndarray, metric=MetricType.L2,
                         storage=StorageType.FLOAT32, device="cuda",
                         resources: Optional[TorchResources] = None
                         ) -> TorchIndexFlat:
    """Build a TorchIndexFlat directly from an (n, d) fp32 matrix."""
    xb = np.ascontiguousarray(xb, dtype=np.float32)
    idx = TorchIndexFlat(xb.shape[1], metric=metric, storage=storage,
                         device=device, resources=resources)
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
                       device="cuda",
                       resources: Optional[TorchResources] = None
                       ) -> TorchIndexFlat:
    """CPU faiss.IndexFlat → TorchIndexFlat (copies the vectors to
    ``device``)."""
    faiss = _faiss()
    metric = (MetricType.L2 if cpu_index.metric_type == faiss.METRIC_L2
              else MetricType.INNER_PRODUCT)
    xb = cpu_index.reconstruct_n(0, cpu_index.ntotal)
    idx = TorchIndexFlat(cpu_index.d, metric=metric, storage=storage,
                         device=device, resources=resources)
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
