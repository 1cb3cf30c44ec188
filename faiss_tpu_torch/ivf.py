"""TorchIndexIVFFlat: the IVF-Flat index (faiss::IndexIVFFlat) on the
chunk-paged pool, with f32, bf16 and int8 lists.

Counterpart of ``faiss_tpu/ivf.py``'s TpuIndexIVFFlat:

  * storage is a CHUNK-PAGED POOL: one (npool·128, d_pad) device tensor of
    128-row chunks (the pool doubles as it grows; existing slots never
    move), per-slot norms and insertion ids (−1 in empty slots), and an
    (nlist, maxc) int32 PAGE TABLE mapping list l's j-th chunk to its pool
    chunk. Device memory, the fine scan and the dense sweep all follow the
    occupancy, never nlist × the longest list;
  * train: ``clustering.Kmeans`` (spherical for IP), then
    ``balance_centroids`` on the same subsample (no list beyond ~2× the
    mean, so the fine scan's static chunk budget stops paying k-means'
    skew); int8 freezes its per-dimension scales from the same sample;
  * add: the coarse assignment is one fp32 GEMM against the centroids and
    the first argmax (ties to the lowest list id); slot arithmetic is host
    numpy on the counts mirror; the rows land with one scatter. int8 rows
    are quantised on the card (norms of the decoded rows, the running
    max ‖codes‖); f32 and bf16 norms are summed in f64 on the host;
  * search: the coarse probe is ``matmul_scores`` against the centroids
    and the top nprobe by ``topk_scores`` (``_probe``); the probed lists'
    occupied chunks are laid out per query (``_chunk_ids``) under a static
    budget (``_chunk_budget``: the nprobe fattest lists, rounded to two
    significant bits) and fed as group ids to K10 (``kernels.
    rescore_groups``: f32 rows, bf16 rows, or int8 codes against q∘s),
    with ``ngroups`` = the pool's capacity and slot validity (``ids ≥ 0``)
    folded into the pre-masked norm stream, which the index keeps per
    generation (``_mutated``); a selector folds in per call. Dead budget
    positions point at chunk 0; the top-k (``kernels.budget_select`` at k ≤
    40, else ``budget_select_plain``, the stable sort) ranks their columns
    as −inf; then slot → id, and −‖q‖² restored. The program also counts
    the live and the budgeted positions and the distinct chunks K10 read
    (``_scan_counts``): one more row of the packed result, which the token
    records under the profiler (``tracing.COUNTERS``);
  * nprobe == nlist takes the DENSE route over the used pool prefix: f32
    sweeps ``matmul_scores`` block by block into ``chunked_topk_scores``;
    bf16 and int8 take the flat ``fused.fused_search`` (two query planes,
    the occupancy as its selector) with the certificate, whose failed
    queries re-run on the plain dense sweep when the token is waited on;
  * range_search gathers the probed chunks' rows in blocks of 8 queries
    (``_probed_scores``) and assembles them with ``calls.range_csr``;
  * every search route, each range pass (the probe included; the radius
    an input tensor) and the coarse assign of ``add`` run through
    ``programs.call`` (``ivf_search``, ``ivf_range``, ``ivf_assign``); the
    assign's programs, which read only the centroids, are owned apart and
    keyed by the centroids' generation, so that an add keeps them.

Distances are exact within the probed lists (fp32-true against the stored
rows), so nprobe == nlist reproduces the flat index; smaller nprobe trades
recall as in faiss. What stays behind from the JAX class: the SMEM budget
of its query split (a v5e limit), the interpret-mode rank depth of its
kernel, the XLA chunk-take block as a search route (queries pad to 8 here,
so the kernel route always applies), and the DIRECT_BV alignment that
gates its dense fused route (a Mosaic compile hazard): the port takes the
fused dense route on any non-empty bf16 / int8 pool.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from . import calls, programs, tracing
from .calls import NQ_PAD
from .clustering import Kmeans, balance_centroids
from .dtypes import MetricType, StorageType
from .index import TorchIndexFlat
from .ops import distance as dist_ops
from .ops import fused, kernels
from .ops.distance import exact_fp32_matmul
from .ops.topk import chunked_topk_scores, topk_scores
from .resources import TorchResources, bind_device
from .storage import (D_ALIGN, D_ALIGN_INT8, _round_up, f32_to_bf16,
                      quantize_int8)

__all__ = ["TorchIndexIVFFlat"]

_CHUNK = kernels.GROUP        # rows per pool chunk = K10's group
_QB = 8                       # queries per range_search gather block
_POOL0 = 8                    # first pool capacity (chunks), then doubling
_GATHER_BUDGET = 512 << 20    # bytes of fine-scan scores per dispatch
_ASSIGN_BLK = 8192            # coarse-assign rows per GEMM block
_DENSE_BLOCK = 256 << 20      # bytes of one dense-sweep score block


def _chunk_ids(probe: torch.Tensor, counts: torch.Tensor,
               ctable: torch.Tensor, nbudget: int):
    """The probed lists' OCCUPIED chunks laid out per query, in probe order:
    (cidx (nq, nbudget) int32 pool chunk ids, okc (nq, nbudget) bool,
    False on positions past the query's chunks, which point at chunk 0 and
    must be masked by the caller). ``counts`` (nlist,) int64 list sizes,
    ``ctable`` (nlist, maxc) int32 the page table."""
    maxc = ctable.shape[1]
    ccnt = -(-counts[probe.to(torch.int64)] // _CHUNK)     # (nq, nprobe)
    offs = torch.cumsum(ccnt, dim=-1) - ccnt               # exclusive prefix
    pos = torch.arange(nbudget, device=probe.device).expand(
        probe.shape[0], nbudget).contiguous()
    # owner of position p = the last probed list whose offset ≤ p
    li = torch.searchsorted(offs.contiguous(), pos, right=True) - 1
    li = torch.clamp(li, 0, probe.shape[1] - 1)
    within = pos - torch.gather(offs, 1, li)
    okc = within < torch.gather(ccnt, 1, li)
    lst = torch.gather(probe.to(torch.int64), 1, li)
    cidx = ctable.reshape(-1)[lst * maxc + torch.where(okc, within, 0)]
    return torch.where(okc, cidx, 0), okc


def _scan_counts(cidx: torch.Tensor, okc: torch.Tensor,
                 npool: int) -> torch.Tensor:
    """The fine scan's counters (``tracing.COUNTERS``), a (3,) int32 tensor
    made on the device with no synchronisation: the live budget positions,
    the budgeted positions, and the distinct pool chunks K10 reads (dead
    positions read chunk 0)."""
    read = torch.zeros((npool,), dtype=torch.int32, device=cidx.device)
    read.index_fill_(0, cidx.reshape(-1).to(torch.int64), 1)
    return torch.stack([
        okc.sum(), torch.full((), okc.numel(), dtype=torch.int64,
                              device=okc.device),
        read.sum()]).to(torch.int32)


def _round_budget(b: int) -> int:
    """A chunk budget rounded up to ~2 significant bits (≤ 25 % slack)."""
    b = max(b, 1)
    step = 1 << max(0, b.bit_length() - 3)
    return -(-b // step) * step


def _chunk_budget(counts: np.ndarray, nprobe: int) -> int:
    """The static per-query chunk budget: the sum of the ``nprobe`` largest
    per-list chunk counts, an upper bound over ANY probe set (results are
    complete within the probed lists), rounded by _round_budget."""
    ccnt = -(-counts.astype(np.int64) // _CHUNK)
    top = np.sort(ccnt)[-nprobe:] if nprobe < ccnt.size else ccnt
    return _round_budget(int(top.sum()))


def dense_fallback(index, x, nq: int, k: int, params):
    """The dense fused route's certificate fallback of a search of ``x``
    (``calls.certificate_fallback``): the failed queries searched again
    through ``index._search_packed`` on the plain dense sweep."""
    x_host = np.ascontiguousarray(x, np.float32).reshape(-1, index.d)

    def rerun(bad):
        packed = index._search_packed(x_host[bad], k, params,
                                      force_plain_dense=True)[0]
        return calls.unpack(packed.cpu().numpy(), k)[:2]

    return calls.certificate_fallback(index, nq, rerun)


class TorchIndexIVFFlat(calls.SearchCalls):
    """faiss::IndexIVFFlat. ``storage``: f32 (exact fp32 distances), bf16
    (2 B/element, distances fp32-true to the stored rows) or int8 (1
    B/element; per-dimension scales frozen by ``train``, norms of the
    decoded rows, exact distances against the decoded database).
    ``device`` defaults to "cuda" (the default device of ``resources``
    where given) and raises without a card; "cpu" runs every kernel's
    plain version. ``resources``: the TorchResources whose program cache
    the searches go through (``device`` must be one of its devices); by
    default the process-wide one of the device's type."""

    def __init__(self, d: int, nlist: int, metric=MetricType.L2,
                 storage=StorageType.FLOAT32, nprobe: int = 1,
                 device=None, train_niter: int = 10, seed: int = 1234,
                 balance: float = 2.0,
                 resources: Optional[TorchResources] = None):
        self.d, self.nlist = int(d), int(nlist)
        if self.d <= 0 or self.nlist <= 0:
            raise ValueError(f"bad IVF config: d={d}, nlist={nlist}")
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        if self.storage_type is StorageType.FLOAT16:
            raise ValueError(
                "TorchIndexIVFFlat supports f32/bf16/int8 storage (f16 is a "
                "flat-index feature)")
        self.device, self.res = bind_device(device, resources)
        self.nprobe = int(nprobe)
        self.train_niter = int(train_niter)
        self.seed = int(seed)
        # train-time list balancing (balance_centroids); 0 / None disables
        self.balance = float(balance) if balance else 0.0
        is_int8 = self.storage_type is StorageType.INT8
        self.d_pad = _round_up(self.d, D_ALIGN_INT8 if is_int8 else D_ALIGN)
        self._dtype = {StorageType.FLOAT32: torch.float32,
                       StorageType.BFLOAT16: torch.bfloat16,
                       StorageType.INT8: torch.int8}[self.storage_type]
        self.quantizer: Optional[TorchIndexFlat] = None   # over the centroids
        self._centroids: Optional[np.ndarray] = None      # (nlist, d) host
        self._cents = None     # (nlist_pad, d_pad) f32 device
        self._cnorms = None    # (nlist_pad,) f32, +inf on the pad rows
        self._scales = None    # int8: (d_pad,) f32 device, frozen
        self.fused_fallbacks = 0   # dense-fused certificate reruns
        self.norm_stream_builds = 0   # builds of the fine scan's _vn
        # what the last train took: Kmeans and balancing seconds (host
        # clock), the objective series, the balancing cap on list sizes
        self.train_stats: dict = {}
        # the coarse assign's programs: an owner of their own and the
        # centroids' generation, so that they outlive an add
        self._owner = programs.new_owner(self)
        self._gen = 0
        self._assign_owner = programs.new_owner(self)
        self._cgen = 0
        self.reset()

    @property
    def is_trained(self) -> bool:
        return self.quantizer is not None and (
            self.storage_type is not StorageType.INT8
            or self._scales is not None)

    # -- train ----------------------------------------------------------------
    def train(self, x: np.ndarray) -> None:
        """Train the coarse quantizer (Kmeans, then balance_centroids on the
        same subsample); int8 also freezes its scales from ``x``. A trained
        index ignores the call, as faiss does."""
        if self.is_trained:
            return
        x = np.ascontiguousarray(x, np.float32)
        if self.storage_type is StorageType.INT8 and self._scales is None:
            self._set_scales(np.maximum(np.abs(x).max(axis=0) / 127.0,
                                        1e-12).astype(np.float32))
        if self.quantizer is not None:
            return
        spherical = self.metric is MetricType.INNER_PRODUCT
        t0 = time.perf_counter()
        km = Kmeans(self.d, self.nlist, niter=self.train_niter,
                    seed=self.seed, metric=self.metric, spherical=spherical,
                    device=self.device, resources=self.res)
        km.train(x)      # ends on a copy to the host: the time is the card's
        self.train_stats = {"kmeans_s": time.perf_counter() - t0,
                            "obj": km.obj, "balance_s": 0.0}
        if not (self.balance and self.nlist > 1):
            self._set_centroids(km.centroids, quantizer=km.index)
            return
        # the subsample Kmeans.train draws first from the same seed
        t0 = time.perf_counter()
        sub = x
        cap_n = self.nlist * km.max_points_per_centroid
        if len(sub) > cap_n:
            rng = np.random.default_rng(self.seed)
            sub = sub[rng.choice(len(sub), cap_n, replace=False)]
        self._set_centroids(balance_centroids(
            sub, km.centroids, cap_ratio=self.balance, metric=self.metric,
            spherical=spherical, device=self.device))
        self.train_stats["balance_s"] = time.perf_counter() - t0
        self.train_stats["cap"] = max(
            int(np.ceil(self.balance * len(sub) / self.nlist)), 2)

    def _set_scales(self, scales: np.ndarray) -> None:
        """Install frozen int8 scales (train and the loader)."""
        sp = np.ones((self.d_pad,), np.float32)   # pad dims: q is 0 there
        sp[: self.d] = np.asarray(scales, np.float32)[: self.d]
        self._scales = torch.from_numpy(sp).to(self.device)
        self._mutated()

    def _set_centroids(self, centroids: np.ndarray, quantizer=None) -> None:
        """Install trained centroids (train, the loader, a shared
        quantizer): +inf norms on the padded rows score them −inf."""
        centroids = np.ascontiguousarray(centroids, np.float32)
        if centroids.shape != (self.nlist, self.d):
            raise ValueError(f"expected ({self.nlist}, {self.d}) centroids, "
                             f"got {centroids.shape}")
        if quantizer is None:
            quantizer = TorchIndexFlat(self.d, metric=self.metric,
                                       device=self.device, resources=self.res)
            quantizer.add(centroids)
        self.quantizer = quantizer
        self._centroids = centroids.copy()
        nl_pad = _round_up(self.nlist, 8)
        c = np.zeros((nl_pad, self.d_pad), np.float32)
        c[: self.nlist, : self.d] = centroids
        cn = np.full((nl_pad,), np.inf, np.float32)
        cn[: self.nlist] = (centroids.astype(np.float64) ** 2).sum(1)
        self._cents = torch.from_numpy(c).to(self.device)
        self._cnorms = torch.from_numpy(cn).to(self.device)
        self._cgen += 1
        self.res.discard(programs.owned_by(self._assign_owner))
        self._mutated()

    def _mutated(self) -> None:
        """A new generation: the captured programs baked the old tensors'
        addresses, ntotal and the pool's shape, so the index's entries
        go, and so do the chunk budgets of the old list sizes. The fine
        scan's norm stream ``_vn`` is built anew: ‖v‖² (L2) or 0 (IP) on
        occupied slots, +inf on empty and removed ones; None while the
        pool is empty. Every write to ``_norms`` or ``_ids`` ends here."""
        self._gen += 1
        self._budgets = {}
        self.res.discard(programs.owned_by(self._owner))
        self._vn = None
        if self._ids is not None:
            with tracing.span("ivf.norm_stream"):
                nslots = self._ids.shape[0]
                self._vn = fused._premask_norms(
                    self._norms, nslots, nslots, self.metric, self._ids >= 0)
            self.norm_stream_builds += 1

    # -- add ------------------------------------------------------------------
    def _ensure_pool(self, need_chunks: int, need_maxc: int) -> None:
        """Grow the pool (by doubling; slots keep their place) and the page
        table's width to hold ``need_chunks`` allocated chunks and
        ``need_maxc`` chunks on the fattest list."""
        new_pool = self.npool if self.npool else _POOL0
        while need_chunks > new_pool:
            new_pool *= 2
        if new_pool != self.npool:
            rows = new_pool * _CHUNK
            old = self.npool * _CHUNK
            for name, shape, dtype, fill in (
                    ("_data", (rows, self.d_pad), self._dtype, 0),
                    ("_norms", (rows,), torch.float32, 0),
                    ("_ids", (rows,), torch.int32, -1)):
                buf = torch.full(shape, fill, dtype=dtype, device=self.device)
                if old:
                    buf[:old] = getattr(self, name)
                setattr(self, name, buf)
            self._chunk_list = np.concatenate([
                self._chunk_list,
                np.full(new_pool - self.npool, -1, np.int32)])
            self.npool = new_pool
        if need_maxc > self.maxc:
            new_maxc = max(self.maxc, 1)
            while need_maxc > new_maxc:
                new_maxc *= 2
            self._ctable_host = np.pad(
                self._ctable_host, ((0, 0), (0, new_maxc - self.maxc)))
            self.maxc = new_maxc

    def _coarse_assign(self, x: np.ndarray):
        """(the batch padded to d_pad on the device, (n,) int64 host list
        ids): ``_assign_padded``, then one copy back."""
        xd, assign = self._assign_padded(x)
        n = x.shape[0]
        return xd[:n], assign[:n].cpu().numpy()

    def _assign_padded(self, x: np.ndarray):
        """(the batch padded to (n_pad, d_pad) on the device, (n_pad,)
        int64 list ids on the device): one copy to the card, then the
        coarse GEMM and the first argmax (the quantizer's arithmetic;
        padded centroid rows score −inf) through the program cached for
        the padded batch, under the assign's own owner and the centroids'
        generation. The batch pads as ``faiss_tpu``'s does, to whole blocks
        of ``blk`` rows, so one program serves every batch that pads
        alike."""
        n = x.shape[0]
        blk = min(_ASSIGN_BLK, max(_QB, _round_up(n, _QB)))
        n_pad = _round_up(n, blk)
        xp = torch.zeros((n_pad, self.d_pad), dtype=torch.float32)
        xp[:n, : self.d] = torch.from_numpy(x)
        xd = xp.to(self.device)
        return xd, programs.call(self, "ivf_assign", TorchIndexIVFFlat._assign,
                                 (blk,), (xd,), owner=self._assign_owner,
                                 gen=self._cgen)

    def _assign(self, blk: int, xd: torch.Tensor) -> torch.Tensor:
        """The coarse assign of the padded batch, in blocks of ``blk``
        rows."""
        return torch.cat([
            torch.argmax(dist_ops.matmul_scores(
                xd[i0:i0 + blk], self._cents, self._cnorms, self.metric),
                dim=-1)
            for i0 in range(0, xd.shape[0], blk)])

    def add(self, x: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError(
                "IndexIVFFlat requires train() before add (faiss throws the "
                "same way, faiss/IndexIVF.cpp)")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) vectors, got {x.shape}")
        n = x.shape[0]
        if n == 0:
            return
        if self.ntotal + n > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors")
        xd, assign = self._coarse_assign(x)
        self._add_preassigned(*self._encode(x, xd), assign)

    def _encode(self, x: np.ndarray, xd: torch.Tensor):
        """(rows in the stored dtype, their stored norms) of the batch ``x``
        (host) and ``xd`` (the same rows padded to d_pad, on the device)."""
        if self.storage_type is StorageType.INT8:
            # on the card with the frozen scales; norms of the DECODED rows
            codes, norms, _, clip = quantize_int8(xd, self._scales)
            self._int8_clipped = (clip if self._int8_clipped is None
                                  else self._int8_clipped + clip)
            self._int8_elems += x.shape[0] * self.d
            return codes, norms
        # pre-quantization norms, summed in f64 on the host (the storage
        # contract every oracle subtracts), 65,536 rows at a time
        norms = np.empty(x.shape[0], np.float32)
        for i0 in range(0, x.shape[0], 1 << 16):
            norms[i0:i0 + (1 << 16)] = (
                x[i0:i0 + (1 << 16)].astype(np.float64) ** 2).sum(1)
        rows = f32_to_bf16(xd) if self._dtype == torch.bfloat16 else xd
        return rows, torch.from_numpy(norms)

    def _add_preassigned(self, rows: torch.Tensor, norms: torch.Tensor,
                         assign: np.ndarray,
                         global_ids: Optional[np.ndarray] = None) -> None:
        """Insert rows whose list is already decided: add, merge_from and
        the loader (which restores a saved routing, never re-routes).
        ``rows`` (n, d_pad) in the stored dtype, ``norms`` (n,) f32 as
        stored, ``assign`` (n,) host list ids. Slots are host arithmetic on
        the counts mirror, stable within each list. ``global_ids``: what
        the device id column records for these rows (the sharded index
        stores global ids, so its merge needs no translation); by default
        the insertion ids."""
        n = rows.shape[0]
        assign = np.asarray(assign, np.int64)
        new_counts = self._counts.astype(np.int64) + np.bincount(
            assign, minlength=self.nlist)
        need_c = -(-new_counts // _CHUNK)            # chunks per list after
        grow = (need_c - self._list_nchunks).astype(np.int64)
        total_new = int(grow.sum())
        self._ensure_pool(self._used_chunks + total_new, int(need_c.max()))
        if total_new:
            # fresh pool chunks to the growing lists, in list order
            ll = np.repeat(np.arange(self.nlist, dtype=np.int64), grow)
            j = np.arange(total_new) - np.repeat(np.cumsum(grow) - grow, grow)
            new_chunks = self._used_chunks + np.arange(total_new,
                                                       dtype=np.int64)
            self._ctable_host[ll, self._list_nchunks[ll] + j] = new_chunks
            self._chunk_list[new_chunks] = ll
            self._used_chunks += total_new
            self._list_nchunks = need_c.astype(np.int32)
        order = np.argsort(assign, kind="stable")
        sa = assign[order]
        rank = np.arange(n) - np.searchsorted(sa, sa)
        pos = self._counts.astype(np.int64)[sa] + rank  # index within list
        slots = np.empty(n, np.int64)
        slots[order] = (self._ctable_host[sa, pos // _CHUNK].astype(np.int64)
                        * _CHUNK + pos % _CHUNK)
        sl = torch.from_numpy(slots).to(self.device)
        self._data[sl] = rows.to(self.device)
        self._norms[sl] = norms.to(self.device)
        self._ids[sl] = (
            torch.arange(self.ntotal, self.ntotal + n, dtype=torch.int32)
            if global_ids is None
            else torch.from_numpy(np.asarray(global_ids, np.int32))
        ).to(self.device)
        if self.storage_type is StorageType.INT8:
            # running max ‖codes‖: the dense fused route's certificate
            q = rows.to(torch.float32)
            qn = torch.sqrt(torch.amax(torch.sum(q * q, dim=-1)))
            self._int8_qn = qn if self._int8_qn is None \
                else torch.maximum(self._int8_qn, qn)
        self._ctable = torch.from_numpy(self._ctable_host).to(self.device)
        self._counts = new_counts.astype(np.int32)
        self._counts_dev = torch.from_numpy(new_counts).to(self.device)
        self._slot_of = np.concatenate([self._slot_of, slots])
        self.ntotal += n
        self._mutated()

    def _assignments(self) -> np.ndarray:
        """(ntotal,) list id of every insertion id."""
        return self._chunk_list[self._slot_of // _CHUNK].astype(np.int64)

    def _rows_by_id(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stored rows (ntotal, d_pad) and norms in insertion-id order,
        on the device, bits as stored."""
        sl = torch.from_numpy(self._slot_of).to(self.device)
        return self._data[sl], self._norms[sl]

    # -- search ---------------------------------------------------------------
    def _prep_search(self, x: np.ndarray, params):
        """Validation, the queries padded to NQ_PAD rows on the device, the
        selector stream (by SLOT, over the slot → id map), the probe
        width and the chunk budget: (q, nq, nq_pad, nprobe, nbudget,
        sel)."""
        if not self.is_trained:
            raise RuntimeError("IndexIVFFlat requires train() before search")
        q, nq, nq_pad = calls.prep_queries(x, self.d, self.d_pad, self.device)
        sel = self._sel_stream(params)
        nprobe = self._nprobe(params)
        self._check_footprint(nq_pad, nprobe)
        return q, nq, nq_pad, nprobe, self._budget(nprobe), sel

    def _sel_stream(self, params) -> Optional[torch.Tensor]:
        """``params``' selector over the slot → id map, as a (npool ·
        CHUNK,) bool stream by slot, or None when nothing is filtered
        (``calls.selector_streams``)."""
        return calls.selector_streams(params, self.ntotal, self._place_sel)

    def _place_sel(self, sel) -> torch.Tensor:
        """``sel`` over the slot → id map, False on empty slots."""
        return sel.device_member(self._ids) & (self._ids >= 0)

    def _check_footprint(self, nq_pad: int, nprobe: int) -> None:
        """Raise where the fine scan of ``nq_pad`` query rows would hold
        more scores than the gather budget (``_nq_cap`` splits a batch
        before it gets here)."""
        nbudget = self._budget(nprobe)
        footprint = nq_pad * nbudget * _CHUNK * 4
        if self._fine_route(nprobe) and footprint > _GATHER_BUDGET:
            raise ValueError(
                f"IVF fine scan working set would be {footprint >> 20} MB "
                f"(nprobe={nprobe}, chunk budget={nbudget}); lower nprobe "
                "(oversized query batches are split automatically: hitting "
                "this means even one 8-query block exceeds the budget)")

    def _budget(self, nprobe: int) -> int:
        """The fine scan's chunk budget at ``nprobe`` (``_chunk_budget`` of
        the list sizes; 1 for an empty pool), worked out once per
        generation and nprobe."""
        b = self._budgets.get(nprobe)
        if b is None:
            b = self._budgets[nprobe] = (
                _chunk_budget(self._counts, nprobe) if self.npool else 1)
        return b

    def _nprobe(self, params) -> int:
        """A search's probe width: ``params.nprobe`` where given, else the
        index's, at most nlist."""
        req = getattr(params, "nprobe", None) if params is not None else None
        return min(req if req is not None else self.nprobe, self.nlist)

    def _probe(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """The coarse step: (nq_pad, nprobe) int32 list ids, best first,
        ties to the lowest list id (the quantizer's arithmetic)."""
        with tracing.span("ivf.coarse_gemm"):
            cs = dist_ops.matmul_scores(q, self._cents, self._cnorms,
                                        self.metric)
        with tracing.span("ivf.top_nprobe"):
            return topk_scores(cs, nprobe)[1]

    def _qeff(self, q: torch.Tensor) -> torch.Tensor:
        """The dot-side query: q, or q∘s against int8 codes."""
        return q * self._scales[None, :] if self._scales is not None else q

    def _fine_scan(self, q, k: int, nprobe: int, nbudget: int, sel,
                   counted: bool):
        """The gather route: K10 over the probed chunks → (scores (nq_pad,
        k_eff) with −‖q‖², insertion ids (nq_pad, k_eff), its counters
        (``_scan_counts``) where ``counted``, else None)."""
        probe = self._probe(q, nprobe)
        with tracing.span("ivf.chunk_ids"):
            cidx, okc = _chunk_ids(probe, self._counts_dev, self._ctable,
                                   nbudget)
            counts = _scan_counts(cidx, okc, self.npool) if counted else None
        with tracing.span("ivf.k10"):
            # the generation's stream; a selector folds in per call
            vn = (self._vn if sel is None
                  else self._vn.masked_fill(~sel, float("inf")))
            s = kernels.rescore_groups(self._qeff(q), self._data, vn, cidx,
                                       metric=self.metric)
        with tracing.span("ivf.top_k"):
            # dead budget positions point at chunk 0: the select masks them
            # (past the kernel's k, the masked stable sort)
            kk = min(k, s.shape[1])
            select = (kernels.budget_select
                      if kk <= kernels.BUDGET_SELECT_MAX_K
                      else kernels.budget_select_plain)
            v, pos = select(s, okc, kk)
            pos = pos.to(torch.int64)
            slot = (torch.gather(cidx, 1, pos // _CHUNK).to(torch.int64)
                    * _CHUNK + pos % _CHUNK)
            if self.metric is MetricType.L2:
                # the kernel's scores omit the rank-invariant −‖q‖²
                v = v - torch.sum(q * q, dim=-1)[:, None]
            return v, self._ids[slot], counts

    def _nsweep(self) -> int:
        """The dense route's sweep width: the used chunk prefix rounded by
        _round_budget (the doubling headroom never enters it)."""
        return min(_round_budget(self._used_chunks) * _CHUNK,
                   self.npool * _CHUNK)

    def _dense_fused_ok(self) -> bool:
        """bf16 and int8 pools take the fused dense route (int8 once its
        certificate's max ‖codes‖ exists); f32 keeps the plain sweep (the
        pool has no (hi, lo) planes for the fused f32 program)."""
        return (self.storage_type is not StorageType.FLOAT32
                and self._used_chunks > 0
                and (self._scales is None or self._int8_qn is not None))

    def _dense_fused(self, q, k: int, sel):
        """nprobe == nlist on bf16 / int8: ``fused_search`` over the used
        pool prefix, the occupancy (and the selector) as its selector
        stream. → (scores, ids, certified)."""
        nslots = self._nsweep()
        occ = self._ids >= 0
        int8 = {}
        if self.storage_type is StorageType.INT8:
            int8 = dict(scales=self._scales, int_norm_max=self._int8_qn)
        v, slot, cert = fused.fused_search(
            q, self._data, self._norms, nslots, k=k, metric=self.metric,
            nv_eff=nslots, sweep_passes=2,
            sel=occ if sel is None else occ & sel, **int8)
        if self.metric is MetricType.L2:
            v = v - torch.sum(q * q, dim=-1)[:, None]
        return v, self._ids[slot.to(torch.int64)], cert

    def _dense_plain(self, q, k: int, sel):
        """nprobe == nlist, the plain sweep: fp32-true scores of the used
        pool prefix block by block into the running stable top-k (the
        f32 route, and the certificate fallback of the fused one)."""
        nslots = self._nsweep()
        nq_pad = q.shape[0]
        occ = self._ids >= 0
        ok = occ if sel is None else occ & sel
        blk = nslots
        while blk % 2 == 0 and blk * nq_pad * 4 > _DENSE_BLOCK:
            blk //= 2

        def score_blk(start: int) -> torch.Tensor:
            rows = self._data[start:start + blk]
            ns = self._norms[start:start + blk]
            if self._scales is not None:
                s = dist_ops.int8_scores(q, self._scales, rows, ns,
                                         self.metric)
            else:
                s = dist_ops.matmul_scores(q, rows, ns, self.metric)
            return s.masked_fill(~ok[None, start:start + blk], float("-inf"))

        v, slot = chunked_topk_scores(score_blk, nslots, blk,
                                      min(k, nslots))
        return v, self._ids[slot.to(torch.int64)]

    def _search_packed(self, x: np.ndarray, k: int, params=None,
                       force_plain_dense: bool = False):
        """Enqueue one search through the program cached for its shape and
        route (``calls.SearchCalls``): (packed result or None for the
        empty index, nq, the certificate fallback or None, the names of
        the counters in the result's last row: the fine scan's). Nothing
        waits for the device."""
        q, nq, _, nprobe, nbudget, sel = self._prep_search(x, params)
        if self.ntotal == 0:
            return None, nq, None, ()
        fine = self._fine_route(nprobe)
        dense_fused = (not fine and self._dense_fused_ok()
                       and not force_plain_dense)
        packed = programs.call(self, "ivf_search", TorchIndexIVFFlat._packed,
                               (int(k), nprobe, nbudget, dense_fused),
                               (q,) if sel is None else (q, sel))
        if not dense_fused:
            return packed, nq, None, tracing.COUNTERS if fine else ()
        return packed, nq, dense_fallback(self, x, nq, k, params), ()

    def _packed(self, k: int, nprobe: int, nbudget: int, dense_fused: bool,
                q, sel=None) -> torch.Tensor:
        """One search on the route, packed, the certificate all True on
        the exact routes (no host synchronisation); the fine scan's ends in
        the row of its counters."""
        v, lab, cert, counts = self._search_local(
            q, k, nprobe, nbudget, sel, not dense_fused, counted=True)
        dists, labels = calls.finalize(v, lab, self.ntotal, k, self.metric)
        if cert is None:
            cert = torch.ones_like(dists[:, 0], dtype=torch.bool)
        return calls.pack(dists, labels, cert, counts)

    def _search_local(self, q, k: int, nprobe: int, nbudget: int, sel,
                      force_plain_dense: bool = False, counted: bool = False):
        """The route for ``nprobe`` on this index's device: (scores with
        −‖q‖², the id column's labels, the certificate or None where the
        route is exact, the fine scan's counters where ``counted`` or
        None): the fine scan below nlist, else the dense fused route (bf16,
        int8) or the plain dense sweep. The sharded index calls this on
        every shard, uncounted."""
        if self._fine_route(nprobe):
            v, lab, counts = self._fine_scan(q, k, nprobe, nbudget, sel,
                                             counted)
            return v, lab, None, counts
        if self._dense_fused_ok() and not force_plain_dense:
            return (*self._dense_fused(q, k, sel), None)
        return (*self._dense_plain(q, k, sel), None, None)

    def _fine_route(self, nprobe: int) -> bool:
        """Whether a search at ``nprobe`` takes the fine scan (and its
        token carries the counters), else a dense route."""
        return nprobe < self.nlist

    def _nq_cap(self, nprobe: int) -> Optional[int]:
        """Most query rows per gather dispatch: the fine scan materializes
        (nq_pad, nbudget·128) f32 scores, so the batch, not only nprobe,
        drives the working set. Larger batches split on this cap."""
        if not self.npool or not self._fine_route(nprobe):
            return None      # the dense route bounds its own blocks
        cap = _GATHER_BUDGET // max(self._budget(nprobe) * _CHUNK * 4, 1)
        return max(NQ_PAD, cap // NQ_PAD * NQ_PAD)

    def _split_rows(self, params) -> Optional[int]:
        return self._nq_cap(self._nprobe(params))

    # -- range search -----------------------------------------------------------
    def _probed_scores(self, qeff, qn, probe, nbudget: int, sel):
        """Scores of a block of queries against the rows of their probed
        chunks, gathered: (scores (nb, nbudget·128), −inf on dead
        positions, empty and filtered slots; insertion ids (nb, ncand)).
        fp32-true against the stored rows, with −‖q‖² (L2)."""
        nb = qeff.shape[0]
        cidx, okc = _chunk_ids(probe, self._counts_dev, self._ctable, nbudget)
        ci = cidx.to(torch.int64)
        cand = self._data.view(-1, _CHUNK, self.d_pad)[ci].reshape(
            nb, nbudget * _CHUNK, self.d_pad).to(torch.float32)
        cnn = self._norms.view(-1, _CHUNK)[ci].reshape(nb, -1)
        cid = self._ids.view(-1, _CHUNK)[ci].reshape(nb, -1)
        valid = (okc.repeat_interleave(_CHUNK, dim=1) & (cid >= 0))
        if sel is not None:
            valid &= sel.view(-1, _CHUNK)[ci].reshape(nb, -1)
        with exact_fp32_matmul():
            dots = torch.bmm(cand, qeff[:, :, None])[:, :, 0]
        s = (2.0 * dots - cnn - qn[:, None]
             if self.metric is MetricType.L2 else dots)
        return s.masked_fill(~valid, float("-inf")), cid

    def range_search(self, x: np.ndarray, radius: float, params=None):
        """All rows within ``radius`` in the nprobe probed lists (faiss
        IndexIVF::range_search: complete within the probe; nprobe == nlist
        is exhaustive), faiss's CSR layout (lims, D, I), best first, ties
        to the lowest id; the strict criterion of the flat index."""
        q, nq, _, nprobe, nbudget, sel = self._prep_search(x, params)
        if self.ntotal == 0:
            return calls.empty_range(nq)
        if _QB * nbudget * _CHUNK * self.d_pad * 4 > _GATHER_BUDGET:
            raise ValueError(
                f"IVF range_search would gather too much per block "
                f"(nprobe={nprobe}, chunk budget={nbudget}); lower nprobe")
        thr = calls.range_threshold(radius, self.metric)
        return calls.range_csr(
            lambda rcap: self._run_range(q, nprobe, nbudget, thr, rcap, sel),
            nq, self.metric)

    def _run_range(self, q, nprobe: int, nbudget: int, thr: float,
                   rcap: int, sel):
        """One range pass over the probed chunks (``_range_packed``), then
        one copy back: host (counts (1, nq_pad), vals, ids (1, nq_pad,
        rc), rc)."""
        packed, rc = self._range_packed(q, nprobe, nbudget, thr, rcap, sel)
        return (*calls.unpack_range(packed.cpu().numpy(), rc), rc)

    def _range_packed(self, q, nprobe: int, nbudget: int, thr: float,
                      rcap: int, sel):
        """One range pass at capacity ``rcap`` through the program cached
        for its shape, the probe inside it and ``thr`` a 0-d input tensor
        (one program serves every radius): the packed (counts, vals, ids)
        on the device and the capacity used."""
        rc = min(rcap, nbudget * _CHUNK)
        inputs = (q, torch.full((), thr, dtype=torch.float32,
                                device=self.device))
        inputs += () if sel is None else (sel,)
        return programs.call(self, "ivf_range", TorchIndexIVFFlat._range_pass,
                             (nprobe, nbudget, rc), inputs), rc

    def _range_pass(self, nprobe: int, nbudget: int, rc: int, q, thr,
                    sel=None) -> torch.Tensor:
        """The range pass of the padded queries over their probed chunks,
        packed (counts, vals, ids), in blocks of _QB queries."""
        nq_pad = q.shape[0]
        probe = self._probe(q, nprobe)
        qeff = self._qeff(q)
        qn = torch.sum(q * q, dim=-1)
        nh, vs, gs = [], [], []
        for b in range(0, nq_pad, _QB):
            s, cid = self._probed_scores(qeff[b:b + _QB], qn[b:b + _QB],
                                         probe[b:b + _QB], nbudget, sel)
            hit = s > thr            # strict, as the flat index
            nh.append(hit.sum(dim=-1, dtype=torch.int32))
            v, i = topk_scores(s.masked_fill(~hit, float("-inf")), rc)
            vs.append(v)
            gs.append(torch.gather(cid, 1, i.to(torch.int64)))
        return calls.pack_range(torch.cat(nh).view(1, nq_pad),
                                torch.cat(vs).view(1, nq_pad, rc),
                                torch.cat(gs).view(1, nq_pad, rc))

    # -- the rest of the surface ---------------------------------------------
    def remove_ids(self, ids) -> int:
        """Remove by insertion id with faiss's stable renumbering (the
        survivors keep their order, ids shift down). Each list compacts:
        one device gather over the slot axis, the bookkeeping host
        arithmetic on the id → slot map."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.ntotal:
            raise IndexError(
                f"remove_ids: ids outside [0, {self.ntotal}): "
                f"[{ids[0]}, {ids[-1]}]")
        keep = np.setdiff1d(np.arange(self.ntotal, dtype=np.int64), ids,
                            assume_unique=True)
        if keep.size == 0:
            self.reset()
            return int(ids.size)
        old_slots = self._slot_of[keep]            # survivors, new-id order
        lists = self._chunk_list[old_slots // _CHUNK].astype(np.int64)
        # a list's pool-slot order is its insertion order (its page-table
        # row is ascending by construction): compact each list in it
        order = np.lexsort((old_slots, lists))
        sl, so = lists[order], old_slots[order]
        rank = np.arange(keep.size) - np.searchsorted(sl, sl)
        # list l owns the pool chunks [base[l], base[l] + need_c[l])
        newcnt = np.bincount(sl, minlength=self.nlist)
        need_c = -(-newcnt // _CHUNK)
        base = np.cumsum(need_c) - need_c
        new_used = int(need_c.sum())
        new_slots_sorted = ((base[sl] + rank // _CHUNK) * _CHUNK
                            + rank % _CHUNK)
        perm = np.zeros((self.npool * _CHUNK,), np.int64)
        perm[new_slots_sorted] = so
        new_ids_flat = np.full((self.npool * _CHUNK,), -1, np.int32)
        new_ids_flat[new_slots_sorted] = np.arange(
            keep.size, dtype=np.int64)[order]
        # hole slots gather stale rows; their id is −1, so every route
        # masks them
        pj = torch.from_numpy(perm).to(self.device)
        self._data = self._data[pj]
        self._norms = self._norms[pj]
        self._ids = torch.from_numpy(new_ids_flat).to(self.device)
        self._ctable_host[:] = 0
        ll = np.repeat(np.arange(self.nlist, dtype=np.int64), need_c)
        jj = np.arange(new_used) - np.repeat(base, need_c)
        self._ctable_host[ll, jj] = np.arange(new_used)
        self._ctable = torch.from_numpy(self._ctable_host).to(self.device)
        self._chunk_list[:] = -1
        self._chunk_list[:new_used] = ll
        self._list_nchunks = need_c.astype(np.int32)
        self._used_chunks = new_used
        self._counts = newcnt.astype(np.int32)
        self._counts_dev = torch.from_numpy(newcnt.astype(np.int64)).to(
            self.device)
        slot_of = np.empty(keep.size, np.int64)
        slot_of[new_ids_flat[new_slots_sorted]] = new_slots_sorted
        self._slot_of = slot_of
        self.ntotal = keep.size
        self._mutated()
        return int(ids.size)

    def merge_from(self, other: "TorchIndexIVFFlat") -> None:
        """faiss::IndexIVF::merge_from: append ``other``'s rows (ids
        continue at ntotal, in order) and reset ``other``. The saved
        routing, stored bits and norms move as they are (never re-routed).
        d, metric, nlist and storage must match; int8 also the scales."""
        if other is self:
            raise ValueError("cannot merge an index into itself")
        if (other.d != self.d or other.metric is not self.metric
                or other.nlist != self.nlist
                or other.storage_type is not self.storage_type):
            raise ValueError(
                "merge_from: d/metric/nlist/storage mismatch "
                f"(({self.d}, {self.metric}, {self.nlist}, "
                f"{self.storage_type}) vs ({other.d}, {other.metric}, "
                f"{other.nlist}, {other.storage_type}))")
        if not (self.is_trained and other.is_trained):
            raise RuntimeError("merge_from requires both indexes trained")
        if self.storage_type is StorageType.INT8 and not torch.equal(
                self._scales, other._scales.to(self.device)):
            raise ValueError(
                "merge_from: int8 scale grids differ: codes are not "
                "bit-compatible (re-add through float instead)")
        if other.ntotal:
            rows, norms = other._rows_by_id()
            self._add_preassigned(rows, norms, other._assignments())
        other.reset()

    def reconstruct(self, key: int) -> np.ndarray:
        """The stored row of insertion id ``key`` (int8: codes × scales)."""
        if not 0 <= key < self.ntotal:
            raise IndexError(f"id {key} out of range [0, {self.ntotal})")
        row = self._data[int(self._slot_of[key])].to(torch.float32)
        if self._scales is not None:
            row = row * self._scales
        return row[: self.d].cpu().numpy()

    def reset(self) -> None:
        """Drop the vectors; the trained quantizer and the int8 scales stay
        (faiss: is_trained persists)."""
        self.ntotal = 0
        self.npool = 0          # pool capacity (chunks; doubles)
        self.maxc = 0           # page-table width (chunks)
        self._used_chunks = 0   # pool allocation top
        self._data = self._norms = self._ids = None
        self._ctable_host = np.zeros((self.nlist, 0), np.int32)
        self._ctable = None
        self._chunk_list = np.empty(0, np.int32)    # pool chunk → list
        self._list_nchunks = np.zeros(self.nlist, np.int32)
        self._counts = np.zeros(self.nlist, np.int32)   # host mirror
        self._counts_dev = None
        self._slot_of = np.empty(0, np.int64)       # insertion id → slot
        self._int8_clipped = None
        self._int8_elems = 0
        self._int8_qn = None    # running max ‖codes‖ (device scalar)
        self._mutated()

    def list_sizes(self) -> np.ndarray:
        """Per-list occupancy (faiss invlists->list_size)."""
        return self._counts.copy()

    def pool_bytes(self) -> int:
        """Device bytes of the pool (rows, norms, ids) and page table."""
        bufs = (self._data, self._norms, self._ids, self._ctable)
        return sum(b.numel() * b.element_size() for b in bufs
                   if b is not None)

    def describe(self) -> str:
        # load = live rows per allocated pool slot
        load = (self._counts.sum() / (self._used_chunks * _CHUNK)
                if self._used_chunks else 0.0)
        int8_note = ""
        if self.storage_type is StorageType.INT8:
            frac = (float(self._int8_clipped) / self._int8_elems
                    if self._int8_elems and self._int8_clipped is not None
                    else 0.0)
            int8_note = f", int8_clipped_fraction={frac:.2e}"
        return (
            f"TorchIndexIVFFlat(d={self.d}, nlist={self.nlist}, "
            f"nprobe={self.nprobe}, metric={self.metric.value}, "
            f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
            f"pool={self._used_chunks}/{self.npool}x{_CHUNK}, "
            f"bucket_load={load:.2f}, "
            f"fused_fallbacks={self.fused_fallbacks}, "
            f"trained={self.is_trained}, device={self.device}{int8_note})")
