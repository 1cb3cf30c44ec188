"""Host-level composition of independent indexes (faiss IndexShards),
after ``faiss_tpu/multi.py``.

Each sub-index (a TorchIndexFlat, on one card or several) is searched on
its own, every sub-search enqueued before the first ``wait()``, and the
per-index k-lists merge on the host. The merge is the numpy stable-argsort
merge of ``faiss_tpu.native.merge_topk``'s fallback: on equal distances the
list merged first wins, so ties go to the lower sub-index.

``faiss_tpu`` merges with the native two-pointer merge (``native
.merge_topk``), which assumes every list sorted best-first. Where that
holds the two merges are equal bit for bit. A sub-index holding a NaN row
returns (−inf, −1) or (+inf, −1) at rank 0 ahead of its real results, and
the two-pointer merge then never reaches those results; the stable merge
still returns the exact top k of the rows that score. So the port keeps
the stable merge (ROADMAP §3, faults of the reference repaired in the
port).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .dtypes import MetricType
from .selector import IDSelectorMask, SearchParams, search_selector


def _merge_two(va, ia, vb, ib, k: int, largest: bool):
    """Merge two best-first (nq, ·) lists into one of k: a stable argsort
    over their concatenation, so on equal values list a wins."""
    vals = np.concatenate([va, vb], axis=1)
    ids = np.concatenate([ia, ib], axis=1)
    order = (np.argsort(-vals, axis=1, kind="stable") if largest
             else np.argsort(vals, axis=1, kind="stable"))[:, :k]
    return (np.take_along_axis(vals, order, 1),
            np.take_along_axis(ids, order, 1))


def merge_search_results(
    results: Sequence[Tuple[np.ndarray, np.ndarray]],
    k: int,
    metric=MetricType.L2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-index (D, I) results (each sorted best-first, int64 labels
    already globally meaningful) into one (nq, k) result."""
    metric = MetricType.coerce(metric)
    largest = metric is MetricType.INNER_PRODUCT
    if not results:
        raise ValueError("no results to merge")
    D, I = results[0]
    D, I = np.asarray(D, np.float32), np.asarray(I, np.int64)
    if D.shape[1] > k:
        D, I = D[:, :k], I[:, :k]
    for Dn, In in results[1:]:
        D, I = _merge_two(
            D, I, np.asarray(Dn, np.float32), np.asarray(In, np.int64),
            min(k, D.shape[1] + Dn.shape[1]), largest)
    if D.shape[1] < k:  # fewer total candidates than k: sentinel fill
        pad = k - D.shape[1]
        sent = -np.inf if largest else np.inf
        D = np.pad(D, ((0, 0), (0, pad)), constant_values=sent)
        I = np.pad(I, ((0, 0), (0, pad)), constant_values=-1)
    return D, I


class IndexShardsHost:
    """Search several independent indexes as one (host-merged).

    Sub-indexes keep their own id spaces; ``add`` routes whole batches to the
    smallest shard and records each sub-index's global id base, so labels are
    insertion-order global ids like every other index here.
    """

    def __init__(self, indexes: Sequence):
        if not indexes:
            raise ValueError("need at least one sub-index")
        d = indexes[0].d
        metric = indexes[0].metric
        for ix in indexes:
            if ix.d != d or ix.metric != metric:
                raise ValueError("sub-indexes must share d and metric")
            if ix.ntotal:
                raise ValueError("sub-indexes must start empty "
                                 "(id bases are assigned by add())")
        self.indexes = list(indexes)
        self.d = d
        self.metric = metric
        self.ntotal = 0
        # per-sub-index list of (global_base, count) extents, insertion order
        self._extents: List[List[Tuple[int, int]]] = [[] for _ in indexes]

    def add(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float32)
        n = x.shape[0]
        if n == 0:
            return
        tgt = int(np.argmin([ix.ntotal for ix in self.indexes]))
        self._extents[tgt].append((self.ntotal, n))
        self.indexes[tgt].add(x)
        self.ntotal += n

    def _globalize(self, which: int, labels: np.ndarray) -> np.ndarray:
        """local insertion-order id → global id via the extent table."""
        out = np.full_like(labels, -1)
        lo = 0
        for base, cnt in self._extents[which]:
            sel = (labels >= lo) & (labels < lo + cnt)
            out[sel] = labels[sel] - lo + base
            lo += cnt
        return out

    def _translate_params(self, params, which: int):
        """Global-id selector → the sub-index's positional mask through the
        extent table (the host-composition analog of faiss's
        IDSelectorTranslated; see selector.py)."""
        if params is None or getattr(params, "sel", None) is None:
            search_selector(params)  # validate type
            return params
        mask = np.zeros(self.indexes[which].ntotal, dtype=bool)
        lo = 0
        for base, cnt in self._extents[which]:
            mask[lo: lo + cnt] = params.sel.is_member(
                np.arange(base, base + cnt, dtype=np.int64))
            lo += cnt
        # nprobe rides along untouched: the sub-index honors or rejects it
        return SearchParams(IDSelectorMask(mask), nprobe=params.nprobe)

    def search(self, x: np.ndarray, k: int,
               params=None) -> Tuple[np.ndarray, np.ndarray]:
        toks = [ix.search_async(x, k, params=self._translate_params(params, w))
                for w, ix in enumerate(self.indexes)]  # all in flight
        results = []
        for w, t in enumerate(toks):
            D, I = t.wait()
            results.append((D, self._globalize(w, I)))
        return merge_search_results(results, k, self.metric)

    def reconstruct(self, key: int) -> np.ndarray:
        """The stored row of global id ``key``, decoded by its sub-index
        (beyond faiss_tpu's IndexShardsHost: what TorchIndexIDMap2's
        reconstruct needs over shards)."""
        key = int(key)
        for which, exts in enumerate(self._extents):
            lo = 0
            for base, cnt in exts:
                if base <= key < base + cnt:
                    return self.indexes[which].reconstruct(lo + key - base)
                lo += cnt
        raise IndexError(f"key {key} out of range [0, {self.ntotal})")

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        """Labels-only search (faiss::Index::assign)."""
        return self.search(x, k)[1]

    def range_search(
        self, x: np.ndarray, radius: float, params=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-merged range search (faiss CSR (lims, D, I) — see
        TorchIndexFlat.range_search): every sub-index contributes ALL its
        in-radius rows, so the union is complete by construction; per-query
        segments re-sorted best-first with global-id tiebreak."""
        per = [(ix.range_search(x, radius,
                                params=self._translate_params(params, w)), w)
               for w, ix in enumerate(self.indexes)]
        nq = per[0][0][0].shape[0] - 1
        largest = self.metric is MetricType.INNER_PRODUCT
        lims = np.zeros(nq + 1, np.int64)
        for (sl, _, _), _w in per:
            lims[1:] += np.diff(sl)
        np.cumsum(lims[1:], out=lims[1:])
        D = np.empty(lims[-1], np.float32)
        I = np.empty(lims[-1], np.int64)
        for qi in range(nq):
            pos = lims[qi]
            for (sl, sd, si), w in per:
                seg = slice(sl[qi], sl[qi + 1])
                n = sl[qi + 1] - sl[qi]
                D[pos:pos + n] = sd[seg]
                I[pos:pos + n] = self._globalize(w, si[seg])
                pos += n
            seg = slice(lims[qi], lims[qi + 1])
            order = np.lexsort((I[seg], -D[seg] if largest else D[seg]))
            D[seg], I[seg] = D[seg][order], I[seg][order]
        return lims, D, I

    def remove_ids(self, ids) -> int:
        """Remove global ids with faiss's stable renumbering — see
        TorchIndexFlat.remove_ids. Global ids map to (sub-index, local id)
        through the extent table; each sub-index removes its own locals, and
        the extents rebuild with the dense renumbering (survivors of one old
        extent stay contiguous in both numberings because extents are
        disjoint global ranges). Returns the number removed."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.ntotal:
            raise IndexError(
                f"remove_ids: ids outside [0, {self.ntotal}): "
                f"[{ids[0]}, {ids[-1]}]")
        new_extents: List[List[Tuple[int, int]]] = [[] for _ in self.indexes]
        for w, exts in enumerate(self._extents):
            local_rm = []
            lo = 0
            for base, cnt in exts:
                gs = np.arange(base, base + cnt, dtype=np.int64)
                rm = np.isin(gs, ids, assume_unique=True)
                local_rm.append(lo + np.nonzero(rm)[0])
                kept = cnt - int(rm.sum())
                if kept:
                    g_first = int(gs[~rm][0])
                    new_extents[w].append(
                        (g_first - int(np.searchsorted(ids, g_first)), kept))
                lo += cnt
            loc = np.concatenate(local_rm) if local_rm else np.empty(0)
            if loc.size:
                self.indexes[w].remove_ids(loc)
        self._extents = new_extents
        self.ntotal -= int(ids.size)
        return int(ids.size)

    def reset(self) -> None:
        for ix in self.indexes:
            ix.reset()
        self._extents = [[] for _ in self.indexes]
        self.ntotal = 0
