"""The host side of a search, written once under the four index classes
(``TorchIndexFlat``, ``TorchIndexIVFFlat``, ``ShardedIndexFlat``,
``ShardedIndexIVFFlat``): the query upload (``prep_queries``), the
selector's stream (``selector_streams``; each index evaluates it over the
id vector it keeps on its devices), the enqueue of one call (the classes'
base ``SearchCalls.search_async``: a batch past the index's cap split into a
``ConcatSearchToken``, an empty index answered by ``empty_result``), the
packed result (``finalize``, ``pack``, ``unpack``) and its token
(``TorchSearchToken``), the rerun of uncertified rows
(``certificate_fallback``) and range_search's passes (``range_csr``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import selector as sel_mod
from . import tracing
from .dtypes import MetricType, worst_distance
from .ops import distance as dist_ops
from .storage import _round_up

# queries pad to a multiple of this many rows
NQ_PAD = 8
# range_search: first per-(query, chunk) hit capacity; one rerun at the next
# power of two when a chunk holds more (its counts are exact either way)
RANGE_CAP0 = 1024


def pinned(shape, dtype, device) -> torch.Tensor:
    """A zeroed host tensor, in pinned memory where it is bound for a card:
    its copy then enqueues without waiting for the device."""
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def prep_queries(x, d: int, d_pad: int, device, unit: int = NQ_PAD):
    """(the queries padded to (nq_pad, d_pad) on ``device``, nq, nq_pad):
    ``x`` checked as (nq, d) (one vector is one row), nq_pad the least
    positive multiple of ``unit`` ≥ nq; padded on the host, then one copy
    from pinned memory."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"expected (n, {d}) queries, got {x.shape}")
    nq = x.shape[0]
    nq_pad = max(unit, _round_up(nq, unit))
    with tracing.span("index.prep_queries"):
        q = pinned((nq_pad, d_pad), torch.float32, device)
        q[:nq, :d] = torch.from_numpy(x)
        return q.to(device, non_blocking=True), nq, nq_pad


def selector_streams(params, ntotal: int, place: Callable, *,
                     flat: bool = False):
    """``params``' selector as the index's device streams: ``place(sel)``,
    where ``sel`` evaluates over a device id tensor or over the positions,
    enqueued (``selector.IDSelector.device_member``, ``positional``), or
    None where nothing is filtered (no selector, or one that admits every
    id in [0, ntotal), decided on the host: the unfiltered program gives
    the same result).
    ``params`` is validated first; ``flat``: the index has no coarse
    quantizer, so an nprobe raises. The evaluation and the placement are
    the ``index.sel_stream`` span; nothing in them waits for the device."""
    if flat:
        sel_mod.reject_ivf_params(params)
    sel = sel_mod.search_selector(params)
    if sel is None:
        return None
    with tracing.span("index.sel_stream"):
        sel = sel_mod.device_selector(sel, ntotal)
        return None if sel is None else place(sel)


def empty_result(nq: int, k: int, metric: MetricType):
    """The answer of an empty index: sentinel distances, labels −1."""
    return (np.full((nq, k), worst_distance(metric), np.float32),
            np.full((nq, k), -1, np.int64))


def empty_range(nq: int):
    """range_search's answer of an empty index: no hits."""
    return (np.zeros(nq + 1, np.int64), np.empty(0, np.float32),
            np.empty(0, np.int64))


class SearchCalls:
    """The search surface of the four index classes, over each one's
    ``_search_packed(x, k, params)``: (packed result, None for an empty
    index; nq; the certificate fallback or None; the names of the counters
    in the result's last row). ``_split_rows(params)``: the most query rows
    one call takes (None: no limit)."""

    def _split_rows(self, params) -> Optional[int]:
        return None

    def search_async(self, x, k: int, params=None):
        """Non-blocking search: returns once the work is enqueued, as a
        ``TorchSearchToken``, or a ``ConcatSearchToken`` over the row
        chunks of a batch past ``_split_rows``, each a call of its own, all
        enqueued up front. ``params`` (``SearchParams``): the rows its
        selector admits (and, on an IVF index, the nprobe)."""
        cap = self._split_rows(params)
        if cap is not None:
            x = np.ascontiguousarray(x, np.float32)
            if x.ndim == 2 and x.shape[0] > cap:
                return ConcatSearchToken([
                    self.search_async(x[i0:i0 + cap], k, params)
                    for i0 in range(0, x.shape[0], cap)])
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        with tracing.span("index.search_async", mint=True):
            packed, nq, fallback, counters = self._search_packed(x, k,
                                                                 params)
            if packed is None:
                return TorchSearchToken(None, nq, k, result=empty_result(
                    nq, k, self.metric))
            return TorchSearchToken(packed, nq, k, fallback=fallback,
                                    counters=counters)

    def search(self, x, k: int, params=None) -> Tuple[np.ndarray, np.ndarray]:
        """(distances f32 (nq, k), labels i64 (nq, k)): ``search_async``'s
        answer."""
        return self.search_async(x, k, params=params).wait()

    def assign(self, x, k: int = 1) -> np.ndarray:
        """Labels-only search (faiss::Index::assign), (nq, k) int64."""
        return self.search(x, k)[1]


def finalize(vals, ids, ntotal: int, k: int, metric: MetricType):
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


def pack(dists, labels, cert, counts=None):
    """One (nq_pad, 2k+1) f32 tensor holding dists, the int32 labels' bits
    and the certificate, so that a search needs one device-to-host copy.
    ``counts``: a (c,) int32 tensor of program counters (c ≤ 2k+1), whose
    bits then follow as one more row (``TorchSearchToken``'s
    ``counters``)."""
    packed = torch.cat([dists, labels.to(torch.int32).view(torch.float32),
                        cert.to(torch.float32)[:, None]], dim=1)
    if counts is None:
        return packed
    row = torch.zeros((1, packed.shape[1]), dtype=torch.int32,
                      device=packed.device)
    row[0, :counts.numel()] = counts
    return torch.cat([packed, row.view(torch.float32)])


def unpack_counts(packed: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` program counters of a host copy of ``pack(..., counts)``
    (its last row), int32."""
    return np.ascontiguousarray(packed[-1, :n]).view(np.int32)


def unpack(packed: np.ndarray, k: int):
    """(dists, int32 labels, certificate) of a host copy of ``pack``."""
    d = packed[:, :k]
    i = np.ascontiguousarray(packed[:, k: 2 * k]).view(np.int32)
    return d, i, packed[:, 2 * k] != 0


def certificate_fallback(index, nq: int, rerun: Callable):
    """A token's fallback: (D, I) of the first ``nq`` rows of a packed
    result (its host certificate, dists and labels), the rows whose
    certificate failed replaced by ``rerun(bad)``'s (host (D, I) whose
    first rows answer the queries ``bad``, in order). A failure in padding
    rows alone changes no answer: nothing reruns and nothing is counted;
    otherwise ``index.fused_fallbacks`` counts one more search."""

    def fallback(cert, d0, i0):
        d_out = np.array(d0[:nq], np.float32)
        i_out = np.array(i0[:nq], np.int64)
        bad = np.nonzero(~cert[:nq])[0]
        if bad.size == 0:
            return d_out, i_out
        index.fused_fallbacks += 1
        d2, i2 = rerun(bad)
        d_out[bad] = d2[: bad.size]
        i_out[bad] = i2[: bad.size]
        return d_out, i_out

    return fallback


class TorchSearchToken:
    """Async search handle. ``search_async`` returns once the search and
    the one device-to-host copy of its packed result are enqueued, the copy
    right behind the search on the same stream, into pinned host memory
    (PyTorch's caching host allocator); ``wait()`` waits for that copy,
    runs the certificate fallback for the uncertified rows only, and
    returns (D, I), arrays of their own; ``is_ready()`` polls a CUDA event
    recorded after the copy. ``counters``: the names of the program
    counters in the packed result's last row (``pack``), which ``wait()``
    records under the call's id while a profiler records."""

    def __init__(self, packed: Optional[torch.Tensor], nq: int, k: int,
                 fallback=None, result=None, counters=()):
        self._packed = packed
        self._nq, self._k = nq, k
        self._fallback = fallback
        self._result = result
        self._counters = counters
        self._event = self._copy_event = None
        if packed is not None and packed.is_cuda:
            # no device guard (≈ 10 µs a call on the H100's host): a copy
            # from a CUDA tensor runs on its own device's current stream
            stream = torch.cuda.current_stream(packed.device)
            self._event = torch.cuda.Event()
            self._event.record(stream)
            # in stream order: the copy runs before the next call's work,
            # and the host block is not reused until it is done
            self._packed = torch.empty(packed.shape, dtype=packed.dtype,
                                       pin_memory=True)
            self._packed.copy_(packed, non_blocking=True)
            self._copy_event = torch.cuda.Event()
            self._copy_event.record(stream)
        # the call id that search_async's span minted (None untraced)
        self._call = tracing.current_call()

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._result is None:
            with tracing.span("token.wait", self._call):
                if self._event is not None and tracing.recording():
                    # traced only: splits the wait into this call's own
                    # work and the copy's, enqueued right behind it
                    with tracing.span("token.sync"):
                        self._event.synchronize()
                with tracing.span("token.copy"):
                    if self._copy_event is not None:
                        self._copy_event.synchronize()
                    host = self._packed.numpy()
                with tracing.span("token.unpack"):
                    if self._counters and tracing.recording():
                        for name, v in zip(self._counters, unpack_counts(
                                host, len(self._counters))):
                            tracing.count(name, v, self._call)
                    d, i, cert = unpack(host, self._k)
                    # a failed padding row changes no answer: no rerun
                    rerun = (self._fallback is not None
                             and not cert[: self._nq].all())
                    if not rerun:
                        # copies: the host block goes back to its pool
                        self._result = (np.array(d[: self._nq], np.float32),
                                        np.array(i[: self._nq], np.int64))
                if rerun:
                    with tracing.span("token.fallback"):
                        self._result = self._fallback(cert, d, i)
            self._packed = self._fallback = None
            self._event = self._copy_event = None
        return self._result

    def is_ready(self) -> bool:
        if self._result is not None or self._copy_event is None:
            return True
        return self._copy_event.query()


class ConcatSearchToken:
    """Handle over the row-chunk tokens of ONE logical search (the IVF
    indexes split a query batch whose score array would pass their gather
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


def range_threshold(radius: float, metric: MetricType) -> float:
    """The score threshold of ``radius`` (−radius for L2), rounded to
    fp32 as the scores are."""
    return float(np.float32(-radius if metric is MetricType.L2 else radius))


def pack_range(counts, vals, ids) -> torch.Tensor:
    """One (nblocks, nq_pad, 1 + 2·cap) f32 tensor holding a range pass's
    int32 counts' bits, its scores and its int32 ids' bits, so that the
    pass needs one device-to-host copy."""
    return torch.cat([counts[..., None].view(torch.float32), vals,
                      ids.to(torch.int32).view(torch.float32)], dim=-1)


def unpack_range(packed: np.ndarray, cap: int):
    """(counts, vals, int32 ids) of a host copy of ``pack_range``."""
    counts = np.ascontiguousarray(packed[..., 0]).view(np.int32)
    ids = np.ascontiguousarray(packed[..., 1 + cap:]).view(np.int32)
    return counts, packed[..., 1: 1 + cap], ids


def range_csr(run_range, nq: int, metric: MetricType):
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
