"""ID selectors and search parameters: filtered search, faiss-style.

After ``faiss_tpu/selector.py``, kept in the port so that the port imports
nothing of the JAX package. faiss's ``SearchParameters{sel}`` restricts a
search to a subset of the stored vectors (faiss/impl/IDSelector.h); here
the selector is honoured exactly: excluded rows score −inf, so they are
never returned, and fewer than k admitted rows sentinel-fill like a small
index.

A selector has two forms. ``is_member`` evaluates it on the host over an
int64 id vector (numpy): the plain reference. ``device_member`` evaluates
it over an id tensor on a device, with torch operations that enqueue and
never wait for the device; it returns what ``is_member`` returns over the
same ids, bit for bit. ``IDSelectorBatch`` and ``IDSelectorMask`` copy
their ids or mask to a device once and keep the copy (their host arrays are
read-only, so it cannot go stale); a copy counts ``sel.uploads``. A
selector whose class overrides ``is_member`` alone (a user subclass) has no
device form: the index evaluates it on the host, counted as
``sel.host_evals``, and copies the mask (``device_selector``).

Each index evaluates the selector over the id vector it keeps on the
device (``calls.selector_streams``): ``TorchIndexFlat`` over its
positions (``positional``; an ``IDSelectorBatch`` keeps that stream, set
on the device once for each size of index it meets), the sharded flat
index over each shard's global-id column, the IVF indexes over their
slot → id maps, ``TorchIndexIDMap`` through
``IDSelectorTranslated`` over its custom ids. The result is one bool
stream on the index's layout: the fused kernels see it folded into the
pre-masked norm stream that already masks padding (+inf norm → −inf score
in the sweep and the rescore, ops/fused._premask_norms), the plain path
and range_search in their block mask. The certificate is unchanged:
excluded rows are −inf on both sides of it, so a certified result is the
exact top-k of the admitted rows. ``IndexShardsHost`` evaluates a
selector on the host over the global ids of each sub-index.
"""

from typing import Optional

import numpy as np
import torch

from . import tracing

__all__ = [
    "IDSelector",
    "IDSelectorRange",
    "IDSelectorBatch",
    "IDSelectorMask",
    "IDSelectorNot",
    "IDSelectorAnd",
    "IDSelectorOr",
    "SearchParams",
    "SearchParameters",
    "SearchParametersIVF",
    "reject_ivf_params",
]

_I64 = np.iinfo(np.int64)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array's copy on ``device``, from pinned memory where the
    device is a card: the copy enqueues without waiting for it."""
    t = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype,
                    pin_memory=device.type == "cuda")
    t.numpy()[...] = arr
    return t.to(device, non_blocking=True)


class IDSelector:
    """Membership predicate over int64 ids: ``is_member`` on the host,
    ``device_member`` on a device."""

    # the selectors this one is made of (Not, And, Or, Translated)
    _parts = ()

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def has_device_form(self) -> bool:
        """Whether ``device_member`` evaluates this selector: the class that
        defines its ``is_member`` defines its device form too, and so do
        those of its parts."""
        owner = next(c for c in type(self).__mro__ if "is_member" in vars(c))
        return "_on_device" in vars(owner) and all(
            p.has_device_form() for p in self._parts)

    def device_member(self, ids: torch.Tensor) -> torch.Tensor:
        """``is_member`` over the id tensor ``ids`` (any integer dtype), as
        a bool tensor on its device; enqueued, no wait for the device."""
        if not self.has_device_form():
            raise TypeError(f"{type(self).__name__} has no device form")
        if ids.dtype != torch.int64:
            ids = ids.to(torch.int64)
        return self._on_device(ids)

    def positional(self, n: int, device: torch.device) -> torch.Tensor:
        """``device_member`` over the positions [0, n) on ``device``: the
        stream of an index whose ids are its positions."""
        return self.device_member(torch.arange(n, device=device))

    def covers(self, lo: int, hi: int) -> bool:
        """True only where the selector admits every id in [lo, hi),
        decided on the host (False where that is not cheap to tell)."""
        return hi <= lo

    # whether a device copy counts as ``sel.uploads`` (False where the
    # array is not the selector's own: an index's id map, a host mask)
    _counted = True

    def _device_copy(self, make, device: torch.device) -> torch.Tensor:
        """The host array ``make()`` on ``device``, copied once into
        ``self._copies``."""
        t = self._copies.get(device)
        if t is None:
            t = self._copies[device] = _upload(make(), device)
            if self._counted:
                tracing.count("sel.uploads", 1, tracing.current_call())
        return t

    def __invert__(self) -> "IDSelector":
        return IDSelectorNot(self)

    def __and__(self, other: "IDSelector") -> "IDSelector":
        return IDSelectorAnd(self, other)

    def __or__(self, other: "IDSelector") -> "IDSelector":
        return IDSelectorOr(self, other)


class IDSelectorRange(IDSelector):
    """ids in [imin, imax) — faiss::IDSelectorRange."""

    def __init__(self, imin: int, imax: int):
        self.imin, self.imax = int(imin), int(imax)

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        return (ids >= self.imin) & (ids < self.imax)

    def _on_device(self, ids: torch.Tensor) -> torch.Tensor:
        if self.imin > _I64.max or self.imax <= max(self.imin, _I64.min):
            return torch.zeros_like(ids, dtype=torch.bool)
        # bounds past int64 hold for every id
        out = ids >= max(self.imin, _I64.min)
        if self.imax <= _I64.max:
            out &= ids < self.imax
        return out

    def covers(self, lo: int, hi: int) -> bool:
        return hi <= lo or (self.imin <= lo and hi <= self.imax)


class IDSelectorBatch(IDSelector):
    """ids in an explicit set — faiss::IDSelectorBatch. ``ids``: the set,
    sorted and unique, read-only."""

    def __init__(self, ids):
        self._ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())
        self._ids.flags.writeable = False
        self._copies = {}
        self._streams = {}      # device → (n, positional stream)

    @property
    def ids(self) -> np.ndarray:
        return self._ids

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        return np.isin(ids, self._ids, assume_unique=False)

    def _on_device(self, ids: torch.Tensor) -> torch.Tensor:
        n = self._ids.size
        if n == 0:
            return torch.zeros_like(ids, dtype=torch.bool)
        # the set, then its largest id again: an id past the largest finds
        # position n, where it meets a smaller id
        table = self._device_copy(
            lambda: np.append(self._ids, self._ids[-1]), ids.device)
        return table[torch.searchsorted(table[:n], ids)] == ids

    def positional(self, n: int, device: torch.device) -> torch.Tensor:
        # the set's ids in [0, n) set on the device, once for each n a
        # device sees in turn: the set cannot change
        kept = self._streams.get(device)
        if kept is None or kept[0] != n:
            s = torch.zeros(n, dtype=torch.bool, device=device)
            lo, hi = np.searchsorted(self._ids, [0, n])
            if hi > lo:
                table = self._device_copy(
                    lambda: np.append(self._ids, self._ids[-1]), device)
                s.index_fill_(0, table[lo:hi], True)
            kept = self._streams[device] = (n, s)
        return kept[1]

    def covers(self, lo: int, hi: int) -> bool:
        # the set is unique: it holds all of [lo, hi) where it holds as many
        return hi <= lo or int(np.searchsorted(self._ids, hi)
                               - np.searchsorted(self._ids, lo)) == hi - lo


class IDSelectorMask(IDSelector):
    """Positional bool mask (mask[i] admits the vector at position/id i);
    ids past the mask are excluded. The escape hatch for precomputed
    masks. ``mask``: a read-only copy of the one given."""

    def __init__(self, mask):
        self._mask = np.array(mask, dtype=bool).reshape(-1)
        self._mask.flags.writeable = False
        self._copies = {}

    @property
    def mask(self) -> np.ndarray:
        return self._mask

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        ok = (ids >= 0) & (ids < self._mask.size)
        out = np.zeros(ids.shape, dtype=bool)
        out[ok] = self._mask[ids[ok]]
        return out

    def _on_device(self, ids: torch.Tensor) -> torch.Tensor:
        n = self._mask.size
        # the mask, then False: an id below 0 reads position −1, one past
        # the mask position n
        m = self._device_copy(lambda: np.append(self._mask, False),
                              ids.device)
        return m[ids.clamp(-1, n)]


class IDSelectorNot(IDSelector):
    def __init__(self, sel: IDSelector):
        self.sel = sel

    @property
    def _parts(self):
        return (self.sel,)

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        return ~self.sel.is_member(ids)

    def _on_device(self, ids: torch.Tensor) -> torch.Tensor:
        return ~self.sel._on_device(ids)


class IDSelectorAnd(IDSelector):
    def __init__(self, *sels: IDSelector):
        self.sels = sels

    @property
    def _parts(self):
        return self.sels

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        m = self.sels[0].is_member(ids)
        for s in self.sels[1:]:
            m &= s.is_member(ids)
        return m

    def _on_device(self, ids: torch.Tensor) -> torch.Tensor:
        m = self.sels[0]._on_device(ids)
        for s in self.sels[1:]:
            m &= s._on_device(ids)
        return m


class IDSelectorOr(IDSelector):
    def __init__(self, *sels: IDSelector):
        self.sels = sels

    @property
    def _parts(self):
        return self.sels

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        m = self.sels[0].is_member(ids)
        for s in self.sels[1:]:
            m |= s.is_member(ids)
        return m

    def _on_device(self, ids: torch.Tensor) -> torch.Tensor:
        m = self.sels[0]._on_device(ids)
        for s in self.sels[1:]:
            m |= s._on_device(ids)
        return m


class IDSelectorTranslated(IDSelector):
    """faiss::IDSelectorTranslated: ``sel``, which speaks custom ids, over
    positions: position i is admitted where ``sel`` admits ``id_map[i]``;
    positions outside the map are excluded. ``copies``: the map's device
    copies, kept by its owner for as long as the map stands."""

    _counted = False    # index state, not the selector's

    def __init__(self, sel: IDSelector, id_map: np.ndarray, copies: dict):
        self.sel, self.id_map, self._copies = sel, id_map, copies

    @property
    def _parts(self):
        return (self.sel,)

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        ok = (ids >= 0) & (ids < self.id_map.size)
        out = np.zeros(ids.shape, dtype=bool)
        out[ok] = self.sel.is_member(self.id_map[ids[ok]])
        return out

    def _on_device(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.id_map.size
        # the map, then 0 for the positions outside it (masked below)
        m = self._device_copy(lambda: np.append(self.id_map, np.int64(0)),
                              ids.device)
        pos = ids.clamp(-1, n)
        return self.sel._on_device(m[pos]) & (pos >= 0) & (pos < n)


def device_selector(sel: IDSelector, ntotal: int) -> Optional[IDSelector]:
    """``sel`` as an index evaluates it on its devices over its ids
    [0, ntotal), or None where it admits every one of them (the unfiltered
    search gives the same answer). A selector with no device form is
    evaluated on the host (``sel.host_evals``) and stands in as its mask,
    copied once."""
    if sel.has_device_form():
        return None if sel.covers(0, ntotal) else sel
    tracing.count("sel.host_evals", 1, tracing.current_call())
    mask = sel.is_member(np.arange(ntotal, dtype=np.int64)).astype(bool)
    if mask.all():
        return None
    out = IDSelectorMask(mask)
    out._counted = False    # counted as the evaluation
    return out


class SearchParams:
    """≈ faiss::SearchParameters: optional selector restricting the search.
    Accepted by search / search_async / range_search. ``nprobe`` is the
    faiss::SearchParametersIVF per-query probe-width override — honored by
    the JAX package's TpuIndexIVFFlat, rejected loudly by flat indexes
    (faiss dynamic_casts its params and throws on a type mismatch)."""

    def __init__(self, sel: Optional[IDSelector] = None,
                 nprobe: Optional[int] = None):
        if sel is not None and not isinstance(sel, IDSelector):
            raise TypeError(
                f"SearchParams.sel must be an IDSelector, got {type(sel)}")
        if nprobe is not None:
            nprobe = int(nprobe)
            if nprobe < 1:
                raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        self.sel = sel
        self.nprobe = nprobe


def reject_ivf_params(params) -> None:
    """Flat-index guard: a params.nprobe override on a non-IVF index is a
    caller bug (faiss::IndexFlat would throw 'invalid search params')."""
    if isinstance(params, SearchParams) and params.nprobe is not None:
        raise ValueError(
            "params.nprobe is an IVF parameter; this index has no coarse "
            "quantizer (use an IVF index, or drop nprobe)")


def search_selector(params) -> Optional[IDSelector]:
    """``params``' selector, or None when there is nothing to filter.
    Rejects unknown params objects loudly."""
    if params is None:
        return None
    if not isinstance(params, SearchParams):
        raise TypeError(
            f"params must be a SearchParams, got {type(params)}")
    return params.sel


# faiss spelling aliases (faiss::SearchParameters / SearchParametersIVF):
# one params class serves both — flat indexes reject the IVF-only fields
# via reject_ivf_params rather than by type, so a selector written for a
# flat index works unchanged on an IVF index (faiss allows the same).
SearchParameters = SearchParams
SearchParametersIVF = SearchParams
