"""ID selectors and search parameters: filtered search, faiss-style.

A copy of ``faiss_tpu/selector.py`` (numpy only), kept in the port so that
the port imports nothing of the JAX package. faiss's
``SearchParameters{sel}`` restricts a search to a subset of the stored
vectors (faiss/impl/IDSelector.h); here the selector is honoured exactly:
excluded rows score −inf, so they are never returned, and fewer than k
admitted rows sentinel-fill like a small index.

A selector evaluates on the host over an int64 id vector (``is_member``).
``TorchIndexFlat`` evaluates it over its positional ids and copies one
(capacity,) bool stream to the device per search: the fused kernels see it
folded into the pre-masked norm stream that already masks padding (+inf
norm → −inf score in the sweep and the rescore, ops/fused._premask_norms),
the plain path and range_search in their block mask. The certificate is
unchanged: excluded rows are −inf on both sides of it, so a certified
result is the exact top-k of the admitted rows. ``TorchIndexIDMap``
evaluates a selector over its custom id map, ``IndexShardsHost`` over the
global ids of each sub-index (faiss's IDSelectorTranslated discipline).
"""

from typing import Optional

import numpy as np

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


class IDSelector:
    """Membership predicate over int64 ids (vectorized, host-side)."""

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

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


class IDSelectorBatch(IDSelector):
    """ids in an explicit set — faiss::IDSelectorBatch."""

    def __init__(self, ids):
        self.ids = np.unique(np.asarray(ids, dtype=np.int64).ravel())

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        return np.isin(ids, self.ids, assume_unique=False)


class IDSelectorMask(IDSelector):
    """Positional bool mask (mask[i] admits the vector at position/id i);
    ids past the mask are excluded. The escape hatch for precomputed
    masks — also what TorchIndexIDMap hands the inner index after
    translating a custom-id selector."""

    def __init__(self, mask):
        self.mask = np.asarray(mask, dtype=bool).ravel()

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        ok = (ids >= 0) & (ids < self.mask.size)
        out = np.zeros(ids.shape, dtype=bool)
        out[ok] = self.mask[ids[ok]]
        return out


class IDSelectorNot(IDSelector):
    def __init__(self, sel: IDSelector):
        self.sel = sel

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        return ~self.sel.is_member(ids)


class IDSelectorAnd(IDSelector):
    def __init__(self, *sels: IDSelector):
        self.sels = sels

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        m = self.sels[0].is_member(ids)
        for s in self.sels[1:]:
            m &= s.is_member(ids)
        return m


class IDSelectorOr(IDSelector):
    def __init__(self, *sels: IDSelector):
        self.sels = sels

    def is_member(self, ids: np.ndarray) -> np.ndarray:
        m = self.sels[0].is_member(ids)
        for s in self.sels[1:]:
            m |= s.is_member(ids)
        return m


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


def selector_mask(params, ids: np.ndarray) -> Optional[np.ndarray]:
    """Evaluate ``params``' selector over ``ids`` → bool mask, or None when
    there is nothing to filter. Rejects unknown params objects loudly."""
    if params is None:
        return None
    if not isinstance(params, SearchParams):
        raise TypeError(
            f"params must be a SearchParams, got {type(params)}")
    if params.sel is None:
        return None
    return params.sel.is_member(ids).astype(bool)


# faiss spelling aliases (faiss::SearchParameters / SearchParametersIVF):
# one params class serves both — flat indexes reject the IVF-only fields
# via reject_ivf_params rather than by type, so a selector written for a
# flat index works unchanged on an IVF index (faiss allows the same).
SearchParameters = SearchParams
SearchParametersIVF = SearchParams
