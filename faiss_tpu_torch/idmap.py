"""Custom-id wrappers: faiss::IndexIDMap / IndexIDMap2, after
``faiss_tpu/idmap.py``, over TorchIndexFlat, TorchIndexIVFFlat or
IndexShardsHost.

  * ``add_with_ids(x, ids)`` stores the caller's int64 ids; plain ``add``
    raises, as faiss::IndexIDMap::add does.
  * ``search`` / ``search_async`` / ``range_search`` translate the inner
    index's positional labels through the id map on the host, at
    ``wait()`` for a token (after the inner fallback has run); the device
    work is the inner index's own. Label −1 stays −1. A selector speaks
    custom ids: it is evaluated over the id map and handed to the inner
    index as a positional mask.
  * ``remove_ids`` removes every position holding one of the custom ids;
    the inner index renumbers stably and the map compacts in step.
  * ``TorchIndexIDMap2`` adds ``reconstruct(custom_id)`` through a reverse
    map rebuilt after a change; a duplicated id resolves to its last
    occurrence (faiss::IndexIDMap2::construct_rev_map).
"""

from typing import Optional, Tuple

import numpy as np

from .selector import IDSelectorMask, SearchParams

__all__ = ["TorchIndexIDMap", "TorchIndexIDMap2"]


class _TranslatedToken:
    """Async token that applies the id translation at wait() time, so the
    wrapped token's selective-fallback machinery still runs first."""

    def __init__(self, token, id_map: np.ndarray):
        self._token = token
        self._id_map = id_map  # snapshot: translation uses add-time mapping

    def wait(self) -> Tuple[np.ndarray, np.ndarray]:
        D, I = self._token.wait()
        return D, _translate(self._id_map, I)

    def is_ready(self) -> bool:
        return self._token.is_ready()


def _translate(id_map: np.ndarray, labels: np.ndarray) -> np.ndarray:
    out = np.full(labels.shape, -1, dtype=np.int64)
    valid = labels >= 0
    out[valid] = id_map[labels[valid]]
    return out


class TorchIndexIDMap:
    """faiss::IndexIDMap over a TorchIndexFlat, a TorchIndexIVFFlat or an
    IndexShardsHost (composition: the inner index stays usable on its own).
    ``params.nprobe`` passes through to the inner index, which an IVF
    index honours and a flat one rejects."""

    def __init__(self, index):
        self.index = index
        self.id_map = np.empty(0, dtype=np.int64)

    # -- delegated config/introspection ------------------------------------
    @property
    def d(self) -> int:
        return self.index.d

    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    @property
    def is_trained(self) -> bool:
        return self.index.is_trained

    def train(self, x: np.ndarray) -> None:
        self.index.train(x)

    # -- mutation -----------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        raise RuntimeError(
            "TorchIndexIDMap requires add_with_ids "
            "(faiss::IndexIDMap::add throws the same way)")

    def add_with_ids(self, x: np.ndarray, ids) -> None:
        x = np.asarray(x)
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if ids.shape[0] != x.shape[0]:
            raise ValueError(
                f"add_with_ids: {x.shape[0]} vectors but {ids.shape[0]} ids")
        self.index.add(x)  # raises on shape/dtype problems before we commit
        self.id_map = np.concatenate([self.id_map, ids])

    def remove_ids(self, ids) -> int:
        """Remove every vector whose CUSTOM id is in ``ids``; returns the
        number of vectors removed (duplicate stored ids each count).
        Unknown ids are ignored, as in faiss's selector-based removal."""
        ids = np.asarray(ids, dtype=np.int64).ravel()
        hit = np.isin(self.id_map, ids)
        pos = np.nonzero(hit)[0]
        if pos.size:
            self.index.remove_ids(pos)
            self.id_map = self.id_map[~hit]
        return int(pos.size)

    def reset(self) -> None:
        self.index.reset()
        self.id_map = np.empty(0, dtype=np.int64)

    # -- search -------------------------------------------------------------
    def _translate_params(self, params) -> Optional[SearchParams]:
        """faiss's IDSelectorTranslated discipline (faiss/IndexIDMap.cpp):
        the caller's selector speaks CUSTOM ids, the inner index speaks
        positions — evaluate the selector over the id map once and hand the
        inner index the resulting positional mask."""
        if params is None or getattr(params, "sel", None) is None:
            return params
        return SearchParams(
            IDSelectorMask(params.sel.is_member(self.id_map)),
            nprobe=params.nprobe)  # inner index honors or rejects it

    def search(self, x: np.ndarray, k: int,
               params=None) -> Tuple[np.ndarray, np.ndarray]:
        D, I = self.index.search(x, k, params=self._translate_params(params))
        return D, _translate(self.id_map, I)

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        return self.search(x, k)[1]

    def search_async(self, x: np.ndarray, k: int,
                     params=None) -> _TranslatedToken:
        return _TranslatedToken(
            self.index.search_async(
                x, k, params=self._translate_params(params)),
            self.id_map)

    def range_search(
        self, x: np.ndarray, radius: float, params=None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        lims, D, I = self.index.range_search(
            x, radius, params=self._translate_params(params))
        return lims, D, _translate(self.id_map, I)

    def reconstruct(self, key: int) -> np.ndarray:
        raise RuntimeError(
            "IndexIDMap does not support reconstruct by custom id; "
            "use TorchIndexIDMap2 (faiss::IndexIDMap2)")

    def describe(self) -> str:
        return (f"{type(self).__name__}(ids={self.id_map.size}) over "
                + self.index.describe())


class TorchIndexIDMap2(TorchIndexIDMap):
    """faiss::IndexIDMap2: IndexIDMap plus reconstruct-by-custom-id through
    a reverse map (rebuilt lazily after any mutation)."""

    def __init__(self, index):
        super().__init__(index)
        self._rev: Optional[dict] = None

    def add_with_ids(self, x: np.ndarray, ids) -> None:
        super().add_with_ids(x, ids)
        self._rev = None

    def remove_ids(self, ids) -> int:
        n = super().remove_ids(ids)
        if n:
            self._rev = None
        return n

    def reset(self) -> None:
        super().reset()
        self._rev = None

    def reconstruct(self, key: int) -> np.ndarray:
        if self._rev is None:
            # last-added occurrence wins, like IndexIDMap2::construct_rev_map
            self._rev = {int(g): i for i, g in enumerate(self.id_map)}
        key = int(key)
        if key not in self._rev:
            raise KeyError(f"reconstruct: id {key} not in the index")
        return self.index.reconstruct(self._rev[key])
