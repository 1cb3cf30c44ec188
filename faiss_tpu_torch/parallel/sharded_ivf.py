"""ShardedIndexIVFFlat: IVF-Flat over a list of torch devices, after
``faiss_tpu/parallel/sharded_ivf.py``.

  * One coarse quantizer (and, for int8, one scale grid), trained on shard
    0 and installed in every shard; each shard is a full TorchIndexIVFFlat
    (its own chunk-paged pool and page table over all nlist lists) holding
    about 1/P of the rows, with GLOBAL ids in its device id column;
  * ``add`` routes the batch once through the shared quantizer, then
    splits it contiguously over the shards (balanced to ±1, rotating the
    remainder's start, as ShardedIndexFlat): every shard keeps the same
    list semantics, so the union of the shards' probed members is the
    single index's probe set;
  * ``search``: each shard runs its own route on its device (the K10 fine
    scan below nlist; at nprobe == nlist the dense fused route for bf16
    and int8, with its certificate, or the plain dense sweep), and the
    (k, gid) lists merge on the first device by (score desc, gid asc),
    ShardedIndexFlat's merge. Rows a dense certificate leaves unproven
    re-run on the plain dense sweep when the token is waited on;
  * the search runs as one program a distinct device (``run_by_device``:
    each device's shard searches and label masking, the merge and the
    packing on the first), cached by the index's TorchResources under
    ``faiss_tpu``'s ``sharded_ivf`` key plus the index's identity, its
    generation, the device and the dense fallback's flag; every mutation,
    and one made on a shard directly (its generation), starts a new
    generation and drops the index's programs.

Also: reconstruct by global id (``_id_shard``, ``_id_local``), selectors
over global ids, the per-query nprobe override, ``search_async``,
``list_sizes``, ``reset``. remove_ids, merge_from and range_search stay
single-device features (TorchIndexIVFFlat), as in the JAX class; so does
``_nq_cap``'s SMEM budget (a v5e limit): the batch splits on the gather
budget alone.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import programs
from .. import selector as sel_mod
from .. import tracing
from ..dtypes import MetricType, StorageType, worst_distance
from ..index import (NQ_PAD, ConcatSearchToken, TorchSearchToken, _pack,
                     _unpack)
from ..ivf import _CHUNK, _GATHER_BUDGET, TorchIndexIVFFlat, _chunk_budget
from ..resources import default_resources
from ..storage import _round_up
from .sharded import (balanced_counts, merge_shard_lists, resolve_devices,
                      run_by_device)

__all__ = ["ShardedIndexIVFFlat"]


class ShardedIndexIVFFlat:
    """IVF-Flat with its rows sharded over ``devices`` (default: the
    devices of ``resources``, else every visible CUDA device; a list may
    repeat a device), one quantizer shared by every shard. The API is
    TorchIndexIVFFlat's search surface. ``resources``: the TorchResources
    whose program cache the searches go through, shared with every shard
    (each device must be one of its devices); by default the process-wide
    one of the first device's type."""

    def __init__(self, d: int, nlist: int, metric=MetricType.L2,
                 storage=StorageType.FLOAT32, nprobe: int = 1,
                 num_shards: Optional[int] = None, devices=None,
                 train_niter: int = 10, seed: int = 1234,
                 balance: float = 2.0, resources=None):
        self.d, self.nlist = int(d), int(nlist)
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        devs = resolve_devices(devices, resources)
        self.res = (resources if resources is not None
                    else default_resources(devs[0]))
        p = num_shards or len(devs)
        if p < 1 or p > len(devs):
            raise ValueError(f"num_shards={p} exceeds {len(devs)} devices")
        self.devices = devs[:p]
        self.shards: List[TorchIndexIVFFlat] = [
            TorchIndexIVFFlat(d, nlist, metric=self.metric,
                              storage=self.storage_type, nprobe=nprobe,
                              device=dev, train_niter=train_niter, seed=seed,
                              balance=balance, resources=self.res)
            for dev in self.devices]
        self.d_pad = self.shards[0].d_pad
        self.nprobe = int(nprobe)
        self.fused_fallbacks = 0   # searches whose dense certificate failed
        # the programs' keys: (kind, owner, generation, ..., device)
        self._owner = programs.new_owner()
        self._gen = 0
        weakref.finalize(self, self.res.discard,
                         programs.owned_by(self._owner))
        self.reset()

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def is_trained(self) -> bool:
        return self.shards[0].is_trained

    @property
    def quantizer(self):
        return self.shards[0].quantizer

    def train(self, x: np.ndarray) -> None:
        """Train one quantizer (and int8 scale grid) on shard 0 and install
        it in every shard: one routing and one quantization for all, so
        results do not depend on the shard count."""
        if self.is_trained:
            return
        self.shards[0].train(np.ascontiguousarray(x, np.float32))
        self._install_from_shard0()

    def _install_from_shard0(self) -> None:
        s0 = self.shards[0]
        for s in self.shards[1:]:
            if s0._scales is not None:
                s._set_scales(s0._scales[: self.d].cpu().numpy())
            s._set_centroids(s0._centroids, quantizer=(
                s0.quantizer if s.device == s0.device else None))
        self._changed()

    def _shard_gens(self):
        return tuple(s._gen for s in self.shards)

    def _changed(self) -> None:
        """A new generation: the programs baked the shards' pools, page
        tables and ntotals, so they go."""
        self._gen += 1
        self._gens = self._shard_gens()
        self.res.discard(programs.owned_by(self._owner))

    # -- mutation -----------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        if not self.is_trained:
            raise RuntimeError("IndexIVFFlat requires train() before add")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) vectors, got {x.shape}")
        n = x.shape[0]
        if n == 0:
            return
        if self.ntotal + n > np.iinfo(np.int32).max:
            raise ValueError("index size would exceed 2^31-1 vectors")
        # one coarse routing for the whole batch, on shard 0
        xd, assign = self.shards[0]._coarse_assign(x)
        counts = balanced_counts(n, self.num_shards, self._next_shard)
        self._next_shard = (self._next_shard + n % self.num_shards) \
            % self.num_shards

        def put(sh, lo, hi, gids):
            rows, norms = sh._encode(x[lo:hi], xd[lo:hi].to(sh.device))
            sh._add_preassigned(rows, norms, assign[lo:hi], global_ids=gids)

        self._place(counts, put)

    def _place(self, counts, put) -> None:
        """Give shard i the next counts[i] rows of a batch (``put(shard,
        lo, hi, global ids)``), with global ids from ntotal."""
        n = sum(counts)
        id_shard = np.empty(n, np.int16)
        id_local = np.empty(n, np.int64)
        off = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            sh = self.shards[i]
            put(sh, off, off + c,
                np.arange(self.ntotal + off, self.ntotal + off + c,
                          dtype=np.int32))
            id_shard[off: off + c] = i
            id_local[off: off + c] = np.arange(sh.ntotal - c, sh.ntotal)
            off += c
        self._id_shard = np.concatenate([self._id_shard, id_shard])
        self._id_local = np.concatenate([self._id_local, id_local])
        self.ntotal += n
        self._changed()

    def reset(self) -> None:
        """Drop the vectors; the trained quantizer and scales stay."""
        for s in self.shards:
            s.reset()
        self.ntotal = 0
        self._next_shard = 0
        # global id → (shard, local insertion id): reconstruct, selectors
        self._id_shard = np.empty(0, np.int16)
        self._id_local = np.empty(0, np.int64)
        self._changed()

    def reconstruct(self, key: int) -> np.ndarray:
        if not 0 <= key < self.ntotal:
            raise IndexError(f"id {key} out of range [0, {self.ntotal})")
        return self.shards[int(self._id_shard[key])].reconstruct(
            int(self._id_local[key]))

    # -- search -------------------------------------------------------------
    def _nprobe(self, params) -> int:
        req = getattr(params, "nprobe", None) if params is not None else None
        return min(req if req is not None else self.nprobe, self.nlist)

    def _sel_streams(self, params):
        """The global admit mask as one slot-indexed bool stream per shard
        on its device, or None when nothing is filtered."""
        if sel_mod.selector_mask(params, np.empty(0, np.int64)) is None:
            return None
        with tracing.span("index.sel_stream"):
            mask = sel_mod.selector_mask(
                params, np.arange(self.ntotal, dtype=np.int64))
            if mask.all():
                return None
            gids = np.nonzero(mask)[0]
            out = []
            for i, sh in enumerate(self.shards):
                s = np.zeros((sh.npool * _CHUNK,), bool)
                s[sh._slot_of[
                    self._id_local[gids[self._id_shard[gids] == i]]]] = True
                out.append(torch.from_numpy(s).to(sh.device))
            return out

    def _search_packed(self, x: np.ndarray, k: int, params=None,
                       force_plain_dense: bool = False, cached: bool = True):
        """Enqueue one sharded search through the programs cached for its
        shape and route, one a device (``cached=False``: run eagerly):
        (packed result on the first device or None for the empty index,
        nq, the dense certificate's fallback or None)."""
        if not self.is_trained:
            raise RuntimeError("IndexIVFFlat requires train() before search")
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) queries, got {x.shape}")
        nq = x.shape[0]
        sel = self._sel_streams(params)
        if self.ntotal == 0:
            return None, nq, None
        if self._shard_gens() != self._gens:
            self._changed()    # a shard changed under the index
        nprobe = self._nprobe(params)
        nq_pad = max(NQ_PAD, _round_up(nq, NQ_PAD))
        out_dev = self.devices[0]
        with tracing.span("index.prep_queries"):
            q = torch.zeros((nq_pad, self.d_pad), dtype=torch.float32)
            q[:nq, : self.d] = torch.from_numpy(x)
            q = q.to(out_dev)
        live = [i for i, sh in enumerate(self.shards) if sh.ntotal]
        nbudget = {i: _chunk_budget(self.shards[i]._counts, nprobe)
                   for i in live}
        for i in live:
            if nprobe < self.nlist and \
                    nq_pad * nbudget[i] * _CHUNK * 4 > _GATHER_BUDGET:
                raise ValueError(
                    f"IVF fine scan working set would be "
                    f"{(nq_pad * nbudget[i] * _CHUNK * 4) >> 20} MB on shard "
                    f"{i} (nprobe={nprobe}, chunk budget={nbudget[i]}); "
                    "lower nprobe")
        # the dense fused route ships a certificate; the others are exact
        proven = not (nprobe >= self.nlist and not force_plain_dense and any(
            self.shards[i]._dense_fused_ok() for i in live))
        key = ("sharded_ivf", self._owner, self._gen, self.num_shards,
               self.nlist, tuple(s.npool for s in self.shards),
               tuple(s.maxc for s in self.shards), nprobe,
               tuple(nbudget.values()), nq_pad, int(k), self.d_pad,
               self.metric, self.storage_type, sel is not None,
               force_plain_dense)
        jobs = [(i, self.shards[i].device, None if sel is None else sel[i])
                for i in live]
        ref = weakref.ref(self)
        metric = self.metric

        def search(i, q_dev, sel_i):
            v, lab, c, _ = ref().shards[i]._search_local(
                q_dev, k, nprobe, nbudget[i], sel_i, force_plain_dense)
            lab = lab.to(torch.int32).masked_fill(~(v > float("-inf")), -1)
            if c is None:
                c = torch.ones((nq_pad,), dtype=torch.bool,
                               device=q_dev.device)
            return v, lab, c

        def merge(parts):
            cert = torch.ones((nq_pad,), dtype=torch.bool, device=out_dev)
            for _, _, c in parts:
                cert &= c
            dists, labels = merge_shard_lists(
                [(v, lab) for v, lab, _ in parts], k, metric, out_dev)
            return _pack(dists, labels, cert)

        packed = run_by_device(self.res, key, jobs, search, merge, q,
                               out_dev, cached)
        if proven:
            return packed, nq, None

        def fallback(cert_h, d0, i0):
            d_out = np.array(d0[:nq], np.float32)
            i_out = np.array(i0[:nq], np.int64)
            bad = np.nonzero(~cert_h[:nq])[0]
            if bad.size == 0:          # only padding rows failed
                return d_out, i_out
            self.fused_fallbacks += 1
            packed2, _, _ = self._search_packed(x[bad], k, params,
                                                force_plain_dense=True)
            d2, i2, _ = _unpack(packed2.cpu().numpy(), k)
            d_out[bad] = d2[: bad.size]
            i_out[bad] = i2[: bad.size]
            return d_out, i_out

        return packed, nq, fallback

    def _search_packed_uncached(self, x: np.ndarray, k: int, params=None,
                                force_plain_dense: bool = False):
        """The first pass of ``_search_packed`` run eagerly, with no
        program: what a replay must equal bit for bit (the card tests and
        chip_smoke). The packed result, None for the empty index."""
        return self._search_packed(x, k, params, force_plain_dense,
                                   cached=False)[0]

    def _nq_cap(self, nprobe: int) -> Optional[int]:
        """Most query rows per dispatch: the fattest shard's fine scan
        materializes (nq_pad, nbudget·128) f32 scores (the gather budget
        alone: the JAX class's SMEM split is a v5e limit)."""
        caps = [s._nq_cap(nprobe) for s in self.shards]
        caps = [c for c in caps if c is not None]
        return min(caps) if caps else None

    def search_async(self, x: np.ndarray, k: int, params=None):
        """Non-blocking search: a TorchSearchToken, or a ConcatSearchToken
        over the row chunks of a batch past the gather budget."""
        xa = np.ascontiguousarray(x, np.float32)
        if xa.ndim == 2 and self.is_trained:
            cap = self._nq_cap(self._nprobe(params))
            if cap is not None and xa.shape[0] > cap:
                return ConcatSearchToken([
                    self.search_async(xa[i0:i0 + cap], k, params=params)
                    for i0 in range(0, xa.shape[0], cap)])
        with tracing.span("index.search_async", mint=True):
            packed, nq, fallback = self._search_packed(x, k, params)
            if packed is None:
                return TorchSearchToken(None, nq, k, result=(
                    np.full((nq, k), worst_distance(self.metric),
                            np.float32),
                    np.full((nq, k), -1, np.int64)))
            return TorchSearchToken(packed, nq, k, fallback=fallback)

    def search(self, x: np.ndarray, k: int,
               params=None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the nprobe closest lists (exact within them), ids
        global; ``params``: a selector and / or an nprobe override."""
        return self.search_async(x, k, params=params).wait()

    def assign(self, x: np.ndarray, k: int = 1) -> np.ndarray:
        return self.search(x, k)[1]

    def list_sizes(self) -> np.ndarray:
        """Per-list occupancy summed over the shards (the single index's
        list_sizes for the same adds)."""
        out = np.zeros(self.nlist, np.int64)
        for s in self.shards:
            out += s._counts
        return out

    def describe(self) -> str:
        per = [s.ntotal for s in self.shards]
        pools = [f"{s._used_chunks}/{s.npool}" for s in self.shards]
        return (f"ShardedIndexIVFFlat(d={self.d}, nlist={self.nlist}, "
                f"nprobe={self.nprobe}, metric={self.metric.value}, "
                f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
                f"shards={self.num_shards}, per_shard={per}, pool={pools}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"fused_fallbacks={self.fused_fallbacks}, "
                f"trained={self.is_trained})")
