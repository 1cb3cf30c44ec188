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
    packing on the first); a change made on a shard directly (its
    generation) starts a new generation too.

Also: reconstruct by global id (``_id_shard``, ``_id_local``), selectors
over global ids, the per-query nprobe override, ``search_async``,
``list_sizes``, ``reset``. remove_ids, merge_from and range_search stay
single-device features (TorchIndexIVFFlat), as in the JAX class; so does
``_nq_cap``'s SMEM budget (a v5e limit): the batch splits on the gather
budget alone.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import calls, programs
from ..dtypes import MetricType, StorageType
from ..ivf import _CHUNK, TorchIndexIVFFlat, dense_fallback
from ..resources import default_resources
from .sharded import balanced_counts, resolve_devices, run_by_device

__all__ = ["ShardedIndexIVFFlat"]


class ShardedIndexIVFFlat(calls.SearchCalls):
    """IVF-Flat with its rows sharded over ``devices`` (default: the
    devices of ``resources``, else every visible CUDA device; a list may
    repeat a device), one quantizer shared by every shard. The API is
    TorchIndexIVFFlat's search surface. ``resources``: the TorchResources
    whose program cache the searches go through, shared with every shard
    (each device must be one of its devices); by default the process-wide
    one of the first device's type."""

    num_replicas = 1     # one query group (``run_by_device``)

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
        self._owner = programs.new_owner(self)
        self._gen = 0
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
    _nprobe = TorchIndexIVFFlat._nprobe      # its own nprobe and nlist

    def _sel_stream(self, params):
        """The global admit mask as one slot-indexed bool stream per shard
        on its device, or None when nothing is filtered."""

        def place(mask):
            gids = np.nonzero(mask)[0]
            return [calls.bool_stream(
                sh.npool * _CHUNK, sh.device,
                sh._slot_of[self._id_local[gids[self._id_shard[gids] == i]]])
                for i, sh in enumerate(self.shards)]

        return calls.selector_streams(params, self.ntotal, place)

    def _search_packed(self, x: np.ndarray, k: int, params=None,
                       force_plain_dense: bool = False):
        """Enqueue one sharded search through the programs cached for its
        shape and route, one a device (``calls.SearchCalls``): (packed
        result on the first device or None for the empty index, nq, the
        dense certificate's fallback or None, no counters)."""
        if not self.is_trained:
            raise RuntimeError("IndexIVFFlat requires train() before search")
        out_dev = self.devices[0]
        q, nq, nq_pad = calls.prep_queries(x, self.d, self.d_pad, out_dev)
        sel = self._sel_stream(params)
        if self.ntotal == 0:
            return None, nq, None, ()
        if self._shard_gens() != self._gens:
            self._changed()    # a shard changed under the index
        nprobe = self._nprobe(params)
        live = [i for i, sh in enumerate(self.shards) if sh.ntotal]
        for i in live:
            self.shards[i]._check_footprint(nq_pad, nprobe)
        nbudgets = tuple(sh._budget(nprobe) for sh in self.shards)
        jobs = [(i, self.shards[i].device, None if sel is None else sel[i])
                for i in live]
        packed = run_by_device(self, "sharded_ivf", (
            int(k), nprobe, nbudgets, force_plain_dense), jobs, q, out_dev)
        # the dense fused route ships a certificate; the others are exact
        if nprobe < self.nlist or force_plain_dense or not any(
                self.shards[i]._dense_fused_ok() for i in live):
            return packed, nq, None, ()
        return packed, nq, dense_fallback(self, x, nq, k, params), ()

    def _job(self, i: int, q: torch.Tensor, sel, k: int, nprobe: int,
             nbudgets: tuple, force_plain_dense: bool):
        """Shard ``i``'s route on its device: (scores, its labels, −1 past
        the valid ones, the certificate, all True on the exact routes)."""
        v, lab, c, _ = self.shards[i]._search_local(
            q, k, nprobe, nbudgets[i], sel, force_plain_dense)
        lab = lab.to(torch.int32).masked_fill(~(v > float("-inf")), -1)
        if c is None:
            c = torch.ones((q.shape[0],), dtype=torch.bool, device=q.device)
        return v, lab, c

    def _split_rows(self, params) -> Optional[int]:
        """Most query rows per call: the fattest shard's fine scan
        materializes (nq_pad, nbudget·128) f32 scores (the gather budget
        alone: the JAX class's SMEM split is a v5e limit)."""
        nprobe = self._nprobe(params)
        caps = [c for c in (s._nq_cap(nprobe) for s in self.shards)
                if c is not None]
        return min(caps) if caps else None

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
