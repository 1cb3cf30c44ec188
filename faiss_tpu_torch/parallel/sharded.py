"""ShardedIndexFlat: flat exact search over a database sharded across a
list of torch devices, after ``faiss_tpu/parallel/sharded.py``.

One process drives every shard. ``devices`` is a list of torch devices,
which may name one device more than once (["cpu"] * 8 in the tests,
["cuda:0"] * 4 on one card); with ``num_replicas = R`` and ``num_shards =
P`` its first R·P entries form an (R, P) grid, row r the devices of replica
group r:

  * each shard is a TorchIndexFlat on its device, plus an int32 global-id
    column on the same device (ids are int32 on the device and int64 at
    the API, as everywhere in the port);
  * ``add`` splits a batch contiguously over the shards, balanced to ±1
    row with a rotating start for the remainder, and appends on each
    device; contiguous global-id extents per shard back ``reconstruct``
    and the dense renumbering of ``remove_ids``;
  * ``search`` makes one dispatch decision for every shard
    (``index.flat_route``: the cost gate at the largest shard's size,
    hi_exact only where every shard's split statistics are zero, one
    query-plane count), runs each shard's own fused or plain search on its
    device (the port's kernels, K1–K10 as the storage picks them), maps
    the local ids to global ids on the device, gathers the (k, gid) lists
    onto the first device and merges them there by (score desc, gid asc):
    gids do not follow shard order across add batches, so equal scores
    break by global id, as the single index breaks them by position. The
    per-shard certificates are ANDed per query, and the uncertified rows
    re-run through the flat indexes' two-tier fallback
    (``index.make_selective_fallback``);
  * the search runs as one program a distinct device of the grid
    (``run_by_device``, each through ``programs.call``): the program of a
    device runs every shard search that lives there, for every replica
    group; the first device's also takes the other devices' (scores,
    gids) as inputs and merges. On one card named P times the whole search
    is one CUDA graph replayed. A change made on a shard's store alone
    (``DeviceStore.version``) starts a new generation too;
  * with R > 1 the query batch splits across the replica groups; a replica
    on a device other than replica 0's holds a copy of the shard, made at
    the first search after a change (before any capture).

What stays behind from the JAX class: the ``shard_map`` / ``Mesh``
program and ``_assemble``'s capacity equalisation, which only fed
``make_array_from_single_device_arrays``; no ``torch.distributed``.
``range_search`` runs on replica 0's shards over the whole query batch,
each shard's pass through that shard index's own range program.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import calls, programs
from ..calls import NQ_PAD
from ..dtypes import MetricType, StorageType
from ..index import FlatCalls, TorchIndexFlat, flat_route
from ..resources import canonical_device, default_resources

__all__ = ["ShardedIndexFlat", "resolve_devices", "merge_shard_lists",
           "balanced_counts", "run_by_device"]


def resolve_devices(devices, resources=None) -> List[torch.device]:
    """``devices`` as torch devices; None: the devices of ``resources``
    (repeats kept), else every visible CUDA device, and a RuntimeError
    where there is none (pass ["cpu"] * P to run the kernels' plain
    versions). With ``resources``, every device must be one of its devices
    (ValueError)."""
    if devices is None:
        if resources is not None:
            return resources.devices
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "* P to run the plain versions of the kernels")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices is empty")
    if any(d.type == "cuda" for d in out) and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    if resources is not None:
        bad = [str(d) for d in out
               if canonical_device(d) not in resources.devices]
        if bad:
            raise ValueError(f"devices {bad} are not among the resources' "
                             f"devices {resources.devices}")
    return out


def run_by_device(index, kind: str, static: tuple, jobs, q: torch.Tensor,
                  out_dev: torch.device):
    """A sharded search as one program a distinct device (the port's
    graphs are per device: a CUDA graph captures one device's stream).

    ``jobs`` = [(item, device, selector stream on that device or None)],
    the jobs of ``index.num_replicas`` query groups in turn, as many each;
    ``index._job(item, q, sel, *static)`` is one job's (scores, gids,
    certificate) on its device, and ``static[0]`` is k. The program of a
    device other than ``out_dev`` runs its jobs and returns their triples,
    which are copied to ``out_dev``; ``out_dev``'s program runs its own
    jobs, takes those copies as inputs and merges them all
    (``merge_packed``). Each goes through ``programs.call`` under ``kind`` and
    ``static``, the device the key's suffix. The functions read the jobs'
    items and devices (which the index's generation pins), never their
    tensors, so a cached program serves later calls of the same key."""
    items = [item for item, _, _ in jobs]
    njobs = len(jobs)
    with_sel = jobs[0][2] is not None if jobs else False
    ns = len(static)
    groups = {}
    for j, (_, dev, _) in enumerate(jobs):
        groups.setdefault(dev, []).append(j)

    def call(dev, fn, inputs):
        return programs.call(index, kind, fn, static, inputs, device=dev,
                             suffix=(dev,))

    def run_jobs(ix, st, js, q_dev, sels):
        return [ix._job(items[j], q_dev, sels[n] if with_sel else None, *st)
                for n, j in enumerate(js)]

    def sels_of(js, dev):
        if not with_sel:
            return ()
        return tuple(jobs[j][2].to(dev, non_blocking=True) for j in js)

    remote, copies = [], []
    for dev, js in groups.items():
        if dev == out_dev:
            continue

        def local(ix, *args, js=js):
            q_dev, *sels = args[ns:]
            return tuple(t for part in run_jobs(ix, args[:ns], js, q_dev, sels)
                         for t in part)

        outs = call(dev, local, (q.to(dev, non_blocking=True),)
                    + sels_of(js, dev))
        remote += js
        copies += [t.to(out_dev, non_blocking=True) for t in outs]
    own = groups.get(out_dev, [])

    def first(ix, *args):
        st, (q0, *rest) = args[:ns], args[ns:]
        nsel = len(own) if with_sel else 0
        parts = dict(zip(own, run_jobs(ix, st, own, q0, rest[:nsel])))
        got = rest[nsel:]
        for n, j in enumerate(remote):
            parts[j] = tuple(got[3 * n: 3 * n + 3])
        return merge_packed([parts[j] for j in range(njobs)], st[0],
                            ix.metric, out_dev, ix.num_replicas)

    return call(out_dev, first, (q,) + sels_of(own, out_dev) + tuple(copies))


def balanced_counts(n: int, p: int, start: int) -> List[int]:
    """A contiguous split of n rows over p shards, balanced to ±1: the
    remainder goes to the ``rem`` shards from ``start`` on (rotating)."""
    base, rem = divmod(n, p)
    return [base + (1 if (i - start) % p < rem else 0) for i in range(p)]


def merge_shard_lists(parts, k: int, metric: MetricType, device):
    """Merge the per-shard lists ``parts`` = [(scores (nq, k_i) best first,
    global ids (nq, k_i) int32, −1 where invalid)] on ``device``: the k best
    by (score desc, gid asc), as distances and int32 labels, (nq, k),
    sentinels where fewer than k rows exist."""
    av = torch.cat([v.to(device) for v, _ in parts], dim=1)
    ag = torch.cat([g.to(device, torch.int32) for _, g in parts], dim=1)
    av = av.masked_fill(ag < 0, float("-inf"))
    # two stable sorts: by gid, then by score: ties keep the gid order
    o = torch.sort(ag, dim=1, stable=True).indices
    av, ag = torch.gather(av, 1, o), torch.gather(ag, 1, o)
    o = torch.sort(av, dim=1, descending=True, stable=True).indices[:, :k]
    return calls.finalize(torch.gather(av, 1, o), torch.gather(ag, 1, o),
                          np.iinfo(np.int32).max, k, metric)


def merge_packed(parts, k: int, metric: MetricType, device,
                 nrep: int = 1) -> torch.Tensor:
    """The packed result of a sharded search: ``parts`` = every job's
    (scores, gids, certificate), ``nrep`` query groups of as many jobs in
    turn; each group's lists merged on ``device`` (``merge_shard_lists``)
    and its certificates ANDed per query."""
    per = len(parts) // nrep
    dists, labels, certs = [], [], []
    for r in range(nrep):
        mine = parts[r * per: (r + 1) * per]
        cert = torch.ones((mine[0][2].shape[0],), dtype=torch.bool,
                          device=device)
        for _, _, c in mine:
            cert &= c
        d_r, l_r = merge_shard_lists([(v, g) for v, g, _ in mine], k, metric,
                                     device)
        dists.append(d_r)
        labels.append(l_r)
        certs.append(cert)
    return calls.pack(torch.cat(dists), torch.cat(labels), torch.cat(certs))


class _ShardStore:
    """One shard: a TorchIndexFlat on its device and the int32 global ids
    of its rows (host mirror, and a (capacity,) device column, −1 past
    ntotal)."""

    def __init__(self, index: TorchIndexFlat):
        self.index = index
        self.gids_host = np.empty(0, np.int32)
        self.gids: Optional[torch.Tensor] = None

    @property
    def store(self):
        return self.index.store

    @property
    def device(self) -> torch.device:
        return self.index.device

    def set_gids(self, gids_host: np.ndarray) -> None:
        self.gids_host = np.asarray(gids_host, np.int32)
        col = np.full((max(self.store.capacity, 1),), -1, np.int32)
        col[: self.gids_host.size] = self.gids_host
        self.gids = torch.from_numpy(col).to(self.device)

    def to_global(self, vals: torch.Tensor, ids: torch.Tensor):
        """Local ids → global ids on the device; −1 past ntotal and on rows
        that scored −inf (or NaN)."""
        nt = self.store.ntotal
        ids = ids.to(torch.int64)
        valid = (ids >= 0) & (ids < nt) & (vals > float("-inf"))
        g = self.gids[ids.clamp(0, self.gids.shape[0] - 1)]
        return torch.where(valid, g, torch.full_like(g, -1))

    def copy_to(self, device: torch.device) -> "_ShardStore":
        """The same shard on another device: stored bits, norms and
        statistics as they are (``DeviceStore.merge_storage``)."""
        ix = self.index
        twin = TorchIndexFlat(ix.d, metric=ix.metric, storage=ix.storage_type,
                              device=device, tuning=ix.tuning,
                              keep_master=ix.store.keep_master,
                              resources=ix.res)
        if ix.store.scales is not None:
            twin.store.set_scales(ix.store.scales[: ix.d].cpu().numpy())
        twin.store.merge_storage(ix.store)
        out = _ShardStore(twin)
        out.set_gids(self.gids_host)
        return out


class ShardedIndexFlat(FlatCalls):
    """Flat exact index over an (R, P) grid of torch devices: the database
    row-sharded over P shards, replicated R times, the query batch split
    over the R replica groups. The API is TorchIndexFlat's; ``devices``
    defaults to the devices of ``resources`` (a list that may repeat a
    device), else every visible CUDA device. ``resources``: the
    TorchResources whose program cache the searches go through, shared
    with every shard (each device must be one of its devices); by default
    the process-wide one of the first device's type."""

    def __init__(self, d: int, metric=MetricType.L2,
                 storage=StorageType.FLOAT32, num_shards: Optional[int] = None,
                 num_replicas: int = 1, keep_master: bool = True,
                 devices=None, tuning=None, resources=None):
        self.metric = MetricType.coerce(metric)
        self.storage_type = StorageType.coerce(storage)
        devs = resolve_devices(devices, resources)
        self.res = (resources if resources is not None
                    else default_resources(devs[0]))
        r = int(num_replicas)
        p = num_shards or len(devs) // max(r, 1)
        if r < 1 or p < 1 or r * p > len(devs):
            raise ValueError(f"num_replicas={r} × num_shards={p} exceeds "
                             f"{len(devs)} devices")
        self.num_replicas = r
        self.grid = [devs[i * p: (i + 1) * p] for i in range(r)]
        self.devices = self.grid[0]      # replica 0's devices own the shards
        self.d = int(d)
        self.keep_master = bool(keep_master)
        self.shards: List[_ShardStore] = [
            _ShardStore(TorchIndexFlat(d, metric=self.metric,
                                       storage=self.storage_type, device=dev,
                                       tuning=tuning,
                                       keep_master=keep_master,
                                       resources=self.res))
            for dev in self.devices]
        self.ntotal = 0
        self._next_shard = 0   # rotating remainder start of the split
        # (gid_start, gid_end, shard, local_start), sorted by gid_start:
        # every mutation appends contiguous gid runs per shard
        self._extents: List[Tuple[int, int, int, int]] = []
        self._replicas = {}    # (r, i) → a copy on replica r's device
        self._force_plain = False
        self.fused_fallbacks = 0
        self._no_reduced_sweep: set = set()
        self._owner = programs.new_owner(self)
        self._gen = 0
        self._versions = self._store_versions()

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def is_trained(self) -> bool:
        return self.shards[0].store.is_trained

    def set_force_plain(self, force: bool) -> None:
        """Run every shard's plain path (cross-path testing; the
        counterpart of set_force_xla)."""
        self._force_plain = bool(force)
        self._changed()

    def train(self, x: np.ndarray) -> None:
        """int8: one set of per-dimension scales, frozen in every shard
        from the same sample (one quantization grid: results do not depend
        on the shard count)."""
        for s in self.shards:
            s.store.train(x)
        self._changed()

    def _store_versions(self):
        return tuple(s.store.version for s in self.shards)

    def _changed(self) -> None:
        """A new generation: the programs baked the shards' stores, gid
        columns and ntotals, and the replica copies are stale, so both
        go."""
        self._replicas = {}
        self._gen += 1
        self._versions = self._store_versions()
        self.res.discard(programs.owned_by(self._owner))

    def _check_shards(self) -> None:
        """A change made on a shard's store alone (not through this index)
        starts a new generation too."""
        if self._store_versions() != self._versions:
            self._changed()

    # -- mutation -----------------------------------------------------------
    def add(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) array, got {x.shape}")
        n = x.shape[0]
        if n == 0:
            return
        if not self.is_trained:
            self.train(x)   # auto-train on the first batch, as TorchIndexFlat
        if self.ntotal + n > np.iinfo(np.int32).max:
            raise ValueError("total index size would exceed 2^31-1 (int32 "
                             "device ids)")
        p = self.num_shards
        counts = balanced_counts(n, p, self._next_shard)
        self._next_shard = (self._next_shard + n % p) % p
        self._append(lambda s, lo, hi: s.index.add(x[lo:hi]), counts)

    def _append(self, put, counts) -> None:
        """Give shard i the next counts[i] rows (``put(shard, lo, hi)``
        stores rows [lo, hi) of the batch), with global ids from ntotal."""
        off, gid0 = 0, self.ntotal
        for i, c in enumerate(counts):
            if c == 0:
                continue
            s = self.shards[i]
            l0 = s.store.ntotal
            self._extents.append((gid0 + off, gid0 + off + c, i, l0))
            put(s, off, off + c)
            s.set_gids(np.concatenate([
                s.gids_host,
                np.arange(gid0 + off, gid0 + off + c, dtype=np.int32)]))
            off += c
        self.ntotal += off
        self._changed()

    def reset(self) -> None:
        for s in self.shards:
            s.index.reset()
            s.set_gids(np.empty(0, np.int32))
        self.ntotal = 0
        self._next_shard = 0
        self._extents = []
        self._no_reduced_sweep.clear()
        self._changed()

    def remove_ids(self, ids) -> int:
        """Remove global ids with faiss's stable renumbering (survivors keep
        their order, ids shift down); returns the number removed. The
        bookkeeping is host arithmetic over the gid extents: each shard
        compacts its rows in place, and its gid column takes the dense
        renumbering (within one old extent the survivors stay contiguous
        in both numberings, so each maps to one new extent)."""
        ids = np.unique(np.asarray(ids, np.int64).ravel())
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.ntotal:
            raise IndexError(f"remove_ids: ids outside [0, {self.ntotal}): "
                             f"[{ids[0]}, {ids[-1]}]")
        p = self.num_shards
        keep_local = [[] for _ in range(p)]
        new_gids = [[] for _ in range(p)]
        new_extents = []
        off = [0] * p
        for g0, g1, si, l0 in self._extents:
            gs = np.arange(g0, g1, dtype=np.int64)
            gk = gs[~np.isin(gs, ids, assume_unique=True)]
            if gk.size == 0:
                continue
            keep_local[si].append(l0 + (gk - g0))
            ng0 = int(gk[0] - np.searchsorted(ids, gk[0]))
            new_gids[si].append(np.arange(ng0, ng0 + gk.size, dtype=np.int32))
            new_extents.append((ng0, ng0 + int(gk.size), si, off[si]))
            off[si] += int(gk.size)
        for si, s in enumerate(self.shards):
            keep = (np.concatenate(keep_local[si]) if keep_local[si]
                    else np.empty(0, np.int64))
            if keep.size != s.store.ntotal:
                s.store.remove_rows(keep)
            s.set_gids(np.concatenate(new_gids[si]) if new_gids[si]
                       else np.empty(0, np.int32))
        self._extents = new_extents
        self.ntotal -= int(ids.size)
        self._no_reduced_sweep.clear()   # new data, new margins
        self._changed()
        return int(ids.size)

    def reconstruct(self, key: int) -> np.ndarray:
        """The stored row of global id ``key``: a bisect over the gid
        extents, then one row from its shard."""
        if not 0 <= key < self.ntotal:
            raise IndexError(f"key {key} out of range [0, {self.ntotal})")
        pos = bisect.bisect_right(self._extents, (key, self.ntotal + 1)) - 1
        if pos >= 0:
            g0, g1, si, l0 = self._extents[pos]
            if g0 <= key < g1:
                return self.shards[si].store.reconstruct(l0 + (key - g0))
        raise KeyError(f"global id {key} not found")

    # -- search -------------------------------------------------------------
    def _prep_queries(self, x: np.ndarray):
        """(queries padded to NQ_PAD rows a replica group on the first
        device, nq, nq_pad)."""
        return calls.prep_queries(x, self.d, self.shards[0].store.d_pad,
                                  self.devices[0],
                                  unit=NQ_PAD * self.num_replicas)

    def _sel_stream(self, params):
        """``params``' selector over the global ids, as one (capacity,)
        bool stream per shard on its device (a shard's local rows through
        their gids), or None when nothing is filtered."""
        return calls.selector_streams(params, self.ntotal, lambda mask: [
            calls.bool_stream(s.store.capacity, s.device,
                              slice(0, s.gids_host.size), mask[s.gids_host])
            for s in self.shards], flat=True)

    def _shard(self, r: int, i: int) -> _ShardStore:
        """Shard i as replica group r searches it: the shard itself on its
        own device, else its copy on replica r's device."""
        dev = self.grid[r][i]
        if dev == self.devices[i]:
            return self.shards[i]
        if (r, i) not in self._replicas:
            self._replicas[(r, i)] = self.shards[i].copy_to(dev)
        return self._replicas[(r, i)]

    def _run_search_fn(self, q: torch.Tensor, k: int, nq_pad: int, *,
                       force_plain: bool, full_sweep: bool = False,
                       sel=None):
        """Enqueue one sharded search of the padded queries ``q`` (on the
        first device) over the rows the per-shard selector streams ``sel``
        admit, through the programs cached for its shape and route, one a
        device. One route for every shard (``flat_route`` over the live
        shards' stores, at the per-replica nq_pad; never the direct form).
        Returns (packed result on the first device, whether the fused path
        ran, whether it ran the one-plane sweep): the signature
        ``make_selective_fallback`` reruns through."""
        self._check_shards()
        live = [i for i, s in enumerate(self.shards) if s.store.ntotal]
        route = flat_route([self.shards[i].store for i in live], self.metric,
                           k, nq_pad // self.num_replicas,
                           plain=force_plain or self._force_plain,
                           full_sweep=full_sweep,
                           pinned=self._no_reduced_sweep, direct=False)
        # replica copies are made here, before any capture
        jobs = [((r, i), self._shard(r, i).device,
                 None if sel is None else sel[i])
                for r in range(self.num_replicas) for i in live]
        packed = run_by_device(self, "sharded_search", (int(k), *route), jobs,
                               q, self.devices[0])
        return packed, route[0], route[0] and route[1] == 1

    def _job(self, item, q: torch.Tensor, sel, k: int, use_fused: bool,
             passes: int, hi_exact: bool, use_direct: bool):
        """Shard ``i``'s search for replica group ``r`` (``item`` = (r, i))
        on its device: (scores, global ids, certificate)."""
        r, i = item
        nq_local = q.shape[0] // self.num_replicas
        s = self._shard(r, i)
        vals, ids, c = s.index._search_local(
            q[r * nq_local: (r + 1) * nq_local], k, use_fused=use_fused,
            passes=passes, hi_exact=hi_exact, use_direct=use_direct, sel=sel)
        return vals, s.to_global(vals, ids), c

    # -- range search ---------------------------------------------------------
    def _run_range(self, q, nq_pad: int, thr: float, cap: int, sel):
        """Every shard's plain-path chunks (the expanded form, as the JAX
        class's), each through that shard index's own range program, their
        hit ids made global on the host, stacked on the chunk axis: the
        CSR assembly cannot tell shards from chunks."""
        self._check_shards()
        counts, vals, ids, caps = [], [], [], []
        for i, s in enumerate(self.shards):
            if not s.store.ntotal:
                continue
            c, v, li, used = s.index._run_range(
                q.to(s.device), nq_pad, thr, cap,
                None if sel is None else sel[i], use_direct=False)
            counts.append(c)
            vals.append(v)
            ids.append(s.gids_host[np.clip(li, 0, s.gids_host.size - 1)])
            caps.append(used)
        width = max(caps)

        def pad(a, fill):
            return np.pad(a, ((0, 0), (0, 0), (0, width - a.shape[2])),
                          constant_values=fill)

        return (np.concatenate(counts),
                np.concatenate([pad(v, -np.inf) for v in vals]),
                np.concatenate([pad(i, -1) for i in ids]), width)

    def describe(self) -> str:
        per = [s.store.ntotal for s in self.shards]
        nbytes = sum(s.store.nbytes() for s in self.shards)
        return (f"ShardedIndexFlat(d={self.d}, metric={self.metric.value}, "
                f"storage={self.storage_type.value}, ntotal={self.ntotal}, "
                f"shards={self.num_shards}, replicas={self.num_replicas}, "
                f"per_shard={per}, devices={[str(d) for d in self.devices]}, "
                f"bytes={nbytes}, pair_only={self.shards[0].store.pair_only}, "
                f"force_plain={self._force_plain}, "
                f"fused_fallbacks={self.fused_fallbacks})")
