"""``faiss_tpu_torch.TorchIndexIVFFlat``: IVF-Flat (faiss ``IndexIVFFlat``)
on one device, with the configuration's ``index.metric``, ``storage``,
``nlist`` and ``nprobe``. The harness hands ``build`` no rows, so the
index it returns trains on its first ``add`` (the first chunk of rows,
through the index's public ``train``) and every ``add`` then goes to the
index's ``add``; ``search_async`` is the index's own.

Its answers are the exact top-k within the probed lists, not over every
row, so it judges them itself (``judge``, over ``reference_ivf.py``), from
the centroids the index trained: the index puts them into the
configuration (``CENTROIDS``), which ``judge`` receives as the same
object. Those centroids are held to plain k-means besides: their k-means
objective on the training rows (the first chunk) may lie at most
``limits.kmeans_excess`` above that of plain fp64 Lloyd's k-means over
the same rows with the same rounds (``reference_ivf.kmeans_excess``).
Where they lie further, the lists every answer was drawn from are not
k-means lists, and every id of every answer counts in ``bad_ids``."""

import sys
import time

import numpy as np

from benchmark import reference, reference_ivf

CENTROIDS = "trained_centroids"     # the configuration's key, set at train


class TrainOnFirstAdd:
    """The index, trained on the rows of its first ``add``."""

    def __init__(self, index, config: dict):
        self.index, self.config = index, config

    def add(self, x) -> None:
        ix = self.index
        if not ix.is_trained:
            t0 = time.perf_counter()
            ix.train(x)
            self.config[CENTROIDS] = ix.quantizer.reconstruct_n(0, ix.nlist)
            st = ix.train_stats
            print(f"train on {len(x)} rows: {time.perf_counter() - t0:.3f} s"
                  f" (k-means {st.get('kmeans_s', 0.0):.3f} s, balancing "
                  f"{st.get('balance_s', 0.0):.3f} s, list cap "
                  f"{st.get('cap')})", file=sys.stderr)
        t0 = time.perf_counter()
        ix.add(x)
        print(f"add of {len(x)} rows: {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)

    def search_async(self, x, k, params=None):
        return self.index.search_async(x, k, params=params)


def build(config: dict, devices):
    """The untrained index on the one device of the cell, which trains on
    its first ``add``."""
    import faiss_tpu_torch as ft

    if len(devices) != 1:
        raise SystemExit(f"TorchIndexIVFFlat runs on one device; the cell "
                         f"asks for {len(devices)}")
    ix = config["index"]
    if not {"nlist", "nprobe", "train_niter"} <= set(ix):
        raise SystemExit(f"TorchIndexIVFFlat needs index.nlist, nprobe and "
                         f"train_niter in configuration {config['name']!r}")
    return TrainOnFirstAdd(ft.TorchIndexIVFFlat(
        config["data"]["d"], ix["nlist"], metric=ix["metric"],
        storage=ix["storage"], nprobe=ix["nprobe"],
        train_niter=ix["train_niter"], device=devices[0]), config)


def search_params(sets):
    """One SearchParams a selector set (sorted ids) to admit."""
    import faiss_tpu_torch as ft

    return [ft.SearchParams(sel=ft.IDSelectorBatch(s)) for s in sets]


def fallbacks(index) -> int:
    """Dense-route certificate reruns (none below nlist: the fine scan is
    exact within its lists)."""
    return index.index.fused_fallbacks


def judge(pool_idx, set_idx, dists, ids, pool_t, src, sets, config: dict,
          traffic: dict) -> dict:
    """The comparison's numbers (``reference_ivf.judge``) for answer rows,
    from the centroids the index trained, and the training check (module
    docstring); the ε bands' sizes, the recall and the check printed."""
    if sets:
        raise SystemExit("TorchIndexIVFFlat's judge takes no selector")
    if CENTROIDS not in config:
        raise SystemExit("the index never trained: no centroids to judge by")
    ix, l2 = config["index"], config["index"]["metric"].upper() == "L2"
    ans = reference.Answers.unique(pool_idx, set_idx, dists, ids)
    nums = reference_ivf.judge(
        ans, pool_t, src.chunks, config[CENTROIDS], ix["nprobe"],
        traffic["k"], l2, config["data"]["rows"])
    print(f"ivf judge: {nums['band_rows']} rows within the ε band of a "
          f"second list, {nums['band_queries']} of {len(np.unique(pool_idx))}"
          f" queries with a list within the ε band of the nprobe-th; "
          f"recall@{traffic['k']} {nums['recall']:.6f}", file=sys.stderr)
    excess, got, ref = reference_ivf.kmeans_excess(
        src.chunk(0)[1], config[CENTROIDS], ix["train_niter"], l2)
    limit = config["limits"]["kmeans_excess"]
    nums["kmeans_excess"] = excess
    print(f"ivf judge: k-means objective {got!r} against plain Lloyd's "
          f"{ref!r}: excess {excess!r} (limit {limit})", file=sys.stderr)
    if not excess <= limit:
        nums["bad_ids"] += int((ans.count[:, None] * (ans.ids >= 0)).sum())
    return nums
