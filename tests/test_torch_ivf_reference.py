"""TorchIndexIVFFlat against the benchmark's plain IVF reference
(``benchmark/reference_ivf.py``), through the IVF cell's own judge
(``benchmark/indexes/TorchIndexIVFFlat.py``), on the CPU.

Seeded rows of the IVF cell's generator, 20,000 × 96 normalised, nlist
64, nprobe 8, L2 and inner product, k 10 and 100: the port's answers come
out correct, and the faults a program could have come out not correct: a
probed list dropped (in the port's probe, or by the control), one list
fewer probed, an answer's id swapped, the scan rounded to bf16 or to
TF32, and centroids that are not a k-means solution (plain Lloyd's with
one round, or training rows). A row equidistant from two centroids is
admissible in both lists, and the ε bands stay under 1 % of the rows and
5 % of the queries.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import datagen, harness, reference, reference_ivf  # noqa: E402
from faiss_tpu_torch.ops import distance as dist_ops  # noqa: E402

torch.set_num_threads(4)

SEED = 2 ** 31 + 20
NLIST, NPROBE = 64, 8
DATA = dict(generator="spectral_mixture", rows=20_000, d=96, queries=200,
            chunk_rows=8192, centres=1, centre_scale=0.0, noise_scale=1.0,
            decay=1.0, normalise=True)
CPU = torch.device("cpu")
# the training check's limit at this size (128 rows a list): plain Lloyd's
# from other starts reads −0.006 to −0.001 (L2) and −0.001 to 0.0003 (IP),
# one round 0.052 and 0.0107
KMEANS_EXCESS = {"L2": 0.02, "IP": 0.004}


def _config(metric):
    return dict(name=f"test-ivf-{metric}", data=dict(DATA),
                index=dict(type="TorchIndexIVFFlat", metric=metric,
                           storage="f32", nlist=NLIST, nprobe=NPROBE,
                           train_niter=10),
                limits=dict(dist_err=1e-5, rank_gap=1e-5,
                            kmeans_excess=KMEANS_EXCESS[metric]))


class Built:
    """The cell's index type built on the CPU from the seeded rows, as the
    harness builds it (trained on its first add)."""

    def __init__(self, metric):
        self.cfg = _config(metric)
        self.ixt = harness.index_type(self.cfg)
        self.src = datagen.Source(self.cfg["data"], SEED, CPU)
        self.index = self.ixt.build(self.cfg, [CPU])
        for _, rows in self.src.chunks():
            self.index.add(rows.numpy())
        self.pool = self.src.queries()
        self.pool_idx = np.arange(len(self.pool))

    def search(self, k):
        return self.index.index.search(self.pool.numpy(), k)

    def judge(self, d, i, k):
        nums = self.ixt.judge(self.pool_idx, np.full(len(self.pool_idx), -1),
                              d, i, self.pool, self.src, [], self.cfg,
                              {"k": k})
        checks, correct = harness.verdict(nums, 0, self.cfg["limits"])
        return nums, checks, correct

    def control(self, k, nprobe, precision, skip=0, rounds=None):
        """A control's answers, from the index's centroids, or with
        ``rounds`` from plain Lloyd's, which it then puts in their place
        (``undo`` restores them)."""
        l2 = self.cfg["index"]["metric"] == "L2"
        cents = self.cfg["trained_centroids"]
        if rounds is not None:
            self.own = cents
            cents = reference_ivf.lloyd(self.src.chunk(0)[1], NLIST, rounds,
                                        l2, seed=1)
            self.cfg["trained_centroids"] = cents
        return reference_ivf.control_answers(
            self.pool, self.pool_idx, self.src.chunks(), cents, nprobe, k,
            l2, precision, skip)

    def undo(self):
        if getattr(self, "own", None) is not None:
            self.cfg["trained_centroids"], self.own = self.own, None


@pytest.fixture(scope="module", params=["L2", "IP"])
def built(request):
    return Built(request.param)


@pytest.mark.parametrize("k", [10, 100])
def test_the_port_is_correct(built, k):
    d, i = built.search(k)
    nums, checks, correct = built.judge(d, i, k)
    assert correct, checks
    assert nums["answers"] == len(built.pool) and nums["bad_ids"] == 0


def test_the_centroids_are_the_index_own(built):
    ix = built.index.index
    np.testing.assert_array_equal(built.cfg["trained_centroids"],
                                  ix._centroids)
    assert ix.ntotal == DATA["rows"]


@pytest.mark.parametrize("k", [10, 100])
def test_the_reference_in_the_program_place_is_correct(built, k):
    """The control at the cell's nprobe in fp64 answers as the program
    must; it also equals the port's ids wherever no two costs tie."""
    d, i = built.control(k, NPROBE, "fp64")
    _, checks, correct = built.judge(d, i, k)
    assert correct, checks
    _, i_port = built.search(k)
    assert (i == i_port).mean() > 0.99


@pytest.mark.parametrize("fault", ["dropped_list", "swapped_id", "bf16_scan",
                                   "tf32_scan", "nearest_dropped",
                                   f"nprobe{NPROBE - 1}", "lloyd1", "lloyd0"])
@pytest.mark.parametrize("k", [10, 100])
def test_planted_faults_are_not_correct(built, fault, k, monkeypatch):
    if fault == "dropped_list":
        # the program's probe drops each query's nearest list and takes the
        # (nprobe+1)-th in its place
        from faiss_tpu_torch.ivf import TorchIndexIVFFlat, topk_scores

        def probe(self, q, nprobe):
            cs = dist_ops.matmul_scores(q, self._cents, self._cnorms,
                                        self.metric)
            return topk_scores(cs, nprobe + 1)[1][:, 1:]

        monkeypatch.setattr(TorchIndexIVFFlat, "_probe", probe)
        d, i = built.search(k)
    elif fault == "swapped_id":         # one answer's id another row's
        d, i = built.search(k)
        i = i.copy()
        i[7, 3] = (i[7, 3] + 1) % DATA["rows"]
    else:
        p, prec, skip, rounds = reference_ivf.control_spec(
            fault.split("_")[0] if "scan" in fault else fault, NPROBE)
        d, i = built.control(k, p, prec, skip, rounds)
    try:
        nums, checks, correct = built.judge(d, i, k)
    finally:
        built.undo()
    assert not correct, checks
    if fault.startswith("lloyd"):       # exact for its centroids: the
        # training check alone fails, and counts every id
        assert nums["kmeans_excess"] > built.cfg["limits"]["kmeans_excess"]
        assert nums["bad_ids"] == len(built.pool) * k
        assert nums["rank_gap"] <= 1e-5 and nums["dist_err"] <= 1e-5


def test_the_port_trains_as_plain_kmeans(built):
    """The port's k-means objective lies within the limit of plain Lloyd's
    with as many rounds, whose own spread over starts is far smaller than
    the limit; one round, or rows as centroids, lie far above it."""
    rows = built.src.chunk(0)[1]
    l2 = built.cfg["index"]["metric"] == "L2"
    limit = built.cfg["limits"]["kmeans_excess"]
    ex = reference_ivf.kmeans_excess(rows, built.cfg["trained_centroids"],
                                     10, l2)[0]
    assert ex <= limit / 2
    for seed in (1, 2):
        other = reference_ivf.lloyd(rows, NLIST, 10, l2, seed=seed)
        assert abs(reference_ivf.kmeans_excess(rows, other, 10, l2)[0]) \
            <= limit / 2
    for rounds in (1, 0):
        bad = reference_ivf.lloyd(rows, NLIST, rounds, l2, seed=1)
        assert reference_ivf.kmeans_excess(rows, bad, 10, l2)[0] > limit


def test_the_judge_is_the_same_in_small_blocks(built, monkeypatch):
    """Blocks of 16 queries and of 2,048 rows against the 64 centroids
    (the cell's blocks hold thousands): the same numbers."""
    d, i = built.search(10)
    whole, _, _ = built.judge(d, i, 10)
    monkeypatch.setattr(reference_ivf, "BLOCK_ELEMS", 16 * 8192)
    small, _, _ = built.judge(d, i, 10)
    assert small == whole


def test_the_eps_bands_stay_small(built):
    d, i = built.search(10)
    nums, _, _ = built.judge(d, i, 10)
    assert nums["band_rows"] < 0.01 * DATA["rows"]
    assert nums["band_queries"] < 0.05 * DATA["queries"]


def _unit(j, d=DATA["d"]):
    v = np.zeros(d, np.float32)
    v[j] = 1.0
    return v


def test_an_equidistant_row_is_admissible_in_both_lists():
    """Row 0 lies exactly halfway between centroids 0 and 1: its lowest
    cost is list 0's (the lower id), and list 1 is in its ε band. A query
    that probes list 1 alone may return it; a row of list 0 alone it may
    not."""
    s = np.float32(np.sqrt(0.5))
    cents = np.stack([_unit(0), _unit(1), _unit(2)])
    rows = np.stack([s * (_unit(0) + _unit(1)),            # equidistant
                     0.9 * _unit(0) + 0.1 * _unit(3),      # list 0 only
                     0.9 * _unit(1) + 0.1 * _unit(4),      # list 1 only
                     0.9 * _unit(2) + 0.1 * _unit(5)])     # list 2 only
    rows_t = torch.from_numpy(rows)
    c = reference_ivf.Centroids(cents, True, CPU)
    a, br, bl = reference_ivf.assign(rows_t, c)
    assert a.tolist() == [0, 0, 1, 2]
    assert list(zip(br.tolist(), bl.tolist())) == [(0, 1)]
    pool = torch.from_numpy(np.stack([0.95 * _unit(1) + 0.05 * _unit(6)]))

    def judge(ids):
        ids = np.asarray([ids], np.int64)
        q64 = pool.double()[0]
        r64 = rows_t.double()[ids[0]]
        d = ((q64 - r64) ** 2).sum(1).numpy()[None].astype(np.float32)
        ans = reference.Answers.unique(np.zeros(1, np.int64),
                                       np.full(1, -1), d, ids)
        return reference_ivf.judge(ans, pool, lambda: [(0, rows_t)], cents,
                                   1, 2, True, len(rows))

    ok = judge([2, 0])
    assert ok["bad_ids"] == 0 and ok["rank_gap"] <= 0 and ok["band_rows"] == 1
    assert judge([2, 1])["bad_ids"] == 1
