"""The float16 cell, ``deep10m-ip-f16.batch``: found by name, its sweep
route read through the roofline, a run at a tiny size on the CPU that
comes out correct through ``run.main``, as ``benchmark/run.py`` runs it,
and the reference's lower-precision controls, which do not."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import datagen, harness, roofline

CELL = "deep10m-ip-f16.batch"
F16_METRICS = {"sweep_roofline.f16", "fallback_share.f16", "idle_share.f16",
               "enqueue_ms.f16", "upload_ms.f16", "replay_ms.f16",
               "copy_wait_ms.f16", "rerun_share.f16"}


def test_bench_f16_cell_found_by_name():
    spec = harness.cell_spec(CELL)
    cell, cfg = spec["cell"], spec["config"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "deep10m-ip-f16", "batch", 1)
    assert cfg["index"] == {"type": "TorchIndexFlat", "metric": "IP",
                            "storage": "f16"}
    assert cfg["data"]["generator"] == "f16_mixture"
    # the rows of deep10m-ip, made by another generator
    base = harness.cell_spec("deep10m-ip.batch")["config"]["data"]
    assert {k: v for k, v in cfg["data"].items() if k != "generator"} == {
        k: v for k, v in base.items() if k != "generator"}
    assert cfg["limits"] == {"dist_err": 1e-5, "rank_gap": 1e-5}
    assert {m["name"] for m in spec["end_to_end"]} == {"qps.10m", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == F16_METRICS
    for m in spec["per_layer"]:
        assert m["moves"] == "qps.10m" and m["workloads"] == [CELL]
        assert callable(harness.reader(m["name"]))


def test_bench_f16_sweep_reads_through_the_roofline():
    cfg = harness.cell_spec(CELL)["config"]
    route = cfg["sweep"]
    assert route["kernels"] and all(k.startswith("sweep_split_mma_kernel<2, ")
                                    for k in route["kernels"])
    shapes = roofline.search_shapes(100, cfg["data"]["rows"],
                                    cfg["data"]["d"], 10)
    assert shapes["hier"] and shapes["ngroups"] == 78_048
    t, by = roofline.sweep_bound_s(
        shapes, q_planes=route["q_planes"], db_planes=route["db_planes"],
        terms=route["terms"], kind=route["kind"])
    # the stored float16 rows are one 2-byte plane: half of deep10m-ip's
    nbytes = roofline.sweep_bytes(shapes, q_planes=route["q_planes"],
                                  db_planes=route["db_planes"])
    assert route["db_planes"] == 1
    assert nbytes == (route["q_planes"] * 104 * 96 * 2 + 9_990_144 * 96 * 2
                      + 9_990_144 * 4 + 104 * 78_048 * 4 + 104 * 9756 * 4)
    ops = 2.0 * route["terms"] * 104 * 9_990_144 * 96
    assert t == max(nbytes / roofline.HBM_BPS, ops / roofline.PEAK["bf16"])
    assert by in ("bytes", "operations") and 0.5e-3 < t < 0.7e-3


def test_bench_f16_generator_rows_are_what_the_index_stores():
    data = dict(harness.cell_spec(CELL)["config"]["data"], rows=3000,
                queries=40, chunk_rows=1024, centres=16)
    src = datagen.Source(data, 2 ** 31 + 24, "cpu")
    rows = torch.cat([r for _, r in src.chunks()])
    assert torch.equal(rows.to(torch.float16).to(torch.float32), rows)
    base = datagen.Source(dict(data, generator="normalised_mixture"),
                          2 ** 31 + 24, "cpu")
    assert torch.equal(src.queries(), base.queries())


RUN = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run
spec = json.load(open({spec!r}))
sys.exit(run.main(["--workload", {cell!r}, "--seed", str(2 ** 31 + 2024),
                   "--seconds", "0.5", "--trace", "0"],
                  device="cpu", spec=spec))
"""


def test_bench_f16_tiny_run_is_correct(tiny_spec, tmp_path):
    """``run.main`` at a tiny size on the CPU, in a process of its own (its
    last step refuses a process that has loaded JAX, as a test process
    beside the JAX package's tests may have)."""
    spec = tiny_spec(CELL)
    # on the CPU a call runs inside search_async: two in flight keep the
    # run short
    spec["traffic"]["depth"] = 2
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    code = RUN.format(root=str(harness.ROOT), cell=CELL,
                      spec=str(tmp_path / "spec.json"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"qps.10m", "setup_s"}
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("precision", ["tf32", "bf16"])
def test_bench_f16_controls_are_not_correct(tiny_spec, precision):
    """The reference computed in TF32 (exact on float16 rows, but not on
    the fp32 queries) or in bf16 fails the cell's limits."""
    from benchmark import reference

    spec = tiny_spec(CELL)
    cfg, tr = spec["config"], spec["traffic"]
    src = datagen.Source(cfg["data"], 2 ** 31 + 7, "cpu")
    pool = src.queries()
    idx = np.arange(len(pool))
    sets = np.full(len(pool), -1)
    d, i = reference.control_answers(pool, idx, sets, src.chunks, tr["k"],
                                     False, cfg["data"]["rows"], [],
                                     precision)
    nums = harness.judge(idx, sets, d, i, pool, src, [], cfg, tr)
    _, correct = harness.verdict(nums, 0, cfg["limits"])
    assert not correct, nums
