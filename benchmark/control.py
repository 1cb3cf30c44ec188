"""The control of ``correct``: the plain reference put in the program's
place, computed in the precision below the configuration's (TF32 inputs
for float32 with TF32 off; bf16 inputs as a second reading), answering the
calls that a run of the cell answers, judged as a run's answers are.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 [--precision tf32,bf16] [--calls N]

at the cell's own size on a CUDA card (or ``--device cpu``). Prints one
JSON line a seed and precision: the numbers compared, each beside its
limit, and whether the control came out not correct (it has to). The
benchmark's own runs do not run this; ``tests/test_bench_reference.py``
keeps it at a small size. ``--calls``: how many calls to answer, by
default one pass over the query pool (filtered: 2,000 calls, more than a
run of that cell answers).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="tf32,bf16")
    ap.add_argument("--calls", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import datagen, harness, reference

    spec = harness.cell_spec(args.workload)
    cfg, tr = spec["config"], spec["traffic"]
    data, k, nq = cfg["data"], tr["k"], tr["nq"]
    l2 = cfg["index"]["metric"].upper() == "L2"
    device = torch.device(args.device)
    calls = args.calls or (2000 if tr.get("selector")
                           else -(-data["queries"] // nq))
    for seed in (int(s) for s in args.seeds.split(",")):
        src = datagen.Source(data, seed, device)
        pool = src.queries()
        sets = (datagen.selector_sets(data["rows"], tr["selector"], seed,
                                      device) if tr.get("selector") else [])
        admits = reference.admit_masks(sets, data["rows"], device)
        i = np.arange(calls)
        pool_idx = np.concatenate(
            [harness.call_queries(c, nq, len(pool)) for c in i])
        set_idx = np.repeat(i % len(sets) if sets else np.full(calls, -1), nq)
        for prec in args.precision.split(","):
            t0 = time.perf_counter()
            d, ids = reference.control_answers(
                pool, pool_idx, set_idx, src.chunks, k, l2, data["rows"],
                admits, prec)
            # judged as a run's answers are: the harness's own comparison
            nums = harness.judge(pool_idx, set_idx, d, ids, pool, src, sets,
                                 cfg, tr)
            checks, correct = harness.verdict(nums, 0, cfg["limits"])
            print(json.dumps({
                "workload": args.workload, "seed": seed, "precision": prec,
                "answers": nums["answers"], "checks": checks,
                "not_correct": not correct,
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
