"""The controls of ``correct`` for an IVF cell: the plain IVF reference
(``reference_ivf.control_answers``) put in the program's place, with the
scan's inputs in TF32 (the precision below the configuration's float32
with TF32 off) and with one probed list dropped, answering one pass over
the query pool, judged as a run's answers are (the index type's ``judge``).

    python benchmark/control_ivf.py --workload <cell> --seeds 1,2,3 [--controls tf32,nprobe49,lloyd1,lloyd0,fp64]

at the cell's own size on a CUDA card (or ``--device cpu``). The centroids
are the index's own: each seed trains the configuration's index on the
first chunk of rows, as a run does; the training controls put plain
Lloyd's k-means with fewer rounds in its place (``lloyd1``), or training
rows taken as centroids (``lloyd0``). Prints one JSON
line a seed and control: the numbers compared, each beside its limit, the
training check's excess and the recall, and whether the control came out
not correct (``tf32``, ``bf16``, ``nearest_dropped``, ``nprobe49`` at the
cell's nprobe 50, ``lloyd1`` and ``lloyd0`` have to; ``fp64``,
the reference at the configuration's nprobe, has not:
``reference_ivf.control_spec``).
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
    ap.add_argument("--controls",
                    default="tf32,nprobe49,lloyd1,lloyd0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import datagen, harness, reference_ivf

    spec = harness.cell_spec(args.workload)
    cfg, tr = spec["config"], spec["traffic"]
    data, k, nq = cfg["data"], tr["k"], tr["nq"]
    nprobe = cfg["index"]["nprobe"]
    l2 = cfg["index"]["metric"].upper() == "L2"
    ixt = harness.index_type(cfg)
    device = torch.device(args.device)
    calls = -(-data["queries"] // nq)
    pool_idx = np.concatenate([harness.call_queries(c, nq, data["queries"])
                               for c in range(calls)])
    set_idx = np.full(len(pool_idx), -1)
    for seed in (int(s) for s in args.seeds.split(",")):
        src = datagen.Source(data, seed, device)
        pool = src.queries()
        t0 = time.perf_counter()
        index = ixt.build(cfg, [device])
        index.add(src.chunk(0)[1].cpu().numpy())    # trains, then adds
        del index
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_train = time.perf_counter() - t0
        own = cfg[ixt.CENTROIDS]
        for name in args.controls.split(","):
            p, prec, skip, rounds = reference_ivf.control_spec(name, nprobe)
            t0 = time.perf_counter()
            cents = (own if rounds is None else reference_ivf.lloyd(
                src.chunk(0)[1], len(own), rounds, l2, seed=1))
            ccfg = dict(cfg, **{ixt.CENTROIDS: cents})
            d, ids = reference_ivf.control_answers(
                pool, pool_idx, src.chunks(), cents, p, k, l2, prec, skip)
            nums = ixt.judge(pool_idx, set_idx, d, ids, pool, src, [], ccfg,
                             tr)
            checks, correct = harness.verdict(nums, 0, cfg["limits"])
            print(json.dumps({
                "workload": args.workload, "seed": seed, "control": name,
                "nprobe": p, "precision": prec, "skip": skip,
                "train_rounds": rounds, "answers": nums["answers"],
                "band_rows": nums["band_rows"],
                "band_queries": nums["band_queries"],
                "recall": nums["recall"],
                "kmeans_excess": nums["kmeans_excess"], "checks": checks,
                "not_correct": not correct, "train_s": t_train,
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
