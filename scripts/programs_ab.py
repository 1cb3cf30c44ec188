"""Host ms/batch of the 1M×128 flat and sharded searches, for comparing two
checkouts of faiss_tpu_torch on one card.

    PYTHONPATH=<checkout> python scripts/programs_ab.py <tag>

Imports the faiss_tpu_torch found first on ``PYTHONPATH``, so running it for
an older checkout unpacked beside this one (``git archive <commit>``) and
for this one, in turns (old, new, new, old) within one call, compares the
two on the same card. For f32 and int8 storage (L2, nq=100, k=10, data from
numpy.random.default_rng(42)): ``ShardedIndexFlat`` over ``["cuda:0"] * 4``,
then a ``TorchIndexFlat`` over the same rows, then the sharded index once
more; each the mean host-clock ms of 20 blocking ``search`` calls after 2
warm-ups. Prints one line: the tag and the times. Needs a CUDA card.
"""

import sys
import time

import numpy as np
import torch

import faiss_tpu_torch as ft
from faiss_tpu_torch.parallel import ShardedIndexFlat


def timed(idx, xq, n=20):
    for _ in range(2):
        idx.search(xq, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        idx.search(xq, 10)
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("programs_ab: CUDA is not available", file=sys.stderr)
        return 1
    tag = sys.argv[1] if len(sys.argv) > 1 else "run"
    rng = np.random.default_rng(42)
    xb = rng.standard_normal((1_000_000, 128), dtype=np.float32)
    xq = rng.standard_normal((100, 128), dtype=np.float32)
    out = {}
    for storage in ("f32", "int8"):
        sh = ShardedIndexFlat(128, storage=storage, devices=["cuda:0"] * 4)
        sh.add(xb)
        out[storage] = timed(sh, xq)
        flat = ft.TorchIndexFlat(128, storage=storage, device="cuda")
        flat.add(xb)
        out[storage + "_flat"] = timed(flat, xq)
        out[storage + "_after_flat"] = timed(sh, xq)
        del sh, flat
        torch.cuda.empty_cache()
    print(tag, {k: round(v, 4) for k, v in out.items()}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
