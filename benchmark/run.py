"""Run one cell of the benchmark of faiss_tpu_torch once.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (it exits 2, and prints no result, without them; it exits 3,
and prints no result, where the process has loaded jax, jaxlib, flax or
faiss_tpu by the end of the run). The last line
of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), device, with ``--trace 1`` breakdown, and last checks:
each number compared with the reference beside its limit, which are also
the last lines of standard error. Caches (Triton, torch extensions, the
CUDA JIT) go to ``.bench_cache/`` in the checkout; the kernels' build
cache is the program's own, ``faiss_tpu_torch/_build/``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = (("TRITON_CACHE_DIR", "triton"),
          ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("CUDA_CACHE_PATH", "nv"))


def finite(x):
    """A JSON-safe number: a non-finite reading is written as 1e300."""
    return x if isinstance(x, int) or math.isfinite(x) else 1e300


def main(argv=None, *, device="cuda", spec=None) -> int:
    """Parse the arguments, run the cell and emit its result. ``device``
    and ``spec`` (tests): a run on another device than the cards, which
    skips the look for them, of a cell_spec given in place of
    BENCHMARK.json's."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES:
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    import faiss_tpu_torch  # noqa: F401  (a checkout without the program fails here)
    from benchmark import harness

    spec = spec if spec is not None else harness.cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device=device,
                           t_process=T_PROCESS, spec=spec)
    for c in out["checks"].values():
        c["value"] = finite(c["value"])
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    # the run's last step, after the metrics' readers have loaded: a
    # process that holds JAX or faiss_tpu prints no result
    found = harness.forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: the benchmark runs "
              "without JAX and without faiss_tpu; no result", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
