"""Nothing the benchmark runs loads jax or faiss_tpu (whole top-level
names: faiss_tpu_torch begins with faiss_tpu), and the reference loads
nothing of faiss_tpu_torch."""

import subprocess
import sys

from benchmark import harness

ALL = """
import sys
sys.path.insert(0, {root!r})
import benchmark.run, benchmark.harness, benchmark.reference
import benchmark.datagen, benchmark.devtrace, benchmark.roofline
import faiss_tpu_torch
from benchmark import harness
for p in (harness.BENCH_DIR / "metrics").glob("*.py"):
    harness.reader(p.stem)
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c",
                          code.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_bench_modules_load_no_jax():
    names = _top_level(ALL)
    assert "faiss_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "faiss_tpu"}


def test_bench_reference_loads_nothing_of_the_program():
    names = _top_level("""
import sys
sys.path.insert(0, {root!r})
import benchmark.reference, benchmark.datagen
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert not names & {"faiss_tpu_torch", "faiss_tpu", "jax"}
