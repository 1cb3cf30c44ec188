"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They import the harness as the package ``benchmark`` from the root of the
checkout, and run cells on the CPU at a tiny size (``tiny_spec``)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny_spec():
    """The cell_spec of a cell at a size the CPU runs in a second: its
    configuration's data cut to ``rows`` rows and a pool of ``queries``,
    in chunks of 8192 rows. ``<config>.<mix>`` names a BENCHMARK.json cell,
    or the mix of traffic/<mix>.json under that configuration."""
    from benchmark import harness

    def make(name, rows=20000, queries=200):
        config, _, mix = name.partition(".")
        try:
            spec = copy.deepcopy(harness.cell_spec(name))
        except SystemExit:
            # a mix kept for a later cell (traffic/<mix>.json): the
            # configuration's one-query cell with that traffic
            spec = copy.deepcopy(harness.cell_spec(config + ".single"))
            spec["traffic"] = harness.read_json(
                harness.BENCH_DIR / "traffic" / f"{mix}.json")
            spec["cell"] = dict(spec["cell"], name=name, traffic=mix)
        spec["config"]["data"].update(rows=rows, queries=queries,
                                      chunk_rows=8192, centres=64)
        return spec

    return make
