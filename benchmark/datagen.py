"""The data of a configuration, made from ``--seed`` on the device.

A configuration's ``data`` names its generator, ``generators/<name>.py``,
which makes rows and queries (``prepare(data, seed, device, generator)``
once, then ``draw(data, state, what, n, generator)`` for each block of
``n`` rows or queries). This module seeds and chunks: rows come in chunks
of ``chunk_rows``; each chunk, the generator's state, the query pool and
each selector set has a torch generator of its own, seeded from (seed,
what, index), so a chunk is made again bit for bit without the others, and
every seed gives the same sizes. Imports numpy and torch only.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

GENERATORS = Path(__file__).resolve().parent / "generators"
_WHAT = {"centres": 1, "rows": 2, "queries": 3, "selector": 4}


def generator(seed: int, what: str, index: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one (seed, what, index)."""
    state = np.random.SeedSequence(
        [int(seed) % (1 << 64), _WHAT[what], int(index)]).generate_state(
            2, np.uint32)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed((int(state[0]) << 32 | int(state[1])) & ((1 << 63) - 1))
    return g


def load_generator(name: str):
    """The module ``generators/<name>.py``; an unknown name raises."""
    path = GENERATORS / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no data generator {name!r} in {GENERATORS}")
    spec = importlib.util.spec_from_file_location(
        "benchmark_generator_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Source:
    """The rows and the query pool of one configuration and seed, made on
    ``device`` by the configuration's generator."""

    def __init__(self, data: dict, seed: int, device):
        self.data, self.seed = data, seed
        self.device = torch.device(device)
        self.gen = load_generator(data["generator"])
        self.state = self.gen.prepare(
            data, seed, self.device, generator(seed, "centres", 0,
                                               self.device))

    @property
    def n_chunks(self) -> int:
        return -(-self.data["rows"] // self.data["chunk_rows"])

    def chunk(self, c: int):
        """(first row id, (n, d) fp32 rows) of chunk ``c``."""
        start = c * self.data["chunk_rows"]
        n = min(self.data["chunk_rows"], self.data["rows"] - start)
        return start, self.gen.draw(self.data, self.state, "rows", n,
                                    generator(self.seed, "rows", c,
                                              self.device))

    def chunks(self):
        """Every chunk in id order, each made when it is reached."""
        return (self.chunk(c) for c in range(self.n_chunks))

    def queries(self) -> torch.Tensor:
        """The (queries, d) fp32 query pool."""
        return self.gen.draw(self.data, self.state, "queries",
                             self.data["queries"],
                             generator(self.seed, "queries", 0, self.device))


def selector_sets(n_rows: int, selector: dict, seed: int, device):
    """``selector["sets"]`` sorted int64 id sets of
    ``round(selector["share"] · n_rows)`` distinct row ids each, as numpy."""
    m = int(round(selector["share"] * n_rows))
    return [np.sort(torch.randperm(
        n_rows, generator=generator(seed, "selector", s, device),
        device=device)[:m].cpu().numpy()).astype(np.int64)
        for s in range(selector["sets"])]
