"""``normalised_mixture``'s rows and queries, with the rows already IEEE
float16 values: the data of an index that stores its rows in float16, as
faiss's ``GpuIndexFlatConfig.useFloat16`` does. Parameters: those of
``normalised_mixture``.

Each row is drawn by ``normalised_mixture``, rounded to float16 (round to
nearest even), and every value whose float16 pattern is subnormal
(0 < |x| < 2^-14 after the rounding) is set to a zero of the same sign; the
rows are returned as fp32. The queries are ``normalised_mixture``'s, bit
for bit, and stay fp32, as the index keeps them.

Why the plain reference (``reference.py``, fp64 exact k-NN over these
rows) is then the exact reference of a float16 index: the index converts
each fp32 row to float16 by round to nearest even and flushes the
subnormal patterns to zeros of their sign. A row that is already a normal
float16 value or a signed zero converts to itself and has nothing to
flush, so the index stores these rows exactly, and the fp32 norms it takes
from its input are the norms of what it stores. Its exact top-k over the
stored rows is therefore the exact top-k over these fp32 rows, which is
what the reference computes, with no float16-specific code.
"""

import torch

from benchmark import datagen

BASE = datagen.load_generator("normalised_mixture")
# the least normal float16 magnitude
F16_MIN_NORMAL = 2.0 ** -14


def to_f16_values(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest float16 values (ties to even), subnormal ones
    set to a zero of their sign, back in fp32."""
    h = x.to(torch.float16).to(torch.float32)
    sub = (h != 0) & (h.abs() < F16_MIN_NORMAL)
    return torch.where(sub, torch.copysign(torch.zeros_like(h), h), h)


def prepare(data: dict, seed: int, device, g: torch.Generator):
    """``normalised_mixture``'s centres."""
    return BASE.prepare(data, seed, device, g)


def draw(data: dict, state, what: str, n: int,
         g: torch.Generator) -> torch.Tensor:
    """``n`` rows or queries (``what``), (n, d) fp32: the rows float16
    values, the queries as drawn."""
    x = BASE.draw(data, state, what, n, g)
    return to_f16_values(x) if what == "rows" else x
