"""The least time of the IVF fine scan's K10 launch over f32 rows
(``rescore_f32_kernel`` and its grouping pass), from one call's counters.

Each input byte is read once and each output byte written once: the
distinct pool chunks the launch reads (``ivf.chunks_read``: 128 rows of d
fp32 each, and their 128 fp32 norms), the group ids of its budget
positions (``ivf.budget_chunks`` int32), the (nq_pad, d) fp32 queries, and
the fp32 scores it writes, 128 a budget position. Its products: d fp32
multiply-adds for each of the 128 rows of each live budget position
(``ivf.live_chunks``; a dead position scores chunk 0 for nothing). The
card's peaks and ``bound_s`` are ``roofline.py``'s; ``GROUP`` (rows a pool
chunk, ``ivf._CHUNK``) and the padding of queries and widths are frozen
there too.
"""

from __future__ import annotations

from benchmark.roofline import D_ALIGN, GROUP, NQ_PAD, bound_s, round_up

# the kernels of one K10 f32 launch, as the trace names them
KERNELS = ("rescore_f32_kernel", "f32_count", "f32_runs", "f32_order")
# one launch of each: the scoring kernel
LAUNCH = "rescore_f32_kernel"


def scan_bytes(*, chunks_read: int, budget_chunks: int, nq: int,
               d: int) -> int:
    """Bytes one launch reads and writes (module docstring)."""
    d_pad = round_up(d, D_ALIGN)
    nq_pad = max(NQ_PAD, round_up(nq, NQ_PAD))
    rows = chunks_read * GROUP * (d_pad * 4 + 4)
    return (rows + budget_chunks * 4 + nq_pad * d_pad * 4
            + budget_chunks * GROUP * 4)


def scan_ops(*, live_chunks: int, d: int) -> float:
    """fp32 operations of one launch: a multiply and an add for each
    element of each live position's rows."""
    return 2.0 * live_chunks * GROUP * round_up(d, D_ALIGN)


def scan_bound_s(*, chunks_read: int, budget_chunks: int, live_chunks: int,
                 nq: int, d: int):
    """(least seconds of one launch, what bounds it)."""
    return bound_s(scan_bytes(chunks_read=chunks_read,
                              budget_chunks=budget_chunks, nq=nq, d=d),
                   scan_ops(live_chunks=live_chunks, d=d), "fp32")
