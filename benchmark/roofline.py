"""The yardstick of the kernels' roofline shares: the card's peaks, the
layout rules that give a search's padded shapes, and the least time of a
sweep.

Frozen copies, so that a later change to the program cannot move the
yardstick: ``chip_smoke.py``'s ``_nbytes``, ``_bound`` and
``_sweep_bound`` (there over tensors, here over their shapes), and the
padding and grouping constants of ``faiss_tpu_torch`` (``index.NQ_PAD``,
``storage.ROW_TILE`` and ``D_ALIGN``, ``ops.kernels.GROUP`` and
``SUPERGROUP``, ``ops.fused.HIER_MIN_GROUPS`` and ``GROUP_PAD``) as they
stood when the benchmark was defined.
"""

from __future__ import annotations

HBM_BPS = 3.35e12                     # H100 SXM data sheet, bytes/s
PEAK = {"bf16": 989e12, "f16": 989e12, "int8": 1979e12, "fp32": 67e12}

NQ_PAD = 8              # queries pad to a multiple of this many rows
ROW_TILE = 1024         # stored rows pad to a multiple of this
D_ALIGN = 8             # bf16 / f16 elements per 16-byte row chunk
GROUP = 128             # rows per candidate group (one group max each)
SUPERGROUP = 8          # groups per supergroup max
HIER_MIN_GROUPS = 65536  # from here on the sweep also writes supergroup maxes
GROUP_PAD = 4           # groups nominated beyond k


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def search_shapes(nq: int, n_rows: int, d: int, k: int) -> dict:
    """The padded shapes of one flat search of ``nq`` queries over
    ``n_rows`` stored rows of width ``d``."""
    nq_pad = max(NQ_PAD, round_up(nq, NQ_PAD))
    nv_eff = round_up(n_rows, ROW_TILE)
    ngroups = nv_eff // GROUP
    kg = min(min(k, nv_eff) + GROUP_PAD, ngroups)
    hier = (ngroups >= HIER_MIN_GROUPS and ngroups % SUPERGROUP == 0
            and kg < ngroups // SUPERGROUP and kg * SUPERGROUP <= ngroups)
    return dict(nq_pad=nq_pad, nv_eff=nv_eff, d_pad=round_up(d, D_ALIGN),
                ngroups=ngroups, hier=hier)


def bound_s(nbytes: float, ops: float, kind: str):
    """(least seconds, what bounds it): the larger of bytes over the HBM
    rate and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BPS
    t_ops = ops / PEAK[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bytes(shapes: dict, *, q_planes: int, db_planes: int,
                itemsize: int = 2) -> int:
    """A sweep reads its query planes, the nv_eff rows of each stored
    plane and the (nv_eff,) fp32 norm stream once, and writes the
    (nq_pad, ngroups) fp32 group maxes (and the supergroup maxes where the
    search is hierarchical)."""
    nq, d, nv, ng = (shapes["nq_pad"], shapes["d_pad"], shapes["nv_eff"],
                     shapes["ngroups"])
    out = nq * ng * 4 + (nq * (ng // SUPERGROUP) * 4 if shapes["hier"] else 0)
    return (q_planes * nq * d * itemsize + db_planes * nv * d * itemsize
            + nv * 4 + out)


def sweep_bound_s(shapes: dict, *, q_planes: int, db_planes: int, terms: int,
                  kind: str, itemsize: int = 2):
    """(least seconds of one sweep, what bounds it): its bytes, and
    ``terms`` products of (nq_pad, d_pad) by (d_pad, nv_eff)."""
    ops = 2.0 * terms * shapes["nq_pad"] * shapes["nv_eff"] * shapes["d_pad"]
    return bound_s(sweep_bytes(shapes, q_planes=q_planes, db_planes=db_planes,
                               itemsize=itemsize), ops, kind)
