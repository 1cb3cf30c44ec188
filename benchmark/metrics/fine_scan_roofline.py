"""The IVF fine scan's K10 f32 launch against its roofline in the traced
window: the mean least time of one launch over the calls whose counters
the window recorded (``roofline_ivf.py``, from ``ivf.chunks_read``,
``ivf.budget_chunks`` and ``ivf.live_chunks``), times the launches of its
scoring kernel that the device trace shows, over the device time of the
launches' kernels (the grouping pass and the scoring kernel), in %
(kernels layer).

The calls whose counters were recorded (their ``wait`` ran under the
profiler) and the launches in the trace differ at the window's edges by
the calls in flight; both counts are printed, and the mean over the
recorded calls stands for each launch."""

import sys

from benchmark import roofline_ivf


def read(run):
    tr = run.trace
    if tr is None or not tr.device:
        return None
    try:
        from faiss_tpu_torch import tracing
    except ImportError:     # a checkout without the program
        return None
    counts = getattr(tracing, "counts", None)
    if counts is None:      # a program without counters
        return None
    calls = {}
    for c in counts():
        calls.setdefault(c.call, {})[c.name] = c.value
    keys = ("ivf.chunks_read", "ivf.budget_chunks", "ivf.live_chunks")
    calls = [v for v in calls.values() if all(k in v for k in keys)]
    busy = sum(e - s for name, s, e in tr.device
               if any(k in name for k in roofline_ivf.KERNELS)) * 1e-6
    launches = sum(1 for name, _, _ in tr.device
                   if roofline_ivf.LAUNCH in name)
    if not calls or not launches or busy <= 0:
        return None
    d, nq = run.config["data"]["d"], run.traffic["nq"]
    least = sum(roofline_ivf.scan_bound_s(
        chunks_read=v["ivf.chunks_read"], budget_chunks=v["ivf.budget_chunks"],
        live_chunks=v["ivf.live_chunks"], nq=nq, d=d)[0]
        for v in calls) / len(calls)
    print(f"fine_scan_roofline: {len(calls)} calls counted, {launches} "
          f"launches traced", file=sys.stderr)
    return 100.0 * least * launches / busy
