"""The mean host time in ms of the queries' preparation (the
``index.prep_queries`` span: padded into pinned memory, then enqueued for
the device) over the traced window's calls (index layer)."""

SPAN = "index.prep_queries"


def read(run):
    # nothing without a device trace (the CPU), as idle_share
    if run.trace is None or not run.trace.device:
        return None
    try:
        from faiss_tpu_torch import tracing
    except ImportError:     # a program without spans
        return None
    ms = [r.ms for r in tracing.spans() if r.name == SPAN]
    return sum(ms) / len(ms) if ms else None
