"""The mean host time in ms of a filtered call's selector stream (the
``index.sel_stream`` span: the selector evaluated over the index's ids and
the stream enqueued for the device, or evaluated on the host where the
program does that) over the traced window's calls (selector layer)."""

SPAN = "index.sel_stream"


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
