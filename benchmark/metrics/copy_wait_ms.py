"""The mean host time in ms of the token's copy of the packed result to
the host (the ``token.copy`` span) over the traced window's calls (token
layer). It follows ``token.sync``, the wait for the call's own work, so
beyond a few µs it is the copy's wait behind the calls enqueued after
this one."""

SPAN = "token.copy"


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
