"""The mean host time in ms of a search program's replay (the
``programs.replay`` span: the inputs copied into its static buffers, the
CUDA graph's replay and the output's clone, all enqueued) over the traced
window's calls (programs layer)."""

SPAN = "programs.replay"


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
