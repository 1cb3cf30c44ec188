"""The selector streams of the traced window that needed the host beyond
their enqueue: a selector's ids or mask copied to a device
(``sel.uploads``) or a selector evaluated on the host
(``sel.host_evals``), over the window's ``index.sel_stream`` spans, in %
(selector layer). Nothing to read from a program that does not count
them."""

NAMES = ("sel.uploads", "sel.host_evals")


def read(run):
    # nothing without a device trace (the CPU), as idle_share
    if run.trace is None or not run.trace.device:
        return None
    try:
        from faiss_tpu_torch import tracing
    except ImportError:     # a checkout without the program
        return None
    if not set(NAMES) <= set(getattr(tracing, "HOST_COUNTERS", ())):
        return None         # a program without these counters
    streams = sum(1 for r in tracing.spans() if r.name == "index.sel_stream")
    if not streams:
        return None
    host = sum(c.value for c in tracing.counts() if c.name in NAMES)
    return 100.0 * host / streams
