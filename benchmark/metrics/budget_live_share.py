"""The fine scan's live budget positions (a probed list's chunk) over its
budgeted ones (nq_pad × the static chunk budget), in %, summed over the
traced window's calls: the program's ``ivf.live_chunks`` and
``ivf.budget_chunks`` counters (ivf layer). A dead position costs K10 a
chunk's scores and the top-k their sort for nothing."""


def read(run):
    try:
        from faiss_tpu_torch import tracing
    except ImportError:     # a checkout without the program
        return None
    counts = getattr(tracing, "counts", None)
    if counts is None:      # a program without counters
        return None
    tot = {"ivf.live_chunks": 0, "ivf.budget_chunks": 0}
    for c in counts():
        if c.name in tot:
            tot[c.name] += c.value
    if not tot["ivf.budget_chunks"]:
        return None
    return 100.0 * tot["ivf.live_chunks"] / tot["ivf.budget_chunks"]
