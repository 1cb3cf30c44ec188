"""The queries that the flat certificate's fallback re-ran in the traced
window, on the two-plane sweep (``flat.tier1_rows``) and on the plain path
(``flat.tier2_rows``; a query that both tiers re-ran counts twice), over
the queries of the calls whose ``wait`` ran under the profiler (its
``token.wait`` spans), in % (fused search layer). Nothing to read from a
program that does not count its reruns."""

NAMES = ("flat.tier1_rows", "flat.tier2_rows")


def read(run):
    try:
        from faiss_tpu_torch import tracing
    except ImportError:     # a checkout without the program
        return None
    if not set(NAMES) <= set(getattr(tracing, "HOST_COUNTERS", ())):
        return None         # a program without these counters
    waits = sum(1 for r in tracing.spans() if r.name == "token.wait")
    if not waits:
        return None
    rerun = sum(c.value for c in tracing.counts() if c.name in NAMES)
    return 100.0 * rerun / (waits * run.traffic["nq"])
