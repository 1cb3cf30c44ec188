"""The calls of the window whose certificate failed for some query and
re-ran it on an exact path (``fused_fallbacks`` added), as a share of the
window's calls (fused search layer)."""


def read(run):
    n = run.nq.size
    return 100.0 * run.fallbacks / n if n else None
