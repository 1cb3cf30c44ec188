"""Queries answered in the window over the window's seconds (closed loop)."""


def read(run):
    return float(run.nq.sum()) / run.window_s if run.window_s > 0 else None
