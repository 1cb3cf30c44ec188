"""The mean host time of ``search_async`` over the window's calls made
with the profiler off: query padding and upload, the selector's host
evaluation and copy, the program's replay and the token (index layer)."""

import numpy as np


def read(run):
    t = run.t_enqueue[~run.traced]
    return float(np.mean(t)) * 1e3 if t.size else None
