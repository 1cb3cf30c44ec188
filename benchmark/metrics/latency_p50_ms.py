"""The median over every call of the window of the time from
``search_async`` to the return of ``wait()``, results on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.latency, 50)) * 1e3 if run.latency.size \
        else None
