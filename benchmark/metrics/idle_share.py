"""1 − (the union of the device's activity intervals) / (the traced
window), from torch.profiler (device layer)."""

from benchmark import devtrace


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(tr) / tr.window_s)
