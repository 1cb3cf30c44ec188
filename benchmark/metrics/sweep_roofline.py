"""The sweep's share of its roofline in the traced window: the least time
of every sweep launch the trace shows (the larger of its bytes over
3.35 TB/s and its products over the peak of their type, ``roofline.py``)
over the device time of those launches (kernels layer).

The configuration's ``sweep`` gives the route its storage takes: the
kernels' names as the trace gives them, the query and stored planes read,
the products and their type. A configuration without one raises."""

import sys

from benchmark import roofline


def read(run):
    route = run.config.get("sweep")
    if route is None:
        raise SystemExit(f"sweep_roofline: configuration "
                         f"{run.config['name']!r} names no sweep route")
    tr = run.trace
    if tr is None:
        return None
    kernels = tuple(route["kernels"])
    sweeps = [(s, e) for name, s, e in tr.device
              if any(k in name for k in kernels)]
    if not sweeps:
        names = sorted({n for n, _, _ in tr.device})
        print(f"sweep_roofline: no kernel named {kernels} in the trace; it "
              f"saw {names[:40]}", file=sys.stderr)
        return None
    data, traffic = run.config["data"], run.traffic
    shapes = roofline.search_shapes(traffic["nq"], data["rows"], data["d"],
                                    traffic["k"])
    least, _ = roofline.sweep_bound_s(
        shapes, q_planes=route["q_planes"], db_planes=route["db_planes"],
        terms=route["terms"], kind=route["kind"])
    busy = sum(e - s for s, e in sweeps) * 1e-6
    return 100.0 * least * len(sweeps) / busy
