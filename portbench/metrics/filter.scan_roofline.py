"""The filtered search's least time over its device time, in %.

Numerator: reference/filter_bound.py's bound of each search, counted at
the rows the filter passes (those rows, their norms, the queries, the
outputs and the mask's keep table once at HBM bandwidth, or 2*B*n*D
operations over the n passing rows at the store type's tensor-core rate,
whichever is longer), whatever rows the route reads. Denominator: the
device time of every device operation inside the `search` spans. Nothing
to read where the run has no filter shapes or no search span."""

from portbench.reference.filter_bound import filter_scan_bound_s
from portbench.tracing import device_ns_in


def read(run):
    w = run.work.get("filter")
    if run.trace is None or w is None:
        return None
    calls, ns = device_ns_in(run.trace, "search")
    if calls == 0 or ns == 0:
        return None
    bound_s, _ = filter_scan_bound_s(w["rows"], w["ids"], w["dim"], w["batch"], w["k"],
                                     w["dtype"])
    return 100.0 * calls * bound_s / (ns * 1e-9)
