"""The flat search's least time over its device time, in %.

Numerator: reference/bound.py's bound of each search (the store, its
norms, the queries and the outputs once at HBM bandwidth, or 2*B*N*D
operations at the store type's tensor-core rate, whichever is longer).
Denominator: the device time of every device operation inside the
`search` spans, whatever kernels implement it. Nothing to read where the
run has no scan shapes or no search span."""

from portbench.reference.bound import scan_bound_s
from portbench.tracing import device_ns_in


def read(run):
    w = run.work.get("scan")
    if run.trace is None or w is None:
        return None
    calls, ns = device_ns_in(run.trace, "search")
    if calls == 0 or ns == 0:
        return None
    bound_s, _ = scan_bound_s(w["rows"], w["dim"], w["batch"], w["k"], w["dtype"])
    return 100.0 * calls * bound_s / (ns * 1e-9)
