"""Rank 0's shard scan: its least time over its device time, in %.

Numerator: reference/bound.py's bound of one search of the rank's own
live rows (the staged rows, their norms, the queries and the outputs once
at HBM bandwidth, or 2*B*N*D operations at the store type's tensor-core
rate, whichever is longer), once per `search` span. Denominator: rank 0's
device time inside the `search` spans less the collectives' kernels
(names starting `nccl`, whose time is mostly the wait for other ranks).
Nothing to read where the run has no shard shapes or no search span."""

from portbench.reference.bound import scan_bound_s
from portbench.tracing import Busy


def read(run):
    w = run.work.get("shard")
    t = run.trace
    if t is None or w is None:
        return None
    busy = Busy([op for op in t.device_ops if not op[2].startswith("nccl")])
    marks = [(s, e) for n, s, e in t.marks if n == "search"]
    ns = sum(busy.covered(s, e) for s, e in marks)
    if not marks or ns == 0:
        return None
    bound_s, _ = scan_bound_s(w["rows"], w["dim"], w["batch"], w["k"], w["dtype"])
    return 100.0 * len(marks) * bound_s / (ns * 1e-9)
