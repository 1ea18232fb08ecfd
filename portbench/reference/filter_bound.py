"""The least time of a filtered exact top-k: the flat scan's roofline
(reference/bound.py) over the rows the filter passes, plus the filter.

Whatever implements the search, the work a filtered search needs is the
passing rows, their norms, the queries and the outputs (bound.py's
`scan_bytes` at n = the rows that pass), and the filter itself read once:
one byte per id of the mask's id space for the keep table. Operations:
2 * B * (rows that pass) * D at the store type's tensor-core rate. The
larger of the two times is the bound, so a route that reads only the
passing rows is held to the same yardstick as one that reads the store.
"""

from __future__ import annotations

from portbench.reference.bound import HBM_BYTES_PER_S, PEAK_OPS_PER_S, scan_bytes, scan_ops


def filter_scan_bytes(passing: int, ids: int, d: int, b: int, k: int, dtype: str) -> int:
    """passing: rows the filter passes; ids: the mask's length (its id space)."""
    return scan_bytes(passing, d, b, k, dtype) + ids


def filter_scan_ops(passing: int, d: int, b: int) -> int:
    return scan_ops(passing, d, b)


def filter_scan_bound_s(passing: int, ids: int, d: int, b: int, k: int,
                        dtype: str) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time of one search."""
    t_bytes = filter_scan_bytes(passing, ids, d, b, k, dtype) / HBM_BYTES_PER_S
    t_ops = filter_scan_ops(passing, d, b) / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
