"""Frozen copy of the flat scan's roofline arithmetic (the least time of a
batched exact top-k over a store), with the card's published peaks.

Bytes: the store, its squared norms, the queries and the (distance, id)
outputs, each read or written once. Operations: 2 * B * N * D at the
store type's dense tensor-core rate (TF32 for float32). The larger of the
two times is the bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM bytes/s and dense tensor-core peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
ITEM_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def scan_bytes(n: int, d: int, b: int, k: int, dtype: str) -> int:
    item = ITEM_BYTES[dtype]
    return n * d * item + n * 4 + b * d * item + b * k * 8 + (b * 4 if dtype == "int8" else 0)


def scan_ops(n: int, d: int, b: int) -> int:
    return 2 * b * n * d


def scan_bound_s(n: int, d: int, b: int, k: int, dtype: str) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time of one search."""
    t_bytes = scan_bytes(n, d, b, k, dtype) / HBM_BYTES_PER_S
    t_ops = scan_ops(n, d, b) / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
