"""Arithmetic the metric readers share."""

from __future__ import annotations

import math


def percentile(values, pct: float) -> float:
    """Nearest-rank percentile: the smallest value with at least pct% of
    the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(pct / 100.0 * len(ordered)) - 1)]


def span_mean_ms(trace, name: str):
    """Mean duration of the spans `name`, in ms; None where there is none."""
    if trace is None:
        return None
    d = trace.durations(name)
    return 1e3 * sum(d) / len(d) if d else None


def self_ms(trace, name: str):
    """Mean self time of the spans `name`, in ms: each span's duration less
    that of the other spans that lie inside it."""
    if trace is None:
        return None
    outer = [(t0, t1) for n, t0, t1 in trace.spans if n == name]
    if not outer:
        return None
    inner = sorted((t0, t1) for n, t0, t1 in trace.spans if n != name)
    total, i = 0.0, 0
    for t0, t1 in sorted(outer):
        total += t1 - t0
        while i < len(inner) and inner[i][0] < t0:
            i += 1
        while i < len(inner) and inner[i][1] <= t1:
            total -= inner[i][1] - inner[i][0]
            i += 1
    return 1e3 * total / len(outer)
