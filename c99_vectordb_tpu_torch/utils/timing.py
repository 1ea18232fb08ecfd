"""Observability: named spans, verbose stage timing and optional device
profiling.

The CLI's observability is -v prints to stderr; results on stdout are never
polluted. This module keeps that contract and adds:
  - `span(name)`: a context manager around one layer's work. Disabled (the
    default) it is one shared no-op context: no clock read, nothing
    recorded. After `enable(True)` each span adds its host time
    (`perf_counter_ns`) to a per-name (count, total_ns) table that
    `snapshot()` copies and `reset()` clears, and opens a profiler range
    `c99vdb.<name>`, so under a running `torch.profiler` it lands on the
    device trace's clock. A span never synchronises the device: the host
    time is the time to issue the work, except where the code inside waits
    for the device itself (a copy to the host).
  - `stage(verbose, name)`: wall-clock per-stage timing lines under -v
  - C99VDB_TRACE=<dir>: wraps the stage in a torch.profiler trace (CPU
    activity, and CUDA activity when a card is present), written as a
    Chrome trace to <dir>/<stage name>/trace.json

The span table is one per process and meant for one thread at a time (the
benchmark's closed loop); a lock keeps its counts whole all the same.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

RANGE_PREFIX = "c99vdb."

_enabled = False
_range = None            # profiler range factory, bound by enable(True)
_table: dict[str, list[int]] = {}
_lock = threading.Lock()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """One timed interval; recorded (and marked for the profiler) while
    spans are enabled."""

    __slots__ = ("name", "ns", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0

    def __enter__(self):
        self._rf = None
        if _enabled:
            self._rf = _range(RANGE_PREFIX + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
            with _lock:
                entry = _table.setdefault(self.name, [0, 0])
                entry[0] += 1
                entry[1] += self.ns
        return False


def span(name: str):
    """Context manager timing one layer's work while spans are enabled."""
    return _Span(name) if _enabled else _NO_SPAN


def enable(on: bool) -> None:
    global _enabled, _range
    if on and _range is None:
        import torch

        # Under a profiler, under half of record_function's cost a span.
        _range = torch._C._profiler._RecordFunctionFast
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def snapshot() -> dict[str, tuple[int, int]]:
    """{span name: (count, total host ns)} since the last reset()."""
    with _lock:
        return {name: (c, ns) for name, (c, ns) in _table.items()}


def reset() -> None:
    with _lock:
        _table.clear()


@contextmanager
def stage(verbose: bool, name: str):
    trace_dir = os.environ.get("C99VDB_TRACE")
    with _Span(name) as timed:
        if trace_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            out_dir = os.path.join(trace_dir, name.replace(" ", "_"))
            os.makedirs(out_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                yield
            prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
        else:
            yield
    if verbose:
        print(f"[timing] {name}: {timed.ns / 1e6:.1f} ms", file=sys.stderr)
