"""Observability: verbose stage timing and optional device profiling.

The CLI's observability is -v prints to stderr; results on stdout are never
polluted. This module keeps that contract and adds:
  - `stage(verbose, name)`: wall-clock per-stage timing lines under -v
  - C99VDB_TRACE=<dir>: wraps the stage in a torch.profiler trace (CPU
    activity, and CUDA activity when a card is present), written as a
    Chrome trace to <dir>/<stage name>/trace.json
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager


@contextmanager
def stage(verbose: bool, name: str):
    trace_dir = os.environ.get("C99VDB_TRACE")
    start = time.perf_counter()
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
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        print(f"[timing] {name}: {elapsed_ms:.1f} ms", file=sys.stderr)
