"""The traced run's instruments: synced spans around the calls into each
layer, and the profiler's device operations on the same timeline.

A span synchronises the card on entry and on exit, so the device work a
call launches runs inside its span, and marks itself with a profiler
annotation, so the device trace can be cut by span. Spans are installed
by patching the program's objects from outside (an entry module names the
points); nothing inside the program is changed, and `restore` puts every
patched attribute back.
"""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

PREFIX = "portbench."


@dataclass
class Trace:
    spans: list[tuple[str, float, float]] = field(default_factory=list)    # host clock, s
    marks: list[tuple[str, int, int]] = field(default_factory=list)        # profiler clock, ns
    device_ops: list[tuple[int, int, str]] = field(default_factory=list)   # profiler clock, ns
    window: tuple[int, int] | None = None                                  # profiler clock, ns

    def durations(self, name: str) -> list[float]:
        return [t1 - t0 for n, t0, t1 in self.spans if n == name]


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.trace = Trace()
        self._patched: list[tuple[object, str, bool, object]] = []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name: str, fn):
        spans = self.trace.spans

        def wrapper(*args, **kwargs):
            self.sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(PREFIX + name):
                out = fn(*args, **kwargs)
                self.sync()
            spans.append((name, t0, time.perf_counter()))
            return out

        return wrapper

    def patch(self, owner, attr: str, name: str) -> None:
        had = attr in vars(owner)
        old = vars(owner).get(attr)
        setattr(owner, attr, self.wrap(name, getattr(owner, attr)))
        self._patched.append((owner, attr, had, old))

    def restore(self) -> None:
        for owner, attr, had, old in reversed(self._patched):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._patched.clear()

    @contextmanager
    def profiled(self):
        """Profile the block (CPU and CUDA activity) and keep its device
        operations and span marks in `self.trace`."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(PREFIX + "window"):
                yield
                self.sync()
        self._read(prof.profiler.kineto_results.events())

    def _read(self, events) -> None:
        t = self.trace
        for e in events:
            name = e.name()
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            on_device = e.device_type() != torch.autograd.DeviceType.CPU
            if name.startswith(PREFIX):
                # Annotations appear on both timelines; the host's one is the span.
                if not on_device:
                    if name == PREFIX + "window":
                        t.window = (start, end)
                    else:
                        t.marks.append((name[len(PREFIX):], start, end))
            elif on_device and not getattr(e, "is_user_annotation", lambda: False)():
                t.device_ops.append((start, end, name))


def merge(intervals) -> list[tuple[int, int]]:
    """Union of (start, end, ...) intervals as sorted disjoint intervals."""
    out: list[list[int]] = []
    for s, e in sorted((s, e) for s, e, *_ in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Busy:
    """The union of device intervals, with the covered length of any span."""

    def __init__(self, intervals):
        self.merged = merge(intervals)
        self.starts = [s for s, _ in self.merged]
        self.ends = [e for _, e in self.merged]
        self.prefix = [0]
        for s, e in self.merged:
            self.prefix.append(self.prefix[-1] + e - s)

    def covered(self, lo: int, hi: int) -> int:
        """Length of [lo, hi] that the intervals cover."""
        i = bisect.bisect_right(self.ends, lo)
        j = bisect.bisect_left(self.starts, hi)
        if hi <= lo or i >= j:
            return 0
        total = self.prefix[j] - self.prefix[i]
        return total - max(0, lo - self.starts[i]) - max(0, self.ends[j - 1] - hi)


def busy_ns(trace: Trace) -> int:
    return Busy(trace.device_ops).covered(*trace.window)


def device_ns_in(trace: Trace, span: str) -> tuple[int, int]:
    """(spans named `span`, device time inside them in ns)."""
    busy = Busy(trace.device_ops)
    marks = [(s, e) for n, s, e in trace.marks if n == span]
    return len(marks), sum(busy.covered(s, e) for s, e in marks)


def innermost_segments(marks, lo: int, hi: int) -> list[tuple[int, int, str]]:
    """[lo, hi] cut into (start, end, name of the innermost mark open
    there), "harness" where none is (marks nest, as one thread's spans do)."""
    events = sorted([(s, 1, i) for i, (_, s, _) in enumerate(marks)]
                    + [(e, 0, i) for i, (_, _, e) in enumerate(marks)])
    out, stack, at = [], [], lo
    for t, starting, i in events + [(hi, 0, -1)]:
        t = min(max(t, lo), hi)
        if t > at:
            out.append((at, t, marks[stack[-1]][0] if stack else "harness"))
            at = t
        if i < 0:
            break
        if starting:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    window's idle time by the innermost span the host was in (`harness`
    outside every span)."""
    lo, hi = trace.window
    by_op: dict[str, int] = {}
    for s, e, name in trace.device_ops:
        by_op[name] = by_op.get(name, 0) + max(0, min(e, hi) - max(s, lo))
    busy = Busy(trace.device_ops)
    idle: dict[str, int] = {}
    for s, e, label in innermost_segments(trace.marks, lo, hi):
        idle[label] = idle.get(label, 0) + (e - s) - busy.covered(s, e)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((k, v) for k, v in idle.items() if v > 0), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in gaps]}
