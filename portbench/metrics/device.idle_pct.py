"""Share of the traced window's wall time in which the profiler shows no
device operation (the union of kernel and copy intervals), in %. Nothing
to read in a run without device operations."""

from portbench.tracing import busy_ns


def read(run):
    t = run.trace
    if t is None or t.window is None or t.window[1] <= t.window[0] or not t.device_ops:
        return None
    return 100.0 * (1.0 - busy_ns(t) / (t.window[1] - t.window[0]))
