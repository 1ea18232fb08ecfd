"""95th percentile (nearest rank) of the latency of every call in the
window, host clock, from the call until its results are on the host."""

from portbench.stats import percentile


def read(run):
    return percentile(run.latencies_s, 95) * 1e3 if run.latencies_s else None
