"""Mean synced span of the index's `search`, per call, in ms."""

from portbench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run.trace, "search")
