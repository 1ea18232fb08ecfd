"""Mean synced span of the cross-rank merge (the all_gather of every
shard's candidates and their (distance, id) merge) on rank 0, per call, in
ms: it includes the wait for the slowest rank's scan."""

from portbench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run.trace, "merge")
