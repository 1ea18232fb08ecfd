"""Mean synced span of the front end's fan-out (rank 0's broadcast of a
request's header and queries to every rank), per call, in ms."""

from portbench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run.trace, "fanout")
