"""The API call's own time, in ms a call: its synced span less the spans
of the layers it calls (embed, search or rank) inside it: hit assembly,
store stat checks, host copies turned into lists."""

from portbench.stats import self_ms


def read(run):
    return self_ms(run.trace, "api")
