"""Mean synced span of the embedder (`embed_texts` or `embed_text`), per call, in ms."""

from portbench.stats import span_mean_ms


def read(run):
    return span_mean_ms(run.trace, "embed")
