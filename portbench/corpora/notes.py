"""Synthetic memo notes and text queries from the seed.

Each note is 4 to 12 words drawn uniformly from `WORDS`; nine in ten carry
metadata {source, priority, topic}, the tenth none. Queries are 2 to 5
words from the same vocabulary. Notes get ids 0..n-1 in order when saved
into an empty store.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.seeds import stream_seed

WORDS = (
    "tea coffee morning meeting project deadline budget review design kernel "
    "memory cache index vector search query filter record note user agent system "
    "priority release deploy server client latency throughput storage disk network "
    "router replica shard cluster backup restore migrate schema table column row "
    "batch stream event window state log metric trace alert incident report team "
    "garden recipe travel flight hotel train ticket museum concert movie book song "
    "running fitness health sleep doctor appointment dentist pharmacy grocery bread "
    "apple orange banana lemon pepper salt sugar butter cheese milk yogurt pasta rice"
).split()
SOURCES = ("user", "agent", "system")
TOPICS = ("work", "home", "travel", "health", "food", "ops")


@dataclass
class Notes:
    records: list[dict]   # {"body": str, "metadata"?: dict}; note i has id i


def make(spec: dict, seed: int, device=None) -> Notes:
    n = spec["notes"]
    rng = np.random.default_rng(stream_seed(seed, "notes"))
    lengths = rng.integers(spec["min_words"], spec["max_words"] + 1, n)
    picks = rng.integers(0, len(WORDS), int(lengths.sum()))
    meta = rng.integers(0, [len(SOURCES), 5, len(TOPICS)], (n, 3))
    records, at = [], 0
    for i in range(n):
        body = " ".join(WORDS[j] for j in picks[at : at + lengths[i]])
        at += lengths[i]
        if i % 10 == 9:
            records.append({"body": body})
        else:
            s, p, t = meta[i]
            records.append({"body": body, "metadata": {
                "source": SOURCES[s], "priority": int(p), "topic": TOPICS[t]}})
    return Notes(records)


def queries(spec: dict, n: int, seed: int, device=None) -> list[str]:
    rng = np.random.default_rng(stream_seed(seed, "queries"))
    lengths = rng.integers(spec["query_min_words"], spec["query_max_words"] + 1, n)
    return [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), int(m))) for m in lengths]
