"""Entry module: an index's `search(queries, k)` on batches of vectors.

The configuration's `system` names the index family (the program's
registry kind) and its constructor settings; the corpus is a vector set
(corpora/clustered.py) added once. Each call is one batch of `batch`
queries from the seeded pool; its (distances, ids) come back on the host.
The check recomputes exact float64 distances of the sampled queries to
every row (reference/exact.py) and judges the returned lists.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.reference.exact import ExactStore, SearchControl, score_lists
from portbench.seeds import stream_seed

QUERY_CHUNK = 32


@dataclass
class Request:
    rows: np.ndarray       # pool rows of the batch
    queries: np.ndarray    # (batch, dim) float32
    k: int


def setup(ctx):
    from c99_vectordb_tpu_torch.models.registry import resolve

    spec = ctx.config["system"]
    index = resolve(spec["family"])(**spec["params"], device=ctx.device)
    index.add(ctx.corpus.rows, ctx.corpus.ids)
    return index


def control(ctx):
    return SearchControl(ctx.corpus.rows, ctx.device)


def requests(ctx) -> list[Request]:
    t = ctx.traffic
    order = np.random.default_rng(stream_seed(ctx.seed, "order")).permutation(t["pool"])
    return [Request(rows, np.ascontiguousarray(ctx.pool[rows]), t["k"])
            for rows in order.reshape(-1, t["batch"])]


def call(index, req: Request):
    return index.search(req.queries, req.k)


def size(req: Request) -> int:
    return len(req.rows)


def span_points(index):
    return [(index, "search", "search")]


def work(index, ctx) -> dict:
    t = ctx.traffic
    return {"scan": {"rows": index.ntotal, "dim": index.dim, "batch": t["batch"], "k": t["k"],
                     "dtype": index.scan_dtype}}


def check(ctx, samples) -> dict:
    """Exact top-k of a seeded subset of the sampled calls' queries."""
    t, lim = ctx.traffic, ctx.config["check"]
    rows, ids, dists = [], [], []
    for _, req, (d, i) in samples:
        rows.append(req.rows)
        ids.append(np.asarray(i))
        dists.append(np.asarray(d))
    rows, ids, dists = np.concatenate(rows), np.concatenate(ids), np.concatenate(dists)
    rng = np.random.default_rng(stream_seed(ctx.seed, "check-queries"))
    pick = np.sort(rng.permutation(len(rows))[: t["check_queries"]])
    store = ExactStore(ctx.corpus.rows, ctx.device)
    misses, gap = 0, 0.0
    for s in range(0, len(pick), QUERY_CHUNK):
        p = pick[s : s + QUERY_CHUNK]
        m, g = score_lists(store.distances(ctx.pool[rows[p]]), ids[p], dists[p], t["k"],
                           lim["tie_tol"])
        misses, gap = misses + m, max(gap, g)
    return {"id_misses": (misses, lim["id_misses"]), "dist_gap": (gap, lim["dist_gap"])}
