"""What the memo entry modules share: a MemoDB of the generated notes, the
text-query requests, the control and the check.

The store lives in the run's own directory under the temporary directory
(TMPDIR), written through `MemoDB.save_many` as a deployment would fill
it; the configuration's `system.env` selects the index kind and scan store
the way the memo CLI's environment does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from portbench.reference.memo import MemoControl, MemoReference
from portbench.seeds import stream_seed

QUERY_CHUNK = 128


@dataclass
class Request:
    rows: np.ndarray    # pool rows of the call
    texts: list[str]
    k: int


def setup(ctx):
    os.environ.update(ctx.config["system"]["env"])
    from c99_vectordb_tpu_torch import api

    db = api.MemoDB("notes", cwd=str(ctx.workdir), device=ctx.device)
    db.save_many(ctx.corpus.records)
    return db


def control(ctx):
    return MemoControl(ctx.corpus.records, ctx.device)


def requests(ctx) -> list[Request]:
    t = ctx.traffic
    order = np.random.default_rng(stream_seed(ctx.seed, "order")).permutation(t["pool"])
    return [Request(rows, [ctx.pool[r] for r in rows], t["k"])
            for rows in order.reshape(-1, t["batch"])]


def size(req: Request) -> int:
    return len(req.rows)


def scan_work(db, ctx) -> dict:
    """The flat scan's shapes, for an entry whose calls search the index."""
    index = db._index()
    t = ctx.traffic
    return {"scan": {"rows": index.ntotal, "dim": index.dim, "batch": t["batch"], "k": t["k"],
                     "dtype": index.scan_dtype}}


def check(ctx, samples, hits_of) -> dict:
    """Judge a seeded subset of the sampled calls' queries: ids and scores
    against the exact ranking, bodies and metadata against the notes."""
    t, lim = ctx.traffic, ctx.config["check"]
    texts, hits = [], []
    for _, req, out in samples:
        texts.extend(req.texts)
        hits.extend(hits_of(out))
    rng = np.random.default_rng(stream_seed(ctx.seed, "check-queries"))
    pick = np.sort(rng.permutation(len(texts))[: t["check_queries"]])
    ref = MemoReference(ctx.corpus.records, ctx.device)
    misses, gap, wrong = 0, 0.0, 0
    for s in range(0, len(pick), QUERY_CHUNK):
        p = pick[s : s + QUERY_CHUNK]
        m, g, w = ref.judge([texts[i] for i in p], [hits[i] for i in p], t["k"], lim["tie_tol"])
        misses, gap, wrong = misses + m, max(gap, g), wrong + w
    return {"id_misses": (misses, lim["id_misses"]), "score_gap": (gap, lim["score_gap"]),
            "record_mismatches": (wrong, lim["record_mismatches"])}
