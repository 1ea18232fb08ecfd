"""Entry module: `MemoDB.recall_many(texts, k)`, the batched serving call
(embed, flat scan and exact rerank, hit assembly), on batches of text
queries from the seeded pool. See memostore.py."""

from __future__ import annotations

from portbench.memostore import Request, control, requests, scan_work as work, setup, size  # noqa: F401
from portbench import memostore


def call(db, req: Request):
    return db.recall_many(req.texts, k=req.k)


def span_points(db):
    from c99_vectordb_tpu_torch import api

    return [(db, "recall_many", "api"), (api, "embed_texts", "embed"),
            (db._index(), "search", "search")]


def check(ctx, samples) -> dict:
    return memostore.check(ctx, samples, lambda out: out)
