"""Entry module: `MemoDB.recall(text, k)` with no filter, the memo CLI's
path (embed one query, rank every note, hit assembly), one query a call
from the seeded pool. See memostore.py."""

from __future__ import annotations

from portbench.memostore import Request, control, requests, setup, size  # noqa: F401
from portbench import memostore


def call(db, req: Request):
    return db.recall(req.texts[0], k=req.k)


def span_points(db):
    from c99_vectordb_tpu_torch import api

    return [(db, "recall", "api"), (api, "embed_text", "embed"),
            (db._index(), "ranked_all", "rank")]


def work(db, ctx) -> dict:
    """The full ranking bypasses the scan kernel: no scan shapes."""
    return {}


def check(ctx, samples) -> dict:
    return memostore.check(ctx, samples, lambda out: [out])
