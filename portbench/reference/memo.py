"""The memo store's recall semantics, recomputed from the notes the
benchmark generated: embed every note and query with the frozen hasher
(text.py), rank exactly by (squared L2 distance, id), skip blank bodies
and ids outside the store, and return k hits with their body and metadata.

`MemoReference` gives the exact float64 distances that judge a run;
`MemoControl` is the same reference in TF32 (exact.Tf32Store), with the
program's recall surface, put in the program's place to show that the
comparison fails a lower precision.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .exact import ExactStore, Tf32Store, score_lists, topk
from .text import Hasher, embed, is_blank_body


class RefHit(NamedTuple):
    doc_id: int
    score: float
    body: str
    metadata: dict[str, Any] | None


class MemoReference:
    def __init__(self, records: list[dict], device, store_cls=ExactStore):
        self.records = records
        self.hasher = Hasher()
        self.device = torch.device(device)
        bodies = [r["body"] for r in records]
        blank = torch.tensor([is_blank_body(b) for b in bodies], device=self.device)
        rows = embed(bodies, self.hasher, self.device, torch.float64)
        self.store = store_cls(rows, self.device, excluded=blank if bool(blank.any()) else None)

    def distances(self, texts: list[str]) -> torch.Tensor:
        """(len(texts), notes) distances; +inf for blank notes."""
        return self.store.distances(embed(texts, self.hasher, self.device, torch.float64))

    def judge(self, texts: list[str], hits: list[list[Any]], k: int, tie_tol: float):
        """(slots missed, largest score gap, hits whose body or metadata is
        not the note's) of the returned hit lists of `texts` (score_lists;
        a list shorter than k misses its absent slots)."""
        ids = np.full((len(texts), k), -1, np.int64)
        scores = np.full((len(texts), k), np.inf, np.float64)
        wrong_records = 0
        for qi, row in enumerate(hits):
            for s, h in enumerate(row[:k]):
                ids[qi, s], scores[qi, s] = h.doc_id, h.score
                ok = 0 <= h.doc_id < len(self.records)
                rec = self.records[h.doc_id] if ok else {}
                if not ok or h.body != rec.get("body") or h.metadata != rec.get("metadata"):
                    wrong_records += 1
            wrong_records += max(0, len(row) - k)
        misses, gap = score_lists(self.distances(texts), ids, scores, k, tie_tol)
        return misses, gap, wrong_records


class MemoControl(MemoReference):
    """The reference in TF32, answering as MemoDB does."""

    def __init__(self, records: list[dict], device):
        super().__init__(records, device, store_cls=Tf32Store)

    def recall_many(self, queries: list[str], k: int = 2) -> list[list[RefHit]]:
        vals, pos = topk(self.distances(queries), k)
        out = []
        for drow, prow in zip(vals.tolist(), pos.tolist()):
            out.append([RefHit(i, float(d), self.records[i]["body"], self.records[i].get("metadata"))
                        for d, i in zip(drow, prow) if d < float("inf")])
        return out

    def recall(self, query: str, k: int = 2) -> list[RefHit]:
        return self.recall_many([query], k)[0]
