"""Exact f32 re-ranking of a candidate shortlist (plain torch).

The scan kernels rank with a key whose arithmetic (reduced-precision
stores, int8 codes, another summation order) can swap neighbours near the
top-k boundary. Every index family therefore finishes with this stage:
take the scan's shortlist, gather the candidate vectors, recompute the
distances elementwise in f32 with the direct (x - q)^2 form, and merge by
(distance, id). The final order always comes from merge_topk's
lexicographic sort, whatever order the scan produced.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import merge_topk


def _rerank_gathered(vectors, rows, cand_ids, queries, k: int):
    vecs = vectors[rows].to(torch.float32)                      # (b, r, dim)
    diff = vecs - queries[:, None, :].to(torch.float32)
    exact = (diff * diff).sum(dim=-1)
    exact = torch.where(cand_ids >= 0, exact, torch.inf)
    return merge_topk(exact, cand_ids, k)


def exact_rerank_rows(vectors, cand_rows, cand_ids, queries, k: int):
    """Rerank when the store row of every candidate is known.

    vectors (n_rows, dim) store; cand_rows (b, r) store row per candidate
    (any value is safe where cand_ids < 0); cand_ids (b, r) external ids,
    -1 = invalid; queries (b, dim). Returns exact (distances (b, k) f32,
    ids (b, k))."""
    queries = torch.as_tensor(queries, device=vectors.device)
    rows = torch.clamp(cand_rows.to(torch.int64), 0, vectors.shape[0] - 1)
    return _rerank_gathered(vectors, rows, cand_ids, queries, k)


def exact_rerank(vectors, row_of_id, cand_ids, queries, k: int):
    """Rerank through a dense id -> row table (row_of_id, int32)."""
    queries = torch.as_tensor(queries, device=vectors.device)
    safe = torch.clamp(cand_ids.to(torch.int64), 0, row_of_id.shape[0] - 1)
    rows = row_of_id[safe].to(torch.int64)
    return _rerank_gathered(vectors, rows, cand_ids, queries, k)


def exact_rerank_sparse(vectors, ids_search, row_of_pos, cand_ids, queries, k: int):
    """Rerank through a binary search over ascending ids (int32 max padded)."""
    queries = torch.as_tensor(queries, device=vectors.device)
    needle = torch.clamp_min(cand_ids, 0).to(torch.int32).contiguous()
    pos = torch.searchsorted(ids_search, needle)
    pos = torch.clamp(pos, 0, ids_search.shape[0] - 1)
    rows = row_of_pos[pos].to(torch.int64)
    return _rerank_gathered(vectors, rows, cand_ids, queries, k)


def exact_rerank_staged(vectors, lookup, cand_ids, queries, k: int):
    """Rerank with a lookup produced by build_id_lookup
    (identity, dense, or sparse)."""
    if lookup[0] == "identity":
        return exact_rerank_rows(vectors, cand_ids, cand_ids, queries, k)
    if lookup[0] == "dense":
        return exact_rerank(vectors, lookup[1], cand_ids, queries, k)
    _, ids_search, row_of_pos = lookup
    return exact_rerank_sparse(vectors, ids_search, row_of_pos, cand_ids, queries, k)


def build_id_lookup(ids, device: torch.device, rows=None):
    """Host-side staging helper: external id -> candidate-store row.

    `ids` is the stored id array in ASCENDING order; `rows` the matching
    store row per id (defaults to the position). Returns tensors on
    `device`:
      ("identity",)                       — ids ARE the store rows
                                            (ids == 0..n-1, positional rows):
                                            the rerank skips the translation
      ("dense", row_of_id)                — a direct table when the id space
                                            is at most 64x the count (+1024)
      ("sparse", ids_search, row_of_pos)  — binary-search fallback when the
                                            id space is sparser than that
    """
    from ..models.base import next_pow2

    ids = np.asarray(ids)
    n = ids.shape[0]
    row_arr = np.arange(n, dtype=np.int32) if rows is None else np.asarray(rows, np.int32)
    if n == 0:
        return ("dense", torch.zeros((1,), dtype=torch.int32, device=device))
    if (
        rows is None
        and ids[0] == 0
        and ids[-1] == n - 1
        and np.array_equal(ids, np.arange(n, dtype=ids.dtype))
    ):
        return ("identity",)
    max_id = int(ids.max())
    if max_id + 1 <= 64 * n + 1024:
        cap = next_pow2(max_id + 1)
        table = np.zeros((cap,), np.int32)
        table[ids.astype(np.int64)] = row_arr
        return ("dense", torch.from_numpy(table).to(device))
    cap = next_pow2(n)
    ids_search = np.full((cap,), np.iinfo(np.int32).max, np.int32)
    ids_search[:n] = ids.astype(np.int32)
    row_of_pos = np.zeros((cap,), np.int32)
    row_of_pos[:n] = row_arr
    return (
        "sparse",
        torch.from_numpy(ids_search).to(device),
        torch.from_numpy(row_of_pos).to(device),
    )


def shortlist_depth(k: int, cap: int) -> int:
    """Kernel shortlist size for an exactness-restoring rerank: 2x or +8,
    whichever is larger, capped at the store size."""
    return min(max(2 * k, k + 8), cap)
