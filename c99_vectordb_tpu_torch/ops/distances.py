"""Squared-L2 scoring and full-ranking programs (plain torch).

Score semantics contract: ascending squared L2 distance over unit vectors
(= 2 - 2*cos), ties broken by lowest record id.

Two formulations:
  - `pairwise_sq_l2` uses the direct (x - q)^2 expansion — exactly
    non-negative; it produces the printed scores of the ranking paths.
  - `scores_via_matmul` uses ||q||^2 + ||x||^2 - 2 q.x so the dominant
    cost is one matmul — used by the batched top-k path.
"""

from __future__ import annotations

import torch

INT32_MAX = torch.iinfo(torch.int32).max

# Working-set cap for ranked_many_program: the (b, cap) f32 distances and
# i32 ids of one chunk of queries plus the stable sort's scratch (values
# and int64 indices) stay under this many bytes; the batch is cut into as
# many chunks as that takes.
RANKED_MANY_BUDGET_BYTES = 1 << 30


def pairwise_sq_l2(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) exact squared L2 distances."""
    diff = queries[:, None, :] - db[None, :, :]
    return (diff * diff).sum(dim=-1)


def scores_via_matmul(
    queries: torch.Tensor, db: torch.Tensor, db_sq_norms: torch.Tensor
) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) squared L2 via the matmul expansion,
    clamped at 0 to absorb cancellation error."""
    q_sq = (queries * queries).sum(dim=1, keepdim=True)
    ip = queries @ db.T
    return torch.clamp_min(q_sq + db_sq_norms[None, :] - 2.0 * ip, 0.0)


def sort_by_dist_id(dists: torch.Tensor, tie_ids: torch.Tensor, in_id_order: bool):
    """Sort rows of `dists` ((cap,) or (B, cap)) ascending by (distance,
    tie id); tie_ids is (cap,), INT32_MAX on padding rows. Rows not in id
    order (an inverted-list canvas, a positional refine store) are put in
    id order first; then a STABLE sort on distance gives the (distance, id)
    order. in_id_order=True (the flat store, whose padding comes last)
    skips that step. Returns (sorted dists, their tie ids)."""
    if not in_id_order:
        by_id = torch.argsort(tie_ids, stable=True)
        dists, tie_ids = dists[..., by_id], tie_ids[by_id]
    sorted_d, order = torch.sort(dists, dim=-1, stable=True)
    return sorted_d, tie_ids[order]


def ranked_program(
    db: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, query: torch.Tensor,
    *, in_id_order: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full ranking of one query against a padded DB.

    Returns (distances, ids), each (cap,), ascending by (distance, id);
    padding rows sort last at (+inf, int32 max). in_id_order: the caller's
    rows are ascending by id with the padding last (sort_by_dist_id)."""
    dists = pairwise_sq_l2(query[None, :], db)[0]
    dists = torch.where(valid, dists, torch.inf)
    return sort_by_dist_id(dists, torch.where(valid, ids, INT32_MAX), in_id_order)


def ranked_many_program(
    db: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor,
    *, in_id_order: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full ranking for a batch of queries: (distances, ids), each (B, cap).

    Every row equals ranked_program's output for that query alone: each
    query's distances are computed by the same per-query expression. The
    batch is cut into chunks whose working set (distances, ids and sort
    scratch) stays under RANKED_MANY_BUDGET_BYTES."""
    b, cap = queries.shape[0], db.shape[0]
    out_d = torch.empty((b, cap), dtype=torch.float32, device=db.device)
    out_i = torch.empty((b, cap), dtype=torch.int32, device=db.device)
    per_query = cap * (4 + 4 + 4 + 8)  # dists + ids + sorted values + int64 order
    chunk = max(1, RANKED_MANY_BUDGET_BYTES // per_query)
    tie_ids = torch.where(valid, ids, INT32_MAX)
    for s0 in range(0, b, chunk):
        qs = queries[s0 : s0 + chunk]
        dists = torch.stack([pairwise_sq_l2(q[None, :], db)[0] for q in qs])
        dists = torch.where(valid[None, :], dists, torch.inf)
        out_d[s0 : s0 + chunk], out_i[s0 : s0 + chunk] = sort_by_dist_id(
            dists, tie_ids, in_id_order)
    return out_d, out_i
