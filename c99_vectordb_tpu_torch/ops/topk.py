"""Exact batched top-k search (plain torch path).

Scores the full padded DB with one matmul and selects the k smallest
distances per query. Padding rows carry +inf distance and id -1.

Tie-breaking: the lower row position wins on equal keys; the flat index
keeps rows ascending by id, so equal distances resolve to the lowest id.
"""

from __future__ import annotations

import torch

from .distances import INT32_MAX, scores_via_matmul


def stable_topk(keys: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of each row of `keys` (B, N), k <= N, ordered
    by (key, position): ties go to the lowest position.

    torch.topk does not promise which of several equal keys it returns, so
    the selection is split: every key strictly below the row's k-th value
    is taken (fewer than k of them), and the remaining slots go to the
    lowest positions holding exactly the k-th value. Returns (values (B, k),
    positions (B, k) int64)."""
    b, n = keys.shape
    kth = torch.topk(keys, k, dim=1, largest=False, sorted=True).values[:, k - 1 :]
    lt = keys < kth
    lt_vals, lt_pos = torch.topk(
        torch.where(lt, keys, torch.inf), k, dim=1, largest=False
    )
    lt_keep = lt_vals < kth
    # Positions as floats (exact below 2**24) so -position rides through topk.
    pos_dtype = torch.float32 if n <= (1 << 24) else torch.float64
    pos_f = torch.arange(n, device=keys.device, dtype=pos_dtype)
    eq_neg, eq_pos = torch.topk(
        torch.where(keys == kth, -pos_f, -torch.inf), k, dim=1, sorted=True
    )
    n_eq = k - lt.sum(dim=1, keepdim=True)
    slot = torch.arange(k, device=keys.device)[None, :]
    eq_keep = (slot < n_eq) & (eq_neg > -torch.inf)
    sentinel = torch.iinfo(torch.int64).max
    cand_v = torch.cat(
        [torch.where(lt_keep, lt_vals, torch.inf),
         torch.where(eq_keep, kth.expand(b, k), torch.inf)], dim=1,
    )
    cand_p = torch.cat(
        [torch.where(lt_keep, lt_pos, sentinel),
         torch.where(eq_keep, eq_pos, sentinel)], dim=1,
    )
    by_pos = torch.argsort(cand_p, dim=1, stable=True)
    cand_v = torch.gather(cand_v, 1, by_pos)
    cand_p = torch.gather(cand_p, 1, by_pos)
    by_val = torch.argsort(cand_v, dim=1, stable=True)[:, :k]
    return torch.gather(cand_v, 1, by_val), torch.gather(cand_p, 1, by_val)


def topk_program(
    db: torch.Tensor,
    ids: torch.Tensor,
    valid: torch.Tensor,
    sq_norms: torch.Tensor,
    queries: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, dim) x (cap, dim) -> top-k (distances (B, k), ids (B, k) int32,
    store rows (B, k) int32), as ops/topk_cuda.fused_topk(return_rows=True)
    returns them."""
    queries = torch.as_tensor(queries, dtype=torch.float32, device=db.device)
    dists = scores_via_matmul(queries, db, sq_norms)
    dists = torch.where(valid[None, :], dists, torch.inf)
    top_d, rows = stable_topk(dists, k)
    out_ids = torch.where(top_d < torch.inf, ids[rows], -1)
    return top_d, out_ids, rows.to(torch.int32)


def merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int, payload=None):
    """Merge candidate sets: (B, C) -> exact (B, k) by (distance, id).

    Invalid candidates must carry +inf distance. The output pads to width
    k with (inf, -1) when C < k. With `payload` (B, C), a per-candidate
    value carried through the selection, the merged (B, k) payload comes
    third (0 in padding)."""
    if dists.shape[-1] < k:
        pad = k - dists.shape[-1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=torch.inf)
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        if payload is not None:
            payload = torch.nn.functional.pad(payload, (0, pad), value=0)
    tie_ids = torch.where(torch.isinf(dists), INT32_MAX, ids)
    # Lexicographic (distance, id): stable sort by the secondary key, then
    # stable sort by the primary key.
    by_id = torch.argsort(tie_ids, dim=-1, stable=True)
    dists = torch.gather(dists, -1, by_id)
    tie_ids = torch.gather(tie_ids, -1, by_id)
    by_d = torch.argsort(dists, dim=-1, stable=True)[..., :k]
    out_d = torch.gather(dists, -1, by_d)
    out_i = torch.gather(tie_ids, -1, by_d)
    out_i = torch.where(out_i == INT32_MAX, -1, out_i)
    if payload is None:
        return out_d, out_i
    return out_d, out_i, torch.gather(torch.gather(payload, -1, by_id), -1, by_d)
