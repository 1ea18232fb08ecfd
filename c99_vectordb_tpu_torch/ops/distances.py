"""Squared-L2 scoring and full-ranking programs (plain torch).

Score semantics contract: ascending squared L2 distance over unit vectors
(= 2 - 2*cos), ties broken by lowest record id.

Two formulations:
  - `pairwise_sq_l2` uses the direct (x - q)^2 expansion — exactly
    non-negative; it produces the printed scores of the ranking paths, so
    it sums each row in one fixed order on every device (below).
  - `scores_via_matmul` uses ||q||^2 + ||x||^2 - 2 q.x so the dominant
    cost is one matmul — used by the batched top-k path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INT32_MAX = torch.iinfo(torch.int32).max

# Working-set cap for a batched full ranking: the (b, cap) f32 distances
# and i32 ids of one chunk of queries plus the stable sort's scratch
# (values and int64 indices) stay under this many bytes; the batch is cut
# into as many chunks as that takes (ranked_many_chunk).
RANKED_MANY_BUDGET_BYTES = 1 << 30
RANKED_BYTES_PER_ROW = 4 + 4 + 4 + 8  # dists + ids + sorted values + int64 order

# The summation order of pairwise_sq_l2: XLA's on the CPU, which the JAX
# package's ranking programs run. Up to SUM_WINDOW columns are summed left
# to right with each square fused into its add (one rounding per step);
# wider rows are squared, summed left to right in windows of SUM_WINDOW
# columns, and the window sums summed the same way in turn. Elementwise
# f32 operations round alike on every device, so the CPU and the card give
# the same bits, and those of the JAX package on its CPU backend (for
# D <= 32 and multiples of 32, which covers the embedder's 384).
SUM_WINDOW = 32
# Bytes of the two slab temporaries per block of queries scored at once.
SLAB_BYTES = 1 << 27


def ranked_many_chunk(cap: int) -> int:
    """Queries per chunk of a batched full ranking over `cap` rows whose
    outputs and sort scratch stay under RANKED_MANY_BUDGET_BYTES."""
    return max(1, RANKED_MANY_BUDGET_BYTES // (cap * RANKED_BYTES_PER_ROW))


def query_rows(queries, dim: int, device) -> torch.Tensor:
    """Queries, a numpy array or a tensor of shape (dim,) or (B, dim), as a
    (B, dim) f32 tensor on `device`."""
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
    return queries.to(device=device, dtype=torch.float32).reshape(-1, dim)


def _window_columns(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (SUM_WINDOW, N, ceil(D / SUM_WINDOW)), contiguous, with
    [j, n, w] = x[n, w * SUM_WINDOW + j] (zero past D)."""
    pad = -x.shape[1] % SUM_WINDOW
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(x.shape[0], x.shape[1] // SUM_WINDOW, SUM_WINDOW).permute(2, 0, 1).contiguous()


def _window_sum(x: torch.Tensor) -> torch.Tensor:
    """(N, n) -> (N,): row sums, left to right up to SUM_WINDOW columns,
    else in SUM_WINDOW windows whose sums are summed the same way."""
    cols = x.T if x.shape[1] <= SUM_WINDOW else _window_columns(x)
    acc = cols[0].clone()
    for c in cols[1:]:
        acc += c
    return acc if x.shape[1] <= SUM_WINDOW else _window_sum(acc)


def _ranking_operand(db: torch.Tensor) -> torch.Tensor:
    """The store laid out for _sq_l2_block: its columns (D, N) up to
    SUM_WINDOW columns, else _window_columns."""
    if db.shape[1] <= SUM_WINDOW:
        return db.T.contiguous()
    return _window_columns(db)


def _sq_l2_block(qs: torch.Tensor, db_op: torch.Tensor) -> torch.Tensor:
    """(b, D) queries against a _ranking_operand store -> (b, N) distances.
    Each distance takes the same elementwise steps whatever b is."""
    b, n = qs.shape[0], db_op.shape[1]
    if qs.shape[1] <= SUM_WINDOW:
        # acc = fma(d, d, acc): d * d is exact in f64, so one f64 add
        # rounded to f32 is the fused step (a double rounding differs
        # only when the f64 sum lands on an f32 tie, ~2^-29 of steps).
        acc = torch.zeros((b, n), dtype=torch.float32, device=db_op.device)
        for j in range(qs.shape[1]):
            d = (qs[:, j, None] - db_op[j][None, :]).double()
            acc = (acc.double() + d * d).float()
        return acc
    # Window sums over (b, N, D / SUM_WINDOW) slabs, one column at a time:
    # the same adds as summing the squared windowed store, in slab-sized
    # temporaries.
    q_op = _window_columns(qs)[:, :, None, :]
    acc = torch.sub(q_op[0], db_op[0])
    acc.mul_(acc)
    sq = torch.empty_like(acc)
    for j in range(1, SUM_WINDOW):
        torch.sub(q_op[j], db_op[j], out=sq)
        acc += sq.mul_(sq)
    return _window_sum(acc.reshape(b * n, -1)).reshape(b, n)


def _sq_l2(qs: torch.Tensor, db_op: torch.Tensor) -> torch.Tensor:
    """_sq_l2_block over blocks of queries whose slab temporaries stay
    near SLAB_BYTES."""
    per_query = 2 * 4 * db_op[0].numel()
    step = max(1, SLAB_BYTES // per_query)
    return torch.cat([_sq_l2_block(qs[s0 : s0 + step], db_op)
                      for s0 in range(0, qs.shape[0], step)])


def pairwise_sq_l2(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) exact squared L2 distances, each row
    summed in the fixed order described at SUM_WINDOW."""
    return _sq_l2(queries, _ranking_operand(db))


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
    dists = torch.where(valid, pairwise_sq_l2(query[None, :], db)[0], torch.inf)
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
    chunk = ranked_many_chunk(cap)
    tie_ids = torch.where(valid, ids, INT32_MAX)
    db_op = _ranking_operand(db)
    for s0 in range(0, b, chunk):
        dists = _sq_l2(queries[s0 : s0 + chunk], db_op)
        dists = torch.where(valid[None, :], dists, torch.inf)
        out_d[s0 : s0 + chunk], out_i[s0 : s0 + chunk] = sort_by_dist_id(
            dists, tie_ids, in_id_order)
    return out_d, out_i
