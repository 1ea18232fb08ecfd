"""Build, incremental-add and filter-mask machinery shared by the index
families (counterpart of the JAX package's models/devbuild.py).

Every helper here is plain torch, as its counterpart is plain XLA:

  * filter pushdown: +inf row norms ARE the scan kernels' exclusion
    mechanism, so a filter needs no kernel change: one masked copy of a
    small (n,)-sized operand per filter, staged once and cached;
  * chunk storage, bucketing and the scatter into padded (nlist, pad)
    inverted lists, all on the index's device, so a corpus-scale build
    never crosses to the host;
  * `GrowTail`, the append buffer for rows added after staging, with the
    exact tail scoring and (distance, id) merge that search applies to it;
  * the corpus-geometry diagnostic, the pad_cap spill assignment, the
    shape-stable tail fold, in-place id removal and the id -> row lookup.

Unlike the JAX package, nothing is padded to power-of-two lengths: torch
runs eagerly, so there is no compiled program to reuse across shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import merge_topk, stable_topk
from .base import next_pow2

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def is_device_array(x) -> bool:
    """True for a torch.Tensor: the port's counterpart of a jax.Array, the
    input that puts an index family in device mode."""
    return isinstance(x, torch.Tensor)


def tail_restage_threshold(ntotal: int) -> int:
    """Tail size that triggers a lazy restage: the tail scan stays a
    few-percent overhead next to the list scan while add stays O(batch)
    (a 10k append to a 1M index stays tail-resident)."""
    return max(4096, ntotal // 64)


def _keep(ids: torch.Tensor, id_mask) -> torch.Tensor:
    """True where the row's external id is set in id_mask. Ids below 0
    (padding) or at/after the mask's end are EXCLUDED, never clip-aliased
    onto the boundary slot."""
    mask = torch.as_tensor(np.asarray(id_mask, dtype=bool), device=ids.device)
    cap = mask.shape[0]
    safe = torch.clamp(ids.to(torch.int64), 0, cap - 1)
    return mask[safe] & (ids >= 0) & (ids < cap)


def mask_norms(norms: torch.Tensor, ids: torch.Tensor, id_mask) -> torch.Tensor:
    """Masked copy of a norms operand (same shape as ids): +inf where the
    row's external id is masked out (or padding)."""
    return torch.where(_keep(ids, id_mask), norms, torch.inf)


def mask_rows(ids: torch.Tensor, id_mask) -> torch.Tensor:
    """Boolean keep-mask in the ids operand's layout."""
    return _keep(ids, id_mask)


def mask_shortlist_ids(ids: torch.Tensor, id_mask) -> torch.Tensor:
    """Invalidate (-1) shortlist entries whose external id is masked out.

    The scan gives masked rows +inf DISTANCE but keeps their real ids, and
    when fewer unmasked candidates exist than the shortlist width those
    inf entries pad it out. The exact rerank is mask-unaware — it would
    re-score them with their true finite distances and LEAK them into
    results — so every masked path scrubs shortlist ids before reranking."""
    return torch.where(_keep(ids, id_mask), ids, -1)


class MaskCache:
    """Per-index cache of filter-mask stagings.

    Keyed by the mask ARRAY OBJECT (kept referenced, so identity is
    stable); passing the same mask object across searches reuses the
    staged masked operands."""

    def __init__(self):
        self._mask = None
        self._value = None

    def get(self, id_mask, build):
        if self._mask is not id_mask:
            self._value = build()
            self._mask = id_mask
        return self._value

    def clear(self):
        self._mask = None
        self._value = None


# -- chunked append storage ---------------------------------------------------


class ChunkStore:
    """Append-only row storage: a list of (b, ...) chunks, consolidated
    lazily into one tensor. Appends are O(1); the consolidation cache
    invalidates on append."""

    def __init__(self):
        self._chunks: list = []
        self._n = 0
        self._cache = None

    def __len__(self) -> int:
        return self._n

    def append(self, chunk) -> None:
        if chunk.shape[0] == 0:
            return
        self._chunks.append(chunk)
        self._n += int(chunk.shape[0])
        self._cache = None

    def clear(self) -> None:
        self._chunks = []
        self._n = 0
        self._cache = None

    def consolidated(self, dtype=None):
        """One tensor holding every appended row, in `dtype` when given."""
        if self._cache is None or (dtype is not None and self._cache.dtype != dtype):
            if not self._chunks:
                raise ValueError("consolidating an empty ChunkStore")
            parts = self._chunks
            if dtype is not None:
                parts = [p.to(dtype) for p in parts]
            self._cache = parts[0] if len(parts) == 1 else torch.cat(parts)
        return self._cache


# -- device bucketing -----------------------------------------------------------


def bucketize_device(assign: torch.Tensor, nlist: int):
    """Bucket (n,) list assignments into inverted-list layout.

    Returns (order, sorted_lists, slots) tensors of length n — row
    order[j] goes to slot slots[j] of list sorted_lists[j]; the stable
    sort keeps each list's rows in input order — plus host (nlist,)
    counts."""
    assign = assign.to(torch.int64)
    order = torch.argsort(assign, stable=True)
    sorted_lists = assign[order]
    starts = torch.searchsorted(
        sorted_lists, torch.arange(nlist + 1, device=assign.device, dtype=torch.int64))
    counts = torch.diff(starts)
    slots = torch.arange(assign.shape[0], device=assign.device) - starts[
        torch.clamp(sorted_lists, 0, nlist)]
    return order, sorted_lists, slots, counts.cpu().numpy()


def scatter_lists_device(values, order, lists, slots, nlist: int, pad: int):
    """(n, width) rows -> (nlist, pad, width) padded lists (zeros)."""
    canvas = torch.zeros((nlist, pad, values.shape[1]), dtype=values.dtype,
                         device=values.device)
    canvas[lists, slots] = values[order]
    return canvas


def scatter_list_ids_device(ids, order, lists, slots, nlist: int, pad: int):
    """(n,) ids -> (nlist, pad) int32 with -1 padding."""
    canvas = torch.full((nlist, pad), -1, dtype=torch.int32, device=ids.device)
    canvas[lists, slots] = ids[order].to(torch.int32)
    return canvas


# -- post-staging append tail ------------------------------------------------------


class GrowTail:
    """Device-side append buffer for rows added after staging.

    Named fields (each (cap,) or (cap, width)) live in preallocated
    buffers that are written IN PLACE, O(batch) per append; when an append
    would overflow, every buffer grows to the next power of two (one
    copy). Id fields pad with -1 (the universal invalid-id marker) so
    unfilled capacity is inert in merges."""

    def __init__(self, fields: dict[str, tuple[int | None, str]], device,
                 initial_cap: int = 0):
        """fields: name -> (width or None for 1-D, dtype string).
        initial_cap: pre-size the buffers (rounded up to pow2) on the first
        append; the index families pass the restage threshold, the size
        the tail reaches before it folds anyway."""
        self._spec = fields
        self._device = torch.device(device)
        self._initial_cap = int(initial_cap)
        self._cap = 0
        self.count = 0
        self._arrays: dict[str, torch.Tensor] = {}

    def __bool__(self) -> bool:
        return self.count > 0

    @property
    def cap(self) -> int:
        return self._cap

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._arrays[name]

    def _grow(self, need: int) -> None:
        new_cap = next_pow2(max(need, self._initial_cap, 1024))
        for name, (width, dtype) in self._spec.items():
            shape = (new_cap,) if width is None else (new_cap, width)
            fresh = torch.full(shape, -1 if name == "ids" else 0, dtype=_DTYPES[dtype],
                               device=self._device)
            if self._cap:
                fresh[: self._cap] = self._arrays[name]
            self._arrays[name] = fresh
        self._cap = new_cap

    def append(self, **chunks) -> None:
        batch = int(next(iter(chunks.values())).shape[0])
        if self.count + batch > self._cap:
            self._grow(self.count + batch)
        for name, chunk in chunks.items():
            buf = self._arrays[name]
            buf[self.count : self.count + batch] = torch.as_tensor(chunk).to(
                device=self._device, dtype=buf.dtype)
        self.count += batch


# -- tail search merge ----------------------------------------------------------------


def tail_scores(tail: GrowTail, centroids, c_sq, queries, nprobe: int):
    """(b, cap) exact tail distances, +inf where the row is invalid or its
    assigned list is NOT probed by that query — the rows a fresh build's
    scan would have seen. The probes repeat the kernel route's formula
    with the q_sq term, UNCLAMPED: q_sq + c_sq - 2 q.c, ties to the lowest
    list."""
    vecs = tail["vecs"].to(torch.float32)
    nlist = centroids.shape[0]
    b = queries.shape[0]
    q32 = queries.to(torch.float32)
    q_sq = (q32 * q32).sum(dim=1)
    coarse = q_sq[:, None] + c_sq[None, :] - 2.0 * (q32 @ centroids.T)
    _, probes = stable_topk(coarse, nprobe)
    probed = torch.zeros((b, nlist + 1), dtype=torch.bool, device=q32.device)
    probed.scatter_(1, probes, True)
    col = torch.clamp(tail["assign"].to(torch.int64), 0, nlist)
    visible = probed[:, col]                                   # (b, cap)
    t_sq = (vecs * vecs).sum(dim=1)
    d = t_sq[None, :] - 2.0 * (q32 @ vecs.T) + q_sq[:, None]
    d = torch.clamp_min(d, 0.0)
    keep = visible & (tail["ids"] >= 0)[None, :]
    return torch.where(keep, d, torch.inf)


def merge_tail(main_d, main_i, tail_d, tail_ids, k: int):
    """Lexicographic (distance, id) merge of main results with tail rows.
    A tail much wider than k is first cut to its 2k nearest (k of id-tie
    slack), as in the JAX package."""
    cap = tail_d.shape[1]
    ti = tail_ids.to(torch.int32)[None, :].expand(tail_d.shape[0], cap)
    td = tail_d
    if cap > 4 * k:
        td, pos = stable_topk(td, min(2 * k, cap))
        ti = torch.gather(ti, 1, pos)
    alld = torch.cat([main_d.to(torch.float32), td], dim=1)
    alli = torch.cat([main_i.to(torch.int32), ti], dim=1)
    return merge_topk(alld, alli, k)


# -- corpus geometry diagnostic ---------------------------------------------------------


def corpus_geometry(counts, pad_cap: int | None = None) -> dict:
    """Clustering-geometry diagnostic from the per-list assignment counts.

    A max/mean cell ratio far above the 2-4x of clusterable corpora flags
    the heavy-tailed regime, where IVF recall plateaus inside the dominant
    cell; 8x is the threshold between the two regimes, and the
    mean-occupancy floor keeps sparse memo-scale corpora quiet."""
    counts = np.asarray(counts, np.int64)
    n = int(counts.sum())
    nlist = int(counts.shape[0])
    if n == 0 or nlist == 0:
        return {
            "n": n, "nlist": nlist, "max_cell": 0, "mean_cell": 0.0,
            "max_cell_ratio": 0.0, "spill_fraction": 0.0,
            "heavy_tailed": False,
        }
    mean = n / nlist
    max_cell = int(counts.max())
    ratio = max_cell / max(mean, 1e-30)
    spill = 0.0
    if pad_cap:
        spill = float(np.maximum(counts - pad_cap, 0).sum()) / n
    return {
        "n": n, "nlist": nlist, "max_cell": max_cell, "mean_cell": mean,
        "max_cell_ratio": ratio, "spill_fraction": spill,
        "heavy_tailed": ratio >= 8.0 and nlist >= 8 and mean >= 16.0,
    }


def geometry_advice(geo: dict) -> str | None:
    """One-line operator guidance when the corpus is heavy-tailed, None
    otherwise (callers gate printing on verbosity)."""
    if not geo.get("heavy_tailed"):
        return None
    return (
        f"heavy-tailed corpus geometry: largest IVF cell holds "
        f"{geo['max_cell_ratio']:.1f}x the mean "
        f"({geo['max_cell']}/{geo['mean_cell']:.0f} rows). Measured "
        f"guidance (BASELINE.md zipf): recall plateaus inside the "
        f"dominant cell; prefer the exact flat scan "
        f"(C99VDB_INDEX=flat C99VDB_SCAN_DTYPE=int8) at nprobe >= 8, "
        f"or bound list memory with pad_cap (C99VDB_PAD_CAP)"
    )


# -- capacity-capped bucketing (pad_cap spill) ----------------------------------------


def _assign_with_cands(rows, centroids, c_sq, r: int, sub: int = 16_384):
    """(cand (n, r) candidate lists, d2 (n,) squared distance to the
    nearest centroid). Slot 0 is the exact nearest list; slots 1..r-1 are
    the r-1 nearest by an exact top-r (the JAX package draws them with
    approx_min_k on the TPU, exact elsewhere)."""
    cands, d2s = [], []
    for s0 in range(0, rows.shape[0], sub):
        xb = rows[s0 : s0 + sub].to(torch.float32)
        d_ = c_sq[None, :] - 2.0 * (xb @ centroids.T)
        prim = torch.argmin(d_, dim=1)
        _, idx = stable_topk(d_, r)
        cands.append(torch.cat([prim[:, None], idx[:, : r - 1]], dim=1))
        d2s.append(d_.min(dim=1).values + (xb * xb).sum(dim=1))
    return torch.cat(cands), torch.cat(d2s)


def _lexsort(key: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Order by (cur, key), ties by position (jnp.lexsort((key, cur)))."""
    by_key = torch.argsort(key, stable=True)
    return by_key[torch.argsort(cur[by_key], stable=True)]


def _rank_rows(cur, key, nlist: int):
    """Rank of every row inside its current list by key; per-list counts."""
    n = cur.shape[0]
    order = _lexsort(key, cur)
    sorted_cur = cur[order]
    starts = torch.searchsorted(sorted_cur, torch.arange(nlist, device=cur.device))
    rank_sorted = torch.arange(n, device=cur.device) - starts[sorted_cur]
    rank_row = torch.empty_like(rank_sorted)
    rank_row[order] = rank_sorted
    cnts = torch.diff(torch.cat([starts, torch.tensor([n], device=cur.device)]))
    return rank_row, cnts


def _spill(cand, d2, cap_vec, valid, nlist: int, r: int):
    """Capacity-capped placement (the JAX package's spill policy): per
    round, rank rows within their current list — primary (nearest-list)
    rows outrank relocated arrivals, closest-to-centroid first; invalid
    rows rank last — and rows past their list's capacity advance to their
    next candidate; the residue past every candidate fills globally free
    capacity in list order. Returns (assign (n,) int64, moved count)."""
    d2m = torch.where(valid, d2, 0.0)
    d2_0 = d2m - d2m.min()
    span = d2_0.max() + 1.0
    cur0 = cand[:, 0]

    def key_of(cur):
        return (d2_0 + torch.where(cur != cur0, span, 0.0)
                + torch.where(valid, 0.0, 4.0 * span))

    cur, r_idx = cur0.clone(), torch.ones_like(cur0)
    for _ in range(r):
        rank_row, _ = _rank_rows(cur, key_of(cur), nlist)
        over = (rank_row >= cap_vec[cur]) & (r_idx < r) & valid
        nxt = torch.gather(cand, 1, torch.clamp(r_idx, max=r - 1)[:, None])[:, 0]
        cur = torch.where(over, nxt, cur)
        r_idx = torch.where(over, r_idx + 1, r_idx)
    rank_row, cnts = _rank_rows(cur, key_of(cur), nlist)
    over = (rank_row >= cap_vec[cur]) & valid
    free = cap_vec - torch.minimum(cnts, cap_vec)
    cumfree = torch.cumsum(free, 0)
    ovr_pos = torch.cumsum(over.to(torch.int64), 0) - 1
    target = torch.searchsorted(cumfree, ovr_pos, right=True)
    cur = torch.where(over, torch.clamp(target, max=nlist - 1), cur)
    return cur, int(((cur != cur0) & valid).sum())


def capped_assign(rows, centroids, cap: int, r: int = 16):
    """Capacity-capped coarse assignment: every list holds <= cap rows
    (requires nlist * cap >= n). Returns (assign (n,) int32, moved)."""
    n = int(rows.shape[0])
    nlist = int(centroids.shape[0])
    if nlist * cap < n:
        raise ValueError(
            f"pad_cap={cap} cannot place {n} rows in {nlist} lists "
            f"(nlist * pad_cap = {nlist * cap} < n)"
        )
    centroids = centroids.to(torch.float32)
    r_eff = min(r, nlist)
    cand, d2 = _assign_with_cands(rows, centroids, (centroids * centroids).sum(1), r_eff)
    cap_vec = torch.full((nlist,), cap, dtype=torch.int64, device=cand.device)
    valid = torch.ones((n,), dtype=torch.bool, device=cand.device)
    assign, moved = _spill(cand, d2, cap_vec, valid, nlist, r_eff)
    return assign.to(torch.int32), moved


def capped_assign_incremental(new_rows, centroids, base_counts, cap: int, r: int = 16,
                              valid=None, n_valid: int | None = None):
    """Capacity-capped assignment of NEW rows into lists that already hold
    base_counts rows (each <= cap): staged rows never move, new rows take
    the remaining space cap - base_count per list, by the same policy.
    valid: optional (n_new,) bool (padding rows of a fixed-capacity buffer;
    their assignments are meaningless); n_valid: the real row count for
    the capacity check. Returns (assign (n_new,) int32, moved); raises if
    the remaining capacity cannot hold the valid rows."""
    n_new = int(new_rows.shape[0])
    nlist = int(centroids.shape[0])
    base_counts = np.asarray(base_counts, np.int64)
    need = n_valid if n_valid is not None else n_new
    free_total = int((cap - np.minimum(base_counts, cap)).sum())
    if free_total < need:
        raise ValueError(
            f"pad_cap={cap} cannot place {need} new rows: only "
            f"{free_total} free slots remain across {nlist} lists"
        )
    centroids = centroids.to(torch.float32)
    dev = centroids.device
    r_eff = min(r, nlist)
    cand, d2 = _assign_with_cands(new_rows, centroids, (centroids * centroids).sum(1), r_eff)
    cap_vec = torch.from_numpy(np.maximum(cap - base_counts, 0)).to(dev)
    valid = (torch.ones((n_new,), dtype=torch.bool, device=dev) if valid is None
             else valid.to(device=dev, dtype=torch.bool))
    assign, moved = _spill(cand, d2, cap_vec, valid, nlist, r_eff)
    return assign.to(torch.int32), moved


# -- shape-stable tail fold (incremental restage) ----------------------------------------
#
# A fold scatters ONLY the tail rows into the existing canvases, at each
# list's HIGH-WATER MARK (max occupied slot + 1), not its live count:
# in-place removals leave holes that a count-based append would collide
# with. Appended rows are not id-sorted inside their lists; the scan
# kernels order candidates by (distance, id), so results do not depend on
# slot order.


def list_hwm(li: torch.Tensor) -> torch.Tensor:
    """Per-list high-water mark: one past the last occupied slot."""
    slot = torch.arange(1, li.shape[1] + 1, device=li.device)[None, :]
    return torch.where(li >= 0, slot, 0).max(dim=1).values


def fold_rank(tassign, tids, hwm, nlist: int):
    """Tail (assign, ids) + per-list high-water marks -> append layout
    (order, lists, slots, new_hwm). Invalid tail rows (ids < 0) map to
    list nlist, which fold_scatter drops."""
    valid = tids >= 0
    a = torch.where(valid, tassign.to(torch.int64), nlist)
    order = torch.argsort(a, stable=True)
    sa = a[order]
    starts = torch.searchsorted(sa, torch.arange(nlist + 1, device=a.device))
    rank = torch.arange(a.shape[0], device=a.device) - starts[torch.clamp(sa, 0, nlist)]
    slots = hwm[torch.clamp(sa, 0, nlist - 1)] + rank
    new_hwm = hwm + torch.diff(starts)
    return order, sa, slots, new_hwm


def grow_pad(canvas, pad_new: int, fill: float = 0.0):
    """Grow a (nlist, pad[, width]) canvas along the slot axis."""
    pad_old = canvas.shape[1]
    if pad_new == pad_old:
        return canvas
    shape = (canvas.shape[0], pad_new) + tuple(canvas.shape[2:])
    out = torch.full(shape, fill, dtype=canvas.dtype, device=canvas.device)
    out[:, :pad_old] = canvas
    return out


def fold_scatter(canvas, values, order, lists, slots):
    """Scatter tail values into a canvas at the fold layout, IN PLACE;
    rows with lists == nlist (invalid) are dropped. Returns the canvas."""
    keep = lists < canvas.shape[0]
    canvas[lists[keep], slots[keep]] = values[order][keep].to(canvas.dtype)
    return canvas


def rows_sqn(vecs):
    v32 = vecs.to(torch.float32)
    return (v32 * v32).sum(dim=1)


def sq8_encode_rows(vecs, scale):
    """Encode rows under an EXISTING per-dimension SQ8 scale (values past
    the scale's range clip at +-127; the exact rerank absorbs the
    shortlist error). Returns (codes int8, decoded-space norms)."""
    codes = torch.clamp(torch.round(vecs.to(torch.float32) / scale), -127, 127)
    dec = codes * scale
    return codes.to(torch.int8), (dec * dec).sum(dim=1)


def canvas_id_lookup(li, max_id: int):
    """The dense external-id -> bucket-row table, straight from the
    (nlist, pad) id canvas (ids are unique)."""
    cap_ids = next_pow2(max(int(max_id) + 1, 1))
    flat = li.reshape(-1).to(torch.int64)
    rows = torch.arange(flat.shape[0], dtype=torch.int32, device=li.device)
    table = torch.zeros((cap_ids,), dtype=torch.int32, device=li.device)
    live = flat >= 0
    table[flat[live]] = rows[live]
    return ("dense", table)


# -- in-place id removal ---------------------------------------------------------------------


def removal_table(removed_ids, device) -> torch.Tensor:
    """(cap,) bool marking removed external ids; negatives ignored."""
    if not is_device_array(removed_ids):
        removed_ids = torch.from_numpy(np.array(removed_ids, np.int64))
    removed = removed_ids.to(device=device, dtype=torch.int64).reshape(-1)
    max_id = int(removed.max()) if removed.numel() else -1
    table = torch.zeros((next_pow2(max(max_id + 1, 1)),), dtype=torch.bool, device=device)
    table[removed[removed >= 0]] = True
    return table


def apply_removal(ids, table, *norms):
    """Mask removed ids out of an id canvas (any shape): ids -> -1 and each
    accompanying norms operand -> +inf (the kernels' exclusion marker,
    made permanent). Live ids past the table's end are never clip-aliased
    onto its last slot. Returns (new_ids, removed_count, *new_norms)."""
    cap = table.shape[0]
    safe = torch.clamp(ids.to(torch.int64), 0, cap - 1)
    hit = table[safe] & (ids >= 0) & (ids < cap)
    new_ids = torch.where(hit, -1, ids)
    return (new_ids, int(hit.sum())) + tuple(torch.where(hit, torch.inf, nm) for nm in norms)


# -- device id lookup ----------------------------------------------------------------------------


def build_id_lookup_device(ids, rows=None):
    """ops/rerank.build_id_lookup's contract from device ids: external id
    -> candidate-store row, deciding identity / dense from two scalars.
    Sparse id spaces (>64x the count) take the host builder, with the ids
    sorted first (its binary search needs them ascending)."""
    from ..ops.rerank import build_id_lookup

    n = int(ids.shape[0])
    dev = ids.device
    if n == 0:
        return ("dense", torch.zeros((1,), dtype=torch.int32, device=dev))
    ids = ids.to(torch.int64)
    max_id = int(ids.max())
    if rows is None and max_id == n - 1 and bool(
            (ids == torch.arange(n, device=dev)).all()):
        return ("identity",)
    row_arr = torch.arange(n, dtype=torch.int32, device=dev) if rows is None else rows
    if max_id + 1 <= 64 * n + 1024:
        table = torch.zeros((next_pow2(max_id + 1),), dtype=torch.int32, device=dev)
        table[ids] = row_arr.to(torch.int32)
        return ("dense", table)
    order = torch.argsort(ids)
    return build_id_lookup(ids[order].cpu().numpy(), dev, rows=row_arr[order].cpu().numpy())
