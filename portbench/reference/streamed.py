"""Exact top-k over a corpus that arrives in blocks, for corpora no card
holds whole: the float64 reference of the sharded cells, its TF32 control,
and the judgement of returned lists. Plain PyTorch; imports torch and
numpy only, nothing of the port.

The caller hands over (first row, rows) blocks that cover the corpus in
row order, row i having id i (the corpus generator makes them again from
the seed, on one device). One pass takes every block to float64 and
gives, for all queries at once, each query's exact top-k by (distance,
id) and the exact distance of each id a program returned (`watch`).
`score` judges returned lists as reference/exact.py's score_lists does,
from those distances instead of a full (Q, n) matrix.
"""

from __future__ import annotations

import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _distances(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """(Q, m) squared L2 distances as float64. "float64": every operand in
    float64 (exact to about 1e-15 on unit rows); "tf32": the control, the
    product of TF32-rounded operands with float32 sums and float32 norms."""
    if precision == "float64":
        x = x.to(torch.float64)
        q = q.to(torch.float64)
        d = (q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :] - 2.0 * (q @ x.T)
    elif precision == "tf32":
        x = x.to(torch.float32)
        q = q.to(torch.float32)
        d = (q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :] - 2.0 * (tf32(q) @ tf32(x).T)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return d.clamp_min_(0.0).to(torch.float64)


def _block_topk(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of each row's k smallest by (value, position)."""
    kk = min(k, d.shape[1])
    vals, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
    # A value tied with the k-th may sit at a lower position outside the
    # pick: such rows take a stable sort instead.
    edge = vals[:, -1:]
    short = (d == edge).sum(1) > (vals == edge).sum(1)
    for r in short.nonzero().flatten().tolist():
        v, p = torch.sort(d[r], stable=True)
        vals[r], pos[r] = v[:kk], p[:kk]
    return vals, pos


def _merge(d: torch.Tensor, i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest candidates of each row by (distance, id)."""
    by_id = torch.argsort(i, dim=1, stable=True)
    d, i = d.gather(1, by_id), i.gather(1, by_id)
    by_d = torch.argsort(d, dim=1, stable=True)[:, :k]
    return d.gather(1, by_d), i.gather(1, by_d)


def stream_topk(blocks, queries, k: int, device, watch=None, precision: str = "float64"):
    """One pass over `blocks` ((first row, (m, D) rows) in row order).

    Returns (dists (Q, k) float64 ascending, ids (Q, k) int64, watched, n):
    the exact top-k by (distance, id) with (inf, -1) past the rows seen;
    watched, for `watch` (Q, W) ids, each id's distance (inf for an id no
    block holds), else None; n the rows seen."""
    dev = torch.device(device)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    nq = q.shape[0]
    best_d = torch.full((nq, k), torch.inf, dtype=torch.float64, device=dev)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    w = None if watch is None else torch.as_tensor(np.asarray(watch, np.int64)).to(dev)
    watched = None if w is None else torch.full(w.shape, torch.inf, dtype=torch.float64,
                                                device=dev)
    n = 0
    for start, rows in blocks:
        d = _distances(q, rows.to(dev), precision)
        m = d.shape[1]
        vals, pos = _block_topk(d, k)
        best_d, best_i = _merge(torch.cat([best_d, vals], 1),
                                torch.cat([best_i, pos + start], 1), k)
        if w is not None:
            inside = (w >= start) & (w < start + m)
            at = torch.where(inside, w - start, 0)
            watched = torch.where(inside, d.gather(1, at), watched)
        n = max(n, start + m)
    return best_d, best_i, watched, n


def score(ref_d: torch.Tensor, watched: torch.Tensor, got_ids, got_d, n: int,
          tie_tol: float) -> tuple[int, float]:
    """Judge returned lists: ref_d (Q, k) the exact k-lists' distances,
    watched (Q, k) the exact distance of each returned id (stream_topk's
    `watched` for watch=got_ids), got_ids and got_d (Q, k) the returned
    ids (-1 where none) and distances. A slot is missed when its id is
    absent, out of range or repeated in the list, or when the id's exact
    distance differs from the k-list's at that slot by more than tie_tol.
    Returns (slots missed, the largest |returned - exact distance of the
    returned id| over the slots not missed by id)."""
    dev = ref_d.device
    k = ref_d.shape[1]
    ids = torch.as_tensor(np.asarray(got_ids, np.int64)).to(dev)
    got = torch.as_tensor(np.asarray(got_d, np.float64)).to(dev)
    valid = (ids >= 0) & (ids < n)
    srt, order = torch.sort(torch.where(valid, ids, -1 - torch.arange(k, device=dev)), dim=1)
    dup_sorted = torch.zeros_like(valid)
    dup_sorted[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    valid &= ~torch.zeros_like(valid).scatter_(1, order, dup_sorted)
    missed = ~valid | ~((watched - ref_d).abs() <= tie_tol)
    gap = torch.where(valid, (got - watched).abs(), torch.zeros_like(got))
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, torch.inf), gap)
    return int(missed.sum()), float(gap.max()) if gap.numel() else 0.0


class StreamedControl:
    """The control with a search's surface: each call streams the whole
    corpus (`blocks()` gives a fresh pass) and returns the exact top-k of
    the TF32 distances on the host."""

    def __init__(self, blocks, device):
        self.blocks = blocks
        self.device = torch.device(device)

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        d, i, _, _ = stream_topk(self.blocks(), queries, k, self.device, precision="tf32")
        return d.to(torch.float32).cpu().numpy(), i.cpu().numpy()
