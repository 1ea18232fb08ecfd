"""Exact squared-L2 distances in float64, the TF32 control, and the
comparison of returned top-k lists against them.

Plain PyTorch. The rows are the inputs the benchmark made (never a tensor
the program staged); they go to the device in blocks and are held there in
float64, so every distance is exact to about 1e-15.
"""

from __future__ import annotations

import numpy as np
import torch

UPLOAD_ROWS = 1 << 17


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _rows_on(rows, device, dtype) -> torch.Tensor:
    if isinstance(rows, torch.Tensor):
        return rows.to(device=device, dtype=dtype)
    out = torch.empty((rows.shape[0], rows.shape[1]), dtype=dtype, device=device)
    for s in range(0, rows.shape[0], UPLOAD_ROWS):
        out[s : s + UPLOAD_ROWS] = torch.from_numpy(
            np.ascontiguousarray(rows[s : s + UPLOAD_ROWS])).to(device=device, dtype=dtype)
    return out


class ExactStore:
    """The rows in float64; distances by ||q||^2 + ||x||^2 - 2 q.x in float64."""

    def __init__(self, rows, device, excluded=None):
        self.x = _rows_on(rows, device, torch.float64)
        self.sq = (self.x * self.x).sum(1)
        # Rows no answer may name (memo's blank bodies): +inf distance.
        self.excluded = excluded

    def distances(self, queries) -> torch.Tensor:
        q = _rows_on(queries, self.x.device, torch.float64)
        d = ((q * q).sum(1, keepdim=True) + self.sq[None, :] - 2.0 * (q @ self.x.T)).clamp_min_(0.0)
        if self.excluded is not None:
            d[:, self.excluded] = torch.inf
        return d


class Tf32Store(ExactStore):
    """The control: the same formula with its product in TF32 (operands
    rounded to a 10-bit mantissa, float32 sums), norms in float32."""

    def __init__(self, rows, device, excluded=None):
        x = _rows_on(rows, device, torch.float32)
        self.x = tf32(x)
        self.sq = (x * x).sum(1)
        self.excluded = excluded

    def distances(self, queries) -> torch.Tensor:
        q = _rows_on(queries, self.x.device, torch.float32)
        d = ((q * q).sum(1, keepdim=True) + self.sq[None, :] - 2.0 * (tf32(q) @ self.x.T)).clamp_min_(0.0)
        if self.excluded is not None:
            d[:, self.excluded] = torch.inf
        return d


def topk(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, positions) of the k smallest of each row, ascending."""
    return torch.topk(dist, k, dim=1, largest=False, sorted=True)


def score_lists(dist64: torch.Tensor, got_ids: np.ndarray, got_d: np.ndarray, k: int,
                tie_tol: float) -> tuple[int, float]:
    """Judge returned lists against exact distances.

    dist64: (Q, n) exact distances of Q queries to every row (row = id);
    got_ids, got_d: (Q, k) the returned ids (-1 where none) and distances.
    A slot is missed when its id is absent, out of range or repeated in the
    list, or when the id's exact distance differs from the exact k-list's
    distance at that slot by more than tie_tol (so swaps among ties within
    tie_tol pass). Returns (slots missed, the largest |returned distance -
    exact distance of the returned id| over the slots not missed by id)."""
    n = dist64.shape[1]
    dev = dist64.device
    ref_d, _ = topk(dist64, k)
    ids = torch.from_numpy(np.asarray(got_ids, np.int64)).to(dev)
    got = torch.from_numpy(np.asarray(got_d, np.float64)).to(dev)
    valid = (ids >= 0) & (ids < n)
    srt, order = torch.sort(torch.where(valid, ids, -1 - torch.arange(k, device=dev)), dim=1)
    dup_sorted = torch.zeros_like(valid)
    dup_sorted[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
    dup = torch.zeros_like(valid).scatter_(1, order, dup_sorted)
    valid &= ~dup
    true = dist64.gather(1, ids.clamp(0, n - 1))
    missed = ~valid | ~((true - ref_d).abs() <= tie_tol)
    gap = torch.where(valid, (got - true).abs(), torch.zeros_like(got))
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, torch.inf), gap)
    return int(missed.sum()), float(gap.max()) if gap.numel() else 0.0


class SearchControl:
    """The control with FlatIndex.search's surface: exact top-k of the TF32
    distances, returned to the host."""

    def __init__(self, rows, device):
        self.store = Tf32Store(rows, device)

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        vals, pos = topk(self.store.distances(queries), k)
        return vals.cpu().numpy(), pos.cpu().numpy().astype(np.int64)
