"""Index family interface.

Replaces the reference's FAISS index objects (IndexHNSWFlat wrapped in
IndexIDMap2, memo_cli.py:244-298) with a device-first family:
every index maps external int64 record ids to stored vectors, supports
incremental add, batched exact-or-approximate search returning ascending
squared-L2 (distance, id) pairs, full ranking for the recall CLI path, and
round-trips through the versioned binary state format (storage/index_io.py).
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class VectorIndex(Protocol):
    kind: str
    dim: int

    @property
    def ntotal(self) -> int: ...

    def ids(self) -> np.ndarray:
        """External ids currently stored, shape (ntotal,), int64."""
        ...

    def add(self, vectors: np.ndarray, ids: np.ndarray) -> None:
        """Append vectors (n, dim) float32 with external ids (n,) int64."""
        ...

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched search: (B, dim) -> (distances (B, k), ids (B, k)).

        Distances ascend within each row; empty slots are (+inf, -1).
        """
        ...

    def ranked_all(self, query: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Full ranking of every stored vector for one query (dim,).

        Returns (distances (ntotal,), ids (ntotal,)) ascending by
        (distance, id) — the recall CLI's k=ntotal search
        (reference memo_cli.py:288-298).
        """
        ...

    def state(self) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        """(params, arrays) for serialization."""
        ...


def next_pow2(n: int, floor: int = 8) -> int:
    cap = floor
    while cap < n:
        cap *= 2
    return cap


def list_pad(max_count: int) -> int:
    """Inverted-list padded length: pow2 up to 128, then 128-multiples
    (the JAX package's rule, so both packages stage the same canvases)."""
    if max_count <= 128:
        return next_pow2(max(max_count, 8))
    return ((max_count + 127) // 128) * 128
