"""Frozen copy of the memo store's text rules and hashed bag-of-words embedder.

A copy, not an import, of the program's tokenizer (lowercase runs of
[a-zA-Z0-9_] after whitespace collapse), its FNV-1a 64-bit token hash
(bucket = h mod dim, sign from the lowest bit), the blank-body rule and the
embed scatter and normalize, so that a later change to the program cannot
move the yardstick. The embedding is exact here: every bucket is a sum of
+-1 signs, and the rows are normalized in float64.
"""

from __future__ import annotations

import re

import numpy as np
import torch

DIM = 384
NORM_EPSILON = 1e-8

_WS_RUN = re.compile(r"\s+")
_TOKEN = re.compile(r"[a-zA-Z0-9_]+")
_FNV_OFFSET = 0xCBF29CE484B1A325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def collapse_whitespace(text: str) -> str:
    return _WS_RUN.sub(" ", text).strip()


def tokenize(text: str) -> list[str]:
    return _TOKEN.findall(collapse_whitespace(text).lower())


def is_blank_body(body: str | None) -> bool:
    return body is None or collapse_whitespace(body) == ""


def fnv1a_64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


class Hasher:
    """token -> (bucket, sign), memoized per token (a corpus repeats its
    vocabulary, so each distinct token is hashed once)."""

    def __init__(self, dim: int = DIM):
        self.dim = dim
        self._memo: dict[str, tuple[int, float]] = {}

    def feature(self, token: str) -> tuple[int, float]:
        hit = self._memo.get(token)
        if hit is None:
            h = fnv1a_64(token.encode("utf-8"))
            hit = (h % self.dim, 1.0 if (h & 1) else -1.0)
            self._memo[token] = hit
        return hit

    def features(self, texts: list[str]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flat (rows int64, buckets int64, signs float64) streams, one entry
        per token occurrence, in document order."""
        rows, buckets, signs = [], [], []
        for r, text in enumerate(texts):
            for tok in tokenize(text):
                b, s = self.feature(tok)
                rows.append(r)
                buckets.append(b)
                signs.append(s)
        return (np.asarray(rows, np.int64), np.asarray(buckets, np.int64),
                np.asarray(signs, np.float64))


def embed(texts: list[str], hasher: Hasher, device, dtype=torch.float64) -> torch.Tensor:
    """(len(texts), dim) rows in `dtype` on `device`: the bucket sums of
    signs divided by their norm, zero rows for texts without tokens. In
    float32 the steps round as the program's embedder rounds them."""
    rows, buckets, signs = hasher.features(texts)
    grid = torch.zeros((len(texts), hasher.dim), dtype=dtype, device=device)
    grid.index_put_((torch.from_numpy(rows).to(device), torch.from_numpy(buckets).to(device)),
                    torch.from_numpy(signs).to(device, dtype), accumulate=True)
    norms = torch.sqrt((grid * grid).sum(dim=1, keepdim=True))
    blank = norms <= NORM_EPSILON
    return torch.where(blank, 0.0, grid / torch.where(blank, 1.0, norms))
