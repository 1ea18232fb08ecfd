"""Deterministic token hashing for the bag-of-words embedder.

DELIBERATE DEVIATION from the reference: memo uses Python's builtin
`hash()` (reference memo_cli.py:163), which is salted per
process (PYTHONHASHSEED), so vectors written by one invocation never match
query vectors embedded by a later one — cross-process recall is broken
upstream (SURVEY.md §2.5 #1). This module replaces it with FNV-1a 64-bit,
which is deterministic across processes, platforms, and time.

The mapping token -> (bucket, sign) mirrors the reference's scheme shape:
bucket = h mod dim, sign from the lowest hash bit.

A C++ fast path (native/tokenize_hash.cc) accelerates bulk hashing during
large index builds; this module is the always-available pure-Python
reference implementation and the arbiter of correctness.
"""

from __future__ import annotations

import numpy as np

from .text import tokenize

_FNV_OFFSET = 0xCBF29CE484B1A325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a_64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def token_features(text: str, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Hash a text's tokens into (buckets, signs) feature arrays.

    Returns int32 bucket indices in [0, dim) and float32 signs in {-1, +1},
    one entry per token occurrence (duplicates intentionally retained —
    the embedder accumulates them, reference memo_cli.py:162-166).
    """
    tokens = tokenize(text)
    n = len(tokens)
    buckets = np.empty((n,), dtype=np.int32)
    signs = np.empty((n,), dtype=np.float32)
    for i, tok in enumerate(tokens):
        h = fnv1a_64(tok.encode("utf-8"))
        buckets[i] = h % dim
        signs[i] = 1.0 if (h & 1) else -1.0
    return buckets, signs


def batch_token_features(
    texts: list[str], dim: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hash a whole corpus into flat (rows, buckets, signs) feature streams.

    rows[i] is the document index of feature i; features appear in document
    order. Uses the native C++ fast path (native/tokenize_hash.cc) for
    all-ASCII corpora — byte-identical semantics there — and falls back to
    the per-document Python path otherwise.
    """
    from .. import native

    clib = native.lib()
    if clib is not None and all(t.isascii() for t in texts):
        import ctypes

        blobs = [t.encode("ascii") for t in texts]
        offsets = np.zeros((len(texts) + 1,), dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        buf = b"".join(blobs)
        n_docs = len(texts)
        counts = np.zeros((n_docs,), dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        clib.th_count_tokens(
            buf, offsets.ctypes.data_as(i64p), n_docs,
            counts.ctypes.data_as(i64p),
        )
        total = int(counts.sum())
        buckets = np.empty((total,), dtype=np.int32)
        signs = np.empty((total,), dtype=np.float32)
        rows = np.empty((total,), dtype=np.int32)
        clib.th_hash_tokens(
            buf, offsets.ctypes.data_as(i64p), n_docs, dim,
            buckets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            signs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return rows, buckets, signs

    per_doc = [token_features(t, dim) for t in texts]
    rows = (
        np.concatenate(
            [np.full((len(b),), i, dtype=np.int32) for i, (b, _) in enumerate(per_doc)]
        )
        if per_doc
        else np.zeros((0,), np.int32)
    )
    buckets = (
        np.concatenate([b for b, _ in per_doc]) if per_doc else np.zeros((0,), np.int32)
    )
    signs = (
        np.concatenate([s for _, s in per_doc]) if per_doc else np.zeros((0,), np.float32)
    )
    return rows, buckets, signs
