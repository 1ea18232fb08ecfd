"""Index construction shared by the API (and, in a later slice, the CLI
verbs): the engine choice and the full rebuild from the record store.
Counterpart of the JAX package's commands.py:63-186.
"""

from __future__ import annotations

import os

import numpy as np

from .constants import DIM
from .models.registry import NOT_YET_PORTED
from .utils.text import is_blank_body


def auto_nlist(corpus_size: int) -> int:
    """IVF cell count for a corpus when C99VDB_NLIST is unset: 4 * sqrt(N)
    rounded up to a 128 multiple (the FAISS 4-16 * sqrt(N) sizing rule;
    4096 at 1M), clamped to [64, 8192]; 64 at memo scale (<= 4096)."""
    if corpus_size <= 4096:
        return 64
    raw = 4.0 * float(corpus_size) ** 0.5
    aligned = -(-int(raw) // 128) * 128
    return min(8192, aligned)


def make_index(corpus_size: int | None = None, device=None):
    """Build an empty index of the configured family on `device`.

    C99VDB_INDEX = flat (default) | ivf_flat. C99VDB_SCAN_DTYPE = float32 |
    bfloat16 | int8 selects the scan store of both. For ivf_flat:
    C99VDB_NLIST (else auto_nlist(corpus_size) when the caller knows the
    corpus size, else 64), C99VDB_NPROBE (8), C99VDB_RERANK_DTYPE = float32 |
    bfloat16, C99VDB_PAD_CAP. The JAX package's other families (ivf_pq,
    sharded_*) are not ported yet and raise."""
    kind = os.environ.get("C99VDB_INDEX", "flat").strip().lower()
    scan_dtype = os.environ.get("C99VDB_SCAN_DTYPE", "float32").strip() or "float32"
    if kind == "flat":
        from .models.flat import FlatIndex

        return FlatIndex(dim=DIM, scan_dtype=scan_dtype, device=device)
    if kind == "ivf_flat":
        from .models.ivf_flat import IVFFlatIndex

        nlist_env = os.environ.get("C99VDB_NLIST", "").strip()
        if nlist_env:
            nlist = int(nlist_env)
        elif corpus_size is not None:
            nlist = auto_nlist(corpus_size)
        else:
            nlist = 64
        rerank_dtype = os.environ.get("C99VDB_RERANK_DTYPE", "float32").strip() or "float32"
        pad_cap_env = os.environ.get("C99VDB_PAD_CAP", "").strip()
        return IVFFlatIndex(dim=DIM, nlist=nlist,
                            nprobe=int(os.environ.get("C99VDB_NPROBE", "8")),
                            scan_dtype=scan_dtype, rerank_dtype=rerank_dtype,
                            pad_cap=int(pad_cap_env) if pad_cap_env else None,
                            device=device)
    if kind in NOT_YET_PORTED:
        raise NotImplementedError(f"index kind '{kind}' not yet ported")
    raise ValueError(f"unknown C99VDB_INDEX '{kind}'")


def build_index_from_store(bodies: list[str], device=None):
    """Embed every non-blank body in ONE batched device program and build
    a fresh index; the (n, dim) embedding is made on the device, and an IVF
    index trains on it (nlist sized from the corpus) before the add."""
    from .ops.embed import embed_texts_device

    keep_ids = [i for i, body in enumerate(bodies) if not is_blank_body(body or "")]
    index = make_index(corpus_size=len(keep_ids), device=device)
    if keep_ids:
        vectors = embed_texts_device([bodies[i] for i in keep_ids], device=index.device)
        if hasattr(index, "train") and not getattr(index, "is_trained", True):
            index.train(vectors)
        index.add(vectors, np.asarray(keep_ids, dtype=np.int64))
    return index
