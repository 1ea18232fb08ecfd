"""Index construction shared by the API (and, in a later slice, the CLI
verbs): the engine choice and the full rebuild from the record store.
Counterpart of the JAX package's commands.py:80-186.
"""

from __future__ import annotations

import os

import numpy as np

from .constants import DIM
from .models.registry import NOT_YET_PORTED
from .utils.text import is_blank_body


def make_index(device=None):
    """Build an empty index of the configured family on `device`.

    C99VDB_INDEX = flat (default); C99VDB_SCAN_DTYPE = float32 | bfloat16 |
    int8 selects the flat scan store. The JAX package's other families
    (ivf_flat, ivf_pq, sharded_*) are not ported yet and raise."""
    kind = os.environ.get("C99VDB_INDEX", "flat").strip().lower()
    if kind == "flat":
        from .models.flat import FlatIndex

        scan_dtype = os.environ.get("C99VDB_SCAN_DTYPE", "float32").strip() or "float32"
        return FlatIndex(dim=DIM, scan_dtype=scan_dtype, device=device)
    if kind in NOT_YET_PORTED:
        raise NotImplementedError(f"index kind '{kind}' not yet ported")
    raise ValueError(f"unknown C99VDB_INDEX '{kind}'")


def build_index_from_store(bodies: list[str], device=None):
    """Embed every non-blank body in ONE batched device program and build
    a fresh index; the (n, dim) embedding is made on the device."""
    from .ops.embed import embed_texts_device

    keep_ids = [i for i, body in enumerate(bodies) if not is_blank_body(body or "")]
    index = make_index(device=device)
    if keep_ids:
        vectors = embed_texts_device([bodies[i] for i in keep_ids], device=index.device)
        index.add(vectors, np.asarray(keep_ids, dtype=np.int64))
    return index
