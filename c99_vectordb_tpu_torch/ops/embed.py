"""Batched hash bag-of-words embedding as one torch program.

Token hashing happens on the host (deterministic FNV-1a, utils/hashing.py);
one scatter-add then builds all embedding rows at once and a normalize
produces unit vectors. Counterpart of the JAX package's ops/embed.py.

Every bucket value is a sum of +-1 signs, so each entry and each squared
norm is an exact small integer in f32 whatever the summation order; the
sqrt and the division are correctly rounded, so the rows are bit-identical
to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DIM, NORM_EPSILON
from ..utils.hashing import batch_token_features
from ..utils.runtime import resolve_device


def embed_texts_device(
    texts: list[str], dim: int = DIM, device: str | torch.device | None = None
) -> torch.Tensor:
    """Embed a batch of texts, returning a (B, dim) f32 tensor ON `device`.

    Only the token features cross to the device; the (B, dim) embedding is
    built there and stays there (index families accept tensors)."""
    dev = resolve_device(device)
    if not texts:
        return torch.zeros((0, dim), dtype=torch.float32, device=dev)
    rows, buckets, signs = batch_token_features(texts, dim)
    grid = torch.zeros((len(texts), dim), dtype=torch.float32, device=dev)
    grid.index_put_(
        (
            torch.from_numpy(rows.astype(np.int64)).to(dev),
            torch.from_numpy(buckets.astype(np.int64)).to(dev),
        ),
        torch.from_numpy(signs).to(dev),
        accumulate=True,
    )
    norms = torch.sqrt((grid * grid).sum(dim=1, keepdim=True))
    blank = norms <= NORM_EPSILON
    return torch.where(blank, 0.0, grid / torch.where(blank, 1.0, norms))


def embed_texts(
    texts: list[str], dim: int = DIM, device: str | torch.device | None = None
) -> np.ndarray:
    """Embed a batch of texts into L2-normalized float32 rows (B, dim).

    Blank texts (no tokens) embed to the zero vector."""
    if not texts:
        return np.zeros((0, dim), dtype=np.float32)
    return embed_texts_device(texts, dim, device).cpu().numpy()


def embed_text(
    text: str, dim: int = DIM, device: str | torch.device | None = None
) -> np.ndarray:
    """Embed a single text into an L2-normalized float32 vector (dim,)."""
    return embed_texts([text], dim, device)[0]
