"""Filtered-search mask staging (the flat slice of the JAX package's
models/devbuild.py; its IVF build helpers arrive with the IVF port).

+inf row norms ARE the scan kernel's exclusion mechanism, so filter
pushdown needs no kernel change: one masked copy of a small (n,)-sized
operand per filter, staged once and cached, scans at full speed.
"""

from __future__ import annotations

import numpy as np
import torch


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
