"""Index-kind registry: serialized `kind` string -> index class."""

from __future__ import annotations

from typing import Any

_REGISTRY: dict[str, Any] = {}

# Kinds the JAX package writes that the port cannot read yet. A file of
# one of these kinds must fail loudly: silently substituting an empty
# index would lose the user's data from view.
NOT_YET_PORTED = ("ivf_pq", "sharded_flat", "sharded_ivf", "sharded_ivf_pq")


def register(cls: Any) -> Any:
    _REGISTRY[cls.kind] = cls
    return cls


def resolve(kind: str) -> Any:
    from . import flat, ivf_flat  # noqa: F401  (registers the built-in kinds)

    try:
        return _REGISTRY[kind]
    except KeyError:
        if kind in NOT_YET_PORTED:
            raise NotImplementedError(f"index kind '{kind}' not yet ported") from None
        raise ValueError(f"unknown index kind '{kind}'") from None
