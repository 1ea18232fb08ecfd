"""Index-kind registry: serialized `kind` string -> index class."""

from __future__ import annotations

from typing import Any

_REGISTRY: dict[str, Any] = {}


def register(cls: Any) -> Any:
    _REGISTRY[cls.kind] = cls
    return cls


def resolve(kind: str) -> Any:
    from . import flat, ivf_flat, ivf_pq  # noqa: F401  (registers the built-in kinds)
    from ..parallel import sharded  # noqa: F401

    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"unknown index kind '{kind}'") from None
