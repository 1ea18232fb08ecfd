"""Independent random streams from one `--seed`, for any whole number."""

from __future__ import annotations

import hashlib


def stream_seed(seed: int, label: str) -> int:
    """A seed in [0, 2**63) for the stream `label` of run seed `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{label}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
