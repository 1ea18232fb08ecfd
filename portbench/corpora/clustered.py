"""Clustered unit vectors made on the device from the seed.

`centers` Gaussian centres; each row is a centre picked uniformly plus
`noise` times a Gaussian vector, normalized to unit length (the shape of
an embedding corpus, where near neighbours share a topic). Queries are
drawn the same way from the same centres. Rows and queries go to the host
as float32, which is the input the program and the reference both take.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.seeds import stream_seed

CHUNK_ROWS = 1 << 17


@dataclass
class Vectors:
    rows: np.ndarray   # (n, dim) float32, unit rows; row i has id i
    ids: np.ndarray    # (n,) int64


def _draw(spec: dict, n: int, seed: int, label: str, device) -> np.ndarray:
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, "centers"))
    centers = torch.randn((spec["centers"], spec["dim"]), generator=g, device=dev)
    g.manual_seed(stream_seed(seed, label))
    out = np.empty((n, spec["dim"]), np.float32)
    for s in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - s)
        labels = torch.randint(0, spec["centers"], (m,), generator=g, device=dev)
        x = torch.randn((m, spec["dim"]), generator=g, device=dev).mul_(spec["noise"])
        x += centers[labels]
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        out[s : s + m] = x.cpu().numpy()
    return out


def make(spec: dict, seed: int, device) -> Vectors:
    rows = _draw(spec, spec["rows"], seed, "rows", device)
    return Vectors(rows, np.arange(spec["rows"], dtype=np.int64))


def queries(spec: dict, n: int, seed: int, device) -> np.ndarray:
    return _draw(spec, n, seed, "queries", device)
