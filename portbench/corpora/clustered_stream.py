"""Clustered unit rows at a scale no one host or card holds, made chunk by
chunk on whichever device asks.

The rows of clustered.py: `centers` Gaussian centres, and each row a
centre picked uniformly plus `noise` times a Gaussian vector, normalized
to unit length. `make` holds only the seed and the spec and makes no row.
Chunk c holds rows [c * chunk_rows, (c + 1) * chunk_rows) and is drawn
from its own stream, stream_seed(seed, f"rows/{c}"), with the centres
from stream_seed(seed, "centers"); so a row does not depend on the number
of ranks or on which rank (or the reference) makes it, and on one kind of
device it is the same bits wherever it is made. Row i has id i. The query
pool is drawn the same way from stream "queries" and returned on the host
as float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.seeds import stream_seed


def _draw(spec: dict, centers: torch.Tensor, m: int, g: torch.Generator) -> torch.Tensor:
    labels = torch.randint(0, spec["centers"], (m,), generator=g, device=centers.device)
    x = torch.randn((m, spec["dim"]), generator=g, device=centers.device).mul_(spec["noise"])
    x += centers[labels]
    return x.div_(torch.linalg.vector_norm(x, dim=1, keepdim=True))


@dataclass
class StreamedCorpus:
    spec: dict
    seed: int

    @property
    def rows(self) -> int:
        return int(self.spec["rows"])

    @property
    def dim(self) -> int:
        return int(self.spec["dim"])

    @property
    def chunk_rows(self) -> int:
        return int(self.spec["chunk_rows"])

    @property
    def chunks(self) -> int:
        return -(-self.rows // self.chunk_rows)

    def centers(self, device) -> torch.Tensor:
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(self.seed, "centers"))
        return torch.randn((self.spec["centers"], self.dim), generator=g, device=device)

    def chunk(self, c: int, device) -> torch.Tensor:
        """Rows of chunk c, (m, dim) float32 on `device`."""
        if not 0 <= c < self.chunks:
            raise IndexError(f"chunk {c} of {self.chunks}")
        dev = torch.device(device)
        g = torch.Generator(device=dev)
        g.manual_seed(stream_seed(self.seed, f"rows/{c}"))
        m = min(self.chunk_rows, self.rows - c * self.chunk_rows)
        return _draw(self.spec, self.centers(dev), m, g)

    def blocks(self, device, lo: int = 0, hi: int | None = None):
        """(first row, rows) for rows [lo, hi), a chunk (or the part of one
        inside the range) at a time."""
        hi = self.rows if hi is None else hi
        for c in range(lo // self.chunk_rows, -(-hi // self.chunk_rows)):
            start = c * self.chunk_rows
            rows = self.chunk(c, device)
            a, b = max(lo - start, 0), min(hi - start, rows.shape[0])
            yield start + a, rows[a:b]

    def rank_range(self, rank: int, world: int) -> tuple[int, int]:
        """Rows [lo, hi) that rank `rank` of `world` holds: even blocks in rank order."""
        return rank * self.rows // world, (rank + 1) * self.rows // world

    def rank_chunks(self, rank: int, world: int, device):
        """The rank's (vectors, ids int64) chunks on `device`, for
        ShardedFlatIndex.add_local."""
        lo, hi = self.rank_range(rank, world)
        for start, rows in self.blocks(device, lo, hi):
            yield rows, torch.arange(start, start + rows.shape[0], dtype=torch.int64,
                                     device=rows.device)


def make(spec: dict, seed: int, device) -> StreamedCorpus:
    return StreamedCorpus(spec, int(seed))


def queries(spec: dict, n: int, seed: int, device) -> np.ndarray:
    corpus = StreamedCorpus(spec, int(seed))
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(stream_seed(seed, "queries"))
    return _draw(spec, corpus.centers(dev), n, g).cpu().numpy()
