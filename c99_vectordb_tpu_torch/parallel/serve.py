"""The front end of a sharded index: one caller on the root rank, every rank
searching.

Sharded search is SPMD: every rank calls `search` with the same arguments
and takes part in the merge's collective. A service has one caller.
`ShardServer` joins the two. On the root rank, `search(queries, k)` fans
the request out (`fanout`: a broadcast of a small header, then of the
queries), runs the index's search as every rank does, and returns the
merged result on the host. Every other rank runs `follow()`, which waits
for the next request, searches, and leaves the (replicated) result on its
card without a copy to the host, until the root calls `stop()`. Mutations
(add, remove) stay SPMD: every rank calls them itself.

Under NCCL the broadcasts stay on the card; under gloo they move through
the host. A rank that dies or stops early leaves the others in a
collective, which raises there once the backend sees the loss (gloo: the
peer's connection closes) or the process group's timeout passes (NCCL's
watchdog); nothing here waits longer than that.

Span (utils/timing.span, off by default): `sharded.fanout`, the
broadcast. Counter (always on, process-wide): COUNTERS["requests"], the
search requests fanned out or received on this rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.distances import query_rows
from ..utils.timing import span

OP_STOP, OP_SEARCH = 0, 1
COUNTERS = {"requests": 0}


class ShardServer:
    """Serves `index` (a sharded index on a 1-D mesh of every rank of the
    default process group) from rank `root`."""

    def __init__(self, index, root: int = 0):
        self.index = index
        self.root = int(root)
        mesh = index.mesh
        self._device = mesh.device
        # Where a broadcast's tensors live: the card under NCCL, else the host.
        self._wire = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
        self._world = dist.get_world_size() if mesh.device_mesh is not None else 1
        self.is_root = self._world == 1 or dist.get_rank() == self.root

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        if self._world > 1:
            dist.broadcast(t, src=self.root)
        return t

    def fanout(self, queries=None, k: int = 0):
        """One request from the root to every rank. On the root: sends
        (B, k) and the (B, D) queries; elsewhere: receives them. Returns
        (queries on this rank's device, k), or None for a stop."""
        with span("sharded.fanout"):
            if self.is_root:
                op = OP_STOP if queries is None else OP_SEARCH
                q = None if queries is None else query_rows(queries, self.index.dim, self._wire)
                self._broadcast(torch.tensor([op, 0 if q is None else q.shape[0], k],
                                             dtype=torch.int64, device=self._wire))
            else:
                header = torch.empty(3, dtype=torch.int64, device=self._wire)
                op, b, k = self._broadcast(header).tolist()
                if op == OP_SEARCH:
                    q = torch.empty((b, self.index.dim), dtype=torch.float32, device=self._wire)
            if op == OP_STOP:
                return None
            q = self._broadcast(q.contiguous()).to(self._device)
            COUNTERS["requests"] += 1
            return q, k

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Root only: the index's search over every rank, as (distances (B,
        k) float32, ids (B, k) int64) on the host."""
        if not self.is_root:
            raise RuntimeError("ShardServer.search runs on the root rank; the others follow()")
        q, k = self.fanout(queries, int(k))
        return self.index.search(q, k)

    def follow(self) -> int:
        """Every rank but the root: serve requests until the root's stop();
        returns the number served."""
        if self.is_root:
            raise RuntimeError("the root rank calls search() and stop(), not follow()")
        served = 0
        while (req := self.fanout()) is not None:
            self.index.search_device(*req)
            served += 1
        return served

    def stop(self) -> None:
        """Root only: end every follower's follow() loop. Returns once every
        rank has the message (the broadcast done on the card too), so the
        ranks may leave the process group together after it."""
        if not self.is_root:
            raise RuntimeError("ShardServer.stop runs on the root rank")
        self.fanout(None)
        if self._wire.type == "cuda":
            torch.cuda.synchronize(self._wire)
