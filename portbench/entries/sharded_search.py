"""Entry module: a sharded flat index over `chips` ranks, one per card,
served from rank 0 to one caller.

setup starts ranks 1 .. W-1 on cuda:1 .. cuda:W-1 (cpu under a cpu
device) as follower processes (portbench/shard_rank.py), joins the
process group as rank 0 on ctx.device (NCCL on cards, gloo on the cpu),
and every rank ingests only its own rows of the streamed corpus
(corpora/clustered_stream.py) with ShardedFlatIndex.add_local. Each call
is ShardServer.search of one batch of `batch` pool queries; the results
come back on the host. The check stops the followers, then streams the
whole corpus through reference/streamed.py on ctx.device once for every
sampled query.

Every exit path of the run ends the followers: check() stops them
cleanly; an exit handler ends any still running (terminate, then kill);
each follower dies with this process (PR_SET_PDEATHSIG); and a follower
that ends before it was stopped ends this process at once. Fails before
it starts any process where the port lacks the per-rank ingest or the
front end.
"""

from __future__ import annotations

import atexit
import datetime
import json
import os
import resource
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from portbench import harness
from portbench.reference.streamed import StreamedControl, score, stream_topk
from portbench.seeds import stream_seed

FOLLOWER = Path(__file__).resolve().parent.parent / "shard_rank.py"
# The process group's timeout: the longest any rank waits in a collective
# for the others (kernel builds on a first run included).
TIMEOUT_S = 300
JOIN_S = 60


@dataclass
class Request:
    rows: np.ndarray       # pool rows of the batch
    queries: np.ndarray    # (batch, dim) float32
    k: int


def _port():
    """The port's sharded index, mesh and front end; raises where the port
    lacks the per-rank ingest (ShardedFlatIndex.add_local) or the front
    end (parallel/serve.py)."""
    from c99_vectordb_tpu_torch.parallel import sharded
    from c99_vectordb_tpu_torch.parallel.mesh import make_mesh

    try:
        from c99_vectordb_tpu_torch.parallel.serve import ShardServer
    except ImportError as exc:
        raise RuntimeError("this port has no parallel/serve.py ShardServer (the front end "
                           "of a sharded index)") from exc
    if not hasattr(sharded.ShardedFlatIndex, "add_local"):
        raise RuntimeError("this port's ShardedFlatIndex has no add_local (per-rank ingest)")
    return sharded, make_mesh, ShardServer


def peak_rss_mib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def build_rank(spec: dict, seed: int, rank: int, world: int, device):
    """One rank's part, on every rank: the index on a mesh of every rank,
    this rank's rows ingested; returns (ShardServer, live rows the ingest
    staged here, by the program's counter)."""
    sharded, make_mesh, ShardServer = _port()
    corpus = harness.load_module("corpora", spec["corpus"]["generator"]).make(
        spec["corpus"], seed, device)
    params = spec["system"]["params"]
    index = sharded.ShardedFlatIndex(**params, mesh=make_mesh(device=device))
    lo, hi = corpus.rank_range(rank, world)
    before = sharded.COUNTERS["staged_live_rows"]
    index.add_local(corpus.rank_chunks(rank, world, device), rows=hi - lo)
    return ShardServer(index), sharded.COUNTERS["staged_live_rows"] - before


def init_group(device: torch.device, rank: int, world: int, port: int) -> None:
    """Join the run's process group; every rank is on this host, so NCCL's
    bootstrap takes the loopback interface unless told otherwise."""
    import torch.distributed as dist

    if device.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """Rank 0's view of the run: the followers, the server, the group."""

    def __init__(self):
        self.procs: list[subprocess.Popen] = []
        self.server = None
        self.staged = 0
        self.stopping = False
        self.group = False

    def start(self, spec: dict, seed: int, world: int, device: torch.device) -> None:
        self.end()
        self.stopping = False
        port = _free_port()
        kind = "cuda" if device.type == "cuda" else "cpu"
        self.procs = [subprocess.Popen(
            [sys.executable, str(FOLLOWER), "--rank", str(r), "--world", str(world),
             "--port", str(port), "--seed", str(seed), "--device", kind, "--spec",
             json.dumps(spec)], stdout=sys.stderr.fileno(), stdin=subprocess.DEVNULL)
            for r in range(1, world)]
        threading.Thread(target=self._watch, args=(self.procs,), daemon=True).start()
        init_group(device, 0, world, port)
        self.group = True

    def _watch(self, procs) -> None:
        """A follower that ends before the stop leaves this rank waiting
        in a collective: end the run at once."""
        while not self.stopping and procs is self.procs:
            for r, p in enumerate(procs, 1):
                if p.poll() is not None and not self.stopping:
                    print(f"portbench: shard rank {r} ended (exit {p.returncode}) before it was "
                          f"stopped", file=sys.stderr, flush=True)
                    os._exit(1)
            time.sleep(0.2)

    def stop(self) -> None:
        """The clean end: the followers leave their loop, every rank leaves
        the process group at once (its teardown may wait for the other
        ranks'), the followers exit, and the index is dropped. Raises if a
        follower or this rank's teardown does not end within JOIN_S."""
        if self.server is None:
            return
        self.stopping = True
        self.server.stop()
        self.server = None
        leave = threading.Thread(target=self._leave, daemon=True)
        leave.start()
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=JOIN_S))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        self.procs = []
        leave.join(JOIN_S)
        bad = [f"shard rank {r} exited with {rc}" for r, rc in enumerate(codes, 1) if rc != 0]
        if leave.is_alive():
            bad.append(f"rank 0 did not leave the process group within {JOIN_S} s")
        if bad:
            raise RuntimeError("; ".join(bad))

    def _leave(self) -> None:
        if self.group:
            import torch.distributed as dist

            dist.destroy_process_group()
            self.group = False

    def end(self) -> None:
        """The exit handler: end any follower still running."""
        self.stopping = True
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.procs = []


RANKS = Ranks()
atexit.register(RANKS.end)


def _spec(ctx) -> dict:
    return {"corpus": ctx.config["corpus"], "system": ctx.config["system"]}


def setup(ctx):
    _port()
    RANKS.start(_spec(ctx), ctx.seed, ctx.cell.chips, ctx.device)
    RANKS.server, RANKS.staged = build_rank(_spec(ctx), ctx.seed, 0, ctx.cell.chips, ctx.device)
    return RANKS.server


def control(ctx):
    return StreamedControl(lambda: ctx.corpus.blocks(ctx.device), ctx.device)


def requests(ctx) -> list[Request]:
    t = ctx.traffic
    order = np.random.default_rng(stream_seed(ctx.seed, "order")).permutation(t["pool"])
    return [Request(rows, np.ascontiguousarray(ctx.pool[rows]), t["k"])
            for rows in order.reshape(-1, t["batch"])]


def call(server, req: Request):
    return server.search(req.queries, req.k)


def size(req: Request) -> int:
    return len(req.rows)


def span_points(server):
    sharded, _, _ = _port()
    return [(server, "search", "search"), (server, "fanout", "fanout"),
            (sharded, "_merge_axes", "merge")]


def work(server, ctx) -> dict:
    t = ctx.traffic
    return {"shard": {"rows": RANKS.staged, "dim": server.index.dim, "batch": t["batch"],
                      "k": t["k"], "dtype": server.index.scan_dtype}}


def check(ctx, samples) -> dict:
    """Stops the followers, then the exact top-k of a seeded subset of the
    sampled calls' queries over the whole corpus, in one streamed pass."""
    RANKS.stop()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"portbench: rank 0 peak host RSS {peak_rss_mib():.1f} MiB", file=sys.stderr)
    t, lim = ctx.traffic, ctx.config["check"]
    rows = np.concatenate([req.rows for _, req, _ in samples])
    ids = np.concatenate([np.asarray(out[1]) for _, _, out in samples])
    dists = np.concatenate([np.asarray(out[0]) for _, _, out in samples])
    rng = np.random.default_rng(stream_seed(ctx.seed, "check-queries"))
    pick = np.sort(rng.permutation(len(rows))[: t["check_queries"]])
    ref_d, _, watched, n = stream_topk(ctx.corpus.blocks(ctx.device), ctx.pool[rows[pick]],
                                       t["k"], ctx.device, watch=ids[pick])
    if n != ctx.corpus.rows:
        raise RuntimeError(f"the reference saw {n} rows of {ctx.corpus.rows}")
    misses, gap = score(ref_d, watched, ids[pick], dists[pick], n, lim["tie_tol"])
    return {"id_misses": (misses, lim["id_misses"]), "dist_gap": (gap, lim["dist_gap"])}
