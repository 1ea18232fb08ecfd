"""One rank of the port's 8-process (host 2, chip 4) mesh check (gloo).

    python tests/torch_multiprocess_worker.py --world 8 --rank R --store FILE --out DIR

The torch.distributed twin of benchmarks/mp_worker.py: eight OS processes
form a ("host", "chip") = (2, 4) mesh, so the `host` merge crosses process
groups as a multi-host job's does. Every rank makes the same global arrays
from one seed, takes its own row shard (row-major over (host, chip), as
a JAX P(("host", "chip")) sharding deals them) and runs
sharded_search_2level, then the two-level ShardedIVFPQIndex and, for
comparison, the same index on a 1-D mesh of the 8 ranks. Each rank checks
the replicated results against a numpy oracle, prints "PARITY OK" and
writes them to DIR/r{R}.npz. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from c99_vectordb_tpu_torch.parallel import (  # noqa: E402
    ShardedIVFPQIndex, make_host_chip_mesh, make_mesh, sharded_search_2level,
)
from c99_vectordb_tpu_torch.parallel.sharded import shard_rows  # noqa: E402

N, DIM, B, K = 4096, 64, 4, 5


def data():
    """benchmarks/mp_worker.py's global arrays (seed 0)."""
    rng = np.random.default_rng(0)
    db = rng.standard_normal((N, DIM)).astype(np.float32)
    queries = rng.standard_normal((B, DIM)).astype(np.float32)
    return db, np.arange(N, dtype=np.int32), queries


def oracle(db, queries, k):
    exact = ((queries[:, None, :].astype(np.float64) - db[None, :, :]) ** 2).sum(-1)
    return np.sort(exact, axis=1)[:, :k], np.argsort(exact, axis=1, kind="stable")[:, :k]


def run(rank: int) -> dict[str, np.ndarray]:
    db, ids, queries = data()
    hmesh = make_host_chip_mesh(2, 4, device="cpu")
    assert hmesh.shape == {"host": 2, "chip": 4}
    axes = ("host", "chip")
    t = torch.from_numpy
    sq = np.einsum("nd,nd->n", db, db).astype(np.float32)
    d, i = sharded_search_2level(hmesh, t(shard_rows(db, hmesh, axes)),
                                 t(shard_rows(ids, hmesh, axes)), t(shard_rows(sq, hmesh, axes)),
                                 t(queries), K)
    want_d, want_i = oracle(db, queries, K)
    assert np.array_equal(i.numpy(), want_i), f"rank {rank}: 2-level ids {i} vs {want_i}"
    assert np.allclose(d.numpy(), want_d, rtol=1e-4, atol=1e-4), f"rank {rank}: 2-level dists"

    out = {"flat_d": d.numpy(), "flat_i": i.numpy()}
    for name, mesh in (("pq2", hmesh), ("pq1", make_mesh(n_data=8, device="cpu"))):
        pq = ShardedIVFPQIndex(dim=DIM, nlist=16, nprobe=16, m=8, refine_factor=16, mesh=mesh)
        pq.load(db, ids.astype(np.int64))
        pd, pi = pq.search(queries, K)
        true = ((queries[:, None, :].astype(np.float64) - db[pi]) ** 2).sum(-1)
        assert (pi >= 0).all() and np.allclose(pd, true, rtol=1e-5, atol=1e-5), (
            f"rank {rank}: {name} distances are not the exact ones")
        out[f"{name}_d"], out[f"{name}_i"] = pd, pi
        out[f"{name}_shards"] = np.asarray(pq.scan_rows_per_chip(B)["shards"])
    assert np.array_equal(out["pq2_i"], out["pq1_i"]) and np.array_equal(out["pq2_d"],
                                                                          out["pq1_d"])
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.world, timeout=datetime.timedelta(seconds=120))
    try:
        res = run(args.rank)
        np.savez(Path(args.out) / f"r{args.rank}.npz", **res)
        print(f"PARITY OK (rank {args.rank}/{args.world})", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
