"""One rank of the per-rank ingest and front-end runs (ShardedFlatIndex.add_local,
parallel/serve.py ShardServer), over gloo on the CPU or NCCL on cuda:RANK.

    python tests/torch_shard_serve_worker.py --world W --rank R --store FILE --out DIR \
        [--mode cases|kill|card] [--device cpu|cuda]

mode `cases` (tests/test_torch_shard_serve.py): every rank runs the same
cases (SPMD, or through the front end: rank 0 calls, the others follow)
and writes what it got to DIR/r{R}.npz, one key per "case.name":
  - parity: a corpus fed whole (load) against the same rows ingested per
    rank (add_local) in the layout load stages, searched on the exact and
    the kernel route, the per-rank index through the front end;
  - reference: the streamed corpus (portbench/corpora/clustered_stream.py)
    split evenly, searched through the front end, scored on rank 0 by
    portbench/reference/streamed.py under the cell's limits, and the same
    with rank 1's candidates dropped from the merge (a planted fault);
  - state: ids(), reconstruct, state() and remove_ids of both indexes;
  - layout: ranks whose ids overlap, which add_local refuses everywhere.
mode `kill` (W = 2): rank 1 dies after one request; rank 0 writes whether
its next search raised. mode `card`: the reference case at the card's
size (tests/test_torch_shard_serve_cuda.py). Imports torch, numpy, the
port and portbench only.
"""

from __future__ import annotations

import argparse
import datetime
import os
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from c99_vectordb_tpu_torch.parallel import ShardedFlatIndex, ShardServer, make_mesh  # noqa: E402
from c99_vectordb_tpu_torch.parallel import sharded  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.reference.streamed import score, stream_topk  # noqa: E402

K = 10
PARITY_ROWS, PARITY_DIM = 9000, 32
CHECK = {"id_misses": 0, "dist_gap": 1e-5, "tie_tol": 2e-5}   # the cell's limits
SPEC = {"generator": "clustered_stream", "rows": 6000, "dim": 24, "centers": 16,
        "noise": 0.6, "chunk_rows": 1000}
CARD_SPEC = dict(SPEC, rows=4_000_000, dim=96, centers=1024, chunk_rows=1_000_000)
SEED = 2**31 + 11


def parity_data():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((PARITY_ROWS, PARITY_DIM)).astype(np.float32)
    q = rng.standard_normal((5, PARITY_DIM)).astype(np.float32)
    return x, np.arange(PARITY_ROWS, dtype=np.int64) * 3 + 1, q


def load_layout(n: int, world: int, rank: int) -> tuple[int, int]:
    """Rows [lo, hi) that ShardedFlatIndex.load stages on `rank` (f32)."""
    per = -(-(-(-n // world)) // 1024) * 1024
    return min(rank * per, n), min((rank + 1) * per, n)


def chunked(x, ids, lo, hi, size):
    for s in range(lo, hi, size):
        e = min(s + size, hi)
        yield torch.from_numpy(x[s:e]), torch.from_numpy(ids[s:e])


def serve(server, calls):
    """Rank 0: the calls' results through the front end, then stop; the
    others: follow until stopped."""
    if server.is_root:
        out = [server.search(q, k) for q, k in calls]
        server.stop()
        return out
    server.follow()
    return None


def streamed_index(spec, rank, world, device, mesh=None):
    corpus = harness.load_module("corpora", "clustered_stream").make(spec, SEED, device)
    index = ShardedFlatIndex(dim=spec["dim"], mesh=mesh or make_mesh(device=device))
    lo, hi = corpus.rank_range(rank, world)
    index.add_local(corpus.rank_chunks(rank, world, device), rows=hi - lo)
    pool = harness.load_module("corpora", "clustered_stream").queries(spec, 32, SEED, device)
    return corpus, index, pool


def judged(corpus, pool, d, i, device):
    ref_d, ref_i, watched, n = stream_topk(corpus.blocks(device), pool, K, device, watch=i)
    misses, gap = score(ref_d, watched, i, d, n, CHECK["tie_tol"])
    return {"misses": misses, "gap": gap, "ref_i": ref_i, "n": n}


def run_cases(world: int, rank: int, device) -> dict[str, np.ndarray]:
    res: dict[str, np.ndarray] = {}

    def put(case, **arrays):
        for name, a in arrays.items():
            res[f"{case}.{name}"] = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    # parity: whole corpus against per-rank ingest in load's layout
    x, ids, q = parity_data()
    whole = ShardedFlatIndex(dim=PARITY_DIM)
    whole.load(x, ids)
    lo, hi = load_layout(len(x), world, rank)
    local = ShardedFlatIndex(dim=PARITY_DIM)
    local.add_local(chunked(x, ids, lo, hi, 700), rows=hi - lo)
    wd, wi = whole.search(q, K)
    wkd, wki = whole._search(q, K, None, kernel_route=True)
    lkd, lki = local._search(q, K, None, kernel_route=True)
    wd3, wi3 = whole.search(q[:2], 3)
    got = serve(ShardServer(local), [(q, K), (q[:2], 3)])
    staged_w, staged_l = whole._stage(), local._stage()
    same_shard = all(torch.equal(a, b) for a, b in zip(staged_w, staged_l))
    put("parity", wd=wd, wi=wi, wkd=wkd, wki=wki, lkd=lkd, lki=lki, same_shard=same_shard,
        ntotal=local.ntotal, per=staged_l[0].shape[0])
    if got is not None:
        put("parity", ld=got[0][0], li=got[0][1], ld3=got[1][0], li3=got[1][1], wd3=wd3,
            wi3=wi3)

    # state: ids, reconstruct, state and removal agree with the whole index
    params, arrays = local.state()
    put("state", ids=local.ids(), whole_ids=whole.ids(), rec=local.reconstruct(int(ids[4321])),
        whole_rec=whole.reconstruct(int(ids[4321])), vectors=arrays["vectors"],
        state_ids=arrays["ids"], removed=local.remove_ids(ids[::7]),
        whole_removed=whole.remove_ids(ids[::7]), after=local.search(q, K)[1],
        whole_after=whole.search(q, K)[1], ntotal_after=local.ntotal)

    # reference: the streamed corpus split evenly, through the front end
    corpus, index, pool = streamed_index(SPEC, rank, world, device)
    got = serve(ShardServer(index), [(pool, K)])
    if got is not None:
        put("reference", d=got[0][0], i=got[0][1], **judged(corpus, pool, *got[0], device))
    if world > 1:
        # planted fault: rank 1's candidates never reach the merge
        real = sharded.all_gather_axis

        def drop_rank1(t, mesh, axis):
            g = real(t, mesh, axis).clone()
            kk = g.shape[2] // 2
            g[1, :, :kk] = torch.full_like(g[1, :, :kk], torch.inf, dtype=torch.float32).view(
                torch.int32)
            g[1, :, kk:] = -1
            return g

        sharded.all_gather_axis = drop_rank1
        try:
            d, i = index.search(pool, K)
        finally:
            sharded.all_gather_axis = real
        if rank == 0:
            put("fault_drop", **judged(corpus, pool, d, i, device))

    # layout: overlapping ranks are refused on every rank
    if world > 1:
        bad = ShardedFlatIndex(dim=4)
        v = np.ones((3, 4), np.float32)
        first = 0 if rank == world - 1 else 10 * rank + 10
        try:
            bad.add_local([(v, np.arange(first, first + 3))], rows=3)
            put("layout", raised="")
        except ValueError as exc:
            put("layout", raised=str(exc), ntotal=bad.ntotal)
    put("counters", **sharded.COUNTERS)
    return res


def run_kill(rank: int, device, out: Path) -> None:
    corpus, index, pool = streamed_index(SPEC, rank, 2, device)
    server = ShardServer(index)
    if rank == 1:
        req = server.fanout()
        index.search_device(*req)
        os.kill(os.getpid(), signal.SIGKILL)
    server.search(pool, K)
    t0 = time.perf_counter()
    try:
        server.search(pool, K)
        server.search(pool, K)
        raised = ""
    except Exception as exc:  # noqa: BLE001 — the error is the result
        raised = f"{type(exc).__name__}: {exc}"
    np.savez(out / "kill.npz", raised=raised, seconds=time.perf_counter() - t0)


def run_card(world: int, rank: int, device, out: Path) -> None:
    corpus, index, pool = streamed_index(CARD_SPEC, rank, world, device)
    staged = sharded.COUNTERS["staged_live_rows"]
    got = serve(ShardServer(index), [(pool, K)] * 3)
    # one id on each rank: the count is summed by an on-card all_reduce
    removed = index.remove_ids(np.arange(0, CARD_SPEC["rows"], CARD_SPEC["rows"] // 4 + 3))
    res = {"staged": staged, "backend": dist.get_backend(), "removed": removed}
    if got is not None:
        res.update(d=got[-1][0], i=got[-1][1], same=all(
            np.array_equal(a[1], got[0][1]) for a in got))
        res.update({k: v.cpu().numpy() if torch.is_tensor(v) else v
                    for k, v in judged(corpus, pool, *got[-1], device).items()})
    np.savez(out / f"card_r{rank}.npz", **res)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=("cases", "kill", "card"), default="cases")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args()
    torch.set_num_threads(1)
    device = torch.device("cpu")
    if args.device == "cuda":
        device = torch.device("cuda", args.rank)
        torch.cuda.set_device(device)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # every rank on this host
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.world, timeout=datetime.timedelta(seconds=60))
    out = Path(args.out)
    if args.mode == "kill":
        run_kill(args.rank, device, out)
        # The group lost a rank: leave without its teardown, which is not
        # what this mode tests.
        os._exit(0)
    try:
        if args.mode == "card":
            run_card(args.world, args.rank, device, out)
        else:
            np.savez(out / f"r{args.rank}.npz", **run_cases(args.world, args.rank, device))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
