"""One rank of the sharded flat index's CPU parity runs (gloo).

    python tests/torch_parallel_worker.py --world W --rank R --store FILE --out DIR \
        [--jax-files DIR]

Every rank runs the same cases (SPMD) on numpy inputs made from the seeds
of tests/test_parallel.py and writes what it got to DIR/r{R}.npz, one key
per "case.name"; tests/test_torch_parallel.py holds those results against
the JAX package's ShardedFlatIndex on a mesh of W of its virtual devices.
At W = 4 the two-level (2 x 2 host x chip) and 2-D (2 data x 2 model)
cases run too. DIR/port_w{W}_{dtype}.memo are files written at W ranks;
--jax-files names a directory of files the JAX package wrote at 8 devices,
which every rank loads. The ranks run on the device C99VDB_PLATFORM names
(every rank on cuda:0 for `cuda`: tests/test_torch_sharded_cuda.py), and
"launches.*" are the flat kernel's launches by mode. Imports torch and the
port only.
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

from c99_vectordb_tpu_torch.ops import topk_cuda  # noqa: E402
from c99_vectordb_tpu_torch.parallel import (  # noqa: E402
    ShardedFlatIndex, make_host_chip_mesh, make_mesh, sharded_search_2d,
    sharded_search_2level, sharded_search_kernels, sharded_search_program,
)
from c99_vectordb_tpu_torch.parallel.sharded import shard_rows  # noqa: E402
from c99_vectordb_tpu_torch.storage.index_io import read_index, write_index  # noqa: E402
from c99_vectordb_tpu_torch.utils.runtime import resolve_device  # noqa: E402

K = 10


def corpus():
    """tests/test_parallel.py's corpus: 1000 x 64 Gaussian rows, ids 0..999,
    6 queries."""
    rng = np.random.default_rng(11)
    vectors = rng.standard_normal((1000, 64)).astype(np.float32)
    queries = rng.standard_normal((6, 64)).astype(np.float32)
    return vectors, np.arange(1000, dtype=np.int64), queries


def third_mask():
    m = np.zeros(1000, bool)
    m[::3] = True
    return m


def padded(vectors, ids, n=1024):
    """The standalone programs' (n, 64) store: rows, -1 padding ids, norms."""
    db = np.zeros((n, vectors.shape[1]), np.float32)
    db[: len(vectors)] = vectors
    idp = np.full((n,), -1, np.int32)
    idp[: len(ids)] = ids.astype(np.int32)
    return db, idp, np.einsum("nd,nd->n", db, db).astype(np.float32)


def tie_rows():
    return np.ones((64, 16), np.float32), np.arange(64, dtype=np.int64)


def tiny_rows():
    rng = np.random.default_rng(1)
    return rng.standard_normal((3, 16)).astype(np.float32), np.arange(3, dtype=np.int64)


def run_cases(world: int, out: Path, jax_files: Path | None) -> dict[str, np.ndarray]:
    res: dict[str, np.ndarray] = {}

    def put(case, **arrays):
        for name, a in arrays.items():
            res[f"{case}.{name}"] = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    x, ids, q = corpus()
    mask = third_mask()
    device = resolve_device()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731

    # TestShardedSearch
    idx = ShardedFlatIndex(dim=64)
    idx.load(x, ids)
    d, i = idx.search(q, K)
    kd, ki = idx._search(q, K, None, kernel_route=True)
    put("search", d=d, i=i, kd=kd, ki=ki, shards=idx._shards, per=idx._stage()[0].shape[0])
    small = ShardedFlatIndex(dim=64)
    small.load(x[:20], ids[:20])
    put("k_spanning", **dict(zip(("d", "i"), small.search(x[:1], k=30))))
    tv, tids = tie_rows()
    tie = ShardedFlatIndex(dim=16)
    tie.load(tv, tids)
    put("tie", i=tie.search(tv[:1], k=8)[1])
    empty = ShardedFlatIndex(dim=16)
    put("empty", **dict(zip(("d", "i"), empty.search(np.zeros((2, 16), np.float32), k=3))))
    tx, tid = tiny_rows()
    few = ShardedFlatIndex(dim=16)
    few.add(tx, tid)
    fd, fi = few.search(np.zeros((1, 16), np.float32), k=7)
    kfd, kfi = few._search(np.zeros((1, 16), np.float32), 7, None, kernel_route=True)
    put("k_exceeds", d=fd, i=fi, kd=kfd, ki=kfi)

    # TestSlotSharding (flat): the kernel routes, as programs and as the index
    db, idp, sq = idx._stage()
    ks = min(2 * K, db.shape[0], 1024)
    pd, pi = sharded_search_kernels(idx.mesh, db, sq, None, db, idp, t(q), K, ks)
    put("kernels_program", d=pd, i=pi)
    sq8 = ShardedFlatIndex(dim=64, scan_dtype="int8")
    sq8.load(x, ids)
    d, i = sq8.search(q, K)
    kd, ki = sq8._search(q, K, None, kernel_route=True)
    db8, idp8, _, codes, dec_sq, scale = sq8._stage()
    pd, pi = sharded_search_kernels(sq8.mesh, codes, dec_sq, scale, db8, idp8, t(q), K,
                                    min(2 * K, db8.shape[0]))
    md, mi = sq8._search(q, K, mask, kernel_route=True)
    put("sq8", d=d, i=i, kd=kd, ki=ki, pd=pd, pi=pi, md=md, mi=mi, scale=scale,
        per=db8.shape[0])

    # TestShardedSerialization (flat): files at W ranks, read back at W
    for dt, index in (("float32", idx), ("int8", sq8)):
        path = out / f"port_w{world}_{dt}.memo"
        if dist.get_rank() == 0:
            write_index(index, path)
        dist.barrier()
        loaded = read_index(path)
        put(f"roundtrip_{dt}", kind=loaded.kind, scan_dtype=loaded.scan_dtype,
            ntotal=loaded.ntotal, **dict(zip(("d", "i"), loaded.search(q, 5))))
        if jax_files is not None:
            from_jax = read_index(jax_files / f"jax_w8_{dt}.memo")
            put(f"from_jax_{dt}", kind=from_jax.kind, scan_dtype=from_jax.scan_dtype,
                ntotal=from_jax.ntotal, **dict(zip(("d", "i"), from_jax.search(q, 5))))
    inc = ShardedFlatIndex(dim=64)
    inc.add(x[500:], ids[500:])
    inc.add(x[:500], ids[:500])
    put("incremental", i=inc.search(q, K)[1], bulk=idx.search(q, K)[1])
    rd, ri = idx.ranked_all(q[0])
    put("ranked_all", d=rd, i=ri)

    # TestShardedRound5 (flat): tail add, mask, in-place removal
    meshes = [("1d", None)]
    if world == 4:
        meshes.append(("2level", make_host_chip_mesh(2, 2)))
    for name, mesh in meshes:
        for dt in ("float32", "int8"):
            ix = ShardedFlatIndex(dim=64, scan_dtype=dt, mesh=mesh)
            ix.load(x[:800], ids[:800])
            ix.search(q, 5)
            ix.add(x[800:], ids[800:])
            staged = ix._staged is not None
            tail = ix._tail.count
            d, i = ix.search(q, 5)
            md, mi = ix.search(q, 5, id_mask=mask)
            kmd, kmi = ix._search(q, 5, mask, kernel_route=True)
            removed = ix.remove_ids(ids[:10])
            still = ix._staged is not None
            rd, ri = ix.search(q, 5)
            put(f"round5_{name}_{dt}", staged=staged, tail=tail, d=d, i=i, md=md, mi=mi,
                kmd=kmd, kmi=kmi, removed=removed, still_staged=still, ntotal=ix.ntotal,
                rd=rd, ri=ri)

    # device mode end to end
    dv = ShardedFlatIndex(dim=64)
    dv.add(t(x[:800]), t(ids[:800].astype(np.int32)))
    mode = dv._mode
    dv.search(q, 5)
    dv.add(t(x[800:]), t(ids[800:].astype(np.int32)))
    tail = dv._tail.count
    d, i = dv.search(q, 5)
    md, mi = dv.search(q, 5, id_mask=mask)
    rec = dv.reconstruct(42)
    removed = dv.remove_ids([42])
    params, arrays = dv.state()
    loaded = ShardedFlatIndex.from_state(params, arrays)
    put("device_mode", mode=mode, tail=tail, d=d, i=i, md=md, mi=mi, rec=rec, removed=removed,
        ntotal=dv.ntotal, state_rows=arrays["vectors"].shape[0], state_ids=arrays["ids"],
        ids=dv.ids(), after=dv.search(q, 5)[1], loaded=loaded.search(q, 5)[1],
        ranked=dv.ranked_all(q[0])[1])

    # tail, then the restage folds it in
    tr = ShardedFlatIndex(dim=64)
    tr.load(x[:800], ids[:800])
    tr.search(q, 5)
    tr.add(x[800:], ids[800:])
    d_tail, i_tail = tr.search(q, 5)
    tr._restage_needed = True
    d_fold, i_fold = tr.search(q, 5)
    put("restage", d_tail=d_tail, i_tail=i_tail, d_fold=d_fold, i_fold=i_fold,
        tail_gone=tr._tail is None)

    # the mask cache: one build per mask object
    mc = ShardedFlatIndex(dim=64)
    mc.add(x, ids)
    mc.search(q, 5, id_mask=mask)
    built = mc._mask_cache._value
    mc.search(q, 5, id_mask=mask)
    reused = mc._mask_cache._value is built
    mc.search(q, 5, id_mask=mask.copy())
    put("mask_cache", reused=reused, rebuilt=mc._mask_cache._value is not built)

    if world == 4:
        # TestTwoLevelMerge: 2 hosts x 2 chips against the 1-D merge
        db, idp, sq = padded(x, ids)
        one = make_mesh(n_data=4)
        two = make_host_chip_mesh(2, 2)
        fd, fi = sharded_search_program(one, t(shard_rows(db, one, ("data",))),
                                        t(shard_rows(idp, one, ("data",))),
                                        t(shard_rows(sq, one, ("data",))), t(q), 7)
        axes = ("host", "chip")
        td, ti = sharded_search_2level(two, t(shard_rows(db, two, axes)),
                                       t(shard_rows(idp, two, axes)),
                                       t(shard_rows(sq, two, axes)), t(q), 7)
        a = ShardedFlatIndex(dim=64, mesh=one)
        a.add(x, ids)
        b = ShardedFlatIndex(dim=64, mesh=two)
        b.add(x, ids)
        put("two_level", fd=fd, fi=fi, td=td, ti=ti,
            **dict(zip(("ad", "ai"), a.search(q, 5))), **dict(zip(("bd", "bi"), b.search(q, 5))))
        # TestSharded2D: 2 data x 2 model
        m2 = make_mesh(n_data=2, n_model=2)
        rows = shard_rows(db, m2, ("data",))
        c = m2.coordinate("model")
        cols = slice(c * 32, (c + 1) * 32)
        d2, i2 = sharded_search_2d(m2, t(rows[:, cols]), t(shard_rows(idp, m2, ("data",))),
                                   t(q[:, cols]), 5)
        put("two_d", d=d2, i=i2)
        # a reassigned mesh restages on the next search (device mode too)
        rm = ShardedFlatIndex(dim=64)
        rm.add(t(x), t(ids.astype(np.int32)))
        before = rm.search(q, 5)
        rm.mesh = two
        after = rm.search(q, 5)
        put("remesh", before_d=before[0], before_i=before[1], after_d=after[0],
            after_i=after[1], ntotal=rm.ntotal, shards=rm._shards)
    put("launches", **topk_cuda.fused_l2_topk.launches_by_mode)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--jax-files")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if resolve_device().type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.world, timeout=datetime.timedelta(seconds=60))
    try:
        out = Path(args.out)
        res = run_cases(args.world, out, Path(args.jax_files) if args.jax_files else None)
        np.savez(out / f"r{args.rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
