"""One rank of the sharded IVF index's parity runs (gloo).

    python tests/torch_parallel_ivf_worker.py --world W --rank R --store FILE --out DIR \
        --shared DIR

Every rank runs the same cases (SPMD) on tests/test_parallel.py's corpus
(1000 x 64, nlist 16) and writes what it got to DIR/r{R}.npz, one key per
"case.name"; tests/test_torch_parallel_ivf.py holds those results against
the JAX package's ShardedIVFIndex on a mesh of W of its virtual devices,
and tests/test_torch_sharded_cuda.py against the oracle on the card.

--shared names a directory with centroids.npy, the coarse quantizer every
case but `trained` and `device_mode` starts from (so both packages probe
the same lists), and any jax_w{8,3}_{float32,int8}.memo files (files
written by the JAX package on 8 and 3 devices), which every rank loads.
DIR/port_w{W}_{dtype}.memo are files written at W ranks. At W = 4 the
two-level (2 x 2 host x chip) cases and a reassigned mesh run too. On a
CUDA device ("cuda" in C99VDB_PLATFORM, every rank on cuda:0) each rank
also holds the IVF kernels against their plain versions on its own block
("kernels.*"); "launches.*" are the IVF kernels' launches. Imports torch
and the port only.
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
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_parallel_worker import corpus, third_mask  # noqa: E402

from c99_vectordb_tpu_torch.ops import ivf_scan, ivf_scan_cuda  # noqa: E402
from c99_vectordb_tpu_torch.parallel import (  # noqa: E402
    ShardedIVFIndex, make_host_chip_mesh, make_mesh, sharded_ivf_search_2level,
    sharded_kmeans_step,
)
from c99_vectordb_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from c99_vectordb_tpu_torch.parallel.sharded import shard_rows  # noqa: E402
from c99_vectordb_tpu_torch.storage.index_io import read_index, write_index  # noqa: E402
from c99_vectordb_tpu_torch.utils.runtime import resolve_device  # noqa: E402

K = 10
NLIST = 16
IVF_KERNELS = ("ivf_scan_select", "ivf_scan_dense", "ivf_scan_dense_int8")
# Results of a rank's own block (not replicated across ranks).
PER_RANK = ("underfilled.raw_d", "underfilled.raw_i")


def kmeans_data():
    """TestDistributedKMeans' two inputs: (512, 32) Gaussian rows, and 8
    blobs of 64 rows in 16 dims with their centres."""
    rng = np.random.default_rng(2)
    data = rng.standard_normal((512, 32)).astype(np.float32)
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 8
    blobs = np.concatenate(
        [c + rng.standard_normal((64, 16)).astype(np.float32) for c in centers])
    return data, blobs, centers


def underfilled_mask():
    """A filter that keeps only ids 0..3: every probed list is underfilled."""
    m = np.zeros(1000, bool)
    m[:4] = True
    return m


def params(dt="float32", nprobe=16, rerank="float32"):
    return {"dim": 64, "nlist": NLIST, "nprobe": nprobe, "scan_dtype": dt,
            "rerank_dtype": rerank}


def kernel_check(index, q, nprobe, k):
    """This rank's block through each IVF kernel its route runs, against
    the plain version on the same operands: {kernel: max |diff|} (int8
    bit for bit, ids equal)."""
    staged = index._stage()
    qd = torch.from_numpy(q).to(index.device)
    probes = ivf_scan.coarse_probes(qd, staged[0], staged[1], nprobe)
    hwm = index._hwm
    out = {}
    if index.scan_dtype == "int8":
        q8, rs = ivf_scan.sq8_stage_queries(qd, staged[3])
        args = (probes, q8, rs, staged[2], staged[4], staged[5])
        kd, ki = ivf_scan_cuda.ivf_scan_dense_int8(*args, qpb=1, hwm=hwm)
        pd, pi = ivf_scan.scan_dense_int8_plain(*args, hwm=hwm)
        assert torch.equal(kd, pd) and torch.equal(ki, pi), "int8 keys differ from plain"
        out["ivf_scan_dense_int8"] = 0.0
        return out
    args = (probes, qd, (qd * qd).sum(1), staged[2], staged[3], staged[4])
    for name, kern, plain in (
            ("ivf_scan_dense", lambda: ivf_scan_cuda.ivf_scan_dense(*args, hwm=hwm),
             lambda: ivf_scan.scan_dense_plain(*args, hwm=hwm)),
            ("ivf_scan_select", lambda: ivf_scan_cuda.ivf_scan_select(*args, k, hwm=hwm),
             lambda: ivf_scan.scan_select_plain(*args, k, hwm=hwm))):
        kd, ki = kern()
        pd, pi = plain()
        fin = torch.isfinite(pd)
        assert torch.equal(fin, torch.isfinite(kd)), f"{name}: inf slots differ"
        diff = (kd[fin] - pd[fin]).abs()
        assert bool((diff <= 1e-5 * torch.clamp_min(pd[fin].abs(), 1.0)).all()), name
        assert torch.equal(ki[fin], pi[fin]) or name == "ivf_scan_select", f"{name}: ids"
        out[name] = float(diff.max()) if diff.numel() else 0.0
    return out


def run_cases(world: int, out: Path, shared: Path) -> dict[str, np.ndarray]:
    res: dict[str, np.ndarray] = {}

    def put(case, **arrays):
        for name, a in arrays.items():
            res[f"{case}.{name}"] = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    x, ids, q = corpus()
    mask = third_mask()
    cents = np.load(shared / "centroids.npy")
    device = resolve_device()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731

    def built(dt="float32", nprobe=16, n=1000, mesh=None, rerank="float32"):
        """The index a JAX ShardedIVFIndex.load builds, on `cents`."""
        return ShardedIVFIndex.from_state(
            params(dt, nprobe, rerank), {"vectors": x[:n], "ids": ids[:n], "centroids": cents},
            mesh=mesh)

    # TestShardedIVF: the port trains its own quantizer (every rank the same)
    tr = ShardedIVFIndex(dim=64, nlist=NLIST, nprobe=16)
    tr.load(x, ids)
    full = tr.search(q, K, nprobe=16)
    put("trained", centroids=tr._centroids, d=full[0], i=full[1],
        lo=tr.search(q, K, nprobe=2)[1], hi=tr.search(q, K, nprobe=8)[1])
    empty = ShardedIVFIndex(dim=16)
    put("empty", **dict(zip(("d", "i"), empty.search(np.zeros((2, 16), np.float32), k=3))))

    # TestSlotSharding (IVF): both f32 routes at nprobe 1, 4, 16; rows per rank
    ix = built(nprobe=4)
    for nprobe in (1, 4, 16):
        d, i = ix._search(q, K, nprobe=nprobe, kernel_route=False)
        kd, ki = ix._search(q, K, nprobe=nprobe, kernel_route=True)
        put(f"routes_p{nprobe}", d=d, i=i, kd=kd, ki=ki)
    for scan in ("dense", "select"):
        put(f"routes_{scan}", **dict(zip(("d", "i"), ix._search(
            q, K, nprobe=4, kernel_route=True, scan=scan))))
    stats = ix.scan_rows_per_chip(b=6)
    put("rows", shards=stats["shards"], pad_local=stats["pad_local"],
        rows_per_chip=stats["rows_per_chip"], rows_all_chips=stats["rows_all_chips"])
    # A filter that leaves every list underfilled, through the select
    # kernel (which fills a list with masked rows at +inf with their ids).
    few = underfilled_mask()
    staged = ix._stage()
    _, masked_sqn, _ = ix._mask_cache.get(few, ix._build_masked)
    from c99_vectordb_tpu_torch.ops.ivf_scan import ivf_full_search

    raw_d, raw_i = ivf_full_search(staged[0], staged[1], staged[2], masked_sqn, staged[4],
                                   t(x[:6]), 1, K, dense=False, hwm=ix._hwm)
    put("underfilled", raw_d=raw_d, raw_i=raw_i,
        **dict(zip(("d", "i"), ix._search(x[:6], K, nprobe=1, id_mask=few,
                                         kernel_route=True, scan="select"))),
        **dict(zip(("dd", "di"), ix._search(x[:6], K, nprobe=1, id_mask=few,
                                           kernel_route=True, scan="dense"))),
        **dict(zip(("cd", "ci"), ix._search(x[:6], K, nprobe=1, id_mask=few,
                                           kernel_route=False))))
    for dt in ("float32", "int8"):
        mi = built(dt)
        md, mii = mi._search(q, 5, id_mask=mask, kernel_route=True)
        cd, ci = mi._search(q, 5, id_mask=mask, kernel_route=False)
        put(f"masked_{dt}", d=md, i=mii, cd=cd, ci=ci)

    # SQ8: exact through the per-shard rerank; the global scale; bf16 rerank
    sq8 = built("int8")
    d, i = sq8.search(q, 5, nprobe=16)
    put("sq8", d=d, i=i, scale=sq8._stage()[3], pad_local=sq8._params[1])
    b16 = built("int8", rerank="bfloat16")
    put("sq8_bf16", **dict(zip(("d", "i"), b16.search(q, 5))))

    # files at W ranks, read back at W; the JAX package's files at W
    for dt, index in (("float32", built()), ("int8", sq8)):
        path = out / f"port_w{world}_{dt}.memo"
        if dist.get_rank() == 0:
            write_index(index, path)
        dist.barrier()
        loaded = read_index(path)
        put(f"roundtrip_{dt}", kind=loaded.kind, scan_dtype=loaded.scan_dtype,
            ntotal=loaded.ntotal, **dict(zip(("d", "i"), loaded.search(q, 5))))
        for devices in (8, 3):
            src = shared / f"jax_w{devices}_{dt}.memo"
            if src.exists():
                from_jax = read_index(src)
                put(f"from_jax{devices}_{dt}", kind=from_jax.kind,
                    scan_dtype=from_jax.scan_dtype, ntotal=from_jax.ntotal,
                    **dict(zip(("d", "i"), from_jax.search(q, 5))))

    # TestShardedRound5 (ivf, ivf_sq8): tail add, mask, in-place removal
    meshes = [("1d", None)]
    if world == 4:
        meshes.append(("2level", make_host_chip_mesh(2, 2)))
    for name, mesh in meshes:
        for dt in ("float32", "int8"):
            r5 = built(dt, n=800, mesh=mesh)
            r5.search(q, 5)
            r5.add(x[800:], ids[800:])
            staged, tail = r5._staged is not None, r5._tail.count
            d, i = r5.search(q, 5)
            md, mi = r5._search(q, 5, id_mask=mask, kernel_route=True)
            cmd, cmi = r5._search(q, 5, id_mask=mask, kernel_route=False)
            removed = r5.remove_ids(ids[:10])
            still = r5._staged is not None
            rd, ri = r5.search(q, 5)
            put(f"round5_{name}_{dt}", staged=staged, tail=tail, d=d, i=i, md=md, mi=mi,
                cmd=cmd, cmi=cmi, removed=removed, still_staged=still, ntotal=r5.ntotal,
                rd=rd, ri=ri)

    # device mode end to end (the index trains its own quantizer on the card)
    for dt in ("float32", "int8"):
        dv = ShardedIVFIndex(dim=64, nlist=NLIST, nprobe=16, scan_dtype=dt)
        dv.add(t(x[:800]), t(ids[:800].astype(np.int32)))
        mode = dv._mode
        dv.search(q, 5)
        dv.add(t(x[800:]), t(ids[800:].astype(np.int32)))
        tail = dv._tail.count
        d, i = dv.search(q, 5)
        md, mi = dv.search(q, 5, id_mask=mask)
        rec = dv.reconstruct(42)
        removed = dv.remove_ids([42])
        p, arrays = dv.state()
        loaded = ShardedIVFIndex.from_state(p, arrays)
        dv.search(q, 5)                       # restaged after the fold
        put(f"device_{dt}", mode=mode, tail=tail, d=d, i=i, md=md, mi=mi, rec=rec,
            removed=removed, ntotal=dv.ntotal, state_ids=arrays["ids"],
            state_vecs=arrays["vectors"], centroids=arrays["centroids"], ids=dv.ids(),
            after=dv.search(q, 5)[1], loaded=loaded.search(q, 5)[1],
            ranked=dv.ranked_all(q[0])[1])

    # tail, then the restage folds it in (host mode and device mode)
    for mode in ("host", "device"):
        tr5 = built(n=800)
        if mode == "device":
            tr5 = ShardedIVFIndex(dim=64, nlist=NLIST, nprobe=16)
            tr5._centroids = t(cents)
            tr5.add(t(x[:800]), t(ids[:800].astype(np.int32)))
        tr5.search(q, 5)
        tr5.add(x[800:], ids[800:])
        d_tail, i_tail = tr5.search(q, 5)
        tr5._restage_needed = True
        d_fold, i_fold = tr5.search(q, 5)
        put(f"restage_{mode}", d_tail=d_tail, i_tail=i_tail, d_fold=d_fold, i_fold=i_fold,
            tail_gone=tr5._tail is None)

    # the mask cache: one build per mask object
    mc = built()
    mc.search(q, 5, id_mask=mask)
    first = mc._mask_cache._value
    mc.search(q, 5, id_mask=mask)
    reused = mc._mask_cache._value is first
    mc.search(q, 5, id_mask=mask.copy())
    put("mask_cache", reused=reused, rebuilt=mc._mask_cache._value is not first)

    # TestDistributedKMeans: the Lloyd step over `data`
    data, blobs, _ = kmeans_data()
    dmesh = make_mesh(n_data=world)
    c = t(data[:8])
    for _ in range(5):
        c = sharded_kmeans_step(dmesh, t(shard_rows(data, dmesh, ("data",))),
                                t(np.ones(512 // world, np.float32)), c)
    cb = t(blobs[:8])
    for _ in range(8):
        cb = sharded_kmeans_step(dmesh, t(shard_rows(blobs, dmesh, ("data",))),
                                 t(np.ones(512 // world, np.float32)), cb)
    put("kmeans", step=c, blobs=cb)

    if world == 4:
        # two-level (2 hosts x 2 chips) against the 1-D mesh, f32 and int8
        two = make_host_chip_mesh(2, 2)
        a, b = built(nprobe=4), built(nprobe=4, mesh=two)
        a8, b8 = built("int8"), built("int8", mesh=two)
        staged = b._stage()
        put("two_level", **dict(zip(("ad", "ai"), a.search(q, K, nprobe=4))),
            **dict(zip(("pd", "pi"), sharded_ivf_search_2level(
                two, *staged, t(q), 4, K, use_kernels=True, hwm=b._hwm))),
            **dict(zip(("bd", "bi"), b.search(q, K, nprobe=4))),
            **dict(zip(("kd", "ki"), b._search(q, K, nprobe=4, kernel_route=True))),
            **dict(zip(("a8d", "a8i"), a8.search(q, 5, nprobe=16))),
            **dict(zip(("b8d", "b8i"), b8.search(q, 5, nprobe=16))),
            shards=b.scan_rows_per_chip(b=6)["shards"])
        # a device-mode index given another mesh restages on its next search
        rm = ShardedIVFIndex(dim=64, nlist=NLIST, nprobe=16)
        rm.add(t(x), t(ids.astype(np.int32)))
        before = rm.search(q, 5)
        rm.mesh = two
        after = rm.search(q, 5)
        put("remesh", before_d=before[0], before_i=before[1], after_d=after[0],
            after_i=after[1], ntotal=rm.ntotal, shards=rm._shards)

    # the port's twin of __graft_entry__.dryrun_multichip
    put("dryrun", **dryrun_multichip())

    if device.type == "cuda":
        errs = {}
        for dt, nprobe, k in (("float32", 4, K), ("int8", 16, 20)):
            for name, err in kernel_check(built(dt, nprobe), q, nprobe, k).items():
                errs[name] = max(errs.get(name, 0.0), err)
        put("kernels", **errs)
    put("launches", **{name: getattr(ivf_scan_cuda, name).launches for name in IVF_KERNELS})
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--shared", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    if resolve_device().type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{args.store}", rank=args.rank,
                            world_size=args.world, timeout=datetime.timedelta(seconds=60))
    try:
        out = Path(args.out)
        res = run_cases(args.world, out, Path(args.shared))
        np.savez(out / f"r{args.rank}.npz", **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
