"""One rank of the sharded IVF-PQ index's parity runs (gloo).

    python tests/torch_parallel_pq_worker.py --world W --rank R --store FILE --out DIR \
        --shared DIR

Every rank runs the same cases (SPMD) on tests/test_parallel.py's corpus
(1000 x 64) and writes what it got to DIR/r{R}.npz, one key per
"case.name"; tests/test_torch_parallel_pq.py holds those results against
the JAX package's ShardedIVFPQIndex on a mesh of W of its virtual devices,
and tests/test_torch_sharded_cuda.py against the oracle on the card.

--shared names a directory with q_{name}.npz, the quantizers (centroids,
codebooks, rotation) every case but `trained` and `incremental` starts
from (so both packages probe the same lists with the same codes; see
QUANTIZERS), and any jax_w{8,3}.memo files (files written by the JAX
package on 8 and 3 devices), which every rank loads. DIR/port_w{W}_{name}.memo
are files written at W ranks. At W = 4 the two-level (2 x 2 host x chip)
cases run too. On a CUDA device ("cuda" in C99VDB_PLATFORM, every rank on
cuda:0) each rank also holds the dense ADC kernel against its plain
version on its own block ("kernels.*"); "launches.*" are the ADC kernels'
launches. Imports torch and the port only.
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

from c99_vectordb_tpu_torch.ops import adc as adc_mod  # noqa: E402
from c99_vectordb_tpu_torch.ops import adc_cuda  # noqa: E402
from c99_vectordb_tpu_torch.parallel import (  # noqa: E402
    ShardedIVFPQIndex, make_host_chip_mesh, sharded_pq_search_program,
)
from c99_vectordb_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from c99_vectordb_tpu_torch.storage.index_io import read_index, write_index  # noqa: E402
from c99_vectordb_tpu_torch.utils.runtime import resolve_device  # noqa: E402

# The shared quantizers: name -> (index params, rows the JAX class trains
# them on). base and refine8 are TestShardedIVFPQ's, opq and k16
# TestShardedIVFPQRound4's, r5 TestShardedRound5's pq family.
BASE = {"dim": 64, "nlist": 16, "nprobe": 16, "m": 8, "ksub": 256, "refine_factor": 4,
        "opq": False, "opq_iters": 8}
QUANTIZERS = {
    "base": (BASE, 1000),
    "refine8": ({**BASE, "refine_factor": 8}, 1000),
    "opq": ({**BASE, "opq": True, "opq_iters": 2}, 1000),
    "k16": ({**BASE, "ksub": 16, "refine_factor": 8}, 1000),
    "r5": ({**BASE, "nlist": 8, "nprobe": 8, "refine_factor": 16}, 800),
}
# Results of a rank's own block (not replicated across ranks).
PER_RANK = ()


def kernel_check(index, q, nprobe, k_adc, qpb):
    """This rank's block through the dense ADC kernel against its plain
    version on the same operands: bit for bit. Returns 0.0."""
    centroids, c_sq, books, canvas, const, li, _ = index._stage()
    q_adc = index._rotate_device(torch.from_numpy(q).to(index.device))
    probes, pc, qd = adc_mod.adc_prologue(q_adc, centroids, c_sq, books, nprobe)
    packed = adc_mod.packed_layout(int(books.shape[1]), index.m)
    args = (probes, pc, qd, canvas, const, li)
    kd, ki = adc_cuda.adc_scan_dense(*args, packed=packed, qpb=qpb, hwm=index._hwm)
    pd, pi = adc_mod.adc_dense_plain(*args, packed=packed, hwm=index._hwm)
    assert torch.equal(ki, pi), "adc_scan_dense: ids differ from plain"
    assert torch.equal(kd, pd), "adc_scan_dense: distances not bit-equal to plain"
    return 0.0


def run_cases(world: int, out: Path, shared: Path) -> dict[str, np.ndarray]:
    res: dict[str, np.ndarray] = {}

    def put(case, **arrays):
        for name, a in arrays.items():
            res[f"{case}.{name}"] = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

    x, ids, q = corpus()
    mask = third_mask()
    device = resolve_device()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    quant = {}
    for name in QUANTIZERS:
        with np.load(shared / f"q_{name}.npz") as z:
            quant[name] = {key: z[key] for key in z.files}

    def built(name="base", n=None, mesh=None):
        """The index a JAX ShardedIVFPQIndex.from_state builds on the shared
        quantizer `name`, host mode."""
        params, n_rows = QUANTIZERS[name]
        n = n_rows if n is None else n
        return ShardedIVFPQIndex.from_state(
            params, {"vectors": x[:n], "ids": ids[:n], **quant[name]}, mesh=mesh)

    # TestShardedIVFPQ: the port trains its own quantizer (every rank the same)
    tr = ShardedIVFPQIndex(dim=64, nlist=16, nprobe=16, m=8)
    tr.load(x, ids)
    put("trained", centroids=tr._centroids, codebooks=tr._codebooks,
        **dict(zip(("d", "i"), tr.search(q, 5, nprobe=16))))
    inc = ShardedIVFPQIndex(dim=64, nlist=16, m=8)
    inc.add(x[:500], ids[:500])
    n_half = inc.ntotal
    inc.add(x[500:], ids[500:])
    put("incremental", n_half=n_half, ntotal=inc.ntotal,
        **dict(zip(("d", "i"), inc.search(q[:2], 3, nprobe=16))))
    empty = ShardedIVFPQIndex(dim=16, m=4)
    put("empty", **dict(zip(("d", "i"), empty.search(np.zeros((2, 16), np.float32), k=3))))

    # Both routes on the shared quantizers, at nprobe 4 and 16 (k 5)
    for name in ("base", "refine8", "opq", "k16"):
        ix = built(name)
        for nprobe in (4, 16):
            d, i = ix._search(q, 5, nprobe=nprobe, kernel_route=False)
            kd, ki = ix._search(q, 5, nprobe=nprobe, kernel_route=True)
            put(f"routes_{name}_p{nprobe}", d=d, i=i, kd=kd, ki=ki)
        md, mi = ix._search(q, 5, id_mask=mask, kernel_route=False)
        kmd, kmi = ix._search(q, 5, id_mask=mask, kernel_route=True)
        put(f"masked_{name}", d=md, i=mi, kd=kmd, ki=kmi)
    base = built()
    stats = base.scan_rows_per_chip(b=6, nprobe=4)
    put("rows", shards=stats["shards"], pad_local=stats["pad_local"],
        rows_per_chip=stats["rows_per_chip"], rows_all_chips=stats["rows_all_chips"])

    # The program on this rank's block, as sharded_pq_search_program
    staged = base._stage()
    for use_kernels in (False, True):
        pd, pi = sharded_pq_search_program(base.mesh, *staged, t(q), t(q), 4, 5, 20,
                                           use_kernels=use_kernels, hwm=base._hwm)
        put(f"program_{'kernel' if use_kernels else 'plain'}", d=pd, i=pi)

    # files at W ranks, read back at W; the JAX package's files at W
    for name in ("base", "opq"):
        path = out / f"port_w{world}_{name}.memo"
        index = built(name)       # on every rank: building an index builds its mesh
        if dist.get_rank() == 0:
            write_index(index, path)
        dist.barrier()
        loaded = read_index(path)
        put(f"roundtrip_{name}", kind=loaded.kind, ntotal=loaded.ntotal, opq=loaded.opq,
            **dict(zip(("d", "i"), loaded.search(q, 5))))
    for devices in (8, 3):
        src = shared / f"jax_w{devices}.memo"
        if src.exists():
            from_jax = read_index(src)
            put(f"from_jax{devices}", kind=from_jax.kind, ntotal=from_jax.ntotal,
                **dict(zip(("d", "i"), from_jax.search(q, 5))))

    # TestShardedRound5 (pq): tail add, mask, in-place removal
    meshes = [("1d", None)]
    if world == 4:
        meshes.append(("2level", make_host_chip_mesh(2, 2)))
    for mesh_name, mesh in meshes:
        r5 = built("r5", mesh=mesh)
        r5.search(q, 5)
        r5.add(x[800:], ids[800:])
        staged_ok, tail = r5._staged is not None, r5._tail.count
        d, i = r5.search(q, 5)
        md, mi = r5._search(q, 5, id_mask=mask, kernel_route=False)
        kmd, kmi = r5._search(q, 5, id_mask=mask, kernel_route=True)
        removed = r5.remove_ids(ids[:10])
        still = r5._staged is not None
        rd, ri = r5.search(q, 5)
        put(f"round5_{mesh_name}", staged=staged_ok, tail=tail, d=d, i=i, md=md, mi=mi,
            kmd=kmd, kmi=kmi, removed=removed, still_staged=still, ntotal=r5.ntotal, rd=rd,
            ri=ri)

    # device mode end to end on the r5 quantizer (tensors in)
    dv = ShardedIVFPQIndex(dim=64, nlist=8, nprobe=8, m=8, refine_factor=16)
    dv._centroids, dv._codebooks = t(quant["r5"]["centroids"]), t(quant["r5"]["codebooks"])
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
    loaded = ShardedIVFPQIndex.from_state(p, arrays)
    put("device", mode=mode, tail=tail, d=d, i=i, md=md, mi=mi, rec=rec, removed=removed,
        ntotal=dv.ntotal, state_ids=arrays["ids"], state_vecs=arrays["vectors"],
        ids=dv.ids(), after=dv.search(q, 5)[1], loaded=loaded.search(q, 5)[1],
        ranked=dv.ranked_all(q[0])[1])
    # the port's own training on tensors (device mode), then a retrain that
    # re-parks the staged rows
    own = ShardedIVFPQIndex(dim=64, nlist=8, nprobe=8, m=8, refine_factor=16)
    own.add(t(x), t(ids.astype(np.int32)))
    own.search(q, 5)
    first = own.search(q, 5)
    own.train(t(x), seed=3)
    put("device_trained", mode=own._mode, centroids=own._centroids, d=first[0], i=first[1],
        ntotal=own.ntotal, staged=own._staged is not None,
        **dict(zip(("rd", "ri"), own.search(q, 5))))

    # tail, then the restage folds it in (host mode and device mode)
    for mode in ("host", "device"):
        tr5 = built("r5")
        if mode == "device":
            tr5 = ShardedIVFPQIndex.from_state(QUANTIZERS["r5"][0], {
                "vectors": np.zeros((0, 64), np.float32), "ids": np.zeros((0,), np.int64),
                **quant["r5"]})
            tr5.add(t(x[:800]), t(ids[:800].astype(np.int32)))
        tr5.search(q, 5)
        tr5.add(x[800:], ids[800:])
        d_tail, i_tail = tr5.search(q, 5)
        tr5._restage_needed = True
        d_fold, i_fold = tr5.search(q, 5)
        put(f"restage_{mode}", d_tail=d_tail, i_tail=i_tail, d_fold=d_fold, i_fold=i_fold,
            tail_gone=tr5._tail is None, mode=tr5._mode)

    # the mask cache: one build per mask object
    mc = built()
    mc.search(q, 5, id_mask=mask)
    first = mc._mask_cache._value
    mc.search(q, 5, id_mask=mask)
    reused = mc._mask_cache._value is first
    mc.search(q, 5, id_mask=mask.copy())
    put("mask_cache", reused=reused, rebuilt=mc._mask_cache._value is not first)

    if world == 4:
        # TestShardedIVFPQRound4: two-level (2 hosts x 2 chips) = the 1-D mesh
        two = make_host_chip_mesh(2, 2)
        a, b = built(), built(mesh=two)
        put("two_level", **dict(zip(("ad", "ai"), a.search(q, 5, nprobe=16))),
            **dict(zip(("bd", "bi"), b.search(q, 5, nprobe=16))),
            **dict(zip(("akd", "aki"), a._search(q, 5, nprobe=4, kernel_route=True))),
            **dict(zip(("bkd", "bki"), b._search(q, 5, nprobe=4, kernel_route=True))),
            shards=b.scan_rows_per_chip(b=6)["shards"])

    # the port's twin of __graft_entry__.dryrun_multichip
    put("dryrun", **dryrun_multichip())

    put("launches", adc_scan_dense=adc_cuda.adc_scan_dense.launches,
        adc_scan_select=adc_cuda.adc_scan_select.launches)
    if device.type == "cuda":
        for name in ("base", "k16"):
            put("kernels", **{f"adc_scan_dense_{name}": kernel_check(built(name), q, 4, 20, 1)})
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
