"""Multi-rank dry run of the sharded families, called by every rank.

Port-side twin of the JAX package's `__graft_entry__.dryrun_multichip`, at
its shapes: one distributed Lloyd step (`sharded_kmeans_step`) and one
exact 2-D search (`sharded_search_2d`) on a make_mesh(n_data, n_model)
of the world's ranks (n_model 2 on an even world of 4 or more ranks), then
the slot-sharded IVF index on a 1-D mesh of every rank (f32; SQ8 with a
tail add, a filter and an in-place removal), the slot-sharded IVF-PQ
index on that mesh, a one-device IVFFlatIndex's device-mode incremental
add (the tail merge) and, on an even world of 4 or more, the two-level
(host, chip) merge of the IVF, SQ8, flat and IVF-PQ indexes.

Every rank calls `dryrun_multichip()` with the same arguments (SPMD) after
torch.distributed is initialized (or with no process group: one rank). Its
asserts are the JAX function's; it returns the steps' results, replicated
on every rank, as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ivf_flat import IVFFlatIndex
from .mesh import make_host_chip_mesh, make_mesh, world_size
from .sharded import (
    ShardedFlatIndex, ShardedIVFIndex, ShardedIVFPQIndex, shard_rows, sharded_kmeans_step,
    sharded_search_2d,
)


def dryrun_multichip(device=None) -> dict[str, np.ndarray]:
    """Run the dry run on this rank (see the module docstring); `device`
    follows utils/runtime.resolve_device."""
    world = world_size()
    n_model = 2 if (world % 2 == 0 and world >= 4) else 1
    n_data = world // n_model
    mesh = make_mesh(n_data=n_data, n_model=n_model, device=device)
    dim = 128 * n_model           # divisible across the model axis
    n = 16 * n_data               # rows per data shard
    b, k, n_clusters = 4, 3, 4
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    queries = rng.standard_normal((b, dim)).astype(np.float32)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)  # noqa: E731
    out = {}

    # Training step: the distributed Lloyd iteration (sums over `data`).
    rows = shard_rows(data, mesh, ("data",))
    centroids = sharded_kmeans_step(mesh, on(rows), on(np.ones((rows.shape[0],), np.float32)),
                                    on(data[:n_clusters]))
    out["kmeans_centroids"] = centroids.cpu().numpy()

    # Serving step: 2-D sharded exact search (rows over data, dims over model).
    width = dim // n_model
    cols = slice(mesh.coordinate("model") * width, (mesh.coordinate("model") + 1) * width)
    dists, out_ids = sharded_search_2d(mesh, on(rows[:, cols]),
                                       on(shard_rows(ids, mesh, ("data",))),
                                       on(queries[:, cols]), k)
    assert dists.shape == (b, k) and out_ids.shape == (b, k)
    assert bool((out_ids >= 0).all())
    out["search_2d_d"], out["search_2d_i"] = dists.cpu().numpy(), out_ids.cpu().numpy()

    # Serving step: slot-sharded IVF (each rank scans 1/S of every list).
    dmesh = make_mesh(n_data=world, n_model=1, device=device)
    ids64 = ids.astype(np.int64)
    ivf = ShardedIVFIndex(dim=dim, nlist=8, nprobe=4, mesh=dmesh)
    ivf.load(data, ids64)
    d_ivf, i_ivf = ivf.search(queries, k)
    assert d_ivf.shape == (b, k) and (i_ivf[:, 0] >= 0).all()
    stats = ivf.scan_rows_per_chip(b)
    assert stats["rows_per_chip"] * world == stats["rows_all_chips"]
    out["ivf_d"], out["ivf_i"] = d_ivf, i_ivf

    # The SQ8 composite: a tail add, a filter, an in-place removal.
    sq8 = ShardedIVFIndex(dim=dim, nlist=8, nprobe=8, scan_dtype="int8", mesh=dmesh)
    sq8.load(data[: n - 4], ids64[: n - 4])
    sq8.search(queries, k)                       # stage
    sq8.add(data[n - 4 :], ids64[n - 4 :])       # parks in the tail
    assert sq8._tail is not None and sq8._tail.count == 4
    d_sq8, i_sq8 = sq8.search(queries, k)
    assert d_sq8.shape == (b, k) and (i_sq8[:, 0] >= 0).all()
    mask = np.zeros((n,), bool)
    mask[::2] = True
    _, i_m = sq8.search(queries, k, id_mask=mask)
    assert ((i_m < 0) | mask[i_m.clip(0)]).all()
    assert sq8.remove_ids(ids64[:2]) == 2 and sq8.ntotal == n - 2
    assert sq8._staged is not None               # removal was in place
    out["sq8_i"], out["sq8_masked_i"] = i_sq8, i_m

    # Serving step: slot-sharded IVF-PQ (per-shard ADC + local refine).
    pq = ShardedIVFPQIndex(dim=dim, nlist=8, nprobe=8, m=8, mesh=dmesh)
    pq.load(data, ids64)
    d_pq, i_pq = pq.search(queries, k)
    assert d_pq.shape == (b, k) and (i_pq[:, 0] >= 0).all()
    out["pq_d"], out["pq_i"] = d_pq, i_pq

    # Serving step: a one-device IVFFlatIndex's device-mode incremental add
    # (the tail merge).
    inc = IVFFlatIndex(dim=dim, nlist=4, nprobe=4, device=dmesh.device)
    inc.add(on(data[: n // 2]), on(ids[: n // 2]))
    inc.search(queries, k)                       # stage
    inc.add(on(data[n // 2 :]), on(ids[n // 2 :]))
    d_inc, i_inc = inc.search(queries, k)        # tail-merged
    assert inc._tail is not None and (i_inc[:, 0] >= 0).all()
    out["inc_d"], out["inc_i"] = d_inc, i_inc

    # The two-level (host, chip) merge: k candidates a host cross `host`.
    if world % 2 == 0 and world >= 4:
        hmesh = make_host_chip_mesh(2, world // 2, device=device)
        ivf2 = ShardedIVFIndex(dim=dim, nlist=8, nprobe=4, mesh=hmesh)
        ivf2.load(data, ids64)
        d_i2, i_i2 = ivf2.search(queries, k)
        assert d_i2.shape == (b, k) and (i_i2[:, 0] >= 0).all()
        sq8_2 = ShardedIVFIndex(dim=dim, nlist=8, nprobe=8, scan_dtype="int8", mesh=hmesh)
        sq8_2.load(data, ids64)
        assert (sq8_2.search(queries, k)[1][:, 0] >= 0).all()
        fl2 = ShardedFlatIndex(dim=dim, mesh=hmesh)
        fl2.add(data, ids64)
        d_f2, i_f2 = fl2.search(queries, k)
        assert d_f2.shape == (b, k) and (i_f2 >= 0).all()
        pq2 = ShardedIVFPQIndex(dim=dim, nlist=8, nprobe=8, m=8, mesh=hmesh)
        pq2.load(data, ids64)
        d_p2, i_p2 = pq2.search(queries, k)
        assert d_p2.shape == (b, k) and (i_p2[:, 0] >= 0).all()
        out["ivf_2level_i"], out["flat_2level_i"] = i_i2, i_f2
        out["pq_2level_d"], out["pq_2level_i"] = d_p2, i_p2
    return out
