"""PyTorch port on the card: the sharded flat index (parallel/sharded.py)
over the flat kernel (csrc/fused_l2_topk.cu), the sharded IVF index over
the IVF kernels (csrc/ivf_scan.cu) and the sharded IVF-PQ index over the
dense ADC kernel (csrc/adc_scan.cu), at W = 1 in this process and at W =
1, 2 and 4 gloo ranks sharing cuda:0 (tests/torch_parallel_worker.py,
tests/torch_parallel_ivf_worker.py and tests/torch_parallel_pq_worker.py,
each spawned once for the module).

Every test here is marked `cuda` and skips without a card. This file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py -q

On the card search takes the kernel route (flat kernel per shard, exact f32
rerank, merge). Ids must equal the float64 numpy oracle's (or FlatIndex's
on the card); distances agree within TOL relative to the row's largest
distance (the card sums the rerank's squares in another order than
numpy). The kernel must have launched in mode float32 and in mode int8.
The sharded IVF index's f32 ids must equal IVFFlatIndex's on the card on
the same centroids; on every rank each IVF kernel equals its plain version
on that rank's block (select and dense within IVF_REL_TOL, int8 bit for
bit), and the select, dense and int8 dense kernels must all have launched.
The sharded IVF-PQ index returns exact distances with no masked or removed
id; on every rank the dense ADC kernel equals its plain version on that
rank's block bit for bit and was launched on the rank's path; at W = 1 it
shortlists as IVFPQIndex's dense route on the same quantizer.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_ivf_worker as ivf_worker
import torch_parallel_pq_worker as pq_worker
import torch_parallel_worker as worker
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex
from c99_vectordb_tpu_torch.models.ivf_pq import IVFPQIndex
from c99_vectordb_tpu_torch.ops import adc_cuda, ivf_scan_cuda, topk_cuda
from c99_vectordb_tpu_torch.ops.rerank import shortlist_depth
from c99_vectordb_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, ShardedIVFPQIndex

pytestmark = pytest.mark.cuda
TOL = 1e-5
WORLDS = (1, 2, 4)
JOIN_TIMEOUT_S = 300
REPO = Path(__file__).resolve().parent.parent
X, IDS, Q = worker.corpus()
MASK = worker.third_mask()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flat kernel has no CPU mode (run on the card)")
    return torch.device("cuda", 0)


def spawn_worlds(script, root, extra=()):
    """{W: [rank results]} of a worker's cases at every W, every rank on
    cuda:0, all spawned at once."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", C99VDB_PLATFORM="cuda")
    procs = {}
    for w in WORLDS:
        out = root / f"w{w}"
        out.mkdir()
        procs[w] = [subprocess.Popen(
            [sys.executable, script, "--world", str(w), "--rank", str(r), "--store",
             str(out / "store"), "--out", str(out), *extra], stdout=(out / f"log{r}").open("w"),
            stderr=subprocess.STDOUT, env=env) for r in range(w)]
    failed = []
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                rc = p.wait(timeout=JOIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in (q for group in procs.values() for q in group):
                    q.kill()
                rc = "timeout"
            if rc != 0:
                failed.append((w, r, rc, (root / f"w{w}" / f"log{r}").read_text()[-3000:]))
    assert not failed, failed
    out = {}
    for w in WORLDS:
        out[w] = []
        for r in range(w):
            with np.load(root / f"w{w}" / f"r{r}.npz") as z:
                out[w].append({key: z[key] for key in z.files})
    return out


def build_sources():
    """Build every kernel source once, before ranks start: each worker's
    dry run reaches the flat, IVF and ADC kernels, and a rank that builds
    one while the others wait in a collective can outlast their timeout."""
    from c99_vectordb_tpu_torch.ops import cuda_build

    for name in ("fused_l2_topk", "ivf_scan", "adc_scan"):
        cuda_build.build(name)


@pytest.fixture(scope="module")
def card_runs(cuda, tmp_path_factory):
    """{W: [rank results]} of the flat worker's cases with every rank on cuda:0."""
    build_sources()
    return spawn_worlds(worker.__file__, tmp_path_factory.mktemp("card_ranks"))


@pytest.fixture(scope="module")
def ivf_card_runs(cuda, tmp_path_factory):
    """{W: [rank results]} of the IVF worker's cases with every rank on
    cuda:0, on a quantizer the port's k-means trains on the CPU."""
    from c99_vectordb_tpu_torch.ops.kmeans import train_kmeans

    build_sources()
    root = tmp_path_factory.mktemp("ivf_card_ranks")
    shared = root / "shared"
    shared.mkdir()
    np.save(shared / "centroids.npy", train_kmeans(X, ivf_worker.NLIST, iters=8, device="cpu"))
    return spawn_worlds(ivf_worker.__file__, root, ("--shared", str(shared)))


@pytest.fixture(scope="module")
def pq_card_runs(cuda, tmp_path_factory):
    """{W: [rank results]} of the IVF-PQ worker's cases with every rank on
    cuda:0, on quantizers the port trains on the CPU."""
    build_sources()
    root = tmp_path_factory.mktemp("pq_card_ranks")
    shared = root / "shared"
    shared.mkdir()
    for name, (params, n) in pq_worker.QUANTIZERS.items():
        index = ShardedIVFPQIndex(**params, device="cpu")
        index.train(X[:n])
        rot = index._rotation if index._rotation is not None else np.zeros((0, 64), np.float32)
        np.savez(shared / f"q_{name}.npz", centroids=index._centroids,
                 codebooks=index._codebooks, rotation=rot)
    return spawn_worlds(pq_worker.__file__, root, ("--shared", str(shared)))


def got(runs, w, case):
    pre = case + "."
    return {k[len(pre):]: v for k, v in runs[w][0].items() if k.startswith(pre)}


def oracle(db, dbids, q, k, mask=None):
    d = ((q[:, None, :].astype(np.float64) - db[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[dbids][None, :], d, np.inf)
    order = np.lexsort((np.broadcast_to(dbids, d.shape), d), axis=1)[:, :k]
    out_d = np.take_along_axis(d, order, 1)
    return out_d, np.where(np.isinf(out_d), -1, dbids[order])


def assert_close(got_d, want_d):
    got_d, want_d = np.asarray(got_d, np.float64), np.asarray(want_d, np.float64)
    assert (np.isinf(got_d) == np.isinf(want_d)).all()
    fin = np.isfinite(want_d)
    scale = np.where(fin, want_d, 0).max(axis=-1, keepdims=True)
    diff = np.abs(np.subtract(got_d, want_d, out=np.zeros_like(want_d), where=fin))
    assert (diff <= TOL * np.maximum(scale, 1.0)).all(), diff.max()


@pytest.mark.parametrize("w", WORLDS)
def test_ranks_on_the_card_match_the_oracle(card_runs, w):
    """Both routes, both stores, masked and unmasked, the tail, removal,
    device mode and the restage: the oracle's ids at W ranks on the card."""
    od, oi = oracle(X, IDS, Q, worker.K)
    s = got(card_runs, w, "search")
    for d, i in ((s["d"], s["i"]), (s["kd"], s["ki"])):
        np.testing.assert_array_equal(i, oi)
        assert_close(d, od)
    q8 = got(card_runs, w, "sq8")
    for d, i in ((q8["d"], q8["i"]), (q8["kd"], q8["ki"]), (q8["pd"], q8["pi"])):
        np.testing.assert_array_equal(i, oi)
        assert_close(d, od)
    np.testing.assert_array_equal(q8["mi"], oracle(X, IDS, Q, worker.K, MASK)[1])
    for dt in ("float32", "int8"):
        r = got(card_runs, w, f"round5_1d_{dt}")
        assert bool(r["staged"]) and int(r["tail"]) == 200 and int(r["removed"]) == 10
        np.testing.assert_array_equal(r["i"], oracle(X, IDS, Q, 5)[1])
        np.testing.assert_array_equal(r["mi"], oracle(X, IDS, Q, 5, MASK)[1])
        np.testing.assert_array_equal(r["kmi"], r["mi"])
        keep = IDS >= 10
        np.testing.assert_array_equal(r["ri"], oracle(X[keep], IDS[keep], Q, 5)[1])
    dv = got(card_runs, w, "device_mode")
    assert str(dv["mode"]) == "device" and int(dv["ntotal"]) == 999
    keep = IDS != 42
    np.testing.assert_array_equal(dv["after"], oracle(X[keep], IDS[keep], Q, 5)[1])
    np.testing.assert_array_equal(dv["loaded"], dv["after"])
    rs = got(card_runs, w, "restage")
    np.testing.assert_array_equal(rs["i_fold"], rs["i_tail"])
    np.testing.assert_array_equal(rs["i_tail"], oracle(X, IDS, Q, 5)[1])
    launches = got(card_runs, w, "launches")
    assert int(launches["float32"]) > 0 and int(launches["int8"]) > 0, launches
    for other in card_runs[w][1:]:
        for key, value in card_runs[w][0].items():
            np.testing.assert_array_equal(other[key], value, err_msg=key)


def test_two_level_and_2d_on_the_card(card_runs):
    r = got(card_runs, 4, "two_level")
    np.testing.assert_array_equal(r["ti"], r["fi"])
    np.testing.assert_array_equal(r["td"], r["fd"])
    np.testing.assert_array_equal(r["bi"], r["ai"])
    np.testing.assert_array_equal(r["ai"], oracle(X, IDS, Q, 5)[1])
    np.testing.assert_array_equal(got(card_runs, 4, "two_d")["i"], oracle(X, IDS, Q, 5)[1])
    for dt in ("float32", "int8"):
        r = got(card_runs, 4, f"round5_2level_{dt}")
        np.testing.assert_array_equal(r["mi"], got(card_runs, 4, f"round5_1d_{dt}")["mi"])
    rm = got(card_runs, 4, "remesh")
    np.testing.assert_array_equal(rm["after_i"], rm["before_i"])


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_one_rank_in_process_equals_flat_index(cuda, scan_dtype):
    """W = 1 without a process group at 200k x 384: the flat kernel (mode
    float32 or int8) + per-shard rerank gives FlatIndex's ids on the card,
    and the shard's kernel output equals its plain version on the shard's
    own operands."""
    rng = np.random.default_rng(7)
    n, d = 200_000, 384
    x = rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 64)] + 0.05 * rng.standard_normal((64, d), dtype=np.float32)
    mask = rng.random(n) < 0.1
    flat = FlatIndex(dim=d, scan_dtype=scan_dtype, device=cuda)
    flat.add(x, np.arange(n))
    index = ShardedFlatIndex(dim=d, scan_dtype=scan_dtype, device=cuda)
    index.add(x, np.arange(n))
    mode = "float32" if scan_dtype == "float32" else "int8"
    before = topk_cuda.fused_l2_topk.launches_by_mode[mode]
    got_d, got_i = index.search(q, 10)
    gm_d, gm_i = index.search(q, 10, id_mask=mask)
    assert topk_cuda.fused_l2_topk.launches_by_mode[mode] == before + 2
    for (gd, gi), (wd, wi) in (((got_d, got_i), flat.search(q, 10)),
                               ((gm_d, gm_i), flat.search(q, 10, id_mask=mask))):
        np.testing.assert_array_equal(gi, wi)
        assert_close(gd, wd)
    staged = index._stage()
    qd = torch.from_numpy(q).to(cuda)
    ks = shortlist_depth(10, n)
    if scan_dtype == "int8":
        ops = (staged[3], staged[1], staged[4], qd * staged[5])
    else:
        ops = staged[:3] + (qd,)
    kd, ki, kr = topk_cuda.fused_topk(*ops, ks, return_rows=True)
    pd, pi, pr = topk_cuda.fused_topk_reference(*ops, ks, return_rows=True)
    torch.cuda.synchronize()
    if scan_dtype == "int8":
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
        return
    # f32 (3xTF32 products): distances within 1e-4 relative; a differing id
    # must be a near-tie, its row's exact distance within 1e-4 of the slot's.
    torch.testing.assert_close(kd, pd, rtol=1e-4, atol=1e-4)
    b_idx, s_idx = torch.nonzero(ki != pi, as_tuple=True)
    rows = kr[b_idx, s_idx].long()
    exact = ((qd[b_idx] - staged[0][rows]) ** 2).sum(1)
    want = pd[b_idx, s_idx]
    assert bool(((exact - want).abs() <= 1e-4 * torch.clamp_min(want.abs(), 1.0)).all())


# -- the sharded IVF index ---------------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
def test_ivf_ranks_on_the_card(ivf_card_runs, w):
    """The IVF worker's cases at W ranks on the card: exhaustive probes give
    the oracle's ids on both routes and both stores, masked, after the tail,
    the removal and the restage, and in device mode; a filter that leaves
    every list underfilled returns no masked id (the select kernel's +inf
    fill becomes -1); each rank's kernels equal their plain versions on its
    block; every IVF kernel launched; results are replicated."""
    got_ = lambda case: got(ivf_card_runs, w, case)  # noqa: E731
    od, oi = oracle(X, IDS, Q, worker.K)
    for case in ("trained",):
        r = got_(case)
        np.testing.assert_array_equal(r["i"], oi)
        assert_close(r["d"], od)
    r = got_("routes_p16")
    for d, i in ((r["d"], r["i"]), (r["kd"], r["ki"])):
        np.testing.assert_array_equal(i, oi)
        assert_close(d, od)
    dense, select = got_("routes_dense"), got_("routes_select")
    np.testing.assert_array_equal(dense["i"], select["i"])
    np.testing.assert_array_equal(dense["d"], select["d"])
    few = ivf_worker.underfilled_mask()
    u = got_("underfilled")
    raw_inf = np.isinf(u["raw_d"])
    assert raw_inf.any() and (u["raw_i"][raw_inf] >= 0).all()
    assert ((u["i"] == -1) == np.isinf(u["d"])).all() and (u["i"] == -1).any()
    assert ((u["i"] < 0) | few[u["i"].clip(0)]).all()
    np.testing.assert_array_equal(u["i"], u["di"])
    np.testing.assert_array_equal(u["i"], u["ci"])
    want5 = oracle(X, IDS, Q, 5)
    for dt in ("float32", "int8"):
        m = got_(f"masked_{dt}")
        for i in (m["i"], m["ci"]):
            np.testing.assert_array_equal(i, oracle(X, IDS, Q, 5, MASK)[1])
        r5 = got_(f"round5_1d_{dt}")
        assert bool(r5["staged"]) and int(r5["tail"]) == 200 and int(r5["removed"]) == 10
        np.testing.assert_array_equal(r5["i"], want5[1])
        np.testing.assert_array_equal(r5["mi"], oracle(X, IDS, Q, 5, MASK)[1])
        keep = IDS >= 10
        np.testing.assert_array_equal(r5["ri"], oracle(X[keep], IDS[keep], Q, 5)[1])
        dv = got_(f"device_{dt}")
        assert str(dv["mode"]) == "device" and int(dv["ntotal"]) == 999
        keep = IDS != 42
        np.testing.assert_array_equal(dv["after"], oracle(X[keep], IDS[keep], Q, 5)[1])
        np.testing.assert_array_equal(dv["loaded"], dv["after"])
    np.testing.assert_array_equal(got_("sq8")["i"], want5[1])
    for mode in ("host", "device"):
        rs = got_(f"restage_{mode}")
        np.testing.assert_array_equal(rs["i_fold"], rs["i_tail"])
        np.testing.assert_array_equal(rs["i_tail"], want5[1])
    for rank in ivf_card_runs[w]:
        errs = {k: float(v) for k, v in rank.items() if k.startswith("kernels.")}
        assert set(errs) == {f"kernels.{k}" for k in ivf_worker.IVF_KERNELS}, errs
        assert errs["kernels.ivf_scan_dense_int8"] == 0.0
        launches = {k: int(v) for k, v in rank.items() if k.startswith("launches.")}
        assert all(v > 0 for v in launches.values()) and len(launches) == 3, launches
    for other in ivf_card_runs[w][1:]:
        for key, value in ivf_card_runs[w][0].items():
            if key not in ivf_worker.PER_RANK and not key.startswith("kernels."):
                np.testing.assert_array_equal(other[key], value, err_msg=key)
    if w == 4:
        t = got_("two_level")
        np.testing.assert_array_equal(t["ai"], t["bi"])
        np.testing.assert_array_equal(t["ad"], t["bd"])
        np.testing.assert_array_equal(t["a8i"], t["b8i"])
        np.testing.assert_array_equal(t["ki"], t["bi"])


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_ivf_one_rank_in_process_equals_ivf_flat(cuda, scan_dtype):
    """W = 1 without a process group at 200k x 384, nlist 256, device mode,
    on IVFFlatIndex's own centroids: ids equal IVFFlatIndex's on the card at
    a dense-route nprobe and at 16 (the select route for f32), unfiltered,
    with a 10% filter, and with a filter that leaves every probed list
    underfilled (nprobe 1, both f32 kernels); the block's kernels equal
    their plain versions; the path launched the kernels its store runs."""
    rng = np.random.default_rng(7)
    n, d = 200_000, 384
    centers = rng.standard_normal((256, d), dtype=np.float32)
    x = centers[rng.integers(0, 256, n)] + 0.6 * rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 64)] + 0.05 * rng.standard_normal((64, d), dtype=np.float32)
    mask = rng.random(n) < 0.1
    sparse = rng.random(n) < 0.002
    x_dev = torch.from_numpy(x).to(cuda)
    ids_dev = torch.arange(n, dtype=torch.int32, device=cuda)
    flat = IVFFlatIndex(dim=d, nlist=256, nprobe=16, scan_dtype=scan_dtype, device=cuda)
    flat.train(x_dev)
    flat.add(x_dev, ids_dev)
    index = ShardedIVFIndex(dim=d, nlist=256, nprobe=16, scan_dtype=scan_dtype, device=cuda)
    index._centroids = flat._centroids
    index.add(x_dev, ids_dev)
    index.search(q[:1], 10)
    pad_local = index._params[1]
    assert pad_local == flat._stage()[6]
    before = {k: getattr(ivf_scan_cuda, k).launches for k in ivf_worker.IVF_KERNELS}
    dense_np = max(1, 4096 // pad_local)
    cases = [({"nprobe": p}, {}) for p in (dense_np, 16)]
    cases += [({"nprobe": p, "id_mask": mask}, {}) for p in (dense_np, 16)]
    if scan_dtype == "float32":
        cases += [({"nprobe": 1, "id_mask": sparse}, {"scan": s}) for s in ("dense", "select")]
    for kw, route in cases:
        got_d, got_i = index._search(q, 10, kernel_route=True, **kw, **route)
        want_d, want_i = flat._search(q, 10, card_route=True, **kw, **route)
        np.testing.assert_array_equal(got_i, want_i)
        assert_close(got_d, want_d)
        if "scan" in route:
            assert (got_i == -1).any() and ((got_i < 0) | sparse[got_i.clip(0)]).all()
    launched = {k: getattr(ivf_scan_cuda, k).launches - v for k, v in before.items()}
    if scan_dtype == "float32":
        assert launched["ivf_scan_dense"] > 0 and launched["ivf_scan_select"] > 0, launched
    else:
        assert launched["ivf_scan_dense_int8"] > 0, launched
    errs = ivf_worker.kernel_check(index, q, 16, 10 if scan_dtype == "float32" else 20)
    assert set(errs) == ({"ivf_scan_dense", "ivf_scan_select"} if scan_dtype == "float32"
                         else {"ivf_scan_dense_int8"}), errs


# -- the sharded IVF-PQ index ------------------------------------------------------------


def assert_exact(d, i, db=X, q=Q):
    """The per-shard refine is exact: each distance is its id's row's."""
    live = i >= 0
    true = ((q[:, None, :].astype(np.float64) - db[i.clip(0)]) ** 2).sum(-1)
    assert_close(np.where(live, d, 0.0), np.where(live, true, 0.0))


def overlap(i, want_i):
    return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(i, want_i)) / want_i.size


@pytest.mark.parametrize("w", WORLDS)
def test_pq_ranks_on_the_card(pq_card_runs, w):
    """The IVF-PQ worker's cases at W ranks on the card (search takes the
    dense ADC kernel per shard): exact distances on both routes and every
    quantizer, recall@5 >= 0.8 where the JAX tests claim it (8-bit codes),
    no masked id, the tail, the removal, device mode and the restage; each
    rank's kernel equals its plain version on its block; the kernel
    launched on every rank; results replicated."""
    got_ = lambda case: got(pq_card_runs, w, case)  # noqa: E731
    want = oracle(X, IDS, Q, 5)[1]
    for name in ("base", "refine8", "opq", "k16"):
        for nprobe in (4, 16):
            r = got_(f"routes_{name}_p{nprobe}")
            for d, i in ((r["d"], r["i"]), (r["kd"], r["ki"])):
                assert_exact(d, i)
        r = got_(f"routes_{name}_p16")
        if name == "k16":
            # 16 codewords a subspace: the JAX tests claim exactness, not
            # recall (TestShardedIVFPQRound4::test_ksub16_exact_distances).
            assert (r["ki"] >= 0).all() and (r["i"] >= 0).all()
        else:
            assert overlap(r["ki"], want) >= 0.8 and overlap(r["i"], want) >= 0.8
        m = got_(f"masked_{name}")
        for i in (m["i"], m["ki"]):
            assert ((i < 0) | MASK[i.clip(0)]).all()
    for route in ("plain", "kernel"):
        p = got_(f"program_{route}")
        r = got_("routes_base_p4")
        np.testing.assert_array_equal(p["i"], r["i" if route == "plain" else "ki"])
    r5 = got_("round5_1d")
    assert bool(r5["staged"]) and int(r5["tail"]) == 200 and int(r5["removed"]) == 10
    assert not np.isin(r5["ri"], IDS[:10]).any() and overlap(r5["i"], want) >= 0.8
    assert_exact(r5["d"], r5["i"])
    for i in (r5["mi"], r5["kmi"]):
        assert ((i < 0) | MASK[i.clip(0)]).all()
    dv = got_("device")
    assert str(dv["mode"]) == "device" and int(dv["ntotal"]) == 999
    np.testing.assert_array_equal(dv["loaded"], dv["after"])
    np.testing.assert_array_equal(dv["state_vecs"], X[dv["state_ids"]])
    assert not (dv["after"] == 42).any()
    for mode in ("host", "device"):
        rs = got_(f"restage_{mode}")
        assert bool(rs["tail_gone"])
        assert_exact(rs["d_fold"], rs["i_fold"])
    for rank in pq_card_runs[w]:
        errs = {k: float(v) for k, v in rank.items() if k.startswith("kernels.")}
        assert set(errs) == {"kernels.adc_scan_dense_base", "kernels.adc_scan_dense_k16"}, errs
        assert all(v == 0.0 for v in errs.values())
        assert int(rank["launches.adc_scan_dense"]) > 0, rank["launches.adc_scan_dense"]
        assert int(rank["launches.adc_scan_select"]) == 0
    for other in pq_card_runs[w][1:]:
        for key, value in pq_card_runs[w][0].items():
            if not key.startswith("kernels."):
                np.testing.assert_array_equal(other[key], value, err_msg=key)
    if w == 4:
        t = got_("two_level")
        for a, b in (("ai", "bi"), ("ad", "bd"), ("aki", "bki"), ("akd", "bkd")):
            np.testing.assert_array_equal(t[a], t[b])


@pytest.mark.parametrize("m,ksub", [(96, 256), (96, 16)])
def test_pq_one_rank_in_process_equals_ivf_pq(cuda, m, ksub):
    """W = 1 without a process group at 200k x 384, nlist 256, device mode,
    on IVFPQIndex's own quantizer (m 96; ksub 256, or 16 nibble-packed):
    the card route shortlists as IVFPQIndex's dense route (k 20,
    refine_factor 20: k_adc 400) and the plain route as IVFPQIndex's CPU
    route, on >= 99% of the rows, unfiltered and with a 10% filter; every
    returned distance is exact; the dense ADC kernel launched once per
    card-route search, and equals its plain version on the block."""
    rng = np.random.default_rng(7)
    n, d = 200_000, 384
    centers = rng.standard_normal((256, d), dtype=np.float32)
    x = centers[rng.integers(0, 256, n)] + 0.6 * rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 64)] + 0.05 * rng.standard_normal((64, d), dtype=np.float32)
    mask = rng.random(n) < 0.1
    x_dev = torch.from_numpy(x).to(cuda)
    ids_dev = torch.arange(n, dtype=torch.int32, device=cuda)
    single = IVFPQIndex(dim=d, nlist=256, nprobe=16, m=m, ksub=ksub, refine_factor=20,
                        device=cuda)
    single.train(x_dev)
    single.add(x_dev, ids_dev)
    index = ShardedIVFPQIndex(dim=d, nlist=256, nprobe=16, m=m, ksub=ksub, refine_factor=20,
                              device=cuda)
    index._centroids, index._codebooks = single._centroids, single._codebooks
    index.add(x_dev, ids_dev)
    index.search(q[:1], 20)
    assert index._params[1] == single._stage()[7]
    before = adc_cuda.adc_scan_dense.launches
    for kw in ({}, {"id_mask": mask}):
        got_d, got_i = index._search(q, 20, kernel_route=True, **kw)
        want_d, want_i = single._search(q, 20, card_route=True, **kw)
        assert (got_i == want_i).all(axis=1).mean() >= 0.99
        assert_exact(got_d, got_i, x, q)
        pd, pi = index._search(q, 20, kernel_route=False, **kw)
        cd, ci = single._search(q, 20, card_route=False, **kw)
        assert (pi == ci).all(axis=1).mean() >= 0.99
        assert_exact(pd, pi, x, q)
        if kw:
            for i in (got_i, pi):
                assert ((i < 0) | mask[i.clip(0)]).all()
    # the two indexes' card routes, each unfiltered and filtered
    assert adc_cuda.adc_scan_dense.launches - before == 4
    assert pq_worker.kernel_check(index, q, 16, 400, 8) == 0.0
