"""The port's sharded IVF index (c99_vectordb_tpu_torch.parallel
ShardedIVFIndex, sharded_kmeans_step and the IVF programs) at W gloo ranks
against the JAX package's on a mesh of W of the conftest's 8 virtual
devices, W in {1, 2, 4}, on the same numpy inputs (tests/test_parallel.py's
corpus: 1000 x 64, nlist 16).

A module fixture spawns every W once (tests/torch_parallel_ivf_worker.py,
one process per rank, all at once) and reads back what each rank got; each
case below is one test over those results. Every case but the port's own
training starts from one coarse quantizer, the JAX class's (centroids.npy),
so both packages probe the same lists: the two k-means sum in different
orders and their centroids differ in the last bits. The JAX package's
kernel routes run in interpret mode, as tests/test_parallel.py runs them;
the port's card route runs the IVF kernels' plain versions on the CPU.

Ids must be equal. Distances are held to REL: |got - want| <= REL times the
largest finite distance of the query's row (the packages sum in different
orders), or bit for bit where the test says so.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ivf_worker as worker
from c99_vectordb_tpu.parallel import (
    ShardedIVFIndex as JIVF, make_host_chip_mesh as j_host_chip, make_mesh as j_mesh,
    sharded_kmeans_step as j_kmeans_step, sharded_search_2d as j_2d,
)
from c99_vectordb_tpu.parallel import sharded as jsharded
from c99_vectordb_tpu.storage import index_io as jio
from c99_vectordb_tpu_torch import commands as tcommands
from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex as TIVF
from c99_vectordb_tpu_torch.models.registry import resolve
from c99_vectordb_tpu_torch.parallel import ShardedIVFIndex, default_data_mesh
from c99_vectordb_tpu_torch.parallel import sharded as tsharded

REL = 1e-5
WORLDS = (1, 2, 4)
JOIN_TIMEOUT_S = 120
REPO = Path(__file__).resolve().parent.parent
X, IDS, Q = worker.corpus()
MASK = worker.third_mask()
K = worker.K


def _spawn(world: int, out: Path, shared: Path):
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", C99VDB_PLATFORM="cpu")
    procs = []
    for rank in range(world):
        log = (out / f"log{rank}").open("w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(worker.__file__)), "--world", str(world), "--rank",
             str(rank), "--store", str(out / "store"), "--out", str(out), "--shared",
             str(shared)], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(out)))
        log.close()
    return procs


def jmesh(w):
    return j_mesh(n_data=w, devices=jax.devices()[:w])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: [rank 0's results, ...]}, "root", "cents": the shared quantizer."""
    root = tmp_path_factory.mktemp("ivf_ranks")
    shared = root / "shared"
    shared.mkdir()
    j = JIVF(dim=64, nlist=worker.NLIST, nprobe=16, mesh=j_mesh(n_data=8))
    j.load(X, IDS)
    np.save(shared / "centroids.npy", np.asarray(j._centroids))
    for dt in ("float32", "int8"):
        j8 = JIVF(dim=64, nlist=worker.NLIST, nprobe=16, scan_dtype=dt, mesh=j_mesh(n_data=8))
        j8.load(X, IDS)
        jio.write_index(j8, shared / f"jax_w8_{dt}.memo")
        # 3 devices, device mode, staged: the file holds its rows in the
        # 3-shard canvas order, not by id.
        j3 = JIVF(dim=64, nlist=worker.NLIST, nprobe=16, scan_dtype=dt, mesh=jmesh(3))
        j3.load(jax.numpy.asarray(X), jax.numpy.asarray(IDS.astype(np.int32)))
        j3.search(Q, 5)
        jio.write_index(j3, shared / f"jax_w3_{dt}.memo")
    procs = {w: _spawn(w, root / f"w{w}", shared) for w in WORLDS}
    failed = []
    for w, ps in procs.items():
        for rank, p in enumerate(ps):
            try:
                rc = p.wait(timeout=JOIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for other in (o for group in procs.values() for o in group):
                    other.kill()
                rc = "timeout"
            if rc != 0:
                failed.append((w, rank, rc, (root / f"w{w}" / f"log{rank}").read_text()[-3000:]))
    assert not failed, failed
    out = {"root": root, "cents": np.load(shared / "centroids.npy")}
    for w in WORLDS:
        ranks = []
        for r in range(w):
            with np.load(root / f"w{w}" / f"r{r}.npz") as z:
                ranks.append({key: z[key] for key in z.files})
        out[w] = ranks
    return out


def got(runs, w, case):
    """Rank 0's results of one case, as {name: array}."""
    pre = case + "."
    return {k[len(pre):]: v for k, v in runs[w][0].items() if k.startswith(pre)}


def jax_built(runs, w, dt="float32", nprobe=16, n=1000, mesh=None, rerank="float32",
              cents=None):
    """The JAX index on the shared quantizer (what the worker's built()
    makes), on W virtual devices."""
    j = JIVF.from_state(worker.params(dt, nprobe, rerank), {
        "vectors": X[:n], "ids": IDS[:n],
        "centroids": runs["cents"] if cents is None else cents})
    j.mesh = jmesh(w) if mesh is None else mesh
    return j


def assert_close(got_d, want_d):
    """|got - want| <= REL x the row's largest finite distance; +inf in the
    same places."""
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    assert (np.isinf(got_d) == np.isinf(want_d)).all()
    fin = np.isfinite(want_d)
    scale = np.where(fin, want_d, 0).max(axis=-1, keepdims=True)
    diff = np.abs(np.subtract(got_d, want_d, out=np.zeros_like(want_d), where=fin))
    assert (diff <= REL * np.maximum(scale, 1.0)).all(), diff.max()


def assert_same(got_pair, want_pair):
    np.testing.assert_array_equal(got_pair[1], want_pair[1])
    assert_close(got_pair[0], want_pair[0])


def oracle(db, dbids, q, k, mask=None):
    d = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[dbids][None, :], d, np.inf)
    out_d = np.sort(d, axis=1)[:, :k]
    order = np.lexsort((np.broadcast_to(dbids, d.shape), d), axis=1)[:, :k]
    return out_d, np.where(np.isinf(out_d), -1, dbids[order])


def recall(i, want_i):
    return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(i, want_i)) / want_i.size


# -- mirror of TestShardedIVF -----------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
def test_full_probe_matches_flat_and_jax(runs, w):
    """The port trains its own quantizer (replicated: every rank's centroids
    are bit-equal, test_every_rank_has_the_same_results); they are the JAX
    class's within 1e-5, and on them the JAX class searches as the port
    does. Probing every list is exact search."""
    r = got(runs, w, "trained")
    np.testing.assert_allclose(r["centroids"], runs["cents"], rtol=1e-5, atol=1e-5)
    assert_same((r["d"], r["i"]), oracle(X, IDS, Q, K))
    j = jax_built(runs, w, cents=r["centroids"])
    assert_same((r["d"], r["i"]), j.search(Q, K, nprobe=16))
    np.testing.assert_array_equal(r["lo"], j.search(Q, K, nprobe=2)[1])
    np.testing.assert_array_equal(r["hi"], j.search(Q, K, nprobe=8)[1])


@pytest.mark.parametrize("w", WORLDS)
def test_partial_probe_recall(runs, w):
    r = got(runs, w, "trained")
    want_i = oracle(X, IDS, Q, K)[1]
    assert recall(r["hi"], want_i) >= recall(r["lo"], want_i)
    assert recall(r["hi"], want_i) > 0.3


@pytest.mark.parametrize("w", WORLDS)
def test_empty(runs, w):
    r = got(runs, w, "empty")
    assert r["i"].shape == (2, 3) and (r["i"] == -1).all() and np.isinf(r["d"]).all()


# -- mirror of TestDistributedKMeans ------------------------------------------------------


def _jax_steps(w, data, init, iters, dim, k):
    m = jmesh(w)
    step = j_kmeans_step(m, data.shape[0], dim, k)
    c = jax.device_put(init, NamedSharding(m, P(None, None)))
    dd = jax.device_put(data, NamedSharding(m, P("data", None)))
    valid = jax.device_put(np.ones((data.shape[0],), np.float32), NamedSharding(m, P("data")))
    for _ in range(iters):
        c = step(dd, valid, c)
    return np.asarray(c)


@pytest.mark.parametrize("w", WORLDS)
def test_kmeans_step_matches_jax_and_lloyd(runs, w):
    """Five distributed Lloyd steps at W ranks: the JAX step's centroids on
    W devices within 1e-5, and a single-device numpy Lloyd's within 1e-3."""
    data, _, _ = worker.kmeans_data()
    got_c = got(runs, w, "kmeans")["step"]
    np.testing.assert_allclose(got_c, _jax_steps(w, data, data[:8].copy(), 5, 32, 8),
                               rtol=1e-5, atol=1e-5)
    cents = data[:8].copy()
    for _ in range(5):
        assign = ((data[:, None, :] - cents[None, :, :]) ** 2).sum(-1).argmin(1)
        for c in range(8):
            if (assign == c).any():
                cents[c] = data[assign == c].mean(0)
    np.testing.assert_allclose(got_c, cents, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("w", WORLDS)
def test_kmeans_step_recovers_blobs(runs, w):
    _, blobs, centers = worker.kmeans_data()
    got_c = got(runs, w, "kmeans")["blobs"]
    np.testing.assert_allclose(got_c, _jax_steps(w, blobs, blobs[:8].copy(), 8, 16, 8),
                               rtol=1e-5, atol=1e-5)
    d = ((centers[:, None, :] - got_c[None, :, :]) ** 2).sum(-1)
    assert (d.min(axis=1) < 16.0).sum() >= 6


# -- mirror of TestSlotShardLayout ----------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_slot_shard_layout(shards):
    """The host layout equals the JAX package's bit for bit; the device form
    equals the host form; capacity, balance and in-list order hold."""
    rng = np.random.default_rng(shards)
    nlist = 7
    assign = rng.integers(0, nlist, 500).astype(np.int64)
    pad_local, order, sorted_lists, slots = tsharded._slot_shard_layout(assign, nlist, shards)
    want = jsharded._slot_shard_layout(assign, nlist, shards)
    assert pad_local == want[0]
    for a, b in zip((order, sorted_lists, slots), want[1:]):
        np.testing.assert_array_equal(a, b)
    dev = tsharded._slot_shard_layout_device(torch.from_numpy(assign), nlist, shards)
    assert dev[0] == pad_local
    for a, b in zip(dev[1:4], (order, sorted_lists, slots)):
        np.testing.assert_array_equal(a.numpy(), b)
    pad = pad_local * shards
    assert (slots >= 0).all() and (slots < pad).all()
    assert len(set(zip(sorted_lists.tolist(), slots.tolist()))) == len(assign)
    chip = slots // pad_local
    local = slots % pad_local
    for lst in range(nlist):
        m = sorted_lists == lst
        counts = np.bincount(chip[m], minlength=shards)
        assert counts.max() - counts.min() <= 1
        for c in range(shards):
            mc = m & (chip == c)
            if mc.sum() > 1:
                assert (np.diff(local[mc]) > 0).all()


# -- mirror of TestSlotSharding's IVF cases ------------------------------------------------


def test_scan_rows_scale_inverse_with_shards(runs):
    rows = {w: int(got(runs, w, "rows")["rows_per_chip"]) for w in WORLDS}
    for w in WORLDS:
        r = got(runs, w, "rows")
        assert int(r["shards"]) == w
        assert int(r["rows_per_chip"]) * w == int(r["rows_all_chips"])
        assert int(r["rows_per_chip"]) == jax_built(runs, w, nprobe=4).scan_rows_per_chip(
            b=6)["rows_per_chip"]
    assert rows[2] <= rows[1] / 2 * 1.5
    assert rows[4] <= rows[1] / 4 * 2.0
    assert rows[4] < rows[2] < rows[1]


@pytest.mark.parametrize("w", WORLDS)
def test_identical_to_single_device_ivf_and_jax(runs, w):
    """At nprobe 1, 4 and 16, on one quantizer: the plain probe route
    equals the JAX class's search on W devices and the single-device
    IVFFlatIndex's CPU route; the card route equals IVFFlatIndex's."""
    single = TIVF(dim=64, nlist=worker.NLIST, nprobe=4, device="cpu")
    single._centroids = runs["cents"]
    single.add(X, IDS)
    j = jax_built(runs, w, nprobe=4)
    for nprobe in (1, 4, 16):
        r = got(runs, w, f"routes_p{nprobe}")
        assert_same((r["d"], r["i"]), j.search(Q, K, nprobe=nprobe))
        assert_same((r["d"], r["i"]), single._search(Q, K, nprobe=nprobe, card_route=False))
        assert_same((r["kd"], r["ki"]), single._search(Q, K, nprobe=nprobe, card_route=True))


@pytest.mark.parametrize("w", WORLDS)
def test_kernel_route_matches_cpu_route_and_jax_interpret(runs, w):
    """The card route (the select or dense kernel per shard, their plain
    versions here) equals the plain probe route, the forced select and
    dense routes equal each other bit for bit, and the JAX package's Pallas
    route (interpret mode) on the same blocks gives the same ids."""
    for nprobe in (1, 4, 16):
        r = got(runs, w, f"routes_p{nprobe}")
        assert_same((r["kd"], r["ki"]), (r["d"], r["i"]))
    dense, select = got(runs, w, "routes_dense"), got(runs, w, "routes_select")
    np.testing.assert_array_equal(dense["d"], select["d"])
    np.testing.assert_array_equal(dense["i"], select["i"])
    np.testing.assert_array_equal(dense["i"], got(runs, w, "routes_p4")["ki"])
    j = jax_built(runs, w, nprobe=4)
    staged = j._stage()
    nlist, pad_local = j._params
    prog = jsharded.sharded_ivf_search_program(j.mesh, nlist, pad_local, 64, Q.shape[0], 4, K,
                                               use_kernels=True)
    jd, ji = prog(*staged, jax.device_put(Q, NamedSharding(j.mesh, P(None, None))))
    assert_same((dense["d"], dense["i"]), (np.asarray(jd), np.asarray(ji)))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_masked_search_matches_oracle_and_jax(runs, w, dt):
    """A third of the ids kept, every list probed: the oracle's ids on the
    card route and the plain route, no masked id, the JAX class's ids."""
    r = got(runs, w, f"masked_{dt}")
    want = oracle(X, IDS, Q, 5, MASK)
    for pair in ((r["d"], r["i"]), (r["cd"], r["ci"])):
        assert ((pair[1] < 0) | MASK[pair[1].clip(0)]).all(), "mask leak"
        assert_same(pair, want)
    assert_same((r["d"], r["i"]), jax_built(runs, w, dt).search(Q, 5, id_mask=MASK))


@pytest.mark.parametrize("w", WORLDS)
def test_underfilled_list_drops_masked_ids(runs, w):
    """A filter that keeps 4 ids, one probe: the select kernel fills each
    underfilled list with masked rows at +inf with their real ids (the raw
    scan on rank 0's block shows them), and the merge turns every +inf
    into -1, so no masked id comes back; the dense route and the plain
    route give the same results, and so does the JAX class."""
    r = got(runs, w, "underfilled")
    few = worker.underfilled_mask()
    raw_inf = np.isinf(r["raw_d"])
    assert raw_inf.any() and (r["raw_i"][raw_inf] >= 0).all()
    assert not few[r["raw_i"][raw_inf]].any()
    assert ((r["i"] == -1) == np.isinf(r["d"])).all() and (r["i"] == -1).any()
    assert ((r["i"] < 0) | few[r["i"].clip(0)]).all()
    np.testing.assert_array_equal(r["i"], r["di"])
    np.testing.assert_array_equal(r["d"], r["dd"])
    assert_same((r["d"], r["i"]), (r["cd"], r["ci"]))
    j = jax_built(runs, w, nprobe=4)
    assert_same((r["d"], r["i"]), j.search(X[:6], K, nprobe=1, id_mask=few))


@pytest.mark.parametrize("w", WORLDS)
def test_sq8_scan_is_exact(runs, w):
    """The int8 scan shortlists; the per-shard exact rerank restores the
    exact top-5 (the oracle's, the JAX class's at W). The global scale
    equals the JAX one within 1 ulp (the SQ8-scale deviation)."""
    r = got(runs, w, "sq8")
    assert_same((r["d"], r["i"]), oracle(X, IDS, Q, 5))
    j = jax_built(runs, w, "int8")
    assert_same((r["d"], r["i"]), j.search(Q, 5, nprobe=16))
    staged = j._stage()
    assert int(r["pad_local"]) == j._params[1]
    np.testing.assert_array_max_ulp(r["scale"], np.asarray(staged[3]), maxulp=1)


@pytest.mark.parametrize("w", WORLDS)
def test_sq8_bf16_rerank_matches_jax(runs, w):
    r = got(runs, w, "sq8_bf16")
    assert_same((r["d"], r["i"]), jax_built(runs, w, "int8", rerank="bfloat16").search(Q, 5))


def test_bad_dtype_combinations_raise():
    with pytest.raises(ValueError, match="int8"):
        ShardedIVFIndex(dim=64, scan_dtype="float32", rerank_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="unsupported scan_dtype"):
        ShardedIVFIndex(dim=64, scan_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="unsupported rerank_dtype"):
        ShardedIVFIndex(dim=64, scan_dtype="int8", rerank_dtype="float16", device="cpu")
    # a legacy float32 + bfloat16 file loads as float32 + float32
    legacy = ShardedIVFIndex.from_state(
        {"dim": 8, "nlist": 2, "nprobe": 2, "scan_dtype": "float32",
         "rerank_dtype": "bfloat16"},
        {"vectors": np.zeros((0, 8), np.float32), "ids": np.zeros((0,), np.int64),
         "centroids": np.zeros((0, 8), np.float32)}, device="cpu")
    assert legacy.rerank_dtype == "float32"


# -- files: at W, from the JAX package at 8 and 3 devices, into the JAX package ----------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_round_trip_at_w(runs, w, dt):
    r = got(runs, w, f"roundtrip_{dt}")
    assert str(r["kind"]) == "sharded_ivf" and str(r["scan_dtype"]) == dt
    assert int(r["ntotal"]) == 1000
    assert_same((r["d"], r["i"]), jax_built(runs, w, dt).search(Q, 5))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("devices", [8, 3])
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_reload_on_different_device_count(runs, w, devices, dt):
    """TestCodeReviewRegressions::test_reload_on_different_device_count
    [sharded_ivf]: a file the JAX package wrote on 8 devices (host mode)
    or on 3 (device mode, rows in its canvas order) loads at W ranks and
    searches as the JAX index that wrote it."""
    r = got(runs, w, f"from_jax{devices}_{dt}")
    assert str(r["kind"]) == "sharded_ivf" and str(r["scan_dtype"]) == dt
    assert int(r["ntotal"]) == 1000
    src = jio.read_index(runs["root"] / "shared" / f"jax_w{devices}_{dt}.memo")
    src.mesh = jmesh(devices)
    assert_same((r["d"], r["i"]), src.search(Q, 5))


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("jax_devices", [8, 3])
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_port_file_loads_in_jax(runs, w, jax_devices, dt):
    loaded = jio.read_index(runs["root"] / f"w{w}" / f"port_w{w}_{dt}.memo")
    loaded.mesh = jmesh(jax_devices)
    assert type(loaded) is JIVF and loaded.scan_dtype == dt and loaded.ntotal == 1000
    np.testing.assert_array_equal(loaded.ids(), IDS)
    np.testing.assert_array_equal(np.asarray(loaded._centroids), runs["cents"])
    assert_same(loaded.search(Q, 5), (got(runs, w, f"roundtrip_{dt}")["d"],
                                      got(runs, w, f"roundtrip_{dt}")["i"]))


# -- mirror of TestShardedRound5 (ivf, ivf_sq8) ------------------------------------------------


ROUND5 = [(w, mesh, dt) for w in WORLDS for mesh in ("1d", "2level") for dt in ("float32", "int8")
          if mesh == "1d" or w == 4]


@pytest.mark.parametrize("w,mesh,dt", ROUND5)
def test_incremental_add_mask_and_remove(runs, w, mesh, dt):
    r = got(runs, w, f"round5_{mesh}_{dt}")
    assert bool(r["staged"]) and int(r["tail"]) == 200
    assert_same((r["d"], r["i"]), oracle(X, IDS, Q, 5))
    want = oracle(X, IDS, Q, 5, MASK)
    for pair in ((r["md"], r["mi"]), (r["cmd"], r["cmi"])):
        assert ((pair[1] < 0) | MASK[pair[1].clip(0)]).all(), "mask leak"
        assert_same(pair, want)
    assert int(r["removed"]) == 10 and bool(r["still_staged"]) and int(r["ntotal"]) == 990
    keep = IDS >= 10
    assert_same((r["rd"], r["ri"]), oracle(X[keep], IDS[keep], Q, 5))
    # the JAX package through the same steps, on the same quantizer
    j = jax_built(runs, w, dt, n=800, mesh=jmesh(w) if mesh == "1d" else j_host_chip(2, 2))
    j.search(Q, 5)
    j.add(X[800:], IDS[800:])
    assert_same((r["d"], r["i"]), j.search(Q, 5))
    assert_same((r["md"], r["mi"]), j.search(Q, 5, id_mask=MASK))
    assert j.remove_ids(IDS[:10]) == 10
    assert_same((r["rd"], r["ri"]), j.search(Q, 5))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_device_mode_end_to_end(runs, w, dt):
    """Tensors in: device mode trains on the device, stages, parks the tail,
    filters, reconstructs, removes in place and serializes; the JAX class's
    device mode through the same steps keeps the same rows in the same
    (canvas) order."""
    r = got(runs, w, f"device_{dt}")
    assert str(r["mode"]) == "device" and int(r["tail"]) == 200
    assert_same((r["d"], r["i"]), oracle(X, IDS, Q, 5))
    assert ((r["mi"] < 0) | MASK[r["mi"].clip(0)]).all()
    np.testing.assert_array_equal(r["mi"], oracle(X, IDS, Q, 5, MASK)[1])
    np.testing.assert_array_equal(r["rec"], X[42])
    assert int(r["removed"]) == 1 and int(r["ntotal"]) == 999
    assert r["state_vecs"].shape == (999, 64)
    np.testing.assert_array_equal(np.sort(r["ids"]), IDS[IDS != 42])
    np.testing.assert_array_equal(r["state_ids"], r["ids"])
    np.testing.assert_array_equal(r["state_vecs"], X[r["state_ids"]])
    np.testing.assert_array_equal(r["loaded"], r["after"])
    keep = IDS != 42
    np.testing.assert_array_equal(r["after"], oracle(X[keep], IDS[keep], Q, 5)[1])
    import jax.numpy as jnp

    j = JIVF(dim=64, nlist=worker.NLIST, nprobe=16, scan_dtype=dt, mesh=jmesh(w))
    j.add(jnp.asarray(X[:800]), jnp.asarray(IDS[:800].astype(np.int32)))
    j.search(Q, 5)
    j.add(jnp.asarray(X[800:]), jnp.asarray(IDS[800:].astype(np.int32)))
    assert j.remove_ids([42]) == 1
    jp, jarrays = j.state()
    np.testing.assert_allclose(r["centroids"], jarrays["centroids"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(r["state_ids"], jarrays["ids"])
    np.testing.assert_array_equal(r["ranked"], j.ranked_all(Q[0])[1])


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("mode", ["host", "device"])
def test_tail_then_restage_matches(runs, w, mode):
    r = got(runs, w, f"restage_{mode}")
    assert bool(r["tail_gone"])
    np.testing.assert_array_equal(r["i_fold"], r["i_tail"])
    assert_close(r["d_fold"], r["d_tail"])
    np.testing.assert_array_equal(r["i_tail"], oracle(X, IDS, Q, 5)[1])


@pytest.mark.parametrize("w", WORLDS)
def test_mask_cache_reuse(runs, w):
    r = got(runs, w, "mask_cache")
    assert bool(r["reused"]) and bool(r["rebuilt"])


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_has_the_same_results(runs, w):
    """Outputs are replicated after the merge, and the replicated k-means
    gives every rank bit-equal centroids: every rank's results equal rank
    0's bit for bit (all but the scans of a rank's own block)."""
    first = runs[w][0]
    assert "trained.centroids" in first and "device_float32.centroids" in first
    for other in runs[w][1:]:
        assert other.keys() == first.keys()
        for key, value in first.items():
            if key not in worker.PER_RANK:
                np.testing.assert_array_equal(other[key], value, err_msg=key)


# -- W = 4: the two-level merge, a reassigned mesh ----------------------------------------------


def test_two_level_mesh_matches_1d_and_jax(runs):
    """2 hosts x 2 chips: f32 and int8 equal the 1-D mesh bit for bit, the
    card route on the two-level mesh equals the plain route (and the
    standalone sharded_ivf_search_2level on the same blocks, bit for bit),
    and both equal the JAX class on a (2, 2) mesh."""
    r = got(runs, 4, "two_level")
    assert int(r["shards"]) == 4
    for a, b in (("a", "b"), ("a8", "b8"), ("k", "p")):
        np.testing.assert_array_equal(r[f"{a}i"], r[f"{b}i"])
        np.testing.assert_array_equal(r[f"{a}d"], r[f"{b}d"])
    assert_same((r["kd"], r["ki"]), (r["bd"], r["bi"]))
    assert_same((r["bd"], r["bi"]), jax_built(runs, 4, nprobe=4, mesh=j_host_chip(2, 2)).search(
        Q, K, nprobe=4))
    assert_same((r["b8d"], r["b8i"]), jax_built(runs, 4, "int8", mesh=j_host_chip(2, 2)).search(
        Q, 5, nprobe=16))


def test_reassigned_mesh_restages(runs):
    r = got(runs, 4, "remesh")
    assert int(r["ntotal"]) == 1000 and int(r["shards"]) == 4
    np.testing.assert_array_equal(r["after_i"], r["before_i"])
    np.testing.assert_array_equal(r["after_d"], r["before_d"])


@pytest.mark.parametrize("w", WORLDS)
def test_dryrun_twin_matches_jax(runs, w):
    """parallel/dryrun.dryrun_multichip at W ranks: its Lloyd step and 2-D
    search at the JAX function's shapes equal the JAX programs' on W
    devices."""
    r = got(runs, w, "dryrun")
    n_model = 2 if w == 4 else 1
    n_data = w // n_model
    dim, n = 128 * n_model, 16 * n_data
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    queries = rng.standard_normal((4, dim)).astype(np.float32)
    m = j_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:w])
    step = j_kmeans_step(m, n, dim, 4)
    c = step(jax.device_put(data, NamedSharding(m, P("data", None))),
             jax.device_put(np.ones((n,), np.float32), NamedSharding(m, P("data"))),
             jax.device_put(data[:4].copy(), NamedSharding(m, P(None, None))))
    np.testing.assert_allclose(r["kmeans_centroids"], np.asarray(c), rtol=1e-5, atol=1e-5)
    jd, ji = j_2d(m, n, dim, 4, 3)(
        jax.device_put(data, NamedSharding(m, P("data", "model"))),
        jax.device_put(np.arange(n, dtype=np.int32), NamedSharding(m, P("data"))),
        jax.device_put(queries, NamedSharding(m, P(None, "model"))))
    assert_same((r["search_2d_d"], r["search_2d_i"]), (np.asarray(jd), np.asarray(ji)))
    assert (r["ivf_i"][:, 0] >= 0).all() and (r["sq8_i"][:, 0] >= 0).all()
    if w == 4:
        np.testing.assert_array_equal(r["ivf_2level_i"], r["ivf_i"])


# -- one rank, no process group; the kind's plumbing ---------------------------------------------


def test_world_of_one_and_the_kind(monkeypatch):
    """No launcher: one rank on the resolved device. resolve() and
    make_index build the port's class; CUDA without a card raises."""
    assert not torch.distributed.is_initialized()
    assert resolve("sharded_ivf") is ShardedIVFIndex
    idx = ShardedIVFIndex(dim=64, nlist=worker.NLIST, nprobe=16, device="cpu")
    assert idx.mesh.shape == default_data_mesh("cpu").shape == {"data": 1}
    idx.load(X, IDS)
    assert_same(idx.search(Q, K), oracle(X, IDS, Q, K))
    monkeypatch.setenv("C99VDB_INDEX", "sharded_ivf")
    monkeypatch.setenv("C99VDB_NLIST", "32")
    monkeypatch.setenv("C99VDB_NPROBE", "4")
    monkeypatch.setenv("C99VDB_SCAN_DTYPE", "int8")
    monkeypatch.setenv("C99VDB_RERANK_DTYPE", "bfloat16")
    made = tcommands.make_index(device="cpu")
    assert (made.kind, made.nlist, made.nprobe, made.scan_dtype, made.rerank_dtype) == (
        "sharded_ivf", 32, 4, "int8", "bfloat16")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            ShardedIVFIndex(dim=8, device="cuda")
