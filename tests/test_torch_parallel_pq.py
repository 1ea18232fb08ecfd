"""The port's sharded IVF-PQ index (c99_vectordb_tpu_torch.parallel
ShardedIVFPQIndex and sharded_pq_search_program) at W gloo ranks against
the JAX package's on a mesh of W of the conftest's 8 virtual devices, W in
{1, 2, 4}, on the same numpy inputs (tests/test_parallel.py's corpus: 1000
x 64).

A module fixture spawns every W once (tests/torch_parallel_pq_worker.py,
one process per rank, all at once) and reads back what each rank got; each
case below is one test over those results. Every case but the port's own
training starts from one quantizer per configuration, the JAX class's
(centroids, codebooks and OPQ rotation in q_{name}.npz), so both packages
probe the same lists with the same codes: the two k-means sum in different
orders, and their quantizers differ in the last bits (further where a
near-tie flips a code). The plain route (the JAX package's CPU route) is
held against the JAX class's search; the card route (the dense ADC kernel
per shard, its plain version here) against the JAX class's Pallas route
in interpret mode (its `_use_kernels` patched to True). The two routes
shortlist by different estimators, so each is held against its own
counterpart.

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
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_pq_worker as worker
from c99_vectordb_tpu.models.flat import FlatIndex as JFlat
from c99_vectordb_tpu.models.ivf_flat import IVFFlatIndex as JIVFFlat
from c99_vectordb_tpu.models.ivf_pq import IVFPQIndex as JSinglePQ
from c99_vectordb_tpu.ops import kmeans as jkmeans
from c99_vectordb_tpu.parallel import ShardedIVFPQIndex as JPQ
from c99_vectordb_tpu.parallel import make_host_chip_mesh as j_host_chip
from c99_vectordb_tpu.parallel import make_mesh as j_mesh
from c99_vectordb_tpu.parallel import sharded as jsharded
from c99_vectordb_tpu.storage import index_io as jio
from c99_vectordb_tpu_torch import commands as tcommands
from c99_vectordb_tpu_torch.models.registry import resolve
from c99_vectordb_tpu_torch.ops.adc import unstage_codes_device
from c99_vectordb_tpu_torch.ops.topk import merge_topk
from c99_vectordb_tpu_torch.parallel import ShardedIVFPQIndex, default_data_mesh
from c99_vectordb_tpu_torch.parallel import sharded as tsharded

REL = 1e-5
WORLDS = (1, 2, 4)
JOIN_TIMEOUT_S = 240
REPO = Path(__file__).resolve().parent.parent
X, IDS, Q = worker.corpus()
MASK = worker.third_mask()


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


def quantizer_of(j) -> dict:
    rot = j._rotation if j._rotation is not None else np.zeros((0, 64), np.float32)
    return {"centroids": np.asarray(j._centroids), "codebooks": np.asarray(j._codebooks),
            "rotation": np.asarray(rot)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: [rank 0's results, ...]}, "root", "quant": {name: the shared
    quantizer}."""
    root = tmp_path_factory.mktemp("pq_ranks")
    shared = root / "shared"
    shared.mkdir()
    quant = {}
    for name, (params, n) in worker.QUANTIZERS.items():
        j = JPQ(**params, mesh=j_mesh(n_data=8))
        j.train(X[:n])
        quant[name] = quantizer_of(j)
        np.savez(shared / f"q_{name}.npz", **quant[name])
    j8 = JPQ(**worker.BASE, mesh=j_mesh(n_data=8))
    j8.load(X, IDS)
    jio.write_index(j8, shared / "jax_w8.memo")
    # 3 devices, device mode, staged: the file holds its rows in the 3-shard
    # canvas order, not by id.
    j3 = JPQ(**worker.BASE, mesh=jmesh(3))
    j3.load(jnp.asarray(X), jnp.asarray(IDS.astype(np.int32)))
    j3.search(Q, 5)
    jio.write_index(j3, shared / "jax_w3.memo")
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
    out = {"root": root, "quant": quant}
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


def jax_built(runs, w, name="base", n=None, mesh=None):
    """The JAX index on the shared quantizer `name` (what the worker's
    built() makes), on W virtual devices."""
    params, n_rows = worker.QUANTIZERS[name]
    n = n_rows if n is None else n
    j = JPQ.from_state(params, {"vectors": X[:n], "ids": IDS[:n], **runs["quant"][name]})
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


def assert_exact(d, i, db=X):
    """The refine is exact: every returned distance is the distance of its
    id's row (float64 reference)."""
    d, i = np.asarray(d), np.asarray(i)
    live = i >= 0
    true = ((Q[: d.shape[0], None, :].astype(np.float64) - db[i.clip(0)]) ** 2).sum(-1)
    assert_close(np.where(live, d, 0.0), np.where(live, true, 0.0))


def oracle(db, dbids, q, k, mask=None):
    d = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[dbids][None, :], d, np.inf)
    out_d = np.sort(d, axis=1)[:, :k]
    order = np.lexsort((np.broadcast_to(dbids, d.shape), d), axis=1)[:, :k]
    return out_d, np.where(np.isinf(out_d), -1, dbids[order])


def overlap(i, want_i):
    return sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(i, want_i)) / want_i.size


def no_leak(i, mask=MASK):
    i = np.asarray(i)
    assert ((i < 0) | mask[i.clip(0)]).all(), "mask leak"


@pytest.fixture(scope="module")
def single_chip():
    """tests/test_parallel.py's single-chip refined IVFPQIndex (JAX)."""
    single = JSinglePQ(dim=64, nlist=16, nprobe=16, m=8, refine=True)
    single.train(X)
    single.add(X, IDS)
    return single.search(Q, 5, nprobe=16)


# -- mirror of TestShardedIVFPQ -----------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
def test_own_training_matches_jax(runs, w, single_chip):
    """The port trains its own quantizer on every rank (bit-equal across
    ranks: test_every_rank_has_the_same_results): its centroids are the JAX
    class's within 1e-5, its codebooks the JAX multi-k-means' of the same
    residuals within 1e-5. Its refined top-5 is exact, overlaps the
    single-chip refined IVFPQIndex's by >= 0.8 (TestShardedIVFPQ), and on
    the port's quantizer the JAX class returns the same ids."""
    r = got(runs, w, "trained")
    np.testing.assert_allclose(r["centroids"], runs["quant"]["base"]["centroids"],
                               rtol=1e-5, atol=1e-5)
    assign = np.asarray(jkmeans.assign_clusters(X, r["centroids"]))
    subs = np.ascontiguousarray((X - r["centroids"][assign]).reshape(1000, 8, 8)
                                .transpose(1, 0, 2))
    np.testing.assert_allclose(r["codebooks"],
                               np.asarray(jkmeans.train_kmeans_multi(subs, 256, iters=8, seed=1)),
                               rtol=1e-5, atol=1e-5)
    assert_exact(r["d"], r["i"])
    assert overlap(r["i"], single_chip[1]) >= 0.8
    j = JPQ.from_state(worker.BASE, {"vectors": X, "ids": IDS, "centroids": r["centroids"],
                                     "codebooks": r["codebooks"],
                                     "rotation": np.zeros((0, 64), np.float32)})
    j.mesh = jmesh(w)
    assert_same((r["d"], r["i"]), j.search(Q, 5, nprobe=16))


@pytest.mark.parametrize("w", WORLDS)
def test_refine_recall_beats_adc(runs, w):
    """refine_factor 8, every list probed: recall@5 against the exact
    flat search >= 0.8 on both routes."""
    flat = JFlat(dim=64)
    flat.add(X, IDS)
    want_i = flat.search(Q, 5)[1]
    r = got(runs, w, "routes_refine8_p16")
    assert overlap(r["i"], want_i) >= 0.8 and overlap(r["ki"], want_i) >= 0.8


@pytest.mark.parametrize("w", WORLDS)
def test_incremental_add(runs, w):
    r = got(runs, w, "incremental")
    assert int(r["n_half"]) == 500 and int(r["ntotal"]) == 1000
    assert (r["i"] >= 0).all()


@pytest.mark.parametrize("w", WORLDS)
def test_empty(runs, w):
    r = got(runs, w, "empty")
    assert r["i"].shape == (2, 3) and (r["i"] == -1).all() and np.isinf(r["d"]).all()


# -- both routes against their JAX counterparts -------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", ["base", "refine8", "opq", "k16"])
def test_plain_route_matches_jax(runs, w, name):
    """The plain route at nprobe 4 and 16, and with a filter keeping a
    third of the ids: the JAX class's search on W devices (its CPU route)
    on the same quantizer; exact distances; no masked id."""
    j = jax_built(runs, w, name)
    for nprobe in (4, 16):
        r = got(runs, w, f"routes_{name}_p{nprobe}")
        assert_same((r["d"], r["i"]), j.search(Q, 5, nprobe=nprobe))
        assert_exact(r["d"], r["i"])
    m = got(runs, w, f"masked_{name}")
    no_leak(m["i"])
    assert_same((m["d"], m["i"]), j.search(Q, 5, id_mask=MASK))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", ["base", "refine8", "opq", "k16"])
def test_card_route_is_exact_and_filtered(runs, w, name):
    """The card route (the dense ADC kernel per shard, its plain version
    here) returns exact distances, no masked id, and at every list probed
    the plain route's ids for >= 0.9 of the entries (the estimators
    differ)."""
    for nprobe in (4, 16):
        r = got(runs, w, f"routes_{name}_p{nprobe}")
        assert_exact(r["kd"], r["ki"])
    r = got(runs, w, f"routes_{name}_p16")
    assert overlap(r["ki"], r["i"]) >= 0.9
    m = got(runs, w, f"masked_{name}")
    no_leak(m["ki"])
    assert_exact(m["kd"], m["ki"])


@pytest.mark.parametrize("name,nprobe,masked", [("base", 4, False), ("base", 16, True),
                                                ("k16", 4, False)])
def test_card_route_matches_jax_kernel_route(runs, monkeypatch, name, nprobe, masked):
    """W = 2: the card route equals the JAX class's Pallas route (the dense
    ADC kernel per shard, interpret mode) on the same quantizer: same ids,
    distances within REL."""
    monkeypatch.setattr(JPQ, "_use_kernels", lambda self: True)
    j = jax_built(runs, 2, name)
    if masked:
        r = got(runs, 2, f"masked_{name}")
        want = j.search(Q, 5, id_mask=MASK)
    else:
        r = got(runs, 2, f"routes_{name}_p{nprobe}")
        want = j.search(Q, 5, nprobe=nprobe)
    assert j._staged_kernel_layout
    assert_same((r["kd"], r["ki"]), want)


@pytest.mark.parametrize("w", WORLDS)
def test_program_equals_the_index(runs, w):
    """sharded_pq_search_program on a rank's staged block (nprobe 4, k 5,
    k_adc 20) gives the index's route results bit for bit."""
    r = got(runs, w, "routes_base_p4")
    for route, (dk, ik) in (("plain", ("d", "i")), ("kernel", ("kd", "ki"))):
        p = got(runs, w, f"program_{route}")
        np.testing.assert_array_equal(p["i"], r[ik])
        np.testing.assert_array_equal(p["d"], r[dk])


def test_scan_rows_scale_inverse_with_shards(runs):
    """TestShardedSerialization::test_pq_rows_scale_inverse_with_shards:
    rows each rank ADC-scans shrink as 1/W (within the lists' rounding), as
    the JAX class's at W."""
    rows = {w: int(got(runs, w, "rows")["rows_per_chip"]) for w in WORLDS}
    for w in WORLDS:
        r = got(runs, w, "rows")
        assert int(r["shards"]) == w
        assert int(r["rows_per_chip"]) * w == int(r["rows_all_chips"])
        assert int(r["rows_per_chip"]) == jax_built(runs, w).scan_rows_per_chip(
            b=6, nprobe=4)["rows_per_chip"]
    assert rows[4] <= rows[1] / 4 * 2.0
    assert rows[4] < rows[2] < rows[1]


# -- the program's pieces, in process ------------------------------------------------------


def test_merge_topk_with_rows_matches_jax():
    """(distance, id) selection carrying a row payload, with exact ties,
    +inf entries and -1 ids, against the JAX function bit for bit."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 6, (5, 40)).astype(np.float32)
    d[:, ::7] = np.inf
    i = rng.permutation(200).reshape(5, 40).astype(np.int32)
    i[:, 3::9] = -1
    d[:, 3::9] = np.inf
    rows = rng.integers(0, 1000, (5, 40)).astype(np.int32)
    for k in (1, 12, 40):
        want = jsharded._merge_topk_with_rows(jnp.asarray(d), jnp.asarray(i),
                                              jnp.asarray(rows), k)
        have = merge_topk(torch.from_numpy(d), torch.from_numpy(i), k, torch.from_numpy(rows))
        for a, b in zip(have, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    wide = merge_topk(torch.from_numpy(d[:, :3]), torch.from_numpy(i[:, :3]), 5,
                      torch.from_numpy(rows[:, :3]))
    assert wide[0].shape == (5, 5) and (wide[1][:, 3:] == -1).all()


@pytest.fixture(scope="module")
def one_block(runs):
    """The JAX class and the port on one device / one rank, both staged on
    the base quantizer."""
    j = jax_built(runs, 1)
    j._stage()
    t = ShardedIVFPQIndex.from_state(worker.BASE, {"vectors": X, "ids": IDS,
                                                   **runs["quant"]["base"]}, device="cpu")
    t._stage()
    return j, t


def test_staged_block_matches_jax(one_block):
    """At W = 1 the port's block holds the JAX class's list ids, refine rows
    and codes (its canvas unstaged) bit for bit."""
    j, t = one_block
    _, _, _, codes, li, lv = j._staged
    tc = t._staged
    assert j._params == t._params
    np.testing.assert_array_equal(tc[5].numpy(), np.asarray(li))
    np.testing.assert_array_equal(tc[6].numpy(), np.asarray(lv))
    np.testing.assert_array_equal(unstage_codes_device(tc[3], 8, 256).numpy(), np.asarray(codes))


@pytest.mark.parametrize("nprobe,k,k_adc", [(1, 5, 20), (4, 10, 40), (16, 5, 300)])
def test_plain_program_matches_jax_on_the_block(one_block, nprobe, k, k_adc):
    """The plain route of sharded_pq_search_program against the JAX
    program (use_kernels=False) on the same one-shard block: same ids,
    distances within REL; with a filter too."""
    j, t = one_block
    nlist, pad_local = j._params
    q = jax.device_put(Q, NamedSharding(j.mesh, P(None, None)))
    for masked in (False, True):
        prog = jsharded.sharded_pq_search_program(j.mesh, nlist, pad_local, 64, 8, 256,
                                                  Q.shape[0], nprobe, k, k_adc, False,
                                                  ("data",), masked)
        extra = (jax.device_put(MASK, NamedSharding(j.mesh, P(None))),) if masked else ()
        want = prog(*j._staged, q, q, *extra)
        tq = torch.from_numpy(Q)
        have = tsharded.sharded_pq_search_program(
            t.mesh, *t._staged, tq, tq, nprobe, k, k_adc, use_kernels=False,
            keep=torch.from_numpy(MASK) if masked else None, hwm=t._hwm)
        assert_same((have[0].numpy(), have[1].numpy()), (np.asarray(want[0]),
                                                         np.asarray(want[1])))


# -- files: at W, from the JAX package at 8 and 3 devices, into the JAX package ----------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", ["base", "opq"])
def test_round_trip_at_w(runs, w, name):
    """TestShardedIVFPQRound4::test_opq_state_roundtrip: a file written at W
    ranks reads back at W (with its rotation) and searches as the JAX
    class on the same quantizer."""
    r = got(runs, w, f"roundtrip_{name}")
    assert str(r["kind"]) == "sharded_ivf_pq" and int(r["ntotal"]) == 1000
    assert bool(r["opq"]) == (name == "opq")
    assert_same((r["d"], r["i"]), jax_built(runs, w, name).search(Q, 5))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("devices", [8, 3])
def test_reload_on_different_device_count(runs, w, devices):
    """A file the JAX package wrote on 8 devices (host mode) or on 3
    (device mode, rows in its canvas order) loads at W ranks and searches
    as the JAX class that reads it on W devices (each shard shortlists
    its own k * refine_factor rows, so results depend on W)."""
    r = got(runs, w, f"from_jax{devices}")
    assert str(r["kind"]) == "sharded_ivf_pq" and int(r["ntotal"]) == 1000
    src = jio.read_index(runs["root"] / "shared" / f"jax_w{devices}.memo")
    src.mesh = jmesh(w)
    assert_same((r["d"], r["i"]), src.search(Q, 5))


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("jax_devices", [8, 3])
@pytest.mark.parametrize("name", ["base", "opq"])
def test_port_file_loads_in_jax(runs, w, jax_devices, name):
    loaded = jio.read_index(runs["root"] / f"w{w}" / f"port_w{w}_{name}.memo")
    loaded.mesh = jmesh(jax_devices)
    assert type(loaded) is JPQ and loaded.ntotal == 1000 and loaded.opq == (name == "opq")
    np.testing.assert_array_equal(loaded.ids(), IDS)
    for key, value in runs["quant"][name].items():
        if value.size:
            np.testing.assert_array_equal(np.asarray(getattr(loaded, f"_{key}")), value)
    assert_same(loaded.search(Q, 5), jax_built(runs, jax_devices, name).search(Q, 5))


# -- mirror of TestShardedRound5 (pq) ---------------------------------------------------------


@pytest.mark.parametrize("w,mesh", [(1, "1d"), (2, "1d"), (4, "1d"), (4, "2level")])
def test_incremental_add_mask_and_remove(runs, w, mesh):
    """800 rows staged, 200 parked in the tail, a filter, an in-place
    removal of 10 ids: the JAX class through the same steps on the same
    quantizer and mesh shape; recall >= 0.8; no masked or removed id."""
    r = got(runs, w, f"round5_{mesh}")
    assert bool(r["staged"]) and int(r["tail"]) == 200
    od, oi = oracle(X, IDS, Q, 5)
    assert overlap(r["i"], oi) >= 0.8
    assert_exact(r["d"], r["i"])
    for d, i in ((r["md"], r["mi"]), (r["kmd"], r["kmi"])):
        no_leak(i)
        assert_exact(d, i)
    assert int(r["removed"]) == 10 and bool(r["still_staged"]) and int(r["ntotal"]) == 990
    assert not np.isin(r["ri"], IDS[:10]).any()
    j = jax_built(runs, w, "r5", mesh=jmesh(w) if mesh == "1d" else j_host_chip(2, 2))
    j.search(Q, 5)
    j.add(X[800:], IDS[800:])
    assert_same((r["d"], r["i"]), j.search(Q, 5))
    assert_same((r["md"], r["mi"]), j.search(Q, 5, id_mask=MASK))
    assert j.remove_ids(IDS[:10]) == 10
    assert_same((r["rd"], r["ri"]), j.search(Q, 5))


@pytest.mark.parametrize("w", WORLDS)
def test_device_mode_end_to_end(runs, w):
    """Tensors in, on the r5 quantizer: device mode stages, parks the tail,
    filters, reconstructs, removes in place and serializes; the JAX class's
    device mode through the same steps keeps the same rows in the same
    (canvas) order and returns the same results."""
    r = got(runs, w, "device")
    assert str(r["mode"]) == "device" and int(r["tail"]) == 200
    assert overlap(r["i"], oracle(X, IDS, Q, 5)[1]) >= 0.8
    no_leak(r["mi"])
    np.testing.assert_array_equal(r["rec"], X[42])
    assert int(r["removed"]) == 1 and int(r["ntotal"]) == 999
    assert r["state_vecs"].shape == (999, 64)
    np.testing.assert_array_equal(np.sort(r["ids"]), IDS[IDS != 42])
    np.testing.assert_array_equal(r["state_ids"], r["ids"])
    np.testing.assert_array_equal(r["state_vecs"], X[r["state_ids"]])
    np.testing.assert_array_equal(r["loaded"], r["after"])
    assert not (r["after"] == 42).any()
    params, _ = worker.QUANTIZERS["r5"]
    j = JPQ(**params, mesh=jmesh(w))
    j._centroids = jnp.asarray(runs["quant"]["r5"]["centroids"])
    j._codebooks = jnp.asarray(runs["quant"]["r5"]["codebooks"])
    j.add(jnp.asarray(X[:800]), jnp.asarray(IDS[:800].astype(np.int32)))
    j.search(Q, 5)
    j.add(jnp.asarray(X[800:]), jnp.asarray(IDS[800:].astype(np.int32)))
    assert_same((r["d"], r["i"]), j.search(Q, 5))
    np.testing.assert_array_equal(r["mi"], j.search(Q, 5, id_mask=MASK)[1])
    assert j.remove_ids([42]) == 1
    _, jarrays = j.state()
    np.testing.assert_array_equal(r["state_ids"], jarrays["ids"])
    np.testing.assert_array_equal(r["after"], j.search(Q, 5)[1])
    np.testing.assert_array_equal(r["ranked"], j.ranked_all(Q[0])[1])


@pytest.mark.parametrize("w", WORLDS)
def test_device_mode_own_training_and_retrain(runs, w):
    """The port's own training on tensors: centroids the JAX k-means' within
    1e-5; a retrain of the staged index re-parks its rows (still 1000, in
    device mode), and both searches return exact distances with recall
    >= 0.8."""
    r = got(runs, w, "device_trained")
    assert str(r["mode"]) == "device" and int(r["ntotal"]) == 1000 and not bool(r["staged"])
    np.testing.assert_allclose(r["centroids"], np.asarray(jkmeans.train_kmeans(X, 8, iters=8)),
                               rtol=1e-5, atol=1e-5)
    want = oracle(X, IDS, Q, 5)[1]
    for d, i in ((r["d"], r["i"]), (r["rd"], r["ri"])):
        assert_exact(d, i)
        assert overlap(i, want) >= 0.8


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("mode", ["host", "device"])
def test_tail_then_restage_matches_jax(runs, w, mode):
    """Tail rows merge after the refine; the forced restage folds them into
    the lists (then they compete for the shortlist): each step equals the
    JAX class's through the same steps in the same mode."""
    r = got(runs, w, f"restage_{mode}")
    assert bool(r["tail_gone"]) and str(r["mode"]) == mode
    params, _ = worker.QUANTIZERS["r5"]
    if mode == "host":
        j = jax_built(runs, w, "r5")
    else:
        j = JPQ(**params, mesh=jmesh(w))
        j._centroids = jnp.asarray(runs["quant"]["r5"]["centroids"])
        j._codebooks = jnp.asarray(runs["quant"]["r5"]["codebooks"])
        j.add(jnp.asarray(X[:800]), jnp.asarray(IDS[:800].astype(np.int32)))
    j.search(Q, 5)
    j.add(X[800:], IDS[800:])
    assert_same((r["d_tail"], r["i_tail"]), j.search(Q, 5))
    j._restage_needed = True
    assert_same((r["d_fold"], r["i_fold"]), j.search(Q, 5))
    assert_exact(r["d_fold"], r["i_fold"])


@pytest.mark.parametrize("w", WORLDS)
def test_mask_cache_reuse(runs, w):
    r = got(runs, w, "mask_cache")
    assert bool(r["reused"]) and bool(r["rebuilt"])


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_has_the_same_results(runs, w):
    """Outputs are replicated after the merge, and the replicated training
    gives every rank bit-equal quantizers."""
    first = runs[w][0]
    assert "trained.codebooks" in first and "device.state_ids" in first
    for other in runs[w][1:]:
        assert other.keys() == first.keys()
        for key, value in first.items():
            if key not in worker.PER_RANK:
                np.testing.assert_array_equal(other[key], value, err_msg=key)


def test_two_level_mesh_matches_1d_and_jax(runs):
    """TestShardedIVFPQRound4::test_two_level_mesh_matches_1d: 2 hosts x 2
    chips hold the 1-D mesh's slots (4 shards either way), so both routes
    give the 1-D results bit for bit, and the JAX class on a (2, 2) mesh
    the same ids."""
    r = got(runs, 4, "two_level")
    assert int(r["shards"]) == 4
    for a, b in (("ai", "bi"), ("ad", "bd"), ("aki", "bki"), ("akd", "bkd")):
        np.testing.assert_array_equal(r[a], r[b])
    assert_same((r["bd"], r["bi"]), jax_built(runs, 4, mesh=j_host_chip(2, 2)).search(
        Q, 5, nprobe=16))


@pytest.mark.parametrize("w", WORLDS)
def test_dryrun_twin_pq_steps(runs, w):
    """parallel/dryrun.dryrun_multichip's new steps at W ranks, against the
    JAX function's steps at its shapes on W devices: the 1-D IVF-PQ index
    (same ids; its own training), the one-device IVFFlatIndex device-mode
    tail merge (same ids) and, at W = 4, the two-level IVF-PQ index (= the
    1-D one)."""
    r = got(runs, w, "dryrun")
    n_model = 2 if w == 4 else 1
    dim, n = 128 * n_model, 16 * (w // n_model)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    queries = rng.standard_normal((4, dim)).astype(np.float32)
    pq = JPQ(dim=dim, nlist=8, nprobe=8, m=8, mesh=jmesh(w))
    pq.load(data, ids.astype(np.int64))
    assert_same((r["pq_d"], r["pq_i"]), pq.search(queries, 3))
    inc = JIVFFlat(dim=dim, nlist=4, nprobe=4)
    inc.add(jnp.asarray(data[: n // 2]), jnp.asarray(ids[: n // 2]))
    inc.search(queries, 3)
    inc.add(jnp.asarray(data[n // 2 :]), jnp.asarray(ids[n // 2 :]))
    assert_same((r["inc_d"], r["inc_i"]), inc.search(queries, 3))
    if w == 4:
        np.testing.assert_array_equal(r["pq_2level_i"], r["pq_i"])
        np.testing.assert_array_equal(r["pq_2level_d"], r["pq_d"])


# -- one rank, no process group; the kind's plumbing ---------------------------------------------


def test_world_of_one_and_the_kind(monkeypatch):
    """No launcher: one rank on the resolved device. resolve() and
    make_index build the port's class from C99VDB_INDEX and its knobs; a
    width m does not divide raises; CUDA without a card raises."""
    assert not torch.distributed.is_initialized()
    assert resolve("sharded_ivf_pq") is ShardedIVFPQIndex
    idx = ShardedIVFPQIndex(dim=64, nlist=16, nprobe=16, m=8, device="cpu")
    assert idx.mesh.shape == default_data_mesh("cpu").shape == {"data": 1}
    idx.load(X, IDS)
    d, i = idx.search(Q, 5)
    assert_exact(d, i)
    monkeypatch.setenv("C99VDB_INDEX", "sharded_ivf_pq")
    monkeypatch.setenv("C99VDB_NLIST", "32")
    monkeypatch.setenv("C99VDB_NPROBE", "4")
    monkeypatch.setenv("C99VDB_PQ_M", "16")
    monkeypatch.setenv("C99VDB_PQ_KSUB", "16")
    monkeypatch.setenv("C99VDB_OPQ", "1")
    made = tcommands.make_index(device="cpu")
    assert (made.kind, made.nlist, made.nprobe, made.m, made.ksub, made.opq) == (
        "sharded_ivf_pq", 32, 4, 16, 16, True)
    assert type(made) is ShardedIVFPQIndex and made.mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="divisible"):
        ShardedIVFPQIndex(dim=60, m=8, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            ShardedIVFPQIndex(dim=8, m=2, device="cuda")
