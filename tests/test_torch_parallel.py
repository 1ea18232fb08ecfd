"""The port's sharded flat index (c99_vectordb_tpu_torch.parallel) at W gloo
ranks against the JAX package's on a mesh of W of the conftest's 8 virtual
devices, W in {1, 2, 4}, on the same numpy inputs (tests/test_parallel.py's
seeds).

A module fixture spawns every W once (tests/torch_parallel_worker.py, one
process per rank, all at once) and reads back what each rank got; each case
below is one test over those results. The JAX kernel routes run in
interpret mode, as tests/test_parallel.py runs them; the port's kernel
route runs the flat kernel's plain version on the CPU.

Ids must be equal. Distances are held to REL: |got - want| <= REL times
the largest finite distance of the query's row (the two packages' matmuls
sum in different orders, and an exact-route distance near 0 carries the
cancellation error of ||q||^2 + ||x||^2 - 2 q.x at the row's scale), or
bit for bit where the test says so.
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

import torch_parallel_worker as worker
from c99_vectordb_tpu.parallel import (
    ShardedFlatIndex as JSharded, make_host_chip_mesh as j_host_chip, make_mesh as j_mesh,
    sharded_search_2d as j_2d,
)
from c99_vectordb_tpu.parallel.sharded import (
    sharded_search_kernels as j_kernels, sharded_search_sq8_kernels as j_sq8_kernels,
)
from c99_vectordb_tpu.storage import index_io as jio
from c99_vectordb_tpu_torch.models.flat import FlatIndex as TFlat
from c99_vectordb_tpu_torch.parallel import (
    ShardedFlatIndex, default_data_mesh, make_host_chip_mesh, make_mesh,
)

REL = 1e-5
WORLDS = (1, 2, 4)
JOIN_TIMEOUT_S = 120
REPO = Path(__file__).resolve().parent.parent
X, IDS, Q = worker.corpus()
MASK = worker.third_mask()
K = worker.K


def _spawn(world: int, out: Path, jax_files: Path):
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", C99VDB_PLATFORM="cpu")
    procs = []
    for rank in range(world):
        log = (out / f"log{rank}").open("w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(worker.__file__)), "--world", str(world), "--rank",
             str(rank), "--store", str(out / "store"), "--out", str(out), "--jax-files",
             str(jax_files)], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(out)))
        log.close()
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: [rank 0's results, rank 1's, ...]} of every W, spawned at once."""
    root = tmp_path_factory.mktemp("ranks")
    jax_files = root / "jax"
    jax_files.mkdir()
    for dt in ("float32", "int8"):
        j = JSharded(dim=64, scan_dtype=dt, mesh=j_mesh(n_data=8))
        j.load(X, IDS)
        jio.write_index(j, jax_files / f"jax_w8_{dt}.memo")
    procs = {w: _spawn(w, root / f"w{w}", jax_files) for w in WORLDS}
    failed = []
    for w, ps in procs.items():
        for rank, p in enumerate(ps):
            try:
                rc = p.wait(timeout=JOIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in (q for group in procs.values() for q in group):
                    q.kill()
                rc = "timeout"
            if rc != 0:
                failed.append((w, rank, rc, (root / f"w{w}" / f"log{rank}").read_text()[-3000:]))
    assert not failed, failed
    out = {}
    for w in WORLDS:
        ranks = []
        for r in range(w):
            with np.load(root / f"w{w}" / f"r{r}.npz") as z:
                ranks.append({key: z[key] for key in z.files})
        out[w] = ranks
    out["root"] = root
    return out


def got(runs, w, case):
    """Rank 0's results of one case, as {name: array}."""
    pre = case + "."
    return {k[len(pre):]: v for k, v in runs[w][0].items() if k.startswith(pre)}


def jmesh(w):
    return j_mesh(n_data=w, devices=jax.devices()[:w])


def jax_index(w, vectors=X, ids=IDS, dim=64, **kw):
    j = JSharded(dim=dim, mesh=jmesh(w), **kw)
    j.load(vectors, ids)
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


def oracle(db, dbids, q, k, mask=None):
    d = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[dbids][None, :], d, np.inf)
    out_d = np.sort(d, axis=1)[:, :k]
    order = np.lexsort((np.broadcast_to(dbids, d.shape), d), axis=1)[:, :k]
    return out_d, np.where(np.isinf(out_d), -1, dbids[order])


# -- mirror of TestShardedSearch ------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
def test_search_matches_jax_and_flat(runs, w):
    r = got(runs, w, "search")
    assert int(r["shards"]) == w and int(r["per"]) * w >= 1000
    jd, ji = jax_index(w).search(Q, K)
    np.testing.assert_array_equal(r["i"], ji)
    assert_close(r["d"], jd)
    # W-independence: the single-device FlatIndex's ids
    flat = TFlat(dim=64, device="cpu")
    flat.add(X, IDS)
    fd, fi = flat.search(Q, K)
    np.testing.assert_array_equal(r["i"], fi)
    assert_close(r["d"], fd)


@pytest.mark.parametrize("w", WORLDS)
def test_kernel_route_matches_exact_route_and_jax_interpret(runs, w):
    """The flat kernel (its plain version here) + per-shard exact rerank
    equals the exact route, and the JAX package's Pallas route (interpret
    mode) on the same shards."""
    r = got(runs, w, "search")
    p = got(runs, w, "kernels_program")
    np.testing.assert_array_equal(r["ki"], r["i"])
    assert_close(r["kd"], r["d"])
    np.testing.assert_array_equal(p["i"], r["ki"])
    np.testing.assert_array_equal(p["d"], r["kd"])  # the same program, bit for bit
    j = jax_index(w)
    db, idp, sq = j._stage()[:3]
    prog = j_kernels(j.mesh, db.shape[0], 64, Q.shape[0], K, min(2 * K, db.shape[0] // w, 1024))
    jd, ji = prog(db, idp, sq, jax.device_put(Q, NamedSharding(j.mesh, P(None, None))))
    np.testing.assert_array_equal(r["ki"], np.asarray(ji))
    assert_close(r["kd"], np.asarray(jd))


@pytest.mark.parametrize("w", WORLDS)
def test_k_spanning_shards(runs, w):
    r = got(runs, w, "k_spanning")
    assert set(r["i"][0, :20].tolist()) == set(range(20))
    assert (r["i"][0, 20:] == -1).all() and np.isinf(r["d"][0, 20:]).all()
    jd, ji = jax_index(w, X[:20], IDS[:20]).search(X[:1], k=30)
    np.testing.assert_array_equal(r["i"], ji)
    assert_close(r["d"], jd)


@pytest.mark.parametrize("w", WORLDS)
def test_cross_shard_tie_break(runs, w):
    assert got(runs, w, "tie")["i"][0].tolist() == list(range(8))
    tv, tids = worker.tie_rows()
    np.testing.assert_array_equal(got(runs, w, "tie")["i"],
                                  jax_index(w, tv, tids, dim=16).search(tv[:1], k=8)[1])


@pytest.mark.parametrize("w", WORLDS)
def test_empty(runs, w):
    r = got(runs, w, "empty")
    assert r["i"].shape == (2, 3) and (r["i"] == -1).all() and np.isinf(r["d"]).all()


@pytest.mark.parametrize("w", WORLDS)
def test_k_exceeds_ntotal(runs, w):
    """TestCodeReviewRegressions::test_sharded_flat_k_exceeds_ntotal, on both
    routes."""
    r = got(runs, w, "k_exceeds")
    tx, tid = worker.tiny_rows()
    j = JSharded(dim=16, mesh=jmesh(w))
    j.add(tx, tid)
    jd, ji = j.search(np.zeros((1, 16), np.float32), k=7)
    for d, i in ((r["d"], r["i"]), (r["kd"], r["ki"])):
        assert i.shape == (1, 7) and (i[0, 3:] == -1).all()
        np.testing.assert_array_equal(i, ji)
        assert_close(d, jd)


# -- mirror of TestSlotSharding's flat cases --------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
def test_sq8_routes_are_exact(runs, w):
    """The SQ8 store: exact route, kernel route and the standalone program
    all give the exact ids; so does the JAX package's SQ8 Pallas route
    (interpret mode); the masked kernel route leaks nothing. The global
    scale equals the JAX one within 1 ulp (standing deviation: x / 127)."""
    r = got(runs, w, "sq8")
    want_d, want_i = oracle(X, IDS, Q, K)
    for d, i in ((r["d"], r["i"]), (r["kd"], r["ki"]), (r["pd"], r["pi"])):
        np.testing.assert_array_equal(i, want_i)
        assert_close(d, want_d)
    md, mi = oracle(X, IDS, Q, K, MASK)
    np.testing.assert_array_equal(r["mi"], mi)
    assert_close(r["md"], md)
    j = jax_index(w, scan_dtype="int8")
    np.testing.assert_array_equal(r["i"], j.search(Q, K)[1])
    staged = j._stage()
    codes, dec_sq, scale = staged[3:]
    db, idp = staged[:2]
    assert int(r["per"]) == db.shape[0] // w
    np.testing.assert_array_max_ulp(r["scale"], np.asarray(scale), maxulp=1)
    prog = j_sq8_kernels(j.mesh, db.shape[0], 64, Q.shape[0], K, min(2 * K, db.shape[0] // w))
    jd, ji = prog(codes, db, idp, dec_sq, scale,
                  jax.device_put(Q, NamedSharding(j.mesh, P(None, None))))
    np.testing.assert_array_equal(r["ki"], np.asarray(ji))
    assert_close(r["kd"], np.asarray(jd))


# -- mirror of TestShardedSerialization (flat) and the cross-loads -----------------------------


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_round_trip_at_w(runs, w, dt):
    r = got(runs, w, f"roundtrip_{dt}")
    assert str(r["kind"]) == "sharded_flat" and str(r["scan_dtype"]) == dt
    assert int(r["ntotal"]) == 1000
    j = jax_index(w, scan_dtype=dt)
    jd, ji = j.search(Q, 5)
    np.testing.assert_array_equal(r["i"], ji)
    assert_close(r["d"], jd)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_jax_file_from_8_devices_loads(runs, w, dt):
    """A file the JAX package wrote on 8 devices loads at W ranks and
    searches as the JAX index does."""
    r = got(runs, w, f"from_jax_{dt}")
    assert str(r["kind"]) == "sharded_flat" and str(r["scan_dtype"]) == dt
    assert int(r["ntotal"]) == 1000
    jd, ji = jax_index(8, scan_dtype=dt).search(Q, 5)
    np.testing.assert_array_equal(r["i"], ji)
    assert_close(r["d"], jd)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("jax_devices", [8, 3])
@pytest.mark.parametrize("dt", ["float32", "int8"])
def test_port_file_loads_in_jax(runs, w, jax_devices, dt):
    """A file the port wrote at W ranks loads in the JAX package on 8 and
    on 3 devices, is the same index, and searches the same."""
    loaded = jio.read_index(runs["root"] / f"w{w}" / f"port_w{w}_{dt}.memo")
    loaded.mesh = jmesh(jax_devices)
    assert type(loaded) is JSharded and loaded.scan_dtype == dt and loaded.ntotal == 1000
    np.testing.assert_array_equal(loaded.ids(), IDS)
    r = got(runs, w, f"roundtrip_{dt}")
    jd, ji = loaded.search(Q, 5)
    np.testing.assert_array_equal(ji, r["i"])
    assert_close(jd, r["d"])


@pytest.mark.parametrize("w", WORLDS)
def test_incremental_add_matches_bulk(runs, w):
    r = got(runs, w, "incremental")
    np.testing.assert_array_equal(r["i"], r["bulk"])


@pytest.mark.parametrize("w", WORLDS)
def test_ranked_all_bit_for_bit(runs, w):
    """The full ranking equals the JAX package's bit for bit (D = 64 is a
    multiple of 32: ops/distances.py follows XLA's order there)."""
    r = got(runs, w, "ranked_all")
    jd, ji = jax_index(w).ranked_all(Q[0])
    assert r["d"].shape == (1000,)
    np.testing.assert_array_equal(r["d"], jd)
    np.testing.assert_array_equal(r["i"], ji)


# -- mirror of TestShardedRound5 (flat) ------------------------------------------------------


ROUND5 = [(w, mesh, dt) for w in WORLDS for mesh in ("1d", "2level") for dt in ("float32", "int8")
          if mesh == "1d" or w == 4]


@pytest.mark.parametrize("w,mesh,dt", ROUND5)
def test_incremental_add_mask_and_remove(runs, w, mesh, dt):
    r = got(runs, w, f"round5_{mesh}_{dt}")
    assert bool(r["staged"]) and int(r["tail"]) == 200
    od, oi = oracle(X, IDS, Q, 5)
    np.testing.assert_array_equal(r["i"], oi)
    assert_close(r["d"], od)
    od, oi = oracle(X, IDS, Q, 5, MASK)
    for d, i in ((r["md"], r["mi"]), (r["kmd"], r["kmi"])):
        assert ((i < 0) | MASK[i.clip(0)]).all(), "mask leak"
        np.testing.assert_array_equal(i, oi)
        assert_close(d, od)
    assert int(r["removed"]) == 10 and bool(r["still_staged"]) and int(r["ntotal"]) == 990
    keep = IDS >= 10
    od, oi = oracle(X[keep], IDS[keep], Q, 5)
    np.testing.assert_array_equal(r["ri"], oi)
    assert_close(r["rd"], od)
    # the JAX package through the same steps
    jm = jmesh(w) if mesh == "1d" else j_host_chip(2, 2)
    j = JSharded(dim=64, scan_dtype=dt, mesh=jm)
    j.load(X[:800], IDS[:800])
    j.search(Q, 5)
    j.add(X[800:], IDS[800:])
    np.testing.assert_array_equal(r["mi"], j.search(Q, 5, id_mask=MASK)[1])
    assert j.remove_ids(IDS[:10]) == 10
    np.testing.assert_array_equal(r["ri"], j.search(Q, 5)[1])


@pytest.mark.parametrize("w", WORLDS)
def test_device_mode_end_to_end(runs, w):
    r = got(runs, w, "device_mode")
    assert str(r["mode"]) == "device" and int(r["tail"]) == 200
    od, oi = oracle(X, IDS, Q, 5)
    np.testing.assert_array_equal(r["i"], oi)
    assert ((r["mi"] < 0) | MASK[r["mi"].clip(0)]).all()
    np.testing.assert_array_equal(r["mi"], oracle(X, IDS, Q, 5, MASK)[1])
    np.testing.assert_array_equal(r["rec"], X[42])
    assert int(r["removed"]) == 1 and int(r["ntotal"]) == 999 and int(r["state_rows"]) == 999
    np.testing.assert_array_equal(np.sort(r["ids"]), IDS[IDS != 42])
    np.testing.assert_array_equal(r["state_ids"], r["ids"])
    np.testing.assert_array_equal(r["loaded"], r["after"])
    keep = IDS != 42
    np.testing.assert_array_equal(r["after"], oracle(X[keep], IDS[keep], Q, 5)[1])
    # the JAX package's device mode through the same steps
    import jax.numpy as jnp

    j = JSharded(dim=64, mesh=jmesh(w))
    j.add(jnp.asarray(X[:800]), jnp.asarray(IDS[:800].astype(np.int32)))
    j.search(Q, 5)
    j.add(jnp.asarray(X[800:]), jnp.asarray(IDS[800:].astype(np.int32)))
    assert j.remove_ids([42]) == 1
    np.testing.assert_array_equal(r["state_ids"], j.state()[1]["ids"])
    np.testing.assert_array_equal(r["ranked"], j.ranked_all(Q[0])[1])


@pytest.mark.parametrize("w", WORLDS)
def test_tail_then_restage_matches(runs, w):
    r = got(runs, w, "restage")
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
    """Outputs are replicated after the merge: every rank's results equal
    rank 0's bit for bit."""
    first = runs[w][0]
    for other in runs[w][1:]:
        assert other.keys() == first.keys()
        for key, value in first.items():
            np.testing.assert_array_equal(other[key], value, err_msg=key)


# -- W = 4: the two-level merge, the 2-D mesh, a reassigned mesh --------------------------------


def test_two_level_merge_bit_for_bit(runs):
    """2 hosts x 2 chips: the standalone two-level program and the index
    on a (host, chip) mesh equal the 1-D merge bit for bit, and the JAX
    package's two-level program."""
    r = got(runs, 4, "two_level")
    np.testing.assert_array_equal(r["ti"], r["fi"])
    np.testing.assert_array_equal(r["td"], r["fd"])
    np.testing.assert_array_equal(r["bi"], r["ai"])
    np.testing.assert_array_equal(r["bd"], r["ad"])
    from c99_vectordb_tpu.parallel import sharded_search_2level

    db, idp, sq = worker.padded(X, IDS)
    m = j_host_chip(2, 2)
    spec = ("host", "chip")
    jd, ji = sharded_search_2level(m, 1024, 64, Q.shape[0], 7)(
        jax.device_put(db, NamedSharding(m, P(spec, None))),
        jax.device_put(idp, NamedSharding(m, P(spec))),
        jax.device_put(sq, NamedSharding(m, P(spec))), Q)
    np.testing.assert_array_equal(r["ti"], np.asarray(ji))
    assert_close(r["td"], np.asarray(jd))
    two = JSharded(dim=64, mesh=j_host_chip(2, 2))
    two.add(X, IDS)
    np.testing.assert_array_equal(r["bi"], two.search(Q, 5)[1])


def test_2d_data_model_mesh(runs):
    """2 data x 2 model: the partial products summed over `model` give the
    JAX package's sharded_search_2d ids and the exact oracle's."""
    r = got(runs, 4, "two_d")
    db, idp, _ = worker.padded(X, IDS)
    m = j_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    jd, ji = j_2d(m, 1024, 64, Q.shape[0], 5)(
        jax.device_put(db, NamedSharding(m, P("data", "model"))),
        jax.device_put(idp, NamedSharding(m, P("data"))),
        jax.device_put(Q, NamedSharding(m, P(None, "model"))))
    np.testing.assert_array_equal(r["i"], np.asarray(ji))
    assert_close(r["d"], np.asarray(jd))
    od, oi = oracle(X, IDS, Q, 5)
    np.testing.assert_array_equal(r["i"], oi)
    assert_close(r["d"], od)


def test_reassigned_mesh_restages(runs):
    """A device-mode index staged on the 1-D mesh, given a (host, chip)
    mesh, restages on its next search: same rows, same results."""
    r = got(runs, 4, "remesh")
    assert int(r["ntotal"]) == 1000 and int(r["shards"]) == 4
    np.testing.assert_array_equal(r["after_i"], r["before_i"])
    np.testing.assert_array_equal(r["after_d"], r["before_d"])


# -- one rank, no process group ---------------------------------------------------------------


def test_world_of_one_without_a_process_group():
    """No launcher: the world has one rank, the index runs there on the
    resolved device, every collective is the identity. Asking for more
    ranks raises; so does CUDA without a card."""
    assert not torch.distributed.is_initialized()
    mesh = default_data_mesh("cpu")
    assert mesh.shape == {"data": 1} and mesh.device == torch.device("cpu")
    idx = ShardedFlatIndex(dim=64, device="cpu")
    assert idx.mesh.shape == {"data": 1} and idx.device.type == "cpu"
    idx.add(X, IDS)
    np.testing.assert_array_equal(idx.search(Q, K)[1], oracle(X, IDS, Q, K)[1])
    assert make_mesh(n_data=1, device="cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="needs an initialized torch.distributed"):
        make_mesh(n_data=2, device="cpu")
    with pytest.raises(RuntimeError, match="needs an initialized torch.distributed"):
        make_host_chip_mesh(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            ShardedFlatIndex(dim=8, device="cuda")
    with pytest.raises(ValueError, match="unsupported scan_dtype"):
        ShardedFlatIndex(dim=8, scan_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="differs from the mesh"):
        ShardedFlatIndex(dim=8, mesh=mesh, device="meta")
