"""PyTorch port, IVFFlatIndex (models/ivf_flat.py) against the JAX package on
the CPU: a JAX-trained index carried across through from_state returns the
JAX package's results on both routes; analogs of the ivf_flat cases of
test_ivf.py, test_devbuild.py, test_remove_ids.py, test_filter_pushdown.py
and test_round3_fixes.py; TPUVDB01 files in both directions; the engine
knobs; MemoDB with C99VDB_INDEX=ivf_flat.

The card route (`_search(card_route=True)`) runs here on CPU tensors, where
each kernel wrapper takes its plain version; it is compared with the JAX
package's TPU branches assembled from its Pallas programs (interpret
mode). The CPU route is compared with the JAX package's own search.

Tolerances: on unit vectors (as the embedder makes them) distances agree
within 1e-5 relative, 1e-5 absolute near 0 (each side sums in its own
order), ids equal except among distances tied that closely. Oracle checks
use nprobe == nlist, where IVF is exhaustive, against float64 numpy with
(distance, id) order: ids equal, distances within 1e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu import commands as jcommands
from c99_vectordb_tpu.models.devbuild import mask_norms as jax_mask_norms
from c99_vectordb_tpu.models.devbuild import mask_shortlist_ids as jax_mask_shortlist_ids
from c99_vectordb_tpu.models.ivf_flat import IVFFlatIndex as JIVF
from c99_vectordb_tpu.ops.ivf_scan_pallas import ivf_full_search_program, ivf_sq8_search_program
from c99_vectordb_tpu.ops.rerank import exact_rerank_rows as jax_rerank_rows
from c99_vectordb_tpu.ops.rerank import exact_rerank_staged as jax_rerank_staged
from c99_vectordb_tpu.ops.rerank import shortlist_depth
from c99_vectordb_tpu.storage import index_io as jio
from c99_vectordb_tpu_torch import commands as tcommands
from c99_vectordb_tpu_torch.models.devbuild import tail_restage_threshold
from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex as TIVF
from c99_vectordb_tpu_torch.storage import index_io as tio

TOL = 1e-5


def same_up_to_ties(want_d, want_i, got_d, got_i, tol=TOL):
    want_d, want_i, got_d, got_i = map(np.asarray, (want_d, want_i, got_d, got_i))
    np.testing.assert_allclose(got_d, want_d, rtol=tol, atol=tol)
    for r in range(want_d.shape[0]):
        k, s = want_d.shape[1], 0
        while s < k:
            e = s + 1
            while e < k and (want_d[r, e] == want_d[r, s] or abs(
                    want_d[r, e] - want_d[r, s]) <= tol * max(1.0, abs(want_d[r, s]))):
                e += 1
            if e < k:
                assert sorted(got_i[r, s:e]) == sorted(want_i[r, s:e]), (r, s, e)
            s = e


def _unit(n, d, seed, centers=16):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32) * 3.0
    x = c[rng.integers(0, centers, n)] + rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _gauss(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _oracle(points, ids, q, k):
    d = ((q[:, None, :].astype(np.float64) - points[None, :, :]) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(ids, d.shape), d), axis=1)[:, :k]
    return np.take_along_axis(d, order, axis=1), ids[order]


def _check_oracle(got, points, ids, q, k):
    od, oi = _oracle(points, ids, q, k)
    np.testing.assert_array_equal(got[1], oi)
    np.testing.assert_allclose(got[0], od, rtol=1e-4, atol=1e-5)


# -- a JAX-trained index, carried across ------------------------------------------


@pytest.fixture(scope="module")
def jax_trained():
    x = _unit(3000, 64, seed=1)
    ids = np.sort(np.random.default_rng(2).permutation(6000)[:3000]).astype(np.int64)
    j = JIVF(dim=64, nlist=16, nprobe=4)
    j.train(x)
    j.add(x, ids)
    q = (x[np.random.default_rng(3).choice(3000, 12)] + 0.02).astype(np.float32)
    mask = np.random.default_rng(4).random(6100) < 0.3
    return j, x, ids, q, mask


def _jax_card_route(j, q, k, nprobe, id_mask):
    """The JAX package's TPU branches of IVFFlatIndex.search, assembled from
    its programs (interpret mode on the CPU)."""
    (cents, c_sq, lv, li, sqn, lookup, pad, extra) = j._stage()
    if id_mask is not None:
        sqn = jax_mask_norms(sqn, li, id_mask)
    nl, b, d = int(cents.shape[0]), q.shape[0], q.shape[1]
    qj = jnp.asarray(q)
    if extra is None:
        prog = ivf_full_search_program(nl, pad, d, b, nprobe, k, exact=True,
                                       dense=nprobe * pad <= 4096)
        dd, di = prog(cents, c_sq, lv, sqn, li, qj)
        if id_mask is not None:     # the port scrubs masked fill (ROADMAP Queue 3)
            di = jax_mask_shortlist_ids(di, id_mask)
        return np.asarray(dd), np.asarray(di)
    ks = min(shortlist_depth(k, j.ntotal), nprobe * pad)
    if extra[0] == "int8":
        dec = extra[3] if id_mask is None else jax_mask_norms(extra[3], li, id_mask)
        _, si, rows = ivf_sq8_search_program(nl, pad, d, b, nprobe, ks)(
            cents, c_sq, extra[1], extra[2], dec, li, qj)
        if id_mask is not None:
            si = jax_mask_shortlist_ids(si, id_mask)
        out = jax_rerank_rows(lv.reshape(-1, d), rows, si, qj, k)
    else:
        prog = ivf_full_search_program(nl, pad, d, b, nprobe, ks, db_dtype=jnp.bfloat16,
                                       dense=nprobe * pad <= 6144)
        _, si = prog(cents, c_sq, extra[1], sqn, li, qj)
        if id_mask is not None:
            si = jax_mask_shortlist_ids(si, id_mask)
        out = jax_rerank_staged(lv.reshape(-1, d), lookup, si, qj, k)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("nprobe", [2, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_jax_trained_index_both_routes(jax_trained, scan_dtype, nprobe, masked):
    j0, x, ids, q, mask = jax_trained
    params, arrays = j0.state()
    params = dict(params, scan_dtype=scan_dtype)
    j = JIVF.from_state(params, arrays)
    t = TIVF.from_state(params, arrays, device="cpu")
    id_mask = mask if masked else None
    jd, ji = j.search(q, 10, nprobe=nprobe, id_mask=id_mask)
    td, ti = t._search(q, 10, nprobe=nprobe, id_mask=id_mask, card_route=False)
    same_up_to_ties(jd, ji, td, ti)
    jd, ji = _jax_card_route(j, q, 10, nprobe, id_mask)
    td, ti = t._search(q, 10, nprobe=nprobe, id_mask=id_mask, card_route=True)
    same_up_to_ties(jd, ji, td, ti)
    if masked:
        assert mask[ti[ti >= 0]].all()


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("scan", [None, "dense", "select"])
def test_routes_agree_exactly_on_integer_data(scan_dtype, scan):
    """Integer rows: every distance is exact in f32, so the card route (any
    scan variant) and the CPU route return identical results."""
    rng = np.random.default_rng(6)
    x = rng.integers(-3, 4, (2000, 32)).astype(np.float32)
    x[0] = 7.0
    ids = np.arange(2000, dtype=np.int64) * 2
    q = rng.integers(-3, 4, (9, 32)).astype(np.float32)
    q[:, 0] = 7.0
    t = TIVF(dim=32, nlist=8, nprobe=8, scan_dtype=scan_dtype, device="cpu")
    t.train(x)
    t.add(x, ids)
    a = t._search(q, 12, card_route=True, scan=scan)
    b = t._search(q, 12, card_route=False)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
    _check_oracle(b, x, ids, q, 12)


# -- build modes ---------------------------------------------------------------------


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_device_build_matches_host_build(scan_dtype):
    points, ids, q = _gauss(512, 32, 1), np.arange(512, dtype=np.int64), _gauss(8, 32, 2)
    host = TIVF(dim=32, nlist=8, nprobe=8, scan_dtype=scan_dtype, device="cpu")
    host.train(points)
    host.add(points, ids)
    dev = TIVF(dim=32, nlist=8, nprobe=8, scan_dtype=scan_dtype, device="cpu")
    dev.train(torch.from_numpy(points))
    assert dev._mode == "device"
    dev.add(torch.from_numpy(points), torch.from_numpy(ids.astype(np.int32)))
    for route in (False, True):
        hd, hi = host._search(q, 10, card_route=route)
        dd, di = dev._search(q, 10, card_route=route)
        np.testing.assert_array_equal(hi, di)
        np.testing.assert_allclose(hd, dd, rtol=1e-5, atol=1e-5)
        _check_oracle((dd, di), points, ids, q, 10)
    np.testing.assert_array_equal(host.ids(), np.sort(dev.ids()))
    np.testing.assert_array_equal(dev.reconstruct(77), points[77])


def test_device_mode_state_roundtrip(tmp_path):
    points, ids = _gauss(300, 16, 5), np.arange(300, dtype=np.int64)
    dev = TIVF(dim=16, nlist=4, nprobe=4, device="cpu")
    dev.add(torch.from_numpy(points), torch.from_numpy(ids.astype(np.int32)))
    dev.search(_gauss(2, 16, 6), k=3)                     # stage (frees chunks)
    assert len(dev._dev_vecs) == 0 and dev.ntotal == 300
    np.testing.assert_array_equal(np.sort(dev.ids()), ids)
    tio.write_index(dev, tmp_path / "x.memo")
    back = tio.read_index(tmp_path / "x.memo", device="cpu")
    from_jax_side = jio.read_index(tmp_path / "x.memo")
    q = _gauss(4, 16, 7)
    bd, bi = back.search(q, k=5)
    dd, di = dev.search(q, k=5)
    np.testing.assert_array_equal(bi, di)
    np.testing.assert_allclose(bd, dd, rtol=1e-5, atol=1e-5)
    jd, ji = from_jax_side.search(q, k=5)
    np.testing.assert_array_equal(ji, di)
    np.testing.assert_array_equal(back.reconstruct(123), points[123])   # rows re-sorted by id


# -- incremental add, tail and fold --------------------------------------------------------


@pytest.mark.parametrize("device_input", [False, True])
def test_incremental_add_matches_fresh_build(device_input):
    d = 24
    base, extra = _gauss(600, d, 10), _gauss(50, d, 11)
    allpts = np.concatenate([base, extra])
    all_ids = np.arange(650, dtype=np.int64)
    q = _gauss(6, d, 12)
    inc = TIVF(dim=d, nlist=6, nprobe=3, device="cpu")
    as_in = torch.from_numpy if device_input else (lambda a: a)
    inc.train(as_in(base))
    inc.add(as_in(base), all_ids[:600])
    inc.search(q, k=5)                                    # stage
    staged_before = inc._staged
    inc.add(as_in(extra), all_ids[600:])
    assert inc._staged is staged_before                   # O(batch), no restage
    assert inc._tail is not None and inc._tail.count == 50 and inc.ntotal == 650
    fresh = TIVF(dim=d, nlist=6, nprobe=3, device="cpu")
    fresh.train(base)
    fresh.add(allpts, all_ids)
    for route in (False, True):
        a, b = inc._search(q, 5, card_route=route), fresh._search(q, 5, card_route=route)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-5)
    dists, ids_r = inc.ranked_all(q[0])
    assert dists.shape[0] == 650
    np.testing.assert_array_equal(ids_r[:10], _oracle(allpts, all_ids, q[:1], 10)[1][0])


def test_tail_overflow_restages_and_matches_oracle():
    d = 16
    base = _gauss(256, d, 20)
    inc = TIVF(dim=d, nlist=4, nprobe=4, device="cpu")
    inc.train(base)
    inc.add(base, np.arange(256, dtype=np.int64))
    q = _gauss(2, d, 21)
    inc.search(q, k=3)
    big = _gauss(tail_restage_threshold(256) + 100, d, 22)
    inc.add(big, np.arange(256, 256 + big.shape[0], dtype=np.int64))
    assert inc._restage_needed
    got = inc.search(q, k=3)
    assert inc._tail is None and not inc._restage_needed
    allpts = np.concatenate([base, big])
    _check_oracle(got, allpts, np.arange(len(allpts)), q, 3)


def test_device_restage_preserves_rows():
    d = 16
    base = _gauss(200, d, 30)
    inc = TIVF(dim=d, nlist=4, nprobe=4, device="cpu")
    inc.add(torch.from_numpy(base), np.arange(200))
    q = _gauss(3, d, 31)
    inc.search(q, k=4)
    assert len(inc._dev_vecs) == 0
    big = _gauss(tail_restage_threshold(200) + 10, d, 32)
    inc.add(torch.from_numpy(big), np.arange(200, 200 + big.shape[0]))
    allpts = np.concatenate([base, big])
    for route in (False, True):
        _check_oracle(inc._search(q, 4, card_route=route), allpts, np.arange(len(allpts)), q, 4)
    assert inc.ntotal == len(allpts)


@pytest.mark.parametrize("card_route", [False, True])
def test_tail_respects_probe_visibility(card_route):
    d = 8
    rng = np.random.default_rng(40)
    a = rng.standard_normal((64, d)).astype(np.float32) + 20.0
    b = rng.standard_normal((64, d)).astype(np.float32) - 20.0
    idx = TIVF(dim=d, nlist=2, nprobe=1, device="cpu")
    idx.train(np.concatenate([a, b]))
    idx.add(a, np.arange(64, dtype=np.int64))
    q = (a[:1] + 0.05).astype(np.float32)
    idx.search(q, k=3)
    far = (b[:1] - 0.05).astype(np.float32)
    idx.add(far, np.asarray([999], np.int64))
    assert idx._tail is not None and idx._tail.count == 1
    assert 999 not in idx._search(q, 3, card_route=card_route)[1]
    assert idx._search(far + 0.01, 1, card_route=card_route)[1][0, 0] == 999


def test_cpu_route_scores_bf16_store_values_exactly():
    d = 32
    points, ids, q = _gauss(256, d, 50), np.arange(256, dtype=np.int64), _gauss(5, d, 51)
    idx = TIVF(dim=d, nlist=4, nprobe=4, scan_dtype="int8", rerank_dtype="bfloat16",
               device="cpu")
    idx.train(points)
    idx.add(points, ids)
    store_vals = torch.from_numpy(points).to(torch.bfloat16).float().numpy()
    _check_oracle(idx.search(q, k=8), store_vals, ids, q, 8)
    # The card route reranks against the same bf16 store.
    _check_oracle(idx._search(q, 8, card_route=True), store_vals, ids, q, 8)


@pytest.mark.parametrize("scan_dtype,cap,mode", [
    ("float32", None, "device"),
    ("int8", None, "device"),
    ("float32", 256, "device"),
    ("int8", 128, "device"),
    ("float32", None, "host"),
    ("bfloat16", None, "host"),
])
def test_fold_matches_oracle(scan_dtype, cap, mode):
    """Removal holes mid-list, then a tail folded in at the high-water
    marks (test_devbuild.py TestTailFold)."""
    rng = np.random.default_rng(0)
    dim, n = 24, 2000
    data = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    q = data[:5]
    idx = TIVF(dim=dim, nlist=16, nprobe=16, scan_dtype=scan_dtype, pad_cap=cap, device="cpu")
    as_in = torch.from_numpy if mode == "device" else (lambda a: a)
    idx.add(as_in(data[:1000]), ids[:1000])
    idx.search(q, 5)
    idx.remove_ids([3, 500, 999])
    if mode == "host":
        idx.search(q, 5)
    idx.add(as_in(data[1000:]), ids[1000:])
    assert idx._tail is not None and idx._tail.count == 1000
    idx._restage_needed = True
    d, i = idx.search(q, 5)                               # the fold happens here
    assert idx._tail is None
    li = idx._staged[3].numpy()
    assert (li >= 0).sum() == 1997
    if cap:
        assert (li >= 0).sum(axis=1).max() <= cap
    keep = ~np.isin(ids, [3, 500, 999])
    oi = _oracle(data[keep], ids[keep], q, 5)[1]
    for route in (False, True):
        got = idx._search(q, 5, card_route=route)[1]
        if scan_dtype == "bfloat16" and not route:
            np.testing.assert_array_equal(got[:, 0], oi[:, 0])
        else:
            np.testing.assert_array_equal(got, oi)
    np.testing.assert_allclose(idx.reconstruct(1500), data[1500], atol=1e-2)


def test_fold_grows_pad():
    rng = np.random.default_rng(1)
    dim = 16
    centers = rng.standard_normal((4, dim)).astype(np.float32) * 10
    base = (centers[np.arange(400) % 4] + rng.standard_normal((400, dim)) * 0.1).astype(
        np.float32)
    idx = TIVF(dim=dim, nlist=4, nprobe=4, device="cpu")
    idx.add(torch.from_numpy(base), np.arange(400))
    idx.search(base[:2], 3)
    pad_before = idx._staged[6]
    hot = (centers[0] + rng.standard_normal((300, dim)) * 0.1).astype(np.float32)
    idx.add(torch.from_numpy(hot), np.arange(400, 700))
    idx._restage_needed = True
    _, got = idx.search(hot[:2], 3)
    assert idx._staged[6] > pad_before
    np.testing.assert_array_equal(got[:, 0], [400, 401])
    assert ((got >= 400) | (got % 4 == 0)).all()
    assert (idx._staged[3].numpy() >= 0).sum() == 700


# -- removal, filters, pad_cap ------------------------------------------------------------


POINTS, Q = _gauss(400, 24, 1), _gauss(4, 24, 2)
IDS = np.arange(400, dtype=np.int64)
DROP = np.arange(0, 400, 7, dtype=np.int64)
KEEP = np.setdiff1d(IDS, DROP)


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mode", ["host", "device"])
def test_remove_ids(scan_dtype, mode):
    idx = TIVF(dim=24, nlist=4, nprobe=4, scan_dtype=scan_dtype, device="cpu")
    as_in = torch.from_numpy if mode == "device" else (lambda a: a)
    idx.train(as_in(POINTS))
    idx.add(as_in(POINTS), IDS)
    idx.search(Q, 3)
    staged = idx._staged
    assert idx.remove_ids(DROP) == len(DROP) and idx.ntotal == len(KEEP)
    if mode == "device":
        assert idx._staged is not staged and idx._staged[2] is staged[2]   # in place
    for route in (False, True):
        _check_oracle(idx._search(Q, 6, card_route=route), POINTS[KEEP], KEEP, Q, 6)
    assert idx.remove_ids(DROP) == 0
    np.testing.assert_array_equal(np.sort(idx.ids()), KEEP)
    with pytest.raises(KeyError):
        idx.reconstruct(int(DROP[3]))


def test_remove_ids_matches_jax_host_mode():
    j = JIVF(dim=24, nlist=4, nprobe=2)
    j.train(POINTS)
    j.add(POINTS, IDS)
    t = TIVF.from_state(*j.state(), device="cpu")
    assert t.remove_ids(DROP) == j.remove_ids(DROP)
    jd, ji = j.search(Q, 6)
    td, ti = t.search(Q, 6)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("tail", [False, True])
def test_id_mask_matches_oracle(scan_dtype, tail):
    rng = np.random.default_rng(0)
    points = rng.standard_normal((400, 24)).astype(np.float32)
    ids = np.arange(400, dtype=np.int64)
    mask = rng.random(420) < 0.25
    q = rng.standard_normal((5, 24)).astype(np.float32)
    idx = TIVF(dim=24, nlist=4, nprobe=4, scan_dtype=scan_dtype, device="cpu")
    idx.train(points[:300])
    idx.add(points[: 300 if tail else 400], ids[: 300 if tail else 400])
    if tail:
        idx.search(q, 3)
        idx.add(points[300:], ids[300:])
        assert idx._tail.count == 100
    keep = mask[:400]
    for route in (False, True):
        got = idx._search(q, 8, id_mask=mask, card_route=route)
        _check_oracle(got, points[keep], ids[keep], q, 8)
        again = idx._search(q, 8, id_mask=mask, card_route=route)      # cached staging
        np.testing.assert_array_equal(again[1], got[1])
    np.testing.assert_array_equal(idx.search(q, 5)[1], _oracle(points, ids, q, 5)[1])


@pytest.mark.parametrize("mode", ["host", "device"])
def test_pad_cap_spill_bounds_lists(mode):
    rng = np.random.default_rng(55)
    hot = rng.standard_normal((700, 16)).astype(np.float32) * 0.5
    cold = rng.standard_normal((100, 16)).astype(np.float32) + 30.0
    pts = np.concatenate([hot, cold])
    ids = np.arange(800, dtype=np.int64)
    q = rng.standard_normal((4, 16)).astype(np.float32) * 0.5
    idx = TIVF(dim=16, nlist=8, nprobe=8, pad_cap=128, device="cpu")
    as_in = torch.from_numpy if mode == "device" else (lambda a: a)
    idx.train(as_in(pts))
    idx.add(as_in(pts), ids)
    for route in (False, True):
        _check_oracle(idx._search(q, 5, card_route=route), pts, ids, q, 5)
    assert (idx._staged[3] >= 0).sum(dim=1).max() <= 128
    assert idx.state()[0]["pad_cap"] == 128
    bad = TIVF(dim=16, nlist=2, nprobe=2, pad_cap=16, device="cpu")
    bad.train(pts)
    bad.add(pts, ids)
    with pytest.raises(ValueError):
        bad.search(q, k=3)


def test_capped_incremental_restage_keeps_base_lists():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 3
    cid = np.minimum(rng.zipf(1.3, 500) - 1, 7)
    rows = (centers[cid] + rng.standard_normal((500, 16))).astype(np.float32)
    cap = 126
    idx = TIVF(dim=16, nlist=8, nprobe=8, pad_cap=cap, device="cpu")
    idx.add(torch.from_numpy(rows[:400]), np.arange(400))
    idx.search(rows[:4], 5)
    assert idx._cap_valid
    before = idx._staged[3].numpy().copy()
    idx.add(torch.from_numpy(rows[400:]), np.arange(400, 500))
    idx._restage_needed = True
    _, got = idx.search(rows[:4], 5)
    after = idx._staged[3].numpy()
    assert (after >= 0).sum(axis=1).max() <= cap and idx.ntotal == 500
    home = {int(v): lst for lst in range(before.shape[0]) for v in before[lst] if v >= 0}
    assert all(home[int(v)] == lst for lst in range(after.shape[0]) for v in after[lst]
               if 0 <= v < 400)
    np.testing.assert_array_equal(got, _oracle(rows, np.arange(500), rows[:4], 5)[1])


# -- surface, files, knobs ------------------------------------------------------------------


def test_surface_and_ranking_match_jax(jax_trained):
    j, x, ids, q, _ = jax_trained
    t = TIVF.from_state(*j.state(), device="cpu")
    assert t.kind == "ivf_flat" and t.ntotal == j.ntotal and t.is_trained
    np.testing.assert_array_equal(t.ids(), j.ids())
    for r in range(3):
        jd, ji = j.ranked_all(q[r])
        td, ti = t.ranked_all(q[r])
        same_up_to_ties(jd[None], ji[None], td[None], ti[None])
    jd, ji, jn = j.ranked_many_device(q[:4])
    td, ti, tn = t.ranked_many_device(q[:4])
    assert jn == tn == 3000
    same_up_to_ties(np.asarray(jd)[:, :50], np.asarray(ji)[:, :50], td.numpy()[:, :50],
                    ti.numpy()[:, :50])
    cache = t._ranked_cache
    t.ranked_all(q[0])
    assert t._ranked_cache is cache
    t.search(q[:1], 3)
    t._ranked_cache = None
    t.ranked_all(q[0])
    assert t._ranked_cache[0].shape[0] == t._staged[2].shape[0] * t._staged[2].shape[1]
    t.add(x[:1] + 5.0, np.asarray([99999]))
    assert t._ranked_cache is None
    assert t.geometry_diagnostic() == j.geometry_diagnostic()


def test_options_and_empty():
    with pytest.raises(ValueError, match="quantized scan_dtype"):
        TIVF(dim=32, scan_dtype="float32", rerank_dtype="bfloat16", device="cpu")
    TIVF(dim=32, scan_dtype="int8", rerank_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError):
        TIVF(dim=32, scan_dtype="float16", device="cpu")
    with pytest.raises(ValueError):
        TIVF(dim=32, pad_cap=4, device="cpu")
    t = TIVF(dim=16, device="cpu")
    d, i = t.search(np.zeros((1, 16), np.float32), 3)
    assert (i == -1).all() and np.isinf(d).all()
    assert t.ranked_all(np.zeros(16, np.float32))[0].shape == (0,)
    assert t.geometry_diagnostic()["n"] == 0


def test_geometry_diagnostic():
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.standard_normal((900, 16)).astype(np.float32) * 0.1,
                          rng.standard_normal((100, 16)).astype(np.float32) * 20.0])
    heavy = TIVF(dim=16, nlist=32, nprobe=4, device="cpu")
    heavy.train(pts)
    heavy.add(pts, np.arange(1000))
    assert heavy.geometry_diagnostic()["heavy_tailed"]
    clustered = np.concatenate([rng.standard_normal((125, 16)).astype(np.float32) * 0.2 + c
                                for c in rng.standard_normal((8, 16)).astype(np.float32) * 25])
    ok = TIVF(dim=16, nlist=8, nprobe=4, device="cpu")
    ok.train(clustered)
    ok.add(clustered, np.arange(1000))
    assert not ok.geometry_diagnostic()["heavy_tailed"]


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_index_files_cross_read(tmp_path, scan_dtype, jax_trained):
    j0, x, ids, q, mask = jax_trained
    params, arrays = j0.state()
    j = JIVF.from_state(dict(params, scan_dtype=scan_dtype,
                             rerank_dtype="bfloat16" if scan_dtype != "float32" else "float32"),
                        arrays)
    t = TIVF.from_state(*j.state(), device="cpu")
    jio.write_index(j, tmp_path / "jax.memo")
    tio.write_index(t, tmp_path / "torch.memo")
    assert (tmp_path / "jax.memo").read_bytes() == (tmp_path / "torch.memo").read_bytes()
    from_jax = tio.read_index(tmp_path / "jax.memo", device="cpu")
    from_torch = jio.read_index(tmp_path / "torch.memo")
    assert isinstance(from_jax, TIVF)
    assert (from_jax.scan_dtype, from_jax.rerank_dtype) == (j.scan_dtype, j.rerank_dtype)
    jd, ji = from_torch.search(q, 7, id_mask=mask)
    td, ti = from_jax.search(q, 7, id_mask=mask)
    same_up_to_ties(jd, ji, td, ti)
    assert tio.load_index_or_fresh(tmp_path / "jax.memo", dim=64, device="cpu").kind == "ivf_flat"


def test_make_index_knobs(monkeypatch):
    for n in (10, 4096, 5000, 100_000, 1_000_000, 10 ** 8):
        assert tcommands.auto_nlist(n) == jcommands.auto_nlist(n)
    for var in ("C99VDB_NLIST", "C99VDB_NPROBE", "C99VDB_SCAN_DTYPE", "C99VDB_RERANK_DTYPE",
                "C99VDB_PAD_CAP"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("C99VDB_INDEX", "ivf_flat")
    made = tcommands.make_index(device="cpu")
    assert isinstance(made, TIVF) and (made.nlist, made.nprobe) == (64, 8)
    assert tcommands.make_index(corpus_size=1_000_000, device="cpu").nlist == 4096
    monkeypatch.setenv("C99VDB_NLIST", "32")
    monkeypatch.setenv("C99VDB_NPROBE", "3")
    monkeypatch.setenv("C99VDB_SCAN_DTYPE", "int8")
    monkeypatch.setenv("C99VDB_RERANK_DTYPE", "bfloat16")
    monkeypatch.setenv("C99VDB_PAD_CAP", "256")
    made = tcommands.make_index(corpus_size=1_000_000, device="cpu")
    want = jcommands.make_index(corpus_size=1_000_000)
    for attr in ("nlist", "nprobe", "scan_dtype", "rerank_dtype", "pad_cap"):
        assert getattr(made, attr) == getattr(want, attr)


WORDS = ("tea coffee morning meeting project deadline budget review design kernel memory "
         "cache index vector search query filter record note user agent system").split()


def test_memodb_ivf_flat_matches_jax(tmp_path, monkeypatch):
    """MemoDB with C99VDB_INDEX=ivf_flat on the CPU against the JAX
    package's MemoDB, each loading the JAX side's files (so both hold the
    same trained lists)."""
    import shutil

    from c99_vectordb_tpu.api import MemoDB as JMemoDB
    from c99_vectordb_tpu_torch.api import MemoDB as TMemoDB

    monkeypatch.setenv("C99VDB_INDEX", "ivf_flat")
    monkeypatch.setenv("C99VDB_NLIST", "8")
    rng = np.random.default_rng(8)
    records = [{"body": " ".join(WORDS[k] for k in rng.integers(0, len(WORDS), 6)),
                "metadata": {"source": ["user", "agent"][i % 2], "p": int(i % 5)}}
               for i in range(600)]
    queries = [" ".join(WORDS[k] for k in rng.integers(0, len(WORDS), 3)) for _ in range(16)]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jdb = JMemoDB("notes", cwd=str(tmp_path / "j"))
    tdb = TMemoDB("notes", cwd=str(tmp_path / "t"), device="cpu")

    def sync_files():
        for name in ("notes.yaml", "notes.memo"):
            shutil.copy2(tmp_path / "j" / name, tmp_path / "t" / name)

    def same(a, b):
        """Equal hit lists up to swaps among scores tied within TOL (hash
        embeddings tie often)."""
        assert len(a) == len(b)
        for ha, hb in zip(a, b):
            assert len(ha) == len(hb)
            same_up_to_ties(np.array([[h.score for h in ha]]), np.array([[h.doc_id for h in ha]]),
                            np.array([[h.score for h in hb]]), np.array([[h.doc_id for h in hb]]))

    jdb.save_many(records)
    sync_files()
    same(jdb.recall_many(queries, k=5), tdb.recall_many(queries, k=5))
    same(jdb.recall_many(queries, k=5, filter="{p: {$gte: 3}}"),
         tdb.recall_many(queries, k=5, filter="{p: {$gte: 3}}"))
    same([jdb.recall(queries[0], k=4, filter="{source: user}", pushdown=True)],
         [tdb.recall(queries[0], k=4, filter="{source: user}", pushdown=True)])
    assert jdb.delete(17) and tdb.delete(17)
    assert (tmp_path / "j" / "notes.yaml").read_bytes() == (
        tmp_path / "t" / "notes.yaml").read_bytes()
    same(jdb.recall_many(queries, k=5), tdb.recall_many(queries, k=5))
    assert jdb.reindex() == tdb.reindex() == 1
    assert tdb._index().kind == "ivf_flat" and tdb._index()._mode == "device"
    sync_files()
    same(jdb.recall_many(queries, k=5), tdb.recall_many(queries, k=5))


def test_large_tensor_ids_stay_exact():
    """Ids past 2**24 given as tensors keep every bit in host mode."""
    pts = _gauss(64, 8, 11)
    big = torch.arange(2 ** 24 + 1, 2 ** 24 + 65, dtype=torch.int64)
    t = TIVF(dim=8, nlist=2, nprobe=2, device="cpu")
    t.add(pts, big)
    np.testing.assert_array_equal(t.ids(), big.numpy())
    assert t.remove_ids(big[:3]) == 3
    np.testing.assert_array_equal(t.search(pts[5:6], 1)[1], [[2 ** 24 + 6]])
