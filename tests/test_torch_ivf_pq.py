"""PyTorch port, IVFPQIndex (models/ivf_pq.py) against the JAX package on the
CPU: a JAX-trained index carried across through from_state returns the JAX
package's results on both routes; counterparts of the IVF-PQ cases of
test_ivf.py, test_adc_pallas.py, test_opq.py, test_devbuild.py,
test_remove_ids.py, test_filter_pushdown.py, test_round3_fixes.py and
test_ranked_many.py; TPUVDB01 files in both directions; the engine knobs;
MemoDB with C99VDB_INDEX=ivf_pq.

The card route (`_search(card_route=True)`) runs here on CPU tensors, where
each kernel wrapper takes its plain version; it is compared with the JAX
package's TPU branch assembled from its Pallas programs (interpret mode).
The CPU route is compared with the JAX package's own search. The two routes
are never held against each other's reference: they round and break ties
differently by design.

Tolerances. Exactly reranked distances (refine on) agree within 1e-5
relative, 1e-5 absolute near 0, ids equal except among distances tied that
closely. Pure-ADC distances of the card route cancel terms of the size of
q_sq + c_sq (coarse distance and item constant), so they agree within 16
f32 ulps of that size (2e-6 times it). Oracle checks run where the result
is exact by construction (refine with nprobe == nlist and a shortlist deep
enough to hold every probed row) against float64 numpy in (distance, id)
order: ids equal, distances within 1e-4 relative. Where the port trains
its own quantizer, a fresh port build is the reference (k-means sums in
another order than the JAX package's)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu import commands as jcommands
from c99_vectordb_tpu.models.devbuild import mask_norms as jax_mask_norms
from c99_vectordb_tpu.models.devbuild import mask_rows as jax_mask_rows
from c99_vectordb_tpu.models.devbuild import mask_shortlist_ids as jax_mask_shortlist_ids
from c99_vectordb_tpu.models.devbuild import merge_tail as jax_merge_tail
from c99_vectordb_tpu.models.devbuild import tail_scores as jax_tail_scores
from c99_vectordb_tpu.models.ivf_pq import IVFPQIndex as JPQ
from c99_vectordb_tpu.ops.adc_pallas import adc_dense_search_program, adc_full_search_program
from c99_vectordb_tpu.ops.rerank import exact_rerank_staged as jax_rerank_staged
from c99_vectordb_tpu.storage import index_io as jio
from c99_vectordb_tpu_torch import commands as tcommands
from c99_vectordb_tpu_torch.models.devbuild import tail_restage_threshold
from c99_vectordb_tpu_torch.models.ivf_pq import IVFPQIndex as TPQ
from c99_vectordb_tpu_torch.models.ivf_pq import train_opq_rotation
from c99_vectordb_tpu_torch.storage import index_io as tio

TOL = 1e-5


def same_up_to_ties(want_d, want_i, got_d, got_i, tol=TOL, atol=TOL):
    want_d, want_i, got_d, got_i = map(np.asarray, (want_d, want_i, got_d, got_i))
    np.testing.assert_allclose(got_d, want_d, rtol=tol, atol=atol)
    for r in range(want_d.shape[0]):
        k, s = want_d.shape[1], 0
        while s < k:
            e = s + 1
            while e < k and (want_d[r, e] == want_d[r, s] or abs(
                    want_d[r, e] - want_d[r, s]) <= max(atol, tol * abs(want_d[r, s]))):
                e += 1
            if e < k:
                assert sorted(got_i[r, s:e]) == sorted(want_i[r, s:e]), (r, s, e)
            s = e


def _corpus(n, d, seed, centers=16):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32) * 3.0
    return (c[rng.integers(0, centers, n)]
            + rng.standard_normal((n, d)).astype(np.float32)).astype(np.float32)


def _oracle(points, ids, q, k):
    d = ((q[:, None, :].astype(np.float64) - points[None, :, :]) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(ids, d.shape), d), axis=1)[:, :k]
    return np.take_along_axis(d, order, axis=1), ids[order]


def _check_oracle(got, points, ids, q, k):
    od, oi = _oracle(points, ids, q, k)
    np.testing.assert_array_equal(got[1], oi)
    np.testing.assert_allclose(got[0], od, rtol=1e-4, atol=1e-5)


def _pq(dim=32, **kw):
    kw.setdefault("nlist", 4)
    kw.setdefault("nprobe", 4)
    kw.setdefault("m", 4)
    return TPQ(dim=dim, device="cpu", **kw)


def _adc_atol(index, q):
    """16 f32 ulps of the cancelling magnitude max q_sq + max c_sq."""
    c_sq = index._stage()[1]
    c_sq = c_sq.numpy() if isinstance(c_sq, torch.Tensor) else np.asarray(c_sq)
    return 2e-6 * float((q * q).sum(1).max() + c_sq.max())


# -- a JAX-trained index, carried across ------------------------------------------


@pytest.fixture(scope="module")
def jax_trained():
    """Host-mode JAX indexes, one per codebook layout: 8-bit (m 8), packed
    4-bit (m 8), unpacked ksub 64 (m 4); gapped ids."""
    x = _corpus(2400, 32, seed=1)
    ids = np.sort(np.random.default_rng(2).permutation(5000)[:2400]).astype(np.int64)
    out = {}
    for ksub, m in ((256, 8), (16, 8), (64, 4)):
        j = JPQ(dim=32, nlist=16, nprobe=4, m=m, ksub=ksub)
        j.train(x)
        j.add(x, ids)
        out[ksub] = j
    q = (x[np.random.default_rng(3).choice(2400, 10)] + 0.05).astype(np.float32)
    mask = np.random.default_rng(4).random(5100) < 0.3
    return out, x, ids, q, mask


def _variant(j0, refine, refine_factor=4):
    params, arrays = j0.state()
    params = dict(params, refine=refine, refine_factor=refine_factor)
    if not refine:
        arrays = dict(arrays, vectors=np.zeros((0, j0.dim), np.float32))
    return params, arrays


def _jax_card_route(j, q, k, nprobe, id_mask):
    """The JAX package's TPU branch of IVFPQIndex.search, assembled from its
    programs (interpret mode on the CPU)."""
    (cents, c_sq, books, _, li, c128, ic, pad) = j._stage()
    if id_mask is not None:
        ic = jax_mask_norms(ic, li, id_mask)
    nl, b, d, ksub = int(cents.shape[0]), q.shape[0], q.shape[1], int(books.shape[1])
    k_adc = max(min(k * j.refine_factor, j.ntotal) if j.refine else k, k)
    if j.refine and k_adc > 256:
        prog = adc_dense_search_program(nl, pad, d, j.m, ksub, b, nprobe, k_adc)
    else:
        prog = adc_full_search_program(nl, pad, d, j.m, ksub, b, nprobe, k_adc)
    dd, di = prog(cents, c_sq, books, c128, ic, li, jnp.asarray(q))
    if id_mask is not None:
        di = jax_mask_shortlist_ids(di, id_mask)
    if j._tail and j._tail.count:
        td = jax_tail_scores(j._tail, cents, c_sq, jnp.asarray(q), nprobe, vec_field="recon")
        if id_mask is not None:
            td = jnp.where(jax_mask_rows(j._tail["ids"], id_mask)[None, :], td, jnp.inf)
        dd, di = jax_merge_tail(dd, di, td, j._tail["ids"], k_adc)
    if j.refine:
        vecs, lookup, _, _ = j._stage_refine()
        dd, di = jax_rerank_staged(vecs, lookup, di.astype(jnp.int32), jnp.asarray(q), k)
        return np.asarray(dd), np.asarray(di)
    return np.asarray(dd)[:, :k], np.asarray(di)[:, :k]


@pytest.mark.parametrize("ksub", [256, 16, 64])
@pytest.mark.parametrize("refine,factor", [(True, 4), (True, 40), (False, 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_jax_trained_index_both_routes(jax_trained, ksub, refine, factor, masked):
    """CPU route against the JAX package's search; for the kernels' codebook
    sizes, the card route against its TPU branch (the select kernel at
    refine_factor 4 and refine off, the dense kernel at 40)."""
    js, x, ids, q, mask = jax_trained
    params, arrays = _variant(js[ksub], refine, factor)
    j = JPQ.from_state(params, arrays)
    t = TPQ.from_state(params, arrays, device="cpu")
    id_mask = mask if masked else None
    jd, ji = j.search(q, 10, nprobe=4, id_mask=id_mask)
    td, ti = t._search(q, 10, nprobe=4, id_mask=id_mask, card_route=False)
    same_up_to_ties(jd, ji, td, ti)
    if ksub == 64:
        return                          # no kernel route for this size
    jd, ji = _jax_card_route(j, q, 10, 4, id_mask)
    td, ti = t._search(q, 10, nprobe=4, id_mask=id_mask, card_route=True)
    atol = TOL if refine else _adc_atol(t, q)
    same_up_to_ties(jd, ji, td, ti, atol=atol)


def test_card_route_with_tail_matches_jax(jax_trained):
    """Rows added after staging park in the tail on both sides, scored by
    the same estimator and merged into the card route's shortlist."""
    js, x, ids, q, mask = jax_trained
    for refine in (True, False):
        params, arrays = _variant(js[256], refine)
        j = JPQ.from_state(params, arrays)
        t = TPQ.from_state(params, arrays, device="cpu")
        j.search(q, 5)
        t.search(q, 5)
        extra = np.concatenate([q + 0.01, x[:110] + 0.03]).astype(np.float32)
        new_ids = np.arange(6000, 6120, dtype=np.int64)
        j.add(extra, new_ids)
        t.add(extra, new_ids)
        assert t._tail is not None and t._tail.count == 120
        for id_mask in (None, mask):
            jd, ji = _jax_card_route(j, q, 10, 4, id_mask)
            td, ti = t._search(q, 10, nprobe=4, id_mask=id_mask, card_route=True)
            same_up_to_ties(jd, ji, td, ti, atol=TOL if refine else _adc_atol(t, q))
            # The mask (5,100 ids long) excludes every tail id.
            assert (ti >= 6000).any() == (id_mask is None)


# -- counterparts of the JAX package's IVF-PQ tests --------------------------------


@pytest.fixture(scope="module")
def clustered():
    x = _corpus(1024, 32, seed=11)
    return x, np.arange(1024, dtype=np.int64)


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


@pytest.mark.parametrize("card_route", [False, True])
def test_recall_and_refine_beats_pure_adc(clustered, card_route):
    x, ids = clustered
    q = x[np.random.default_rng(9).choice(1024, 8)] + 0.01
    _, want = _oracle(x, ids, q, 10)
    pure = _pq(nlist=16, nprobe=16, m=8, refine=False)
    pure.train(x)
    pure.add(x, ids)
    refined = _pq(nlist=16, nprobe=16, m=8)
    refined.train(x)
    refined.add(x, ids)
    _, gp = pure._search(q, 10, card_route=card_route)
    _, gr = refined._search(q, 10, card_route=card_route)
    _, exact1 = _oracle(x, ids, q, 1)
    assert all(exact1[r, 0] in gp[r].tolist() for r in range(8))
    assert _recall(gp, want) >= 0.5
    assert _recall(gr, want) >= max(_recall(gp, want), 0.9)


def test_host_retrain_reencodes_rows():
    """Retraining a host-mode index that holds rows re-encodes them under
    the new quantizer (a fresh build on that quantizer is the reference);
    a pure-code index cannot, and refuses. (The JAX package keeps the old
    codes here: ROADMAP Queue 3.)"""
    x, y = _corpus(600, 32, seed=14), _corpus(600, 32, seed=15)
    ids = np.arange(600)
    t = _pq(nlist=8)
    t.train(x)
    t.add(x, ids)
    t.search(x[:2], 3)
    t.train(y)
    fresh = _pq(nlist=8)
    fresh.train(y)
    fresh.add(x, ids)
    np.testing.assert_array_equal(t._codes, fresh._codes)
    np.testing.assert_array_equal(t._assign, fresh._assign)
    for card_route in (False, True):
        got = t._search(x[:5], 5, card_route=card_route)
        want = fresh._search(x[:5], 5, card_route=card_route)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    pure = _pq(nlist=8, refine=False)
    pure.add(x, ids)
    with pytest.raises(ValueError, match="orphan"):
        pure.train(y)


def test_ranked_all_ties_in_id_order_on_a_positional_store():
    """Duplicate rows under gappy ids added after staging land in a
    positional refine store out of id order; ranked_all still orders exact
    ties by id (the JAX package's lexicographic sort)."""
    x = _corpus(64, 16, seed=16)
    t = _pq(dim=16, nlist=2, nprobe=2)
    t.add(torch.from_numpy(x), torch.arange(0, 6400, 100, dtype=torch.int32))
    t.search(x[:1], 3)
    t.add(torch.from_numpy(np.repeat(x[:1], 3, axis=0)),
          torch.tensor([7, 3, 5], dtype=torch.int32))
    assert t._stage_refine()[1][0] != "identity"
    d, i = t.ranked_all(x[0])
    assert i[:4].tolist() == [0, 3, 5, 7] and (d[:4] == 0).all()
    dm, im, n = t.ranked_many_device(x[:1])
    np.testing.assert_array_equal(im[0, :n].numpy(), i)


def test_compression_dim_check_and_empty():
    x = _corpus(512, 32, seed=12)
    t = _pq(nlist=8)
    assert t.search(x[:2], 3)[1].tolist() == [[-1] * 3] * 2
    t.train(x)
    t.add(x, np.arange(512))
    assert t.code_bytes_per_vector == 4
    assert t._codes.shape == (512, 4) and t._codes.dtype == np.uint8
    with pytest.raises(ValueError, match="divisible"):
        TPQ(dim=30, m=8, device="cpu")
    with pytest.raises(ValueError):
        TPQ(dim=32, refine_dtype="int8", device="cpu")
    with pytest.raises(ValueError):
        TPQ(dim=32, refine=False, pad_cap=128, device="cpu")


@pytest.mark.parametrize("refine", [True, False])
def test_ranked_all_matches_jax(jax_trained, refine):
    """ranked_all: the refine store's exact scan, or the pure-code ADC
    ranking (the JAX package's _adc_ranked_program), with the JAX package's
    order; ranked_many_device is None for a pure-code index."""
    js, x, ids, q, _ = jax_trained
    params, arrays = _variant(js[256], refine)
    j = JPQ.from_state(params, arrays)
    t = TPQ.from_state(params, arrays, device="cpu")
    jd, ji = j.ranked_all(q[0])
    td, ti = t.ranked_all(q[0])
    assert td.shape == (2400,) and (np.diff(td) >= -1e-5).all()
    same_up_to_ties(jd[None], ji[None], td[None], ti[None])
    if refine:
        many = t.ranked_many_device(q[:3])
        for r in range(3):
            one = t.ranked_all_device(q[r])
            np.testing.assert_array_equal(many[0][r].numpy(), one[0].numpy())
            np.testing.assert_array_equal(many[1][r].numpy(), one[1].numpy())
    else:
        assert t.ranked_many_device(q) is None and t.ranked_all_device(q[0]) is None


def test_pure_adc_ranked_all_matches_full_probe_search():
    x = _corpus(40, 32, seed=13)
    t = _pq(refine=False)
    t.train(x)
    t.add(x, np.arange(40))
    dists, got = t.ranked_all(x[7])
    assert len(got) == 40 and (np.diff(dists) >= -1e-5).all()
    sd, si = t._search(x[7:8], 10, nprobe=4, card_route=False)
    np.testing.assert_array_equal(got[:10], si[0])
    np.testing.assert_allclose(dists[:10], sd[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("refine", [True, False])
def test_refine_layouts_with_gapped_ids(refine):
    """Odd ids stage an id-indexed store; stride-64 ids a positional one
    (an id-indexed store would be ~64x the rows)."""
    rng = np.random.default_rng(9)
    pts = rng.standard_normal((60, 32)).astype(np.float32)
    odd = np.arange(60, dtype=np.int64) * 2 + 1
    t = _pq(nlist=2, nprobe=2, refine=True)
    t.train(pts)
    t.add(pts, odd)
    assert t._stage_refine()[1][0] == "identity"
    q = pts[17:19] + 0.01
    _, i = t._search(q, 5, card_route=refine)
    exact = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(i, odd[np.argsort(exact, axis=1)[:, :5]])
    wide = np.arange(60, dtype=np.int64) * 64
    t = _pq(nlist=2, nprobe=2, refine=True)
    t.train(pts)
    t.add(pts, wide)
    vecs, lookup, _, _ = t._stage_refine()
    assert lookup[0] != "identity" and vecs.shape[0] <= 2 * 64
    assert t._search(pts[5:6] + 0.01, 3, card_route=refine)[1][0, 0] == wide[5]


def test_refined_4bit_recall():
    x = _corpus(768, 32, seed=41, centers=8)
    ids = np.arange(768, dtype=np.int64)
    t = _pq(nlist=8, nprobe=8, m=8, ksub=16, refine_factor=8)
    t.train(x)
    t.add(x, ids)
    assert t._stage()[2].shape[1] == 16 and t._stage()[5].shape[1] == 4     # packed
    _, want = _oracle(x, ids, x[:8], 5)
    for card_route in (False, True):
        assert _recall(t._search(x[:8], 5, card_route=card_route)[1], want) >= 0.8


# -- OPQ -----------------------------------------------------------------------------


def _correlated(n=4096, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((n, 4)).astype(np.float32)
    mix = rng.standard_normal((4, dim)).astype(np.float32) * 3.0
    return low @ mix + 0.1 * rng.standard_normal((n, dim)).astype(np.float32)


def _recon_mse(index, data):
    data_q = index._rotate(data)
    assign, codes = index._encode(data)
    books = index._np(index._codebooks)
    recon = np.concatenate([books[j][codes[:, j].astype(int)] for j in range(index.m)], axis=1)
    return float(((data_q - (recon + index._np(index._centroids)[assign])) ** 2).mean())


def test_opq_rotation_orthogonal_and_reduces_error():
    data = _correlated()
    plain = _pq(m=4, refine=False)
    plain.train(data)
    opq = _pq(m=4, opq=True, opq_iters=6, refine=False)
    opq.train(data)
    np.testing.assert_allclose(opq._rotation @ opq._rotation.T, np.eye(32), atol=1e-4)
    assert _recon_mse(opq, data) < 0.9 * _recon_mse(plain, data)


def test_opq_rotation_tensor_input_matches_numpy_and_jax_quality():
    from c99_vectordb_tpu.models.ivf_pq import train_opq_rotation as jax_opq

    data = _correlated(n=2048)
    r_np = train_opq_rotation(data, 4, iters=2, seed=1, device="cpu")
    r_t = train_opq_rotation(torch.from_numpy(data), 4, iters=2, seed=1)
    np.testing.assert_allclose(r_t, r_np, rtol=1e-4, atol=1e-5)
    # The rotations themselves may differ (k-means sums in another order),
    # but both must be orthogonal and quantize this corpus about as well.
    r_j = jax_opq(data, 4, iters=2, seed=1)

    def mse(rot):
        idx = _pq(m=4, refine=False)
        idx._rotation = rot
        idx.train(data)
        return _recon_mse(idx, data)

    assert mse(r_np) <= 1.1 * mse(r_j)


@pytest.mark.parametrize("card_route", [False, True])
def test_opq_scores_stay_in_original_space(card_route):
    data = _correlated(n=1024)
    t = _pq(opq=True, opq_iters=3)
    t.train(data)
    t.add(data, np.arange(1024))
    q = data[:3] + 0.01
    d, i = t._search(q, 5, card_route=card_route)
    np.testing.assert_allclose(d, ((q[:, None, :] - data[i]) ** 2).sum(-1), rtol=1e-4, atol=1e-4)


def test_opq_recall_not_worse():
    data = _correlated(n=2048, seed=3)
    ids = np.arange(2048, dtype=np.int64)
    q = _correlated(n=16, seed=9)
    _, want = _oracle(data, ids, q, 10)

    def recall(opq):
        t = _pq(m=4, opq=opq, opq_iters=6, refine=False)
        t.train(data)
        t.add(data, ids)
        return _recall(t.search(q, 10)[1], want)

    assert recall(True) >= recall(False) - 0.05


def test_opq_reconstruct_maps_back():
    data = _correlated(n=1024, seed=4)
    t = _pq(m=4, opq=True, opq_iters=2, refine=False)
    t.train(data)
    t.add(data, np.arange(1024))
    approx = t.reconstruct(77)
    assert np.linalg.norm(approx - data[77]) < np.linalg.norm(approx - data[78])


# -- device mode, tail, capacity, pad_cap --------------------------------------------


def test_device_build_matches_host_build():
    pts = _corpus(512, 32, seed=60)
    ids = np.arange(512, dtype=np.int64)
    q = _corpus(6, 32, seed=61)
    host = _pq()
    host.train(pts)
    host.add(pts, ids)
    dev = _pq()
    dev.train(torch.from_numpy(pts))
    assert dev._mode == "device"
    dev.add(torch.from_numpy(pts), torch.arange(512, dtype=torch.int32))
    for card_route in (False, True):
        hd, hi = host._search(q, 10, card_route=card_route)
        dd, di = dev._search(q, 10, card_route=card_route)
        np.testing.assert_array_equal(hi, di)
        np.testing.assert_allclose(hd, dd, rtol=1e-4, atol=1e-5)
    assert len(dev._dev_vecs) == 0 and len(dev._dev_codes) == 0
    a_h, a_d = host.state()[1], dev.state()[1]
    for name in ("ids", "codes", "assign"):
        np.testing.assert_array_equal(a_h[name], a_d[name])
    np.testing.assert_allclose(a_h["vectors"], a_d["vectors"], rtol=1e-6)


@pytest.mark.parametrize("kw", [{"opq": True, "opq_iters": 2}, {"refine": False},
                                {"ksub": 16, "m": 8}, {"refine_dtype": "bfloat16"}])
def test_device_build_variants_match_host(kw):
    pts = _corpus(400, 32, seed=62)
    q = _corpus(4, 32, seed=63)
    host = _pq(**kw)
    host.train(pts)
    host.add(pts, np.arange(400, dtype=np.int64))
    dev = _pq(**kw)
    dev.train(torch.from_numpy(pts))
    dev.add(torch.from_numpy(pts), torch.arange(400, dtype=torch.int32))
    for card_route in (False, True):
        hd, hi = host._search(q, 5, card_route=card_route)
        dd, di = dev._search(q, 5, card_route=card_route)
        np.testing.assert_array_equal(hi, di)
        np.testing.assert_allclose(hd, dd, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("device_input", [False, True])
@pytest.mark.parametrize("card_route", [False, True])
def test_incremental_add_matches_fresh_build(device_input, card_route):
    base, extra = _corpus(600, 32, seed=70), _corpus(50, 32, seed=71)
    allpts = np.concatenate([base, extra])
    all_ids = np.arange(650, dtype=np.int64)
    q = _corpus(6, 32, seed=72)
    inc = _pq()
    if device_input:
        inc.train(torch.from_numpy(base))
        inc.add(torch.from_numpy(base), torch.arange(600, dtype=torch.int32))
    else:
        inc.train(base)
        inc.add(base, all_ids[:600])
    inc.search(q, 5)                                           # stage
    staged = inc._staged
    if device_input:
        inc.add(torch.from_numpy(extra), torch.arange(600, 650, dtype=torch.int32))
    else:
        inc.add(extra, all_ids[600:])
    assert inc._staged is staged and inc._tail.count == 50 and inc.ntotal == 650
    fresh = _pq()
    fresh.train(base)
    fresh.add(allpts, all_ids)
    di_d, di_i = inc._search(q, 5, card_route=card_route)
    df_d, df_i = fresh._search(q, 5, card_route=card_route)
    np.testing.assert_array_equal(di_i, df_i)
    np.testing.assert_allclose(di_d, df_d, rtol=1e-4, atol=1e-5)
    dists, ids_r = inc.ranked_all(q[0])
    assert dists.shape[0] == 650
    np.testing.assert_array_equal(ids_r[:10], _oracle(allpts, all_ids, q[:1], 10)[1][0])


def test_incremental_add_pure_code_ranked_all():
    base, extra = _corpus(300, 16, seed=80), _corpus(30, 16, seed=81)
    inc = _pq(dim=16, refine=False)
    inc.train(base)
    inc.add(base, np.arange(300))
    q = _corpus(1, 16, seed=82)[0]
    inc.search(q[None], 3)
    inc.add(extra, np.arange(300, 330))
    dists, ids_r = inc.ranked_all(q)
    assert dists.shape[0] == 330 and set(range(300, 330)) <= set(ids_r.tolist())
    fresh = _pq(dim=16, refine=False)
    fresh.train(base)
    fresh.add(np.concatenate([base, extra]), np.arange(330))
    fd, fi = fresh.ranked_all(q)
    np.testing.assert_array_equal(ids_r, fi)
    np.testing.assert_allclose(dists, fd, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("card_route", [False, True])
def test_tail_overflow_restages(card_route):
    base = _corpus(256, 16, seed=90)
    inc = _pq(dim=16)
    inc.add(torch.from_numpy(base), torch.arange(256, dtype=torch.int32))
    q = _corpus(3, 16, seed=91)
    inc.search(q, 4)
    thresh = tail_restage_threshold(256)
    big = _corpus(thresh + 20, 16, seed=92)
    inc.add(torch.from_numpy(big), torch.arange(256, 276 + thresh, dtype=torch.int32))
    assert inc._restage_needed
    dd, di = inc._search(q, 4, card_route=card_route)
    assert inc._tail is None and inc.ntotal == 276 + thresh
    fresh = _pq(dim=16)
    fresh.train(base)
    allpts = np.concatenate([base, big])
    fresh.add(allpts, np.arange(len(allpts)))
    fd, fi = fresh._search(q, 4, card_route=card_route)
    np.testing.assert_array_equal(di, fi)
    np.testing.assert_allclose(dd, fd, rtol=1e-4, atol=1e-5)


def test_refine_store_growth_and_gapped_append():
    base = _corpus(64, 16, seed=95)
    t = _pq(dim=16, nlist=2, nprobe=2)
    t.train(base)
    t.add(base, np.arange(64))
    q = _corpus(2, 16, seed=96)
    t.search(q, 3)
    assert t._stage_refine()[1][0] == "identity"
    more = _corpus(32, 16, seed=97)
    t.add(more, np.arange(64, 96))
    t.search(q, 3)
    far = _corpus(1, 16, seed=98)
    t.add(far, np.asarray([100_000]))
    assert t._stage_refine()[1][0] != "identity"
    allpts = np.concatenate([base, more, far])
    all_ids = np.concatenate([np.arange(96), [100_000]]).astype(np.int64)
    for card_route in (False, True):
        _check_oracle(t._search(q, 3, card_route=card_route), allpts, all_ids, q, 3)


def test_declared_capacity_device_mode():
    pts = _corpus(300, 16, seed=99)
    ids = torch.arange(300, dtype=torch.int32)
    q = _corpus(3, 16, seed=100)
    plain = _pq(dim=16)
    plain.train(torch.from_numpy(pts))
    plain.add(torch.from_numpy(pts), ids)
    capd = _pq(dim=16, capacity=512)
    capd.train(torch.from_numpy(pts))
    capd.add(torch.from_numpy(pts[:200]), ids[:200])
    assert len(capd._dev_vecs) == 0 and int(capd._staged_refine[0].shape[0]) == 512
    capd.add(torch.from_numpy(pts[200:]), ids[200:])
    pd_, pi_ = plain.search(q, 5)
    cd_, ci_ = capd.search(q, 5)
    np.testing.assert_array_equal(pi_, ci_)
    np.testing.assert_allclose(pd_, cd_, rtol=1e-5, atol=1e-6)
    extra = _corpus(300, 16, seed=101)
    capd.add(torch.from_numpy(extra), torch.arange(300, 600, dtype=torch.int32))
    fresh = _pq(dim=16)
    fresh.train(pts)
    fresh.add(np.concatenate([pts, extra]), np.arange(600))
    dd, di = capd.search(q, 5)
    fd, fi = fresh.search(q, 5)
    np.testing.assert_array_equal(di, fi)
    np.testing.assert_allclose(dd, fd, rtol=1e-4, atol=1e-5)
    assert capd.state()[0]["capacity"] == 512


@pytest.mark.parametrize("device_mode", [False, True])
@pytest.mark.parametrize("card_route", [False, True])
def test_pad_cap_bounds_lists_and_reencodes(device_mode, card_route):
    rng = np.random.default_rng(77)
    hot = rng.standard_normal((700, 16)).astype(np.float32) * 0.5
    cold = rng.standard_normal((100, 16)).astype(np.float32) + 30.0
    pts = np.concatenate([hot, cold])
    ids = np.arange(800, dtype=np.int64)
    q = rng.standard_normal((4, 16)).astype(np.float32) * 0.5
    t = _pq(dim=16, nlist=8, nprobe=8, pad_cap=128, refine_factor=160)
    if device_mode:
        t.train(torch.from_numpy(pts))
        t.add(torch.from_numpy(pts), torch.from_numpy(ids.astype(np.int32)))
    else:
        t.train(pts)
        t.add(pts, ids)
    got = t._search(q, 5, card_route=card_route)
    per_list = (t._staged[4] >= 0).sum(dim=1).numpy()
    assert per_list.max() <= 128 and per_list.sum() == 800
    _check_oracle(got, pts, ids, q, 5)
    assert t.state()[0]["pad_cap"] == 128
    assert t.geometry_diagnostic()["max_cell"] <= 128


def test_capped_incremental_restage_keeps_base_lists():
    rng = np.random.default_rng(78)
    pts = np.concatenate([rng.standard_normal((700, 16)).astype(np.float32) * 0.5,
                          rng.standard_normal((100, 16)).astype(np.float32) + 30.0])
    t = _pq(dim=16, nlist=8, nprobe=8, pad_cap=160, refine_factor=200)
    t.train(torch.from_numpy(pts))
    t.add(torch.from_numpy(pts[:600]), torch.arange(600, dtype=torch.int32))
    t.search(pts[:2], 3)
    before = {int(i): lst for lst, row in enumerate(t._staged[4].tolist()) for i in row if i >= 0}
    extra = torch.from_numpy(pts[600:])
    t.add(extra, torch.arange(600, 800, dtype=torch.int32))
    t._restage_needed = True
    got = t.search(pts[:4] + 0.01, 5)
    after = {int(i): lst for lst, row in enumerate(t._staged[4].tolist()) for i in row if i >= 0}
    assert all(after[i] == lst for i, lst in before.items())
    assert (t._staged[4] >= 0).sum(dim=1).max() <= 160 and len(after) == 800
    _check_oracle(got, pts, np.arange(800), pts[:4] + 0.01, 5)


# -- removal, reconstruct, filters ----------------------------------------------------


POINTS = _corpus(400, 24, seed=1)
IDS = np.arange(400, dtype=np.int64)
Q = _corpus(4, 24, seed=2)
DROP = np.arange(0, 400, 7, dtype=np.int64)
KEEP = np.setdiff1d(IDS, DROP)


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("card_route", [False, True])
def test_remove_ids(mode, card_route):
    t = TPQ(dim=24, nlist=4, nprobe=4, m=4, refine_factor=32, device="cpu")
    if mode == "device":
        t.train(torch.from_numpy(POINTS))
        t.add(torch.from_numpy(POINTS), torch.from_numpy(IDS.astype(np.int32)))
    else:
        t.train(POINTS)
        t.add(POINTS, IDS)
    t.search(Q, 3)
    assert t.remove_ids(DROP) == len(DROP) and t.ntotal == len(KEEP)
    _check_oracle(t._search(Q, 6, card_route=card_route), POINTS[KEEP], KEEP, Q, 6)
    assert t.remove_ids(DROP) == 0
    np.testing.assert_array_equal(np.sort(t.ids()), KEEP)
    dists, ids_r = t.ranked_all(Q[0])
    assert dists.shape[0] == len(KEEP) and not set(DROP.tolist()) & set(ids_r.tolist())


def test_remove_ids_matches_jax_device_mode():
    """Both packages in device mode remove the same rows in place; the
    port's codes and ids read back equal the JAX package's."""
    j = JPQ(dim=24, nlist=4, nprobe=4, m=4, refine=False)
    j.train(jnp.asarray(POINTS))
    j.add(jnp.asarray(POINTS), jnp.asarray(IDS.astype(np.int32)))
    params, arrays = j.state()
    t = TPQ.from_state(params, arrays, device="cpu")
    j.search(Q, 3)
    t.search(Q, 3)
    assert j.remove_ids(DROP) == t.remove_ids(DROP) == len(DROP)
    a_j, a_t = j.state()[1], t.state()[1]
    for name in ("ids", "codes", "assign"):
        np.testing.assert_array_equal(a_t[name], a_j[name])


def test_reconstruct_refine_exact_and_pure_code_approx():
    exact = TPQ(dim=24, nlist=4, m=4, device="cpu")
    exact.train(POINTS)
    exact.add(POINTS, IDS)
    np.testing.assert_allclose(exact.reconstruct(77), POINTS[77])
    code = TPQ(dim=24, nlist=4, m=4, refine=False, device="cpu")
    code.train(POINTS)
    code.add(POINTS, IDS)
    approx = code.reconstruct(77)
    assert np.linalg.norm(approx - POINTS[77]) < np.linalg.norm(approx - POINTS[78])
    dev = TPQ(dim=24, nlist=4, m=4, refine=False, device="cpu")
    dev.train(torch.from_numpy(POINTS))
    dev.add(torch.from_numpy(POINTS), torch.from_numpy(IDS.astype(np.int32)))
    dev.search(Q, 3)
    np.testing.assert_allclose(dev.reconstruct(77), approx, rtol=1e-5, atol=1e-6)
    dev_r = TPQ(dim=24, nlist=4, m=4, device="cpu")
    dev_r.add(torch.from_numpy(POINTS), torch.from_numpy(IDS.astype(np.int32)))
    dev_r.search(Q, 3)
    np.testing.assert_allclose(dev_r.reconstruct(123), POINTS[123], rtol=1e-6)
    dev_r.remove_ids([123])
    with pytest.raises(KeyError):
        dev_r.reconstruct(123)


@pytest.mark.parametrize("card_route", [False, True])
@pytest.mark.parametrize("tail", [False, True])
def test_id_mask_matches_oracle(card_route, tail):
    rng = np.random.default_rng(0)
    mask = rng.random(400) < 0.1
    t = TPQ(dim=24, nlist=4, nprobe=4, m=4, refine_factor=16, device="cpu")
    t.train(POINTS)
    if tail:
        t.add(POINTS[:300], IDS[:300])
        t.search(Q, 3)
        t.add(POINTS[300:], IDS[300:])
        assert t._tail.count == 100
    else:
        t.add(POINTS, IDS)
    keep = mask[IDS]
    k = 5
    got = t._search(Q, k, id_mask=mask, card_route=card_route)
    _check_oracle(got, POINTS[keep], IDS[keep], Q, k)
    assert np.isin(got[1], IDS[keep]).all()


# -- files, knobs, MemoDB -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["host", "device", "opq", "ksub16", "pure"])
def test_jax_files_load_and_search_the_same(tmp_path, kind):
    x = _corpus(600, 32, seed=30)
    ids = np.arange(0, 1200, 2, dtype=np.int64)
    q = _corpus(5, 32, seed=31)
    kw = {"opq": {"opq": True, "opq_iters": 2}, "ksub16": {"ksub": 16, "m": 8},
          "pure": {"refine": False}}.get(kind, {})
    j = JPQ(dim=32, nlist=8, nprobe=3, **{"m": 4, **kw})
    if kind == "device":
        j.train(jnp.asarray(x))
        j.add(jnp.asarray(x), jnp.asarray(ids.astype(np.int32)))
    else:
        j.train(x)
        j.add(x, ids)
    jio.write_index(j, tmp_path / "j.memo")
    t = tio.read_index(tmp_path / "j.memo", device="cpu")
    assert isinstance(t, TPQ) and t._mode == "host" and t.ntotal == 600
    back = jio.read_index(tmp_path / "j.memo")
    jd, ji = back.search(q, 7)
    td, ti = t._search(q, 7, card_route=False)
    same_up_to_ties(jd, ji, td, ti)
    # ... and the port's file of it loads in the JAX package, byte-equal.
    tio.write_index(t, tmp_path / "t.memo")
    assert (tmp_path / "t.memo").read_bytes() == (tmp_path / "j.memo").read_bytes()
    again = jio.read_index(tmp_path / "t.memo")
    np.testing.assert_array_equal(again.search(q, 7)[1], ji)


def test_port_device_file_loads_in_jax(tmp_path):
    x = _corpus(500, 32, seed=32)
    q = _corpus(4, 32, seed=33)
    t = _pq(nlist=8, nprobe=8, refine_factor=40)
    t.train(torch.from_numpy(x))
    t.add(torch.from_numpy(x), torch.arange(500, dtype=torch.int32))
    t.search(q, 3)
    t.add(torch.from_numpy(x[:10] + 0.5), torch.arange(500, 510, dtype=torch.int32))
    t.remove_ids(np.arange(0, 500, 9))
    tio.write_index(t, tmp_path / "t.memo")
    j = jio.read_index(tmp_path / "t.memo")
    assert j.kind == "ivf_pq" and j.ntotal == t.ntotal
    allpts = np.concatenate([x, x[:10] + 0.5])
    all_ids = np.arange(510)
    keep = ~np.isin(all_ids, np.arange(0, 500, 9))
    _check_oracle(j.search(q, 5), allpts[keep], all_ids[keep], q, 5)
    _check_oracle(t.search(q, 5), allpts[keep], all_ids[keep], q, 5)


def test_make_index_knobs(monkeypatch):
    for name in ("C99VDB_NLIST", "C99VDB_PQ_M", "C99VDB_PQ_KSUB", "C99VDB_OPQ", "C99VDB_PAD_CAP"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("C99VDB_INDEX", "ivf_pq")
    t = tcommands.make_index(corpus_size=1_000_000, device="cpu")
    j = jcommands.make_index(corpus_size=1_000_000)
    for attr in ("nlist", "nprobe", "m", "ksub", "opq", "pad_cap", "refine", "refine_factor"):
        assert getattr(t, attr) == getattr(j, attr), attr
    monkeypatch.setenv("C99VDB_PQ_M", "16")
    monkeypatch.setenv("C99VDB_PQ_KSUB", "16")
    monkeypatch.setenv("C99VDB_OPQ", "1")
    monkeypatch.setenv("C99VDB_PAD_CAP", "256")
    monkeypatch.setenv("C99VDB_NLIST", "32")
    t = tcommands.make_index(device="cpu")
    j = jcommands.make_index()
    assert (t.m, t.ksub, t.opq, t.pad_cap, t.nlist) == (16, 16, True, 256, 32)
    for attr in ("nlist", "m", "ksub", "opq", "pad_cap"):
        assert getattr(t, attr) == getattr(j, attr), attr
    monkeypatch.setenv("C99VDB_OPQ", "false")
    assert not tcommands.make_index(device="cpu").opq


WORDS = ("tea coffee morning meeting project deadline budget review design kernel memory "
         "cache index vector search query filter record note user agent system").split()


def test_memodb_ivf_pq_matches_jax(tmp_path, monkeypatch):
    """MemoDB with C99VDB_INDEX=ivf_pq on the CPU against the JAX package's
    MemoDB, each loading the JAX side's files; after a reindex (device mode
    on the port's side) the port stays a working ivf_pq MemoDB."""
    from c99_vectordb_tpu.api import MemoDB as JMemoDB
    from c99_vectordb_tpu_torch.api import MemoDB as TMemoDB

    monkeypatch.setenv("C99VDB_INDEX", "ivf_pq")
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
        assert len(a) == len(b)
        for ha, hb in zip(a, b):
            assert len(ha) == len(hb)
            same_up_to_ties(np.array([[h.score for h in ha]]), np.array([[h.doc_id for h in ha]]),
                            np.array([[h.score for h in hb]]), np.array([[h.doc_id for h in hb]]))

    jdb.save_many(records)
    sync_files()
    assert tdb._index().kind == "ivf_pq"
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
    assert tdb._index().kind == "ivf_pq" and tdb._index()._mode == "device"
    hits = tdb.recall_many(queries, k=5)
    assert all(len(h) == 5 for h in hits)
    sync_files()
    same(jdb.recall_many(queries, k=5), tdb.recall_many(queries, k=5))


def test_exhaustive_search_matches_oracle():
    """nprobe == nlist with a shortlist that holds every row: both routes
    are exact through the rerank."""
    x = _corpus(300, 16, seed=40)
    ids = np.arange(300)
    t = _pq(dim=16, nlist=4, nprobe=4, refine_factor=100)
    t.train(x)
    t.add(x, ids)
    q = x[:5] + 0.02
    for card_route in (False, True):
        _check_oracle(t._search(q, 5, card_route=card_route), x, ids, q, 5)


# -- the high-water marks the select kernel stops at ---------------------------------------


def test_hwm_follows_remove_and_restage(monkeypatch):
    """Device mode: the hwm the index hands to the ADC select route is
    list_hwm of its staged ids after the staging, after an in-place
    remove_ids (holes: the mark is not the live count) and after the
    restage that folds a tail in; the select route with and without it
    equals the JAX package's select program on the same staged canvas."""
    from c99_vectordb_tpu.ops.adc_pallas import CODE_LANES
    from c99_vectordb_tpu_torch.models import ivf_pq as tpq_mod
    from c99_vectordb_tpu_torch.models.devbuild import list_hwm
    from c99_vectordb_tpu_torch.ops.adc import adc_full_search

    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("hwm"))
        return adc_full_search(*args, **kw)

    monkeypatch.setattr(tpq_mod, "adc_full_search", spy)
    x = _corpus(1200, 32, seed=12)
    ids = np.arange(0, 2400, 2, dtype=np.int32)
    q = (x[::101] + 0.05).astype(np.float32)
    t = TPQ(dim=32, nlist=8, nprobe=3, m=8, refine=False, device="cpu")
    t.train(torch.from_numpy(x[:800]))
    t.add(torch.from_numpy(x[:800]), torch.from_numpy(ids[:800]))

    def check(stage, holes):
        seen.clear()
        t._search(q, 10, card_route=True)
        cents, c_sq, books, _, li, canvas, const, pad = t._staged
        want_hwm = list_hwm(li).to(torch.int32)
        assert len(seen) == 1 and torch.equal(seen[0], want_hwm), stage
        assert (want_hwm > (li >= 0).sum(1)).any() == holes, stage
        c128 = np.zeros((8, CODE_LANES, pad), np.uint8)
        c128[:, :8] = canvas.numpy()
        jd, ji = adc_full_search_program(8, pad, 32, 8, 256, q.shape[0], 3, 10)(
            *(jnp.asarray(a.numpy()) for a in (cents, c_sq, books)), jnp.asarray(c128),
            jnp.asarray(const.numpy()), jnp.asarray(li.numpy()), jnp.asarray(q))
        for hwm in (want_hwm, None):
            td, ti = adc_full_search(cents, c_sq, books, canvas, const, li,
                                     torch.from_numpy(q), 3, 10, hwm=hwm)
            same_up_to_ties(jd, ji, td.numpy(), ti.numpy(), atol=_adc_atol(t, q))

    check("staged", holes=False)
    assert t.remove_ids(ids[:800:3]) == len(ids[:800:3])
    check("after remove_ids", holes=True)
    t.add(torch.from_numpy(x[800:]), torch.from_numpy(ids[800:]))
    t._restage_needed = True
    t.search(q[:1], 1)                                     # the restage
    assert t._tail is None and t.ntotal == 1200 - len(ids[:800:3])
    check("after the restage", holes=False)


def test_dense_hwm_follows_remove_and_restage(monkeypatch):
    """Device mode, the dense route (refine on, a shortlist deeper than
    2 * LANE_K): the hwm the index hands to adc_dense_search is list_hwm of
    its staged ids after the staging, after an in-place remove_ids (holes:
    the mark is not the live count), with a tail parked beside the staged
    lists, and after the restage that folds the tail in. On each staging's
    operands, unmasked and with half the ids masked (+inf constants, real
    ids below the marks), the dense plain version with the marks equals it
    without them and the JAX package's dense programs in interpret mode
    (one and eight queries per grid step) bit for bit."""
    from c99_vectordb_tpu.ops.adc_pallas import (CODE_LANES, adc_dense_program,
                                                 adc_dense_program_multi)
    from c99_vectordb_tpu_torch.models import ivf_pq as tpq_mod
    from c99_vectordb_tpu_torch.models.devbuild import keep_table, list_hwm, mask_norms
    from c99_vectordb_tpu_torch.ops import adc as tadc

    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("hwm"))
        return tadc.adc_dense_search(*args, **kw)

    monkeypatch.setattr(tpq_mod, "adc_dense_search", spy)
    x = _corpus(1200, 32, seed=13)
    ids = np.arange(0, 2400, 2, dtype=np.int32)
    q = (x[::150] + 0.05).astype(np.float32)                # 8 queries
    mask = np.random.default_rng(13).random(2400) < 0.5
    t = TPQ(dim=32, nlist=8, nprobe=3, m=8, refine_factor=30, device="cpu")
    t.train(torch.from_numpy(x[:800]))
    t.add(torch.from_numpy(x[:800]), torch.from_numpy(ids[:800]))

    def check(stage, holes):
        seen.clear()
        t._search(q, 10, card_route=True)
        cents, c_sq, books, _, li, canvas, const, pad = t._staged
        want_hwm = list_hwm(li).to(torch.int32)
        assert len(seen) == 1 and torch.equal(seen[0], want_hwm), stage
        assert (want_hwm > (li >= 0).sum(1)).any() == holes, stage
        probes, pc, qd = tadc.adc_prologue(t._rotate_device(torch.from_numpy(q)), cents, c_sq,
                                           books, 3)
        c128 = np.zeros((8, CODE_LANES, pad), np.uint8)
        c128[:, :8] = canvas.numpy()
        qd128 = np.zeros((q.shape[0], CODE_LANES, 256), np.float32)
        qd128[:, :8] = qd.numpy()
        progs = (adc_dense_program(8, pad, 8, 256, q.shape[0], 3),
                 adc_dense_program_multi(8, pad, 8, 256, q.shape[0], 3, 8))
        for ic in (const, mask_norms(const, li, keep_table(mask, li.device))):
            got = tadc.adc_dense_plain(probes, pc, qd, canvas, ic, li, packed=False,
                                       hwm=want_hwm)
            bare = tadc.adc_dense_plain(probes, pc, qd, canvas, ic, li, packed=False)
            assert torch.equal(got[0], bare[0]) and torch.equal(got[1], bare[1]), stage
            args = tuple(jnp.asarray(a) for a in (probes.numpy(), pc.numpy(), qd128, c128,
                                                  ic.numpy(), li.numpy()))
            for prog in progs:
                jd, ji = prog(*args)
                np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))
                np.testing.assert_array_equal(got[1].numpy(), np.asarray(ji))
        assert bool((torch.isinf(got[0]) & (got[1] >= 0)).any()), stage   # masked, real ids

    check("staged", holes=False)
    assert t.remove_ids(ids[:800:3]) == len(ids[:800:3])
    check("after remove_ids", holes=True)
    t.add(torch.from_numpy(x[800:]), torch.from_numpy(ids[800:]))
    assert t._tail is not None and t._tail.count == 400
    check("with a tail", holes=True)
    t._restage_needed = True
    t.search(q[:1], 1)                                     # the restage
    assert t._tail is None and t.ntotal == 1200 - len(ids[:800:3])
    check("after the restage", holes=False)
