"""PyTorch port, the IVF build machinery of models/devbuild.py against the
JAX package's models/devbuild.py on the CPU (analogs of test_devbuild.py),
on the same numpy inputs.

Tolerances: integer outputs (orders, slots, counts, assignments, ids,
codes, tables) are equal; f32 outputs (tail distances, decoded norms) agree
within 1e-5 relative, the same values summed in another order; the SQ8
scale within one ulp (XLA may turn the division by 127 into a multiply by
its reciprocal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu.models import devbuild as jdb
from c99_vectordb_tpu.models.ivf_flat import _sq8_stage as jax_sq8_stage
from c99_vectordb_tpu.ops.kmeans import train_kmeans as jax_train_kmeans
from c99_vectordb_tpu_torch.models import devbuild as tdb
from c99_vectordb_tpu_torch.models.base import list_pad
from c99_vectordb_tpu_torch.models.ivf_flat import _sq8_stage

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def test_chunkstore_consolidation():
    cs = tdb.ChunkStore()
    cs.append(torch.ones((3, 4)))
    cs.append(torch.zeros((0, 4)))
    cs.append(torch.zeros((2, 4)))
    assert len(cs) == 5
    out = cs.consolidated()
    assert out.shape == (5, 4) and out[:3].eq(1).all() and out[3:].eq(0).all()
    assert cs.consolidated(torch.bfloat16).dtype == torch.bfloat16
    cs.clear()
    with pytest.raises(ValueError):
        cs.consolidated()


def test_growtail_append_grows_in_place():
    tail = tdb.GrowTail({"vecs": (4, "float32"), "ids": (None, "int32")}, "cpu")
    for i in range(3):
        tail.append(vecs=torch.full((600, 4), float(i)),
                    ids=torch.arange(600, dtype=torch.int32) + i * 600)
    assert tail.count == 1800 and tail.cap == 2048 and bool(tail)
    ids = tail["ids"].numpy()
    np.testing.assert_array_equal(ids[:1800], np.arange(1800))
    assert (ids[1800:] == -1).all()                      # empty capacity is inert
    assert (tail["vecs"][1200:1800] == 2.0).all()
    buf = tail["vecs"]
    tail.append(vecs=torch.ones((10, 4)), ids=torch.zeros(10, dtype=torch.int32))
    assert tail["vecs"] is buf                           # no growth: written in place
    sized = tdb.GrowTail({"ids": (None, "int32")}, "cpu", initial_cap=5000)
    sized.append(ids=torch.zeros(3, dtype=torch.int32))
    assert sized.cap == 8192


def test_bucketize_matches_jax():
    assign = np.random.default_rng(3).integers(0, 7, size=100).astype(np.int32)
    order, lists, slots, counts = tdb.bucketize_device(_t(assign), 7)
    jo, jl, js, jc = jdb.bucketize_device(jnp.asarray(assign), 7)
    np.testing.assert_array_equal(counts, jc)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jo)[:100])
    np.testing.assert_array_equal(lists.numpy(), np.asarray(jl)[:100])
    np.testing.assert_array_equal(slots.numpy(), np.asarray(js)[:100])
    vals = np.random.default_rng(4).standard_normal((100, 5)).astype(np.float32)
    pad = list_pad(int(counts.max()))
    got = tdb.scatter_lists_device(_t(vals), order, lists, slots, 7, pad)
    want = jdb.scatter_lists_device(jnp.asarray(vals), jo, jl, js, 7, pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ids = np.arange(100, dtype=np.int32) * 3
    np.testing.assert_array_equal(
        tdb.scatter_list_ids_device(_t(ids), order, lists, slots, 7, pad).numpy(),
        np.asarray(jdb.scatter_list_ids_device(jnp.asarray(ids), jo, jl, js, 7, pad)))


def test_build_id_lookup_device():
    iota = torch.arange(32, dtype=torch.int32)
    assert tdb.build_id_lookup_device(iota)[0] == "identity"
    kind, table = tdb.build_id_lookup_device(iota * 3)
    assert kind == "dense"
    np.testing.assert_array_equal(table.numpy()[np.arange(32) * 3], np.arange(32))
    assert tdb.build_id_lookup_device(iota, rows=iota.flip(0))[0] == "dense"
    sparse = torch.tensor([10 ** 6, 5, 3 * 10 ** 6], dtype=torch.int32)
    kind, ids_search, row_of_pos = tdb.build_id_lookup_device(sparse)
    assert kind == "sparse"
    pos = np.searchsorted(ids_search.numpy(), sparse.numpy())
    np.testing.assert_array_equal(row_of_pos.numpy()[pos], [0, 1, 2])


def _tail_fixture(seed=5, cap=2048, count=1500, d=16, nlist=6, b=7):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((cap, d)).astype(np.float32)
    ids = np.where(np.arange(cap) < count, np.arange(cap), -1).astype(np.int32)
    assign = rng.integers(0, nlist, cap).astype(np.int32)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    c_sq = (cents * cents).sum(1)
    q = rng.standard_normal((b, d)).astype(np.float32)
    return vecs, ids, assign, cents, c_sq, q


@pytest.mark.parametrize("nprobe", [1, 3, 6])
def test_tail_scores_and_merge_match_jax(nprobe):
    vecs, ids, assign, cents, c_sq, q = _tail_fixture()
    jt = jdb.GrowTail({"vecs": (16, "float32"), "ids": (None, "int32"),
                       "assign": (None, "int32")})
    jt.append(vecs=jnp.asarray(vecs[:1500]), ids=jnp.asarray(ids[:1500]),
              assign=jnp.asarray(assign[:1500]))
    tt = tdb.GrowTail({"vecs": (16, "float32"), "ids": (None, "int32"),
                       "assign": (None, "int32")}, "cpu")
    tt.append(vecs=_t(vecs[:1500]), ids=_t(ids[:1500]), assign=_t(assign[:1500]))
    want = np.asarray(jdb.tail_scores(jt, jnp.asarray(cents), jnp.asarray(c_sq),
                                      jnp.asarray(q), nprobe))
    got = tdb.tail_scores(tt, _t(cents), _t(c_sq), _t(q), nprobe).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)
    main_d = np.sort(np.random.default_rng(6).random((7, 10)).astype(np.float32) * 40, axis=1)
    main_i = np.arange(70, dtype=np.int32).reshape(7, 10) + 5000
    for k in (5, 10):
        jd, ji = jdb.merge_tail(main_d, main_i, jnp.asarray(want), jt["ids"], k)
        td, ti = tdb.merge_tail(_t(main_d), _t(main_i), _t(want), tt["ids"], k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_corpus_geometry_matches_jax():
    counts = np.full((64,), 100, np.int64)
    counts[0] = 4000
    for c, cap in ((counts, 256), (np.full((64,), 100, np.int64), None),
                   (np.zeros((8,), np.int64), None), (np.array([3, 0, 0]), None)):
        geo = tdb.corpus_geometry(c, pad_cap=cap)
        assert geo == jdb.corpus_geometry(c, pad_cap=cap)
        assert tdb.geometry_advice(geo) == jdb.geometry_advice(geo)
    assert "heavy-tailed" in tdb.geometry_advice(tdb.corpus_geometry(counts, 256))


def _heavy(n_base=400, n_new=100, nlist=8, dim=16):
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((nlist, dim)).astype(np.float32) * 3
    cid = np.minimum(rng.zipf(1.3, n_base + n_new) - 1, nlist - 1)
    rows = (centers[cid] + rng.standard_normal((n_base + n_new, dim))).astype(np.float32)
    cents = jax_train_kmeans(rows[:n_base], nlist, iters=4)
    return rows, cents, int(np.ceil((n_base + n_new) / nlist) * 2)


def test_capped_assign_matches_jax():
    rows, cents, cap = _heavy()
    got, moved = tdb.capped_assign(_t(rows), _t(cents), cap)
    want, jmoved = jdb.capped_assign(jnp.asarray(rows), cents, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert moved == jmoved > 0
    assert np.bincount(got.numpy(), minlength=8).max() <= cap
    with pytest.raises(ValueError, match="cannot place"):
        tdb.capped_assign(_t(rows), _t(cents), 10)


def test_capped_assign_incremental_matches_jax():
    rows, cents, cap = _heavy()
    base, _ = tdb.capped_assign(_t(rows[:400]), _t(cents), cap)
    base_counts = np.bincount(base.numpy(), minlength=8)
    got, moved = tdb.capped_assign_incremental(_t(rows[400:]), _t(cents), base_counts, cap)
    want, jmoved = jdb.capped_assign_incremental(jnp.asarray(rows[400:]), cents,
                                                 base_counts, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert moved == jmoved
    total = base_counts + np.bincount(got.numpy(), minlength=8)
    assert total.max() <= cap and total.sum() == 500
    valid = np.arange(100) < 60                           # padding rows of a buffer
    got, _ = tdb.capped_assign_incremental(_t(rows[400:]), _t(cents), base_counts, cap,
                                           valid=_t(valid), n_valid=60)
    want, _ = jdb.capped_assign_incremental(jnp.asarray(rows[400:]), cents, base_counts, cap,
                                            valid=jnp.asarray(valid), n_valid=60)
    np.testing.assert_array_equal(got.numpy()[:60], np.asarray(want)[:60])
    with pytest.raises(ValueError, match="free slots"):
        tdb.capped_assign_incremental(_t(rows[400:]), _t(cents), np.full((8,), cap), cap)


def test_fold_helpers_match_jax():
    rng = np.random.default_rng(8)
    nlist, pad, cap_t, d = 5, 16, 32, 4
    li = np.where(rng.random((nlist, pad)) < 0.5, np.arange(nlist * pad).reshape(nlist, pad),
                  -1).astype(np.int32)
    li[:, 12:] = -1
    hwm = tdb.list_hwm(_t(li))
    jhwm = jdb._list_hwm_program(nlist, pad)(jnp.asarray(li))
    np.testing.assert_array_equal(hwm.numpy(), np.asarray(jhwm))
    tassign = rng.integers(0, nlist, cap_t).astype(np.int32)
    tids = np.where(np.arange(cap_t) < 20, 1000 + np.arange(cap_t), -1).astype(np.int32)
    got = tdb.fold_rank(_t(tassign), _t(tids), hwm, nlist)
    want = jdb._fold_rank_program(cap_t, nlist)(jnp.asarray(tassign), jnp.asarray(tids), jhwm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    order, lists, slots, new_hwm = got
    new_pad = list_pad(int(new_hwm.max()))
    canvas = np.random.default_rng(9).standard_normal((nlist, pad, d)).astype(np.float32)
    vals = np.random.default_rng(10).standard_normal((cap_t, d)).astype(np.float32)
    tg = tdb.fold_scatter(tdb.grow_pad(_t(canvas), new_pad), _t(vals), order, lists, slots)
    jg = jdb.fold_scatter(jdb.grow_pad(jnp.asarray(canvas), new_pad), jnp.asarray(vals),
                          *want[:3])
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    ti = tdb.fold_scatter(tdb.grow_pad(_t(li), new_pad, fill=-1), _t(tids), order, lists, slots)
    np.testing.assert_array_equal(
        ti.numpy(), np.asarray(jdb.fold_scatter(jdb.grow_pad(jnp.asarray(li), new_pad, fill=-1),
                                                jnp.asarray(tids), *want[:3])))
    kind, table = tdb.canvas_id_lookup(ti, int(ti.max()))
    jkind, jtable = jdb.canvas_id_lookup(jnp.asarray(ti.numpy()), int(ti.max()))
    assert kind == jkind == "dense"
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))


def test_sq8_encode_and_stage_match_jax():
    rng = np.random.default_rng(33)
    lv = (rng.standard_normal((4, 64, 16)) * 5).astype(np.float32)
    li = np.full((4, 64), -1, np.int32)
    li[:, :40] = np.arange(160, dtype=np.int32).reshape(4, 40)
    lv[li < 0] = 1e6                                      # poison padding
    codes, scale, dec = _sq8_stage(_t(lv), _t(li))
    jc, js, jd = map(np.asarray, jax_sq8_stage(jnp.asarray(lv), jnp.asarray(li)))
    np.testing.assert_allclose(scale.numpy(), js, rtol=1.2e-7, atol=0)
    np.testing.assert_array_equal(codes.numpy(), jc)
    np.testing.assert_allclose(dec.numpy(), jd, rtol=TOL)
    live = li >= 0
    np.testing.assert_allclose(scale.numpy(), np.abs(lv[live]).max(axis=0) / 127.0, rtol=1e-6)
    rows = rng.standard_normal((50, 16)).astype(np.float32) * 9
    tc, td = tdb.sq8_encode_rows(_t(rows), scale)
    jc2, jd2 = jdb.sq8_encode_rows(jnp.asarray(rows), jnp.asarray(scale.numpy()))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc2))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd2), rtol=TOL)
    np.testing.assert_allclose(tdb.rows_sqn(_t(rows)).numpy(),
                               np.asarray(jdb.rows_sqn(jnp.asarray(rows))), rtol=TOL)


def test_removal_matches_jax_and_never_aliases():
    ids = np.arange(-3, 600, dtype=np.int32).reshape(-1, 1)[:600].reshape(20, 30)
    norms = np.random.default_rng(1).random((20, 30)).astype(np.float32)
    removed = np.array([0, 255, 7, -1, 9999], np.int64)
    table = tdb.removal_table(removed, "cpu")
    jtable = jdb.removal_table(removed)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    got = tdb.apply_removal(_t(ids), table, _t(norms))
    want = jdb.apply_removal(jnp.asarray(ids), jtable, jnp.asarray(norms))
    assert got[1] == want[1] == 3                         # 0, 7 and 255; 9999 absent
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert (got[0].numpy() >= 256).sum() == (ids >= 256).sum()   # ids past the table survive
