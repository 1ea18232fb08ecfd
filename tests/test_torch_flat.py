"""PyTorch port, FlatIndex and the TPUVDB01 container against the JAX package
on the CPU.

Fixtures are integer-valued, so every distance is exact in f32 in both
packages and ids (ties included) must agree exactly. The card's route
(shortlist -> fused top-k -> mask_shortlist_ids -> exact_rerank_rows) is
driven on CPU tensors, where the kernel wrapper takes its plain version,
against the JAX fused_topk (Pallas interpret mode) + exact_rerank_rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu.models.devbuild import mask_shortlist_ids as jax_mask_shortlist_ids
from c99_vectordb_tpu.models.flat import FlatIndex as JFlat
from c99_vectordb_tpu.ops.rerank import exact_rerank_rows as jax_exact_rerank_rows
from c99_vectordb_tpu.ops.rerank import shortlist_depth
from c99_vectordb_tpu.ops.topk_pallas import fused_topk as jax_fused_topk
from c99_vectordb_tpu.storage import index_io as jio
from c99_vectordb_tpu_torch import commands as tcommands
from c99_vectordb_tpu_torch.models import flat as tflat
from c99_vectordb_tpu_torch.models.flat import FlatIndex as TFlat
from c99_vectordb_tpu_torch.storage import index_io as tio

DIM = 16


def _corpus(n, seed, d=DIM):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    ids = np.sort(rng.permutation(3 * n)[:n]).astype(np.int64)
    q = rng.integers(-3, 4, (6, d)).astype(np.float32)
    mask = rng.random(3 * n + 5) < 0.3
    return x, ids, q, mask


def _pair(x, ids, scan_dtype="float32"):
    j, t = JFlat(dim=x.shape[1], scan_dtype=scan_dtype), TFlat(
        dim=x.shape[1], scan_dtype=scan_dtype, device="cpu")
    # Unsorted ingest in two batches exercises the sorted-by-id invariant.
    order = np.random.default_rng(0).permutation(len(ids))
    half = len(ids) // 2
    for part in (order[:half], order[half:]):
        j.add(x[part], ids[part])
        t.add(torch.from_numpy(x[part]), ids[part])
    return j, t


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 10, 700])
def test_search_matches_jax(scan_dtype, masked, k):
    x, ids, q, mask = _corpus(300, 1)
    j, t = _pair(x, ids, scan_dtype)
    kw = {"id_mask": mask} if masked else {}
    jd, ji = j.search(q, k, **kw)
    td, ti = t.search(q, k, **kw)
    assert td.dtype == np.float32 and ti.dtype == np.int64 and ti.shape == (6, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)
    if masked:
        hit = ti[ti >= 0]
        assert mask[hit].all()


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("masked", [False, True, "tensor", "sparse"])
def test_card_route_wiring_on_cpu_tensors(scan_dtype, masked):
    """The CUDA search route, run on CPU tensors, against the same route
    assembled from JAX pieces (flat.py's on-TPU branch). masked="tensor"
    passes the port the mask as a torch tensor, JAX the numpy array;
    masked="sparse" keeps 10 of the 1,024 padded rows, so the port scans
    their compacted staging where JAX scans the masked store."""
    x, ids, q, mask = _corpus(1000, 2)
    if masked == "sparse":
        mask = np.zeros_like(mask)
        mask[ids[::100]] = True
    j, t = _pair(x, ids, scan_dtype)
    k = 10
    id_mask = None if not masked else torch.from_numpy(mask) if masked == "tensor" else mask
    compacted = tflat.COUNTERS["compact_searches"]
    td, ti = t._search(q, k, id_mask, rerank_route=True)
    assert tflat.COUNTERS["compact_searches"] - compacted == int(masked == "sparse")

    (vecs, jids, valid, sq_norms, _, scan_vecs, scan_norms, scan_scale) = j._staged()
    norms = sq_norms if scan_norms is None else scan_norms
    if masked:
        from c99_vectordb_tpu.models.devbuild import mask_norms

        norms = mask_norms(norms, jids, mask)
    q_scan = jnp.asarray(q) if scan_scale is None else jnp.asarray(q) * scan_scale
    k_scan = shortlist_depth(k, vecs.shape[0])
    _, sl_ids, rows = jax_fused_topk(scan_vecs, jids, norms, q_scan, k_scan, return_rows=True)
    if masked:
        sl_ids = jax_mask_shortlist_ids(sl_ids, mask)
    jd, ji = jax_exact_rerank_rows(vecs, rows, sl_ids, q, k)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_array_equal(td, np.asarray(jd))
    # The rerank route and the single exact pass agree on exact data.
    pd, pi = t._search(q, k, id_mask, rerank_route=False)
    np.testing.assert_array_equal(ti, pi)
    np.testing.assert_array_equal(td, pd)


def test_surface_matches_jax():
    x, ids, q, _ = _corpus(200, 3)
    j, t = _pair(x, ids)
    assert t.ntotal == j.ntotal == 200 and t.kind == j.kind == "flat"
    np.testing.assert_array_equal(t.ids(), j.ids())
    for doc_id in ids[::37]:
        np.testing.assert_array_equal(t.reconstruct(doc_id), j.reconstruct(doc_id))
    with pytest.raises(KeyError):
        t.reconstruct(int(ids.max()) + 1)
    gone = np.concatenate([ids[::5], [10**6]])
    assert t.remove_ids(gone) == j.remove_ids(gone) == 40
    np.testing.assert_array_equal(t.ids(), j.ids())
    for r in range(q.shape[0]):
        jd, ji = j.ranked_all(q[r])
        td, ti = t.ranked_all(q[r])
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    jd, ji, jn = j.ranked_many_device(q)
    td, ti, tn = t.ranked_many_device(q)
    assert jn == tn == 160
    np.testing.assert_array_equal(ti.numpy()[:, :tn], np.asarray(ji)[:, :jn])
    np.testing.assert_array_equal(td.numpy()[:, :tn], np.asarray(jd)[:, :jn])
    np.testing.assert_array_equal(t.search(q, 5)[1], j.search(q, 5)[1])


def test_empty_and_small():
    t = TFlat(dim=4, device="cpu")
    d, i = t.search(np.zeros((2, 4), np.float32), 3)
    assert np.isinf(d).all() and (i == -1).all()
    assert t.ranked_all(np.zeros(4, np.float32))[0].shape == (0,)
    t.add(np.eye(4, dtype=np.float32)[:3], np.arange(3))
    d, i = t.search(np.zeros((1, 4), np.float32), 5)
    assert i[0].tolist() == [0, 1, 2, -1, -1] and np.isinf(d[0, 3:]).all()
    with pytest.raises(ValueError):
        TFlat(dim=4, scan_dtype="float16", device="cpu")


@pytest.mark.parametrize("mmap", ["1", "0"])
def test_index_files_cross_read(tmp_path, monkeypatch, mmap):
    monkeypatch.setenv("C99VDB_INDEX_MMAP", mmap)
    x, ids, q, mask = _corpus(300, 4)
    j, t = _pair(x, ids, "int8")
    jio.write_index(j, tmp_path / "jax.memo")
    tio.write_index(t, tmp_path / "torch.memo")
    assert (tmp_path / "jax.memo").read_bytes() == (tmp_path / "torch.memo").read_bytes()
    from_jax = tio.read_index(tmp_path / "jax.memo", device="cpu")
    from_torch = jio.read_index(tmp_path / "torch.memo")
    assert isinstance(from_jax, TFlat) and from_jax.scan_dtype == "int8"
    assert from_torch.scan_dtype == "int8"
    for name in ("vectors", "ids"):
        np.testing.assert_array_equal(from_jax.state()[1][name], j.state()[1][name])
        np.testing.assert_array_equal(from_torch.state()[1][name], t.state()[1][name])
    np.testing.assert_array_equal(from_jax.search(q, 7, id_mask=mask)[1],
                                  from_torch.search(q, 7, id_mask=mask)[1])
    # from_state takes the JAX state() output unchanged.
    params, arrays = j.state()
    adopted = TFlat.from_state(params, arrays, device="cpu")
    np.testing.assert_array_equal(adopted.search(q, 7)[1], j.search(q, 7)[1])


def test_unported_kind_raises(tmp_path, monkeypatch):
    from c99_vectordb_tpu.models.ivf_pq import IVFPQIndex

    rng = np.random.default_rng(5)
    pts = rng.standard_normal((300, 8)).astype(np.float32)
    pq = IVFPQIndex(dim=8, nlist=2, nprobe=2, m=2)
    pq.train(pts)
    pq.add(pts, np.arange(300))
    jio.write_index(pq, tmp_path / "pq.memo")
    # ivf_pq is ported: the JAX-written file loads (both ways in) and
    # searches as the JAX package's does.
    loaded = tio.read_index(tmp_path / "pq.memo", device="cpu")
    assert loaded.kind == "ivf_pq" and loaded.ntotal == 300
    again = tio.load_index_or_fresh(tmp_path / "pq.memo", dim=8, device="cpu")
    np.testing.assert_array_equal(again.ids(), np.arange(300))
    np.testing.assert_array_equal(loaded.search(pts[:4], 3)[1], pq.search(pts[:4], 3)[1])
    monkeypatch.setenv("C99VDB_INDEX", "ivf_pq")
    assert tcommands.make_index(device="cpu").kind == "ivf_pq"
    # Every kind of the JAX package is ported, the sharded ones at one rank
    # without a process group; an unknown kind is a ValueError.
    from c99_vectordb_tpu_torch.models.registry import resolve

    for kind in ("sharded_flat", "sharded_ivf", "sharded_ivf_pq"):
        monkeypatch.setenv("C99VDB_INDEX", kind)
        index = tcommands.make_index(device="cpu")
        assert index.kind == kind and index.mesh.shape == {"data": 1}
        assert type(index) is resolve(kind)
    from c99_vectordb_tpu.models.registry import resolve as jresolve

    for kind in ("flat", "ivf_flat", "ivf_pq", "sharded_flat", "sharded_ivf", "sharded_ivf_pq"):
        assert resolve(kind).kind == jresolve(kind).kind == kind
    with pytest.raises(ValueError, match="unknown index kind 'bogus'"):
        resolve("bogus")
    monkeypatch.setenv("C99VDB_INDEX", "bogus")
    with pytest.raises(ValueError):
        tcommands.make_index(device="cpu")
    monkeypatch.setenv("C99VDB_INDEX", "flat")
    monkeypatch.setenv("C99VDB_SCAN_DTYPE", "bfloat16")
    made = tcommands.make_index(device="cpu")
    assert isinstance(made, TFlat) and made.scan_dtype == "bfloat16"


def test_unreadable_files_recover_fresh(tmp_path, capsys):
    (tmp_path / "junk.memo").write_bytes(b"not an index at all")
    (tmp_path / "faiss.memo").write_bytes(b"IxM2" + b"\0" * 64)
    fresh = tio.load_index_or_fresh(tmp_path / "junk.memo", dim=8, device="cpu")
    assert isinstance(fresh, TFlat) and fresh.ntotal == 0
    assert tio.load_index_or_fresh(tmp_path / "faiss.memo", dim=8, device="cpu").ntotal == 0
    assert "FAISS-format" in capsys.readouterr().err
    assert tio.load_index_or_fresh(tmp_path / "missing.memo", dim=8, device="cpu").ntotal == 0
