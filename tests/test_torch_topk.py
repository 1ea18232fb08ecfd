"""PyTorch port, selection and ranking ops against the JAX package on the CPU:
the fused L2 top-k contract (ops/topk_cuda.py; the JAX side runs its Pallas
kernel in interpret mode, as tests/test_topk_pallas.py does), topk_program,
merge_topk, the three rerank routes and the full-ranking programs.

Most fixtures are integer-valued, so every distance is exact in f32 on both
sides and ids must agree exactly, ties included. Where arithmetic differs
(random data, the int8 key's product-then-add), distances agree within the
stated tolerance and ids agree up to swaps inside groups of near-equal
distances (same_up_to_ties).

The kernel's own tests on the card are in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu.ops import distances as jdist
from c99_vectordb_tpu.ops import rerank as jrerank
from c99_vectordb_tpu.ops import topk as jtopk
from c99_vectordb_tpu.ops.topk_pallas import fused_topk as jax_fused_topk
from c99_vectordb_tpu_torch.ops import distances as tdist
from c99_vectordb_tpu_torch.ops import rerank as trerank
from c99_vectordb_tpu_torch.ops import topk as ttopk
from c99_vectordb_tpu_torch.ops import topk_cuda


def same_up_to_ties(want_d, want_i, got_d, got_i, tol):
    """Distances agree slot by slot within tol; ids agree up to permutations
    inside groups of distances within tol (the last group may be cut by k)."""
    np.testing.assert_allclose(got_d, want_d, rtol=tol, atol=tol)
    for r in range(want_d.shape[0]):
        k = want_d.shape[1]
        s = 0
        while s < k:
            e = s + 1
            while e < k and (want_d[r, e] == want_d[r, s] or abs(
                    want_d[r, e] - want_d[r, s]) <= tol * max(1.0, abs(want_d[r, s]))):
                e += 1
            if e < k:
                assert sorted(got_i[r, s:e]) == sorted(want_i[r, s:e]), (r, s, e)
            s = e


def _np_dtype(name):
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[name]


def _torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[name]


def _fixture(case, dtype, rng):
    """(db f32 values, ids, norms, queries, k, tile_n) for one case."""
    n, d, b, k, tile = 1024, 16, 4, 7, 256
    if case == "random":
        db = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((5, d)).astype(np.float32)
        k, tile = 10, 1024
    elif case == "ties":
        db = rng.integers(-2, 3, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, (b, d)).astype(np.float32)
    elif case == "duplicates":
        base = rng.integers(-3, 4, (d,)).astype(np.float32)
        db = np.tile(base, (n, 1))
        q = np.stack([base, base + 1])
        k = 4
    else:
        db = rng.integers(-2, 3, (n, d)).astype(np.float32) + 3.0
        q = np.zeros((3, d), np.float32) if case == "batch_padding" else rng.integers(
            -1, 2, (b, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    norms = np.einsum("nd,nd->n", db, db).astype(np.float32)
    if dtype == "int8":
        db = np.clip(db, -127, 127)
    if case == "padding":           # 5 live rows of one padded tile
        ids[5:] = -1
        norms[5:] = np.inf
        k = 8
    elif case == "masked":          # +inf norms on a third, nearest included
        d2 = ((q[:, None, :] - db[None]) ** 2).sum(-1)
        norms[np.argsort(d2, axis=1, kind="stable")[:, :2].ravel()] = np.inf
        norms[rng.permutation(n)[: n // 3]] = np.inf
    elif case == "k_gt_live":       # three live rows, k above them
        live = rng.permutation(n)[:3]
        keep = np.zeros(n, bool)
        keep[live] = True
        norms[~keep] = np.inf
        k = 6
    return db, ids, norms, q, k, tile


CASES = ["random", "ties", "duplicates", "padding", "masked", "k_gt_live", "batch_padding"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_fused_topk_contract_matches_jax_kernel(case, dtype):
    db, ids, norms, q, k, tile = _fixture(case, dtype, np.random.default_rng(7))
    jd, ji, jr = jax_fused_topk(
        jnp.asarray(db, dtype=_np_dtype(dtype)), jnp.asarray(ids), jnp.asarray(norms),
        jnp.asarray(q), k, tile_n=tile, return_rows=True,
    )
    jd, ji, jr = np.asarray(jd), np.asarray(ji), np.asarray(jr)
    tdb = torch.from_numpy(db).to(_torch_dtype(dtype))
    args = (tdb, torch.from_numpy(ids), torch.from_numpy(norms), torch.from_numpy(q), k)
    td, ti, tr = (x.numpy() for x in topk_cuda.fused_topk_reference(*args, return_rows=True))
    assert td.shape == ti.shape == tr.shape == (q.shape[0], k)
    assert ti.dtype == np.int32 and tr.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    np.testing.assert_array_equal(ti[np.isinf(td)], -1)
    if case == "random" or dtype == "int8":
        # int8: XLA may fuse the key's product and sum; random: summation order.
        same_up_to_ties(jd, ji, td, ti, 1e-5)
    else:
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tr, jr)
    if case == "duplicates":
        assert ti[0].tolist() == [0, 1, 2, 3]
    # On CPU tensors the kernel wrapper takes the plain version, launches nothing.
    before = topk_cuda.fused_l2_topk.launches
    wd, wi, wr = topk_cuda.fused_topk(*args, return_rows=True)
    assert topk_cuda.fused_l2_topk.launches == before
    np.testing.assert_array_equal(wd.numpy(), td)
    np.testing.assert_array_equal(wi.numpy(), ti)
    np.testing.assert_array_equal(wr.numpy(), tr)


PLAN_BS = [1, 63, 64, 65, 127, 128, 129, 200, 1024]
PLAN_SHAPES = [(37, 20), (8192 + 37, 129), (131_072, 20), (1 << 20, 200)]


# (blocks per SM, queries a block, store rows a tile, most splits), as
# fused_l2_topk_shape reports them: the f32 kernel's (one block per SM), the
# bf16 / int8 kernel's (two per SM), and the latter with a lower cap on the
# splits, which the plan must take from the shape.
KERNEL_SHAPES = {"f32_64x128": (1, 64, 128, 128), "mma_64x64": (2, 64, 64, 128),
                 "mma_64x64_cap32": (2, 64, 64, 32)}


@pytest.mark.parametrize("shape", list(KERNEL_SHAPES))
@pytest.mark.parametrize("b", PLAN_BS)
def test_launch_plan_fills_one_wave(shape, b):
    """fused_l2_topk's launch plan (the grid the wrapper asks the kernel
    for, and the partial lists it allocates): the splits are the most that
    keep (query tiles x splits) within one wave of resident blocks, at least
    one, and at most one per row tile and the kernel's cap (pass 2 merges 4
    a lane)."""
    sms = 132
    per_sm, q_tile, row_tile, cap = KERNEL_SHAPES[shape]
    for n, k in PLAN_SHAPES:
        plan = topk_cuda.launch_plan(b, n, k, sms, per_sm, q_tile, row_tile, cap)
        q_tiles, s = plan["q_tiles"], plan["splits"]
        assert q_tiles == -(-b // q_tile)
        assert s == max(1, min(per_sm * sms // q_tiles, -(-n // row_tile), cap))
        assert 1 <= s <= min(cap, -(-n // row_tile))
        assert q_tiles * s <= max(per_sm * sms, q_tiles)
        assert plan["part"] == (s, b, k)
    if b == 128:   # MemoDB's shape (131,072 rows, k 20)
        plan = topk_cuda.launch_plan(b, 131_072, 20, sms, per_sm, q_tile, row_tile, cap)
        want = {"f32_64x128": (2, 66), "mma_64x64": (2, 128), "mma_64x64_cap32": (2, 32)}[shape]
        assert (plan["q_tiles"], plan["splits"]) == want
    if b == 1024:   # 1M rows at B = 1024
        plan = topk_cuda.launch_plan(b, 1 << 20, 20, sms, per_sm, q_tile, row_tile, cap)
        want = {"f32_64x128": (16, 8), "mma_64x64": (16, 16), "mma_64x64_cap32": (16, 16)}[shape]
        assert (plan["q_tiles"], plan["splits"]) == want


# The f32 mode's plan at 1M rows, k 20, on 132 SMs (one block per SM, at
# most 128 queries a block, 128-row tiles, 128 splits): (query tiles, query
# tile, splits).
F32_PLANS = {1: (1, 8, 128), 7: (1, 8, 128), 8: (1, 8, 128), 9: (1, 16, 128),
             64: (1, 64, 128), 128: (1, 128, 128), 129: (2, 72, 66), 1024: (8, 128, 16)}


@pytest.mark.parametrize("b", list(F32_PLANS))
def test_launch_plan_picks_the_f32_query_tile(b):
    """The f32 mode's query tile (wgmma's N) follows B: the smallest multiple
    of 8 that holds the batch's share of ceil(B / 128) tiles, so B = 1 runs
    8 queries and B <= 128 one tile (one read of the store), with the splits
    and the partial lists sized as for any mode, and the staged queries
    sized for whole tiles and 32-column stages. Each launch is counted once,
    under its query tile; the plain version (CPU tensors) launches nothing."""
    n, k = 1 << 20, 20
    plan = topk_cuda.launch_plan(b, n, k, 132, 1, 128, 128, 128, q_step=topk_cuda.F32_Q_STEP)
    q_tiles, q_tile, splits = F32_PLANS[b]
    assert (plan["q_tiles"], plan["q_tile"], plan["splits"]) == (q_tiles, q_tile, splits)
    assert plan["part"] == (splits, b, k)
    assert q_tile % 8 == 0 and q_tiles * q_tile >= b > q_tiles * (q_tile - 8)
    assert topk_cuda.f32_stage_floats(b, 768, q_tile) == q_tiles * 48 * 2 * q_tile * 16
    assert topk_cuda.f32_stage_floats(b, 100, q_tile) == q_tiles * 8 * 2 * q_tile * 16   # 4 stages
    fn = topk_cuda.fused_l2_topk
    saved = (fn.launches, dict(fn.launches_by_mode), dict(fn.launches_by_qtile))
    try:
        topk_cuda._count_launch("float32", q_tile)
        assert fn.launches == saved[0] + 1
        assert fn.launches_by_mode == dict(saved[1], float32=saved[1]["float32"] + 1)
        assert {t: fn.launches_by_qtile[t] - saved[2][t] for t in saved[2]} == {
            t: int(t == q_tile) for t in saved[2]}
        topk_cuda._count_launch("bfloat16", 64)
        assert fn.launches_by_qtile[q_tile] == saved[2][q_tile] + 1
        rng = np.random.default_rng(b)
        db = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
        q_st = torch.from_numpy(rng.standard_normal((b, 16)).astype(np.float32))
        before = (fn.launches, dict(fn.launches_by_mode), dict(fn.launches_by_qtile))
        got = fn(q_st, db, (db * db).sum(1), 5)
        assert (fn.launches, fn.launches_by_mode, fn.launches_by_qtile) == before
        want = topk_cuda.select_plain(q_st, db, (db * db).sum(1), 5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    finally:
        fn.launches, fn.launches_by_mode, fn.launches_by_qtile = saved


@pytest.mark.parametrize("name, const", [("FW_DK", "F32_BOX_COLS"), ("FW_BOXES", None),
                                         ("FW_QMAX", None)])
def test_f32_staging_constants_match_the_source(name, const):
    """The f32 mode's staging layout has one source of truth per side: the
    kernel's FW_DK (columns a box) and FW_BOXES (boxes a ring stage) and the
    wrapper's F32_BOX_COLS and F32_STAGE_COLS, which size the scratch and lay
    out stage_f32_plain, must agree; the query tiles the wrapper counts run
    to the kernel's FW_QMAX."""
    import re
    from pathlib import Path

    src = (Path(topk_cuda.__file__).resolve().parent.parent / "csrc" / "fused_l2_topk.cu").read_text()
    got = re.search(rf"^constexpr int {name} = (\d+);", src, re.M)
    assert got, f"{name} not found in the source"
    val = int(got.group(1))
    if name == "FW_DK":
        assert val == topk_cuda.F32_BOX_COLS
    elif name == "FW_BOXES":
        assert val * topk_cuda.F32_BOX_COLS == topk_cuda.F32_STAGE_COLS
    else:
        assert max(topk_cuda.fused_l2_topk.launches_by_qtile) == val
        assert min(topk_cuda.fused_l2_topk.launches_by_qtile) == topk_cuda.F32_Q_STEP


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stable_topk_matches_lexsort_oracle(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 4, (6, 300)).astype(np.float32)
    keys[:, rng.permutation(300)[:40]] = np.inf
    for k in (1, 5, 64, 300):
        vals, pos = ttopk.stable_topk(torch.from_numpy(keys), k)
        order = np.stack([np.lexsort((np.arange(300), row))[:k] for row in keys])
        np.testing.assert_array_equal(pos.numpy(), order)
        np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(keys, order, 1))


def _padded_store(rng, n_live=300, cap=512, d=8):
    db = np.zeros((cap, d), np.float32)
    db[:n_live] = rng.integers(-2, 3, (n_live, d))
    ids = np.full(cap, -1, np.int32)
    ids[:n_live] = np.arange(n_live) * 2 + 1   # sparse-ish, ascending
    valid = np.zeros(cap, bool)
    valid[:n_live] = True
    norms = np.einsum("nd,nd->n", db, db).astype(np.float32)
    norms[n_live:] = np.inf
    q = rng.integers(-2, 3, (5, d)).astype(np.float32)
    return db, ids, valid, norms, q


@pytest.mark.parametrize("k", [1, 10, 300, 512])
def test_topk_program_matches_jax_on_exact_ties(k):
    db, ids, valid, norms, q = _padded_store(np.random.default_rng(3))
    jd, ji = jtopk.topk_program(db.shape[0], db.shape[1], k)(db, ids, valid, norms, q)
    td, ti, _ = ttopk.topk_program(*(torch.from_numpy(a) for a in (db, ids, valid, norms, q)), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("k", [3, 12, 40])
def test_merge_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    d = rng.integers(0, 5, (4, 20)).astype(np.float32)
    i = rng.permutation(200)[:80].reshape(4, 20).astype(np.int32)
    d[rng.random((4, 20)) < 0.2] = np.inf
    i[np.isinf(d) & (rng.random((4, 20)) < 0.5)] = -1
    jd, ji = jtopk.merge_topk(jnp.asarray(d), jnp.asarray(i), k)
    td, ti = ttopk.merge_topk(torch.from_numpy(d), torch.from_numpy(i), k)
    assert td.shape == (4, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("route", ["identity", "dense", "sparse"])
def test_rerank_routes_match_jax(route):
    rng = np.random.default_rng(11)
    n, d = 200, 8
    vecs = rng.integers(-3, 4, (n, d)).astype(np.float32)
    if route == "identity":
        ids = np.arange(n, dtype=np.int64)
    elif route == "dense":
        ids = np.sort(rng.permutation(3 * n)[:n]).astype(np.int64)
    else:
        ids = np.sort(rng.permutation(10**6)[:n]).astype(np.int64) + 70_000
    q = rng.integers(-3, 4, (6, d)).astype(np.float32)
    cand = ids[rng.integers(0, n, (6, 12))].astype(np.int32)
    cand[:, -2:] = -1
    jl = jrerank.build_id_lookup(ids)
    tl = trerank.build_id_lookup(ids, torch.device("cpu"))
    assert jl[0] == tl[0] == route
    jd, ji = jrerank.exact_rerank_staged(jnp.asarray(vecs), jl, jnp.asarray(cand), q, 5)
    td, ti = trerank.exact_rerank_staged(torch.from_numpy(vecs), tl, torch.from_numpy(cand),
                                         torch.from_numpy(q), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    rows = np.searchsorted(ids, np.maximum(cand, 0)).astype(np.int32)
    jd, ji = jrerank.exact_rerank_rows(jnp.asarray(vecs), jnp.asarray(rows), jnp.asarray(cand),
                                       q, 5)
    td, ti = trerank.exact_rerank_rows(torch.from_numpy(vecs), torch.from_numpy(rows),
                                       torch.from_numpy(cand), torch.from_numpy(q), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert trerank.shortlist_depth(10, 1 << 20) == jrerank.shortlist_depth(10, 1 << 20) == 20
    assert trerank.shortlist_depth(3, 9) == jrerank.shortlist_depth(3, 9)


def test_ranked_programs_match_jax_on_exact_ties(monkeypatch):
    db, ids, valid, norms, q = _padded_store(np.random.default_rng(5))
    cap, d = db.shape
    tdb, tids, tvalid, tq = (torch.from_numpy(a) for a in (db, ids, valid, q))
    for r in range(q.shape[0]):
        jd, ji = jdist.ranked_program(cap, d)(db, ids, valid, q[r])
        td, ti = tdist.ranked_program(tdb, tids, tvalid, tq[r], in_id_order=True)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jd, ji = jdist.ranked_many_program(cap, d, q.shape[0])(db, ids, valid, q)
    # A small budget forces several chunks; rows must not depend on it.
    monkeypatch.setattr(tdist, "RANKED_MANY_BUDGET_BYTES", 2 * cap * 20)
    td, ti = tdist.ranked_many_program(tdb, tids, tvalid, tq, in_id_order=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(
        tdist.scores_via_matmul(tq, tdb, torch.from_numpy(norms))[:, valid].numpy(),
        np.asarray(jdist.scores_via_matmul(q, db, norms))[:, valid], rtol=0, atol=0)
    # Rows in any order (an inverted-list canvas, a positional refine store)
    # are put in id order first (the default): the (distance, id) ranking
    # is the same, and the same as on the store already in id order.
    perm = np.random.default_rng(6).permutation(cap)
    pdb, pids, pvalid = (torch.from_numpy(np.ascontiguousarray(a[perm]))
                         for a in (db, ids, valid))
    for r in range(q.shape[0]):
        td, ti = tdist.ranked_program(pdb, pids, pvalid, tq[r])
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[r])
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[r])
    td, ti = tdist.ranked_many_program(pdb, pids, pvalid, tq)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("case", CASES)
def test_fused_topk_bf16_queries_on_int8_store_match_jax_kernel(case):
    """The q_int8=False mode: int8 codes decoded to bf16 against bf16
    queries (-2 q rounded to bf16), f32 accumulation."""
    db, ids, norms, q, k, tile = _fixture(case, "int8", np.random.default_rng(8))
    jd, ji, jr = jax_fused_topk(
        jnp.asarray(db, dtype=jnp.int8), jnp.asarray(ids), jnp.asarray(norms), jnp.asarray(q), k,
        tile_n=tile, q_int8=False, return_rows=True)
    jd, ji, jr = np.asarray(jd), np.asarray(ji), np.asarray(jr)
    args = (torch.from_numpy(db).to(torch.int8), torch.from_numpy(ids), torch.from_numpy(norms),
            torch.from_numpy(q), k)
    td, ti, tr = (x.numpy() for x in topk_cuda.fused_topk_reference(
        *args, q_int8=False, return_rows=True))
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    if case == "random":
        same_up_to_ties(jd, ji, td, ti, 1e-5)       # summation order
    else:                                           # integer data: every sum exact
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tr, jr)
    q_st, rs = topk_cuda.stage_queries(torch.from_numpy(q), torch.int8, q_int8=False)
    assert q_st.dtype == torch.bfloat16 and rs is None
    before = dict(topk_cuda.fused_l2_topk.launches_by_mode)
    wd, wi = topk_cuda.fused_topk(*args, q_int8=False)
    assert topk_cuda.fused_l2_topk.launches_by_mode == before
    np.testing.assert_array_equal(wd.numpy(), td)
    np.testing.assert_array_equal(wi.numpy(), ti)
