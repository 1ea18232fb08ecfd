"""PyTorch port, the IVF list-scan programs (ops/ivf_scan.py) on CPU tensors,
where each kernel wrapper takes its plain version, against the JAX
package's Pallas programs (ops/ivf_scan_pallas.py, interpret mode) on the
same numpy inputs.

Inputs are unit vectors, as the embedder makes them, so distances are
O(1). Tolerances: f32 and bf16 distances within 1e-5 relative (1e-5
absolute near 0: the two sides sum the dot product in another order); ids
equal except inside groups of distances tied within that tolerance. Int8
keys: the port rounds float(ip) * rs and the sum separately (as its kernel
does, bit for bit), while XLA on the CPU contracts them into one FMA, so
the JAX keys are the single rounding of the same exact product: each side
is checked exactly against its own rounding, and the two agree within one
ulp (ids and bucket rows equal except among keys tied that closely)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu.models.devbuild import mask_norms as jax_mask_norms
from c99_vectordb_tpu.models.ivf_flat import IVFFlatIndex as JIVF
from c99_vectordb_tpu.ops.ivf_scan_pallas import ivf_full_search_program, ivf_sq8_search_program
from c99_vectordb_tpu_torch.ops import ivf_scan
from c99_vectordb_tpu_torch.ops.topk import merge_topk

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


@pytest.fixture(scope="module")
def staged():
    """16 lists of D=64 from a JAX-staged index (test_ivf_scan_pallas.py's
    fixture), as numpy, plus queries and a 30% id mask."""
    rng = np.random.default_rng(17)
    centers = rng.standard_normal((16, 64)).astype(np.float32) * 6.0
    points = np.concatenate(
        [c + rng.standard_normal((128, 64)).astype(np.float32) for c in centers])
    points /= np.linalg.norm(points, axis=1, keepdims=True)
    ivf = JIVF(dim=64, nlist=16, nprobe=16)
    ivf.train(points)
    ivf.add(points, np.arange(points.shape[0], dtype=np.int64))
    cents, c_sq, lv, li, sqn, _, pad, _ = ivf._stage()
    arrays = {name: np.asarray(a) for name, a in
              dict(cents=cents, c_sq=c_sq, lv=lv, li=li, sqn=sqn).items()}
    queries = (points[rng.choice(len(points), 8)] + 0.01).astype(np.float32)
    mask = rng.random(points.shape[0] + 7) < 0.3
    return arrays, pad, queries, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_both(arrays, pad, q, nprobe, k, *, dtype="float32", dense=False, qps_step=1,
              masked_sqn=None):
    jdtype = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    sqn = arrays["sqn"] if masked_sqn is None else masked_sqn
    lv = jnp.asarray(arrays["lv"]).astype(jdtype)
    prog = ivf_full_search_program(arrays["lv"].shape[0], pad, q.shape[1], q.shape[0], nprobe, k,
                                   db_dtype=jdtype, exact=dtype == "float32", dense=dense,
                                   qps_step=qps_step)
    jd, ji = prog(jnp.asarray(arrays["cents"]), jnp.asarray(arrays["c_sq"]), lv,
                  jnp.asarray(sqn), jnp.asarray(arrays["li"]), jnp.asarray(q))
    tv = _t(arrays["lv"]).to(getattr(torch, dtype))
    td, ti = ivf_scan.ivf_full_search(_t(arrays["cents"]), _t(arrays["c_sq"]), tv, _t(sqn),
                                      _t(arrays["li"]), _t(q), nprobe, k, dense=dense,
                                      qpb=qps_step)
    assert td.shape == (q.shape[0], k) and ti.dtype == torch.int32
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nprobe", [1, 3, 16])
@pytest.mark.parametrize("variant", ["select", "select_qps4", "dense"])
def test_scan_matches_pallas(staged, dtype, nprobe, variant):
    arrays, pad, q, _ = staged
    jd, ji, td, ti = _run_both(arrays, pad, q, nprobe, 10, dtype=dtype,
                               dense=variant == "dense",
                               qps_step=4 if variant == "select_qps4" else 1)
    same_up_to_ties(jd, ji, td, ti)


@pytest.mark.parametrize("variant", ["select", "dense"])
@pytest.mark.parametrize("k", [10, 300])
def test_id_mask_matches_pallas(staged, variant, k):
    """+inf norms of masked rows (the pushdown operand). At k=300 one probe
    cannot fill the list: the dense variant fills it with (inf, -1) on both
    sides. The select variant lets masked rows (inf, real id) fill it; there
    the Pallas kernel re-extracts its first +inf column every round (its
    extraction marks a taken slot +inf, which is still the minimum), so it
    repeats one id, while the port fills with distinct masked rows in id
    order. The finite entries agree."""
    arrays, pad, q, mask = staged
    msqn = np.asarray(jax_mask_norms(jnp.asarray(arrays["sqn"]), jnp.asarray(arrays["li"]),
                                     mask))
    jd, ji, td, ti = _run_both(arrays, pad, q, 1, k, dense=variant == "dense",
                               masked_sqn=msqn)
    same_up_to_ties(jd, ji, td, ti)
    inf = np.isinf(td)
    if variant == "dense":
        np.testing.assert_array_equal(ti[inf], ji[inf])
    else:
        for r in range(ti.shape[0]):
            fill = ti[r][inf[r] & (ti[r] >= 0)]
            assert len(set(fill.tolist())) == len(fill) and not mask[fill].any()
            assert (np.diff(fill) > 0).all()


@pytest.mark.parametrize("variant", ["select", "dense"])
def test_k_above_probed_rows_pads(staged, variant):
    arrays, pad, q, _ = staged
    jd, ji, td, ti = _run_both(arrays, pad, q[:2], 2, 2 * pad + 40, dense=variant == "dense")
    same_up_to_ties(jd, ji, td, ti)
    np.testing.assert_array_equal(ti, ji)
    assert (ti[:, -40:] == -1).all() and np.isinf(td[:, -40:]).all()


def test_kth_boundary_tie_lowest_id_wins():
    """A duplicate vector (ids 70 then 10) in two lists, k=1: the later,
    lower id must win the boundary tie (test_ivf_scan_pallas.py:146)."""
    d, pad = 32, 128
    dup = np.random.default_rng(8).standard_normal((d,)).astype(np.float32)
    lv = np.zeros((2, pad, d), np.float32)
    li = np.full((2, pad), -1, np.int32)
    lv[0, 0], li[0, 0] = dup, 70
    lv[1, 0], li[1, 0] = dup, 10
    arrays = {"lv": lv, "li": li, "sqn": np.einsum("lpd,lpd->lp", lv, lv).astype(np.float32)}
    arrays["cents"] = np.stack([dup + 0.01, dup + 0.5]).astype(np.float32)
    arrays["c_sq"] = np.einsum("nd,nd->n", arrays["cents"], arrays["cents"]).astype(np.float32)
    for dense in (False, True):
        jd, ji, td, ti = _run_both(arrays, pad, dup[None, :], 2, 1, dense=dense)
        assert ti[0, 0] == ji[0, 0] == 10
        assert td[0, 0] == jd[0, 0]


def test_underfilled_lists_keep_sentinels():
    """Fewer live rows than k: (inf, -1) padding, never duplicates
    (test_ivf_scan_pallas.py:173)."""
    d, pad, k = 32, 128, 10
    rng = np.random.default_rng(9)
    lv = np.zeros((2, pad, d), np.float32)
    li = np.full((2, pad), -1, np.int32)
    for s, rid in enumerate((100, 101, 102)):
        lv[0, s] = rng.standard_normal(d).astype(np.float32)
        li[0, s] = rid
    arrays = {"lv": lv, "li": li, "sqn": np.einsum("lpd,lpd->lp", lv, lv).astype(np.float32)}
    arrays["cents"] = np.stack([lv[0, 0] + 0.01, lv[0, 0] + 9.0]).astype(np.float32)
    arrays["c_sq"] = np.einsum("nd,nd->n", arrays["cents"], arrays["cents"]).astype(np.float32)
    q2 = np.vstack([lv[0, 0][None, :]] * 2)
    for dense, qps in ((False, 1), (False, 2), (True, 1)):
        jd, ji, td, ti = _run_both(arrays, pad, q2, 1, k, dense=dense, qps_step=qps)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(td, jd, rtol=TOL, atol=TOL)
        for row in ti:
            assert sorted(row[:3].tolist()) == [100, 101, 102] and (row[3:] == -1).all()


def test_select_and_dense_plain_versions_are_bit_identical(staged):
    arrays, pad, q, mask = staged
    probes = ivf_scan.coarse_probes(_t(q), _t(arrays["cents"]), _t(arrays["c_sq"]), 5)
    qt = _t(q)
    args = (probes, qt, (qt * qt).sum(1), _t(arrays["lv"]), _t(arrays["sqn"]), _t(arrays["li"]))
    sd, si = ivf_scan.scan_select_plain(*args, 25)
    md, mi = merge_topk(*ivf_scan.scan_dense_plain(*args), 25)
    assert torch.equal(sd, md) and torch.equal(si, mi)


def _sq8(arrays):
    lv, li = arrays["lv"], arrays["li"]
    live = li >= 0
    maxabs = np.abs(np.where(live[:, :, None], lv, 0.0)).max(axis=(0, 1), initial=1e-30)
    scale = (maxabs / 127.0).astype(np.float32)
    codes = np.clip(np.rint(lv / scale), -127, 127)
    dec = codes * scale
    return (codes.astype(np.int8), scale,
            np.einsum("lpd,lpd->lp", dec, dec).astype(np.float32))


@pytest.mark.parametrize("qps_step", [1, 8])
@pytest.mark.parametrize("nprobe,ks", [(3, 20), (16, 40), (2, 300)])
def test_sq8_scan_matches_pallas(staged, qps_step, nprobe, ks):
    """Int8 dense scan + exact shortlist + canvas rows: keys bit-equal, ids
    and bucket rows equal (ks=300 > nprobe * pad pads the shortlist)."""
    arrays, pad, q, _ = staged
    codes, scale, dec = _sq8(arrays)
    prog = ivf_sq8_search_program(16, pad, 64, 8, nprobe, ks, qps_step=qps_step)
    jd, ji, jr = prog(jnp.asarray(arrays["cents"]), jnp.asarray(arrays["c_sq"]),
                      jnp.asarray(codes), jnp.asarray(scale), jnp.asarray(dec),
                      jnp.asarray(arrays["li"]), jnp.asarray(q))
    td, ti, tr = ivf_scan.ivf_sq8_search(_t(arrays["cents"]), _t(arrays["c_sq"]), _t(codes),
                                         _t(scale), _t(dec), _t(arrays["li"]), _t(q), nprobe, ks,
                                         qpb=qps_step)
    jd, ji, jr = map(np.asarray, (jd, ji, jr))
    td, ti, tr = td.numpy(), ti.numpy(), tr.numpy()
    # Each side's keys are its own rounding of the exact integer dot.
    flat_codes = codes.reshape(-1, 64).astype(np.float64)
    q8, rs = ivf_scan.sq8_stage_queries(_t(q), _t(scale))
    q8, rs = q8.numpy().astype(np.float64), rs.numpy()
    for r in range(q.shape[0]):
        for keys, rows, single in ((td, tr, False), (jd, jr, True)):
            live = np.isfinite(keys[r])
            ip = (flat_codes[rows[r][live]] @ q8[r]).astype(np.float32)
            base = dec.reshape(-1)[rows[r][live]]
            want = ((ip.astype(np.float64) * rs[r] + base).astype(np.float32) if single
                    else (ip * rs[r]).astype(np.float32) + base)
            np.testing.assert_array_equal(keys[r][live], want)
    same_up_to_ties(jd, ji, td, ti, tol=1e-6)
    same_up_to_ties(jd, jr, td, tr, tol=1e-6)
    live = ti >= 0
    np.testing.assert_array_equal(arrays["li"].reshape(-1)[tr[live]], ti[live])


def test_sq8_query_staging_matches_jax(staged):
    arrays, _, q, _ = staged
    _, scale, _ = _sq8(arrays)
    qs = jnp.asarray(q) * jnp.asarray(scale) * -2.0
    rs = jnp.maximum(jnp.max(jnp.abs(qs), axis=1, keepdims=True), 1e-30) / 127.0
    want = jnp.clip(jnp.rint(qs / rs), -127, 127).astype(jnp.int8)
    q8, trs = ivf_scan.sq8_stage_queries(_t(q), _t(scale))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(want))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(rs)[:, 0])


def test_coarse_probes_match_jax(staged):
    import jax

    arrays, _, q, _ = staged
    coarse = jnp.asarray(arrays["c_sq"])[None, :] - 2.0 * jnp.dot(
        jnp.asarray(q), jnp.asarray(arrays["cents"]).T)
    _, want = jax.lax.top_k(-coarse, 5)
    got = ivf_scan.coarse_probes(_t(q), _t(arrays["cents"]), _t(arrays["c_sq"]), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


# -- the select kernel's probe groups and high-water marks ----------------------------------


def _split_merge(probes, q, q_sq, lv, sqn, li, k, groups, hwm=None):
    """The select kernel's split rule emulated with its plain version: each
    contiguous group of ceil(nprobe / groups) probe ranks keeps its own k
    best, then one merge of the partial lists by (dist, id'), id' = id or
    INT32_MAX for the (inf, -1) fill (csrc/select_merge.cuh)."""
    nprobe = probes.shape[1]
    per = -(-nprobe // groups)
    parts = [ivf_scan.scan_select_plain(probes[:, p0:p0 + per].contiguous(), q, q_sq, lv, sqn,
                                        li, k, hwm=hwm) for p0 in range(0, nprobe, per)]
    d = torch.cat([p[0] for p in parts], 1)
    i = torch.cat([p[1] for p in parts], 1)
    md, mt = ivf_scan.lex_topk(d, torch.where(i >= 0, i, ivf_scan.INT32_MAX), k)
    return md, torch.where(mt == ivf_scan.INT32_MAX, -1, mt)


def _planted_lists(seed, nlist=8, pad=6, k=5):
    """Lists scored by a zero query, so each distance is its row's norm:
    integer norms (many exact ties), padding, masked rows (+inf norm, real
    id); k - 1 rows at 1..k-1 and, tied at the k-th place, id 900 in the
    list probed first and id 5 in the list probed last."""
    g = torch.Generator().manual_seed(seed)
    lv = torch.randn((nlist, pad, 4), generator=g)
    li = (torch.randperm(nlist * pad, generator=g) + 1000).reshape(nlist, pad).to(torch.int32)
    li[torch.rand((nlist, pad), generator=g) < 0.2] = -1
    sqn = torch.randint(k + 1, k + 8, (nlist, pad), generator=g).to(torch.float32)
    sqn[torch.rand((nlist, pad), generator=g) < 0.1] = torch.inf
    probes = torch.randperm(nlist, generator=g)[None, :].to(torch.int32)
    first, last = int(probes[0, 0]), int(probes[0, -1])
    for r in range(k - 1):                       # the k - 1 nearest, one per list
        sqn[int(probes[0, r % nlist]), 1], li[int(probes[0, r % nlist]), 1] = r + 1, 100 + r
    sqn[first, 0], li[first, 0] = k, 900
    sqn[last, 0], li[last, 0] = k, 5
    q = torch.zeros((1, 4))
    return probes, q, torch.zeros(1), lv, sqn, li


@pytest.mark.parametrize("groups", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_and_merge_equals_single_pass(groups, seed):
    """Probe groups merged by (dist, id') give the single pass's result,
    the k-th place tie included: the lower id wins although its list is
    probed last (and lies in another group)."""
    k = 5
    args = _planted_lists(seed, k=k)
    sd, si = ivf_scan.scan_select_plain(*args, k)
    assert si[0, k - 1] == 5 and sd[0, k - 1] == k and sd[0, k - 2] == k - 1
    gd, gi = _split_merge(*args, k, groups)
    assert torch.equal(gd, sd) and torch.equal(gi, si)
    # Deeper than the live rows: masked rows fill, then (inf, -1), alike.
    sd, si = ivf_scan.scan_select_plain(*args, 45)
    gd, gi = _split_merge(*args, 45, groups)
    assert torch.equal(gd, sd) and torch.equal(gi, si) and (si[0, -3:] == -1).all()


def test_select_stops_at_hwm(staged):
    """Slots at or past hwm are padding for the select plain version (rows
    there are ignored); the true marks change nothing; the dense plain
    version scans to pad."""
    arrays, pad, q, _ = staged
    qt = _t(q)
    probes = ivf_scan.coarse_probes(qt, _t(arrays["cents"]), _t(arrays["c_sq"]), 6)
    lv, sqn, li = _t(arrays["lv"]), _t(arrays["sqn"]), _t(arrays["li"])
    args = (probes, qt, (qt * qt).sum(1), lv, sqn)
    from c99_vectordb_tpu_torch.models.devbuild import list_hwm

    true = list_hwm(li).to(torch.int32)
    want = ivf_scan.scan_select_plain(*args, li, 20)
    got = ivf_scan.scan_select_plain(*args, li, 20, hwm=true)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    low = torch.clamp(true - 40, min=0).to(torch.int32)
    cut = torch.where(torch.arange(pad)[None, :] < low[:, None], li, -1)
    got = ivf_scan.scan_select_plain(*args, li, 20, hwm=low)
    want = ivf_scan.scan_select_plain(*args, cut, 20)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _, si = ivf_scan.ivf_full_search(_t(arrays["cents"]), _t(arrays["c_sq"]), lv, sqn, li, qt, 6,
                                     20, hwm=low)
    assert torch.equal(si, got[1])


@pytest.mark.parametrize("b,nprobe,max_groups,qpb,per_sm,groups", [
    (128, 16, 65535, 1, 2, None), (128, 16, 192, 1, 2, None), (128, 16, 34, 1, 1, None),
    (1, 16, 65535, 1, 2, None), (4096, 16, 65535, 1, 2, None), (37, 7, 65535, 4, 2, None),
    (37, 7, 65535, 1, 2, 3), (37, 7, 65535, 1, 2, 5), (9, 1, 65535, 1, 2, 4),
    (9, 16, 2, 1, 2, 16), (128, 16, 6, 1, 2, None), (128, 16, 5, 1, 2, None),
    (128, 16, 65535, 1, 19, None), (128, 8, 65535, 1, 19, None), (128, 16, 192, 1, 13, None),
    (100, 16, 192, 1, 2, None), (64, 12, 65535, 1, 2, None), (1000, 7, 65535, 8, 2, None),
])
def test_probe_groups_rule(b, nprobe, max_groups, qpb, per_sm, groups):
    """The select grids' probe groups: contiguous groups of ceil(nprobe / G)
    ranks, at most nprobe and at most what the merge holds, and (asked
    nothing) equal groups and enough blocks for SELECT_WAVES waves where
    the probes and the merge allow it."""
    from c99_vectordb_tpu_torch.ops import select_common as sc

    waves = sc.SELECT_WAVES
    g = sc.probe_groups(b, nprobe, qpb, per_sm, 132, max_groups, groups)
    per = -(-nprobe // g)
    assert 1 <= g <= nprobe and -(-nprobe // per) == g
    assert g <= max_groups
    if groups is not None:
        assert g <= groups
    elif min(nprobe, 16) <= max_groups:
        assert nprobe % g == 0                                 # equal groups
        assert g == nprobe or -(-b // qpb) * g >= waves * per_sm * 132


# -- the dense kernels' high-water marks -----------------------------------------------------


def _padded(arrays):
    """The staged lists (all full) with list l's last 9 * (l % 8) slots
    turned into padding and a hole at slot 5 of every list: marks below
    pad, live rows under them."""
    li = arrays["li"].copy()
    for lst in range(li.shape[0]):
        li[lst, li.shape[1] - 9 * (lst % 8):] = -1
    li[:, 5] = -1
    return {**arrays, "li": li}


def _marks(kind, li):
    """The true marks of the staged lists (list_hwm), marks that cut live
    rows, or 0 everywhere."""
    from c99_vectordb_tpu_torch.models.devbuild import list_hwm

    true = list_hwm(li).to(torch.int32)
    if kind == "true":
        return true
    if kind == "cut":
        return torch.clamp(true - 40, min=0).to(torch.int32)
    return torch.zeros_like(true)


def _dense_args(arrays, q, nprobe, route):
    """(plain version, its operands) of the f32 or int8 dense kernel on the
    staged lists, probed by the kernel route's probes."""
    qt = _t(q)
    probes = ivf_scan.coarse_probes(qt, _t(arrays["cents"]), _t(arrays["c_sq"]), nprobe)
    if route == "int8":
        codes, scale, dec = _sq8(arrays)
        q8, rs = ivf_scan.sq8_stage_queries(qt, _t(scale))
        return ivf_scan.scan_dense_int8_plain, (probes, q8, rs, _t(codes), _t(dec),
                                                 _t(arrays["li"]))
    return ivf_scan.scan_dense_plain, (probes, qt, (qt * qt).sum(1), _t(arrays["lv"]),
                                       _t(arrays["sqn"]), _t(arrays["li"]))


@pytest.mark.parametrize("route", ["f32", "int8"])
@pytest.mark.parametrize("kind", ["true", "cut", "zero"])
def test_dense_plain_versions_stop_at_hwm(staged, route, kind):
    """The dense plain versions with marks: the true marks change no bit
    (the slots past them are padding already); marks that cut live rows
    give the output on ids_below_hwm(ids, hwm), bit for bit, with (+inf,
    -1) past each mark; marks of 0 give all (+inf, -1)."""
    from c99_vectordb_tpu_torch.ops.select_common import ids_below_hwm

    arrays, pad, q, _ = staged
    plain, args = _dense_args(_padded(arrays), q, 6, route)
    li = args[-1]
    hwm = _marks(kind, li)
    assert (hwm < pad).any()
    got_d, got_i = plain(*args, hwm=hwm)
    want_d, want_i = plain(*args[:-1], ids_below_hwm(li, hwm))
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    cols = torch.arange(6 * pad) % pad
    past = cols[None, :] >= hwm[args[0].long()].repeat_interleave(pad, dim=1)
    assert torch.isinf(got_d[past]).all() and (got_i[past] == -1).all()
    if kind == "true":
        base_d, base_i = plain(*args)
        assert torch.equal(got_d, base_d) and torch.equal(got_i, base_i)
    if kind == "zero":
        assert past.all()


@pytest.mark.parametrize("nprobe", [3, 16])
def test_dense_plain_with_true_marks_matches_pallas(staged, nprobe):
    """With the true marks, the f32 dense plain version + merge_topk equals
    the JAX dense program within TOL (ids up to ties), and the int8 plain
    version + the exact shortlist gives the JAX int8 program's ids and
    bucket rows, each side's keys its own rounding of the exact integer
    dot (the module doc)."""
    arrays, pad, q, _ = staged
    arrays = _padded(arrays)
    plain, args = _dense_args(arrays, q, nprobe, "f32")
    hwm = _marks("true", args[-1])
    assert (hwm < pad).any()
    jd, ji = ivf_full_search_program(16, pad, 64, 8, nprobe, 10, exact=True, dense=True)(
        *(jnp.asarray(arrays[n]) for n in ("cents", "c_sq", "lv", "sqn", "li")), jnp.asarray(q))
    td, ti = merge_topk(*plain(*args, hwm=hwm), 10)
    same_up_to_ties(jd, ji, td.numpy(), ti.numpy())
    plain, args = _dense_args(arrays, q, nprobe, "int8")
    codes, scale, dec = _sq8(arrays)
    jd, ji, jr = ivf_sq8_search_program(16, pad, 64, 8, nprobe, 40)(
        jnp.asarray(arrays["cents"]), jnp.asarray(arrays["c_sq"]), jnp.asarray(codes),
        jnp.asarray(scale), jnp.asarray(dec), jnp.asarray(arrays["li"]), jnp.asarray(q))
    d, i, pos = ivf_scan._shortlist_topk(*plain(*args, hwm=hwm), 40)
    rows = ivf_scan._canvas_rows(pos, args[0], pad)
    same_up_to_ties(jd, ji, d.numpy(), i.numpy(), tol=1e-6)
    same_up_to_ties(jd, jr, d.numpy(), rows.numpy(), tol=1e-6)


@pytest.mark.parametrize("nprobe", [3, 16])
def test_full_search_dense_and_sq8_with_hwm_match_pallas(staged, nprobe):
    """ivf_full_search(dense=True, hwm=) and ivf_sq8_search(hwm=) with the
    true marks against the JAX ivf_full_search_program(dense=True) and
    ivf_sq8_search_program; with marks of 0 every result is (inf, -1)."""
    arrays, pad, q, _ = staged
    arrays = _padded(arrays)
    li = _t(arrays["li"])
    hwm = _marks("true", li)
    jd, ji = ivf_full_search_program(16, pad, 64, 8, nprobe, 10, exact=True, dense=True)(
        *(jnp.asarray(arrays[n]) for n in ("cents", "c_sq", "lv", "sqn", "li")), jnp.asarray(q))
    common = (_t(arrays["cents"]), _t(arrays["c_sq"]))
    td, ti = ivf_scan.ivf_full_search(*common, _t(arrays["lv"]), _t(arrays["sqn"]), li, _t(q),
                                      nprobe, 10, dense=True, hwm=hwm)
    same_up_to_ties(jd, ji, td.numpy(), ti.numpy())
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    codes, scale, dec = _sq8(arrays)
    sq8 = (_t(codes), _t(scale), _t(dec), li, _t(q), nprobe, 40)
    jd, ji, jr = ivf_sq8_search_program(16, pad, 64, 8, nprobe, 40)(
        *(jnp.asarray(a) for a in (arrays["cents"], arrays["c_sq"], codes, scale, dec,
                                   arrays["li"], q)))
    td, ti, tr = ivf_scan.ivf_sq8_search(*common, *sq8, hwm=hwm)
    same_up_to_ties(jd, ji, td.numpy(), ti.numpy(), tol=1e-6)
    same_up_to_ties(jd, jr, td.numpy(), tr.numpy(), tol=1e-6)
    zero = torch.zeros_like(hwm)
    zd, zi = ivf_scan.ivf_full_search(*common, _t(arrays["lv"]), _t(arrays["sqn"]), li, _t(q),
                                      nprobe, 10, dense=True, hwm=zero)
    assert torch.isinf(zd).all() and (zi == -1).all()
    zd, zi, _ = ivf_scan.ivf_sq8_search(*common, *sq8, hwm=zero)
    assert torch.isinf(zd).all() and (zi == -1).all()


@pytest.mark.parametrize("blocks,per_sm,list_tiles,splits", [
    (384, 2, 36, None), (2048, 7, 36, None), (1024, 2, 8, None), (640, 4, 36, None),
    (128, 2, 1, None), (4096 * 16, 8, 36, None), (384, 2, 36, 4), (384, 2, 36, 99),
    (384, 2, 36, 0), (1, 16, 100_000, None),
])
def test_row_splits_rule(blocks, per_sm, list_tiles, splits):
    """The IVF dense grids' row splits: at least one, at most the tiles of
    a full list; asked nothing, a full list takes at most
    DENSE_SPLIT_TILES tiles per block, and the grid reaches SELECT_WAVES
    waves where the lists' tiles allow it."""
    from c99_vectordb_tpu_torch.ops import select_common as sc

    s = sc.row_splits(blocks, per_sm, 132, list_tiles, splits)
    assert 1 <= s <= min(list_tiles, 65535)
    if splits is not None:
        assert s == max(1, min(splits, list_tiles))
        return
    assert s == list_tiles or -(-list_tiles // s) <= sc.DENSE_SPLIT_TILES
    assert s == list_tiles or blocks * s >= sc.SELECT_WAVES * per_sm * 132
