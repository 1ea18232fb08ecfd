"""PyTorch port on the card: the three hand-written IVF list-scan kernels
(csrc/ivf_scan.cu) against their plain versions, and IVFFlatIndex on CUDA
against the same index on the CPU.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU mode). The select kernel splits each query's probes into groups and
merges them, the dense kernels split them into groups and each list's rows
into splits; their tests force the group count (`_groups=`) and the splits
(`_splits=`) and pass lists' high-water marks (`hwm=`), true, stale-high,
zero or cutting live rows (which the kernels must then not read). This file imports neither jax nor
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_ivf_cuda.py -q

Tolerances: int8 keys bit-equal (product and sum round separately on both
sides); f32/bf16 distances within 1e-5 relative (1e-5 absolute near 0: the
kernel and the plain version sum the dot product in another order), with
ids equal except inside groups of distances tied within that tolerance.
The select and dense kernels share one distance routine, so their
distances are bit-equal. The index fixtures are integer-valued, so every
distance is exact in f32 on both devices and results must be equal."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.models.devbuild import list_hwm
from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex
from c99_vectordb_tpu_torch.ops import ivf_scan, ivf_scan_cuda, select_common
from c99_vectordb_tpu_torch.ops.topk import merge_topk

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run on the card)")
    return torch.device("cuda", 0)


def same_up_to_ties(want_d, want_i, got_d, got_i, tol=TOL):
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


def _lists(nlist, pad, d, device, seed, dtype=torch.float32, fill=0.7):
    """Random lists with padding slots (id -1), a few masked rows (+inf
    norms, real ids) and a few underfilled lists."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((nlist, pad, d), generator=g)
    ids = torch.randperm(nlist * pad, generator=g).reshape(nlist, pad).to(torch.int32)
    live = torch.rand((nlist, pad), generator=g) < fill
    live[: nlist // 4, 3:] = False                            # underfilled lists
    ids = torch.where(live, ids, -1)
    x32 = x.to(dtype).to(torch.float32)
    sqn = (x32 * x32).sum(-1)
    sqn[torch.rand((nlist, pad), generator=g) < 0.1] = torch.inf
    return (x.to(dtype).to(device).contiguous(), sqn.to(device), ids.to(device))


def _queries(b, d, nlist, nprobe, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, d), generator=g)
    probes = torch.stack([torch.randperm(nlist, generator=g)[:nprobe] for _ in range(b)])
    return q.to(device), (q * q).sum(1).to(device), probes.to(torch.int32).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 200, 1100])
@pytest.mark.parametrize("qpb", [1, 4])
def test_select_and_dense_match_plain(cuda, dtype, k, qpb):
    nlist, pad, d = 24, 200, 96                    # ragged last row tile
    lists, sqn, ids = _lists(nlist, pad, d, cuda, seed=k + qpb, dtype=dtype)
    q, q_sq, probes = _queries(37, d, nlist, 6, cuda, seed=k)
    s0, d0 = ivf_scan_cuda.ivf_scan_select.launches, ivf_scan_cuda.ivf_scan_dense.launches
    kd, ki = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lists, sqn, ids, k, qpb)
    dd2, di2 = ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn, ids)
    assert ivf_scan_cuda.ivf_scan_select.launches == s0 + 1
    assert ivf_scan_cuda.ivf_scan_dense.launches == d0 + 1
    pd, pi = ivf_scan.scan_select_plain(probes, q, q_sq, lists, sqn, ids, k)
    pd2, pi2 = ivf_scan.scan_dense_plain(probes, q, q_sq, lists, sqn, ids)
    torch.cuda.synchronize()
    assert kd.shape == (37, k) and ki.dtype == torch.int32
    same_up_to_ties(pd.cpu().numpy(), pi.cpu().numpy(), kd.cpu().numpy(), ki.cpu().numpy())
    assert torch.equal(di2, pi2)
    np.testing.assert_allclose(dd2.cpu().numpy(), pd2.cpu().numpy(), rtol=TOL, atol=TOL)
    # Select and dense + merge: bit-equal distances, equal ids where finite.
    md, mi = merge_topk(dd2, di2, k)
    assert torch.equal(md, kd)
    fin = torch.isfinite(kd)
    assert torch.equal(mi[fin], ki[fin])


@pytest.mark.parametrize("qpb", [1, 8])
def test_dense_int8_matches_plain_bit_for_bit(cuda, qpb):
    nlist, pad, d = 20, 136, 384
    g = torch.Generator(device="cpu").manual_seed(qpb)
    codes = torch.randint(-127, 128, (nlist, pad, d), generator=g, dtype=torch.int8).to(cuda)
    dec = torch.rand((nlist, pad), generator=g).to(cuda) * 50
    ids = torch.where(torch.rand((nlist, pad), generator=g) < 0.8,
                      torch.arange(nlist * pad).reshape(nlist, pad), -1).to(torch.int32).to(cuda)
    q8 = torch.randint(-127, 128, (40, d), generator=g, dtype=torch.int8).to(cuda)
    rs = (torch.rand((40,), generator=g) * 0.01).to(cuda)
    _, _, probes = _queries(40, d, nlist, 5, cuda, seed=3)
    before = ivf_scan_cuda.ivf_scan_dense_int8.launches
    kd, ki = ivf_scan_cuda.ivf_scan_dense_int8(probes, q8, rs, codes, dec, ids, qpb)
    assert ivf_scan_cuda.ivf_scan_dense_int8.launches == before + 1
    pd, pi = ivf_scan.scan_dense_int8_plain(probes, q8, rs, codes, dec, ids)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_kernels_reject_bad_operands(cuda):
    lists, sqn, ids = _lists(8, 64, 32, cuda, seed=1)
    q, q_sq, probes = _queries(4, 32, 8, 2, cuda, seed=1)
    counts = (ivf_scan_cuda.ivf_scan_select.launches, ivf_scan_cuda.ivf_scan_dense.launches)
    with pytest.raises(TypeError):
        ivf_scan_cuda.ivf_scan_select(probes.long(), q, q_sq, lists, sqn, ids, 5)
    with pytest.raises(ValueError):
        ivf_scan_cuda.ivf_scan_select(probes, q, q_sq.cpu(), lists, sqn, ids, 5)
    with pytest.raises(ValueError):
        ivf_scan_cuda.ivf_scan_dense(probes, q[:, ::2], q_sq, lists, sqn, ids)
    with pytest.raises(TypeError):
        ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists.half(), sqn, ids)
    codes = torch.zeros((8, 64, 30), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ivf_scan_cuda.ivf_scan_dense_int8(probes, torch.zeros((4, 30), dtype=torch.int8,
                                                              device=cuda),
                                          torch.ones(4, device=cuda), codes, sqn, ids)
    assert counts == (ivf_scan_cuda.ivf_scan_select.launches,
                      ivf_scan_cuda.ivf_scan_dense.launches)


def _corpus(n, d, seed):
    """Integer rows with exact f32 distances: both devices must agree
    exactly. Row 0 holds 7 in every dimension and every query holds 7 in
    dimension 0, so SQ8 scales are exact too."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    x[0] = 7.0
    ids = np.sort(rng.permutation(2 * n)[:n]).astype(np.int64)
    q = rng.integers(-3, 4, (24, d)).astype(np.float32)
    mask = rng.random(2 * n + 3) < 0.3
    return x, ids, q, mask


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("nprobe", [2, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_ivf_flat_on_card_matches_cpu(cuda, scan_dtype, nprobe, masked):
    """Both routes on the card (dense at nprobe 2, select at 16 for f32)
    against the index on the CPU, from one state with integer centroids
    (so both devices pick the same probes), with a tail."""
    x, ids, q, mask = _corpus(3000, 32, seed=nprobe)
    cents = x[100:116].copy()
    assign = ((x[:2800, None, :] - cents[None]) ** 2).sum(-1).argmin(1).astype(np.int32)
    params = {"dim": 32, "nlist": 16, "nprobe": nprobe, "scan_dtype": scan_dtype,
              "rerank_dtype": "float32", "pad_cap": None}
    arrays = {"vectors": x[:2800], "ids": ids[:2800], "centroids": cents, "assign": assign}
    card = IVFFlatIndex.from_state(params, arrays, device=cuda)
    cpu = IVFFlatIndex.from_state(params, arrays, device="cpu")
    kw = {"id_mask": mask} if masked else {}
    card.search(q[:1], 5)
    cpu.search(q[:1], 5)
    card.add(x[2800:], ids[2800:])                 # tail rows
    cpu.add(x[2800:], ids[2800:])
    gd, gi = card.search(q, 10, **kw)
    cd, ci = cpu.search(q, 10, **kw)
    pd, pi = cpu._search(q, 10, card_route=True, **kw)
    np.testing.assert_array_equal(gi, pi)
    np.testing.assert_array_equal(gd, pd)
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_array_equal(gd, cd)


def test_ivf_flat_device_mode_on_card(cuda):
    """Device-mode build, removal and fold on the card against the card
    route's plain versions on the CPU, from the card's own state."""
    x, ids, q, _ = _corpus(4000, 32, seed=5)
    card = IVFFlatIndex(dim=32, nlist=16, nprobe=16, device=cuda)
    card.add(torch.from_numpy(x[:3000]).to(cuda), ids[:3000])
    card.search(q[:1], 3)
    card.add(torch.from_numpy(x[3000:]).to(cuda), ids[3000:])
    card._restage_needed = True
    assert card.remove_ids(ids[::7]) > 0
    params, arrays = card.state()
    cpu = IVFFlatIndex.from_state(params, arrays, device="cpu")
    for scan in ("dense", "select"):
        gd, gi = card._search(q, 10, card_route=True, scan=scan)
        pd, pi = cpu._search(q, 10, card_route=True, scan=scan)
        np.testing.assert_array_equal(gi, pi)
        np.testing.assert_array_equal(gd, pd)


def _hwm(kind, ids, device, seed=0):
    """High-water marks: None, the true marks, stale-high (pad), true with
    some lists at 0, or random marks that cut live rows."""
    nlist, pad = ids.shape
    true = list_hwm(ids.cpu()).to(torch.int32)
    if kind == "none":
        return None
    if kind == "stale":
        true = torch.full((nlist,), pad, dtype=torch.int32)
    elif kind == "zero":
        true[::3] = 0
    elif kind == "cut":
        g = torch.Generator(device="cpu").manual_seed(seed)
        true = torch.randint(0, pad + 1, (nlist,), generator=g).to(torch.int32)
    return true.to(device)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 96), (torch.bfloat16, 96),
                                     (torch.float32, 100), (torch.float32, 384)])
@pytest.mark.parametrize("groups", [None, 1, 2, 3, 7])
@pytest.mark.parametrize("kind", ["none", "true", "stale", "zero", "cut"])
def test_select_groups_and_hwm_match_plain(cuda, dtype, d, groups, kind):
    """Any probe grouping (7 probes: 3 groups of 3, 3, 1) and any marks:
    the plain version within TOL, and bit-equal to the dense kernel + merge
    on the ids the marks leave. D = 100 takes the unaligned loader; pad 208
    keeps a ragged last tile."""
    nlist, pad = 24, 208
    lists, sqn, ids = _lists(nlist, pad, d, cuda, seed=d + (groups or 0), dtype=dtype)
    q, q_sq, probes = _queries(21, d, nlist, 7, cuda, seed=1000 + d)
    hwm = _hwm(kind, ids, cuda, seed=d)
    before = ivf_scan_cuda.ivf_scan_select.launches
    kd, ki = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lists, sqn, ids, 10, hwm=hwm,
                                           _groups=groups)
    assert ivf_scan_cuda.ivf_scan_select.launches == before + 1
    pd, pi = ivf_scan.scan_select_plain(probes, q, q_sq, lists, sqn, ids, 10, hwm=hwm)
    same_up_to_ties(pd.cpu().numpy(), pi.cpu().numpy(), kd.cpu().numpy(), ki.cpu().numpy())
    md, mi = merge_topk(*ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn,
                                                       select_common.ids_below_hwm(ids, hwm)), 10)
    assert torch.equal(md, kd)
    fin = torch.isfinite(kd)
    assert torch.equal(mi[fin], ki[fin])


def _planted(device, k, nlist=8, pad=48, seed=0):
    """A zero query, so each distance is its row's norm: integer norms
    (many exact ties), padding, masked rows; k - 1 rows of query 0 at
    1..k-1 and, tied at the k-th place, id 900 in the list probed first and
    id 5 in the list probed last."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    lv = torch.randn((nlist, pad, 32), generator=g)
    li = (torch.randperm(nlist * pad, generator=g) + 1000).reshape(nlist, pad).to(torch.int32)
    li[torch.rand((nlist, pad), generator=g) < 0.2] = -1
    sqn = torch.randint(k + 1, k + 8, (nlist, pad), generator=g).to(torch.float32)
    sqn[torch.rand((nlist, pad), generator=g) < 0.1] = torch.inf
    probes = torch.stack([torch.randperm(nlist, generator=g) for _ in range(3)]).to(torch.int32)
    for r in range(k - 1):                      # query 0's k - 1 nearest
        lst = int(probes[0, r % nlist])
        sqn[lst, 1 + r // nlist], li[lst, 1 + r // nlist] = r + 1, 100 + r
    first, last = int(probes[0, 0]), int(probes[0, -1])
    sqn[first, 0], li[first, 0] = k, 900
    sqn[last, 0], li[last, 0] = k, 5
    q = torch.zeros((3, 32))
    return tuple(t.to(device).contiguous() for t in (probes, q, torch.zeros(3), lv, sqn, li))


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("k", [5, 40])
def test_select_kth_tie_across_groups_lowest_id_wins(cuda, groups, k):
    """At the k-th place a tie between id 900 (first probe, first group)
    and id 5 (last probe, last group): the lower id wins, as in the single
    pass; every grouping gives the plain version's bits."""
    probes, q, q_sq, lv, sqn, li = _planted(cuda, k)
    kd, ki = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lv, sqn, li, k, _groups=groups)
    pd, pi = ivf_scan.scan_select_plain(probes, q, q_sq, lv, sqn, li, k)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert int(ki[0, k - 1]) == 5 and float(kd[0, k - 1]) == k


@pytest.mark.parametrize("groups", [None, 2, 16])
def test_select_nprobe_one_and_deep_k(cuda, groups):
    """nprobe = 1 (one group whatever is asked), and k = 1100 (lists in
    global scratch) over 16 probes with true marks."""
    lists, sqn, ids = _lists(24, 200, 96, cuda, seed=5)
    q, q_sq, probes = _queries(9, 96, 24, 1, cuda, seed=6)
    kd, ki = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lists, sqn, ids, 10, _groups=groups)
    md, mi = merge_topk(*ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn, ids), 10)
    assert torch.equal(md, kd)
    q, q_sq, probes = _queries(9, 96, 24, 16, cuda, seed=7)
    hwm = _hwm("true", ids, cuda)
    kd, ki = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lists, sqn, ids, 1100, hwm=hwm,
                                           _groups=groups)
    md, mi = merge_topk(*ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn, ids), 1100)
    assert torch.equal(md, kd)
    fin = torch.isfinite(kd)
    assert torch.equal(mi[fin], ki[fin])


@pytest.mark.parametrize("k", [10, 1100])
def test_select_qpb_does_not_change_results(cuda, k):
    lists, sqn, ids = _lists(24, 200, 96, cuda, seed=8)
    q, q_sq, probes = _queries(37, 96, 24, 6, cuda, seed=9)
    hwm = _hwm("zero", ids, cuda)
    one = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lists, sqn, ids, k, 1, hwm=hwm)
    four = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lists, sqn, ids, k, 4, hwm=hwm)
    assert torch.equal(one[0], four[0]) and torch.equal(one[1], four[1])


def test_select_plan_puts_two_blocks_on_every_sm(cuda):
    """At the 1M path's shape (B = 128, nprobe 16, D = 384, k = 10, f32)
    the grid holds at least two blocks per SM."""
    plan = ivf_scan_cuda.select_plan(128, 16, 384, 10, torch.float32, cuda)
    assert plan["blocks_per_sm"] >= 2 and plan["blocks"] >= 2 * plan["sms"]


# -- the dense kernels' grid and high-water marks --------------------------------------------


def _int8_lists(nlist, pad, d, b, device, seed):
    """Random SQ8 codes with padding, their decoded norms, ids; int8
    queries and scales."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    codes = torch.randint(-127, 128, (nlist, pad, d), generator=g, dtype=torch.int8)
    dec = torch.rand((nlist, pad), generator=g) * 50
    ids = torch.where(torch.rand((nlist, pad), generator=g) < 0.7,
                      torch.arange(nlist * pad).reshape(nlist, pad), -1).to(torch.int32)
    ids[: nlist // 4, 3:] = -1                                # underfilled lists
    q8 = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
    rs = torch.rand((b,), generator=g) * 0.01
    return tuple(t.to(device) for t in (codes, dec, ids, q8, rs))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 96), (torch.bfloat16, 96),
                                     (torch.float32, 100), (torch.float32, 384)])
@pytest.mark.parametrize("groups", [1, 2, 7])
@pytest.mark.parametrize("kind", ["none", "true", "stale", "zero", "cut"])
def test_dense_groups_and_hwm_match_plain(cuda, dtype, d, groups, kind):
    """Any probe grouping (7 probes: G of 1, 2 and nprobe) and any marks:
    the plain version with the same marks (ids equal, distances within
    TOL), and dense + merge_topk bit-equal to the select kernel with the
    same marks. D = 100 takes the synchronous loader; pad 208 keeps a
    ragged last tile."""
    nlist, pad = 24, 208
    lists, sqn, ids = _lists(nlist, pad, d, cuda, seed=3 * d + groups, dtype=dtype)
    q, q_sq, probes = _queries(21, d, nlist, 7, cuda, seed=2000 + d)
    hwm = _hwm(kind, ids, cuda, seed=d + 1)
    before = ivf_scan_cuda.ivf_scan_dense.launches
    dd, di = ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn, ids, hwm=hwm,
                                          _groups=groups)
    assert ivf_scan_cuda.ivf_scan_dense.launches == before + 1
    pd, pi = ivf_scan.scan_dense_plain(probes, q, q_sq, lists, sqn, ids, hwm=hwm)
    torch.cuda.synchronize()
    assert torch.equal(di, pi)
    assert torch.equal(torch.isinf(dd), torch.isinf(pd))
    np.testing.assert_allclose(dd.cpu().numpy(), pd.cpu().numpy(), rtol=TOL, atol=TOL)
    kd, ki = ivf_scan_cuda.ivf_scan_select(probes, q, q_sq, lists, sqn, ids, 10, hwm=hwm)
    md, mi = merge_topk(dd, di, 10)
    assert torch.equal(md, kd)
    fin = torch.isfinite(kd)
    assert torch.equal(mi[fin], ki[fin])
    if kind == "zero":
        cut = hwm[probes.long()] == 0
        assert bool(cut.any())
        rows = dd.reshape(21, 7, pad)[cut]
        assert torch.isinf(rows).all() and (di.reshape(21, 7, pad)[cut] == -1).all()


@pytest.mark.parametrize("d", [384, 100, 64])
@pytest.mark.parametrize("groups", [1, 2, 7])
@pytest.mark.parametrize("kind", ["none", "true", "stale", "zero", "cut"])
def test_dense_int8_groups_and_hwm_match_plain(cuda, d, groups, kind):
    """The int8 kernel with any grouping and any marks: bit-equal to the
    plain version with the same marks. D = 100 (not a multiple of 16)
    takes the synchronous word loader."""
    nlist, pad = 20, 136
    codes, dec, ids, q8, rs = _int8_lists(nlist, pad, d, 33, cuda, seed=d + groups)
    _, _, probes = _queries(33, d, nlist, 7, cuda, seed=d)
    hwm = _hwm(kind, ids, cuda, seed=d + 2)
    before = ivf_scan_cuda.ivf_scan_dense_int8.launches
    kd, ki = ivf_scan_cuda.ivf_scan_dense_int8(probes, q8, rs, codes, dec, ids, hwm=hwm,
                                               _groups=groups)
    assert ivf_scan_cuda.ivf_scan_dense_int8.launches == before + 1
    pd, pi = ivf_scan.scan_dense_int8_plain(probes, q8, rs, codes, dec, ids, hwm=hwm)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.parametrize("splits", [1, 2, 5, 40])
def test_dense_row_splits_do_not_change_results(cuda, splits):
    """Row splits (each block takes tiles s, s + S, ... of its lists, and
    its share of the tails) give the one-split output, bit for bit, with
    cutting marks; 40 splits exceed the 7 tiles of a list and are cut."""
    lists, sqn, ids = _lists(24, 208, 96, cuda, seed=11)
    q, q_sq, probes = _queries(9, 96, 24, 5, cuda, seed=12)
    hwm = _hwm("cut", ids, cuda, seed=13)
    one = ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn, ids, hwm=hwm, _splits=1)
    got = ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn, ids, hwm=hwm,
                                       _splits=splits)
    assert torch.equal(one[0], got[0]) and torch.equal(one[1], got[1])
    codes, dec, ids8, q8, rs = _int8_lists(24, 208, 128, 9, cuda, seed=14)
    one = ivf_scan_cuda.ivf_scan_dense_int8(probes, q8, rs, codes, dec, ids8, hwm=hwm,
                                            _splits=1)
    got = ivf_scan_cuda.ivf_scan_dense_int8(probes, q8, rs, codes, dec, ids8, hwm=hwm,
                                            _splits=splits)
    assert torch.equal(one[0], got[0]) and torch.equal(one[1], got[1])


def test_dense_int8_qpb_does_not_change_keys(cuda):
    """qpb is the JAX package's queries per grid step: 1 and 8 give equal
    keys and ids, marks or none."""
    codes, dec, ids, q8, rs = _int8_lists(20, 136, 384, 40, cuda, seed=21)
    _, _, probes = _queries(40, 384, 20, 16, cuda, seed=22)
    for hwm in (None, _hwm("true", ids, cuda)):
        one = ivf_scan_cuda.ivf_scan_dense_int8(probes, q8, rs, codes, dec, ids, 1, hwm=hwm)
        eight = ivf_scan_cuda.ivf_scan_dense_int8(probes, q8, rs, codes, dec, ids, 8, hwm=hwm)
        assert torch.equal(one[0], eight[0]) and torch.equal(one[1], eight[1])


def test_dense_kernels_reject_bad_hwm(cuda):
    """A mark of the wrong shape, dtype or device raises before a launch."""
    lists, sqn, ids = _lists(8, 64, 32, cuda, seed=1)
    q, q_sq, probes = _queries(4, 32, 8, 2, cuda, seed=1)
    codes, dec, ids8, q8, rs = _int8_lists(8, 64, 32, 4, cuda, seed=2)
    true = _hwm("true", ids, cuda)
    counts = (ivf_scan_cuda.ivf_scan_dense.launches, ivf_scan_cuda.ivf_scan_dense_int8.launches)
    for bad in (true[:5], true.long(), true.cpu(), true[None, :]):
        with pytest.raises(ValueError):
            ivf_scan_cuda.ivf_scan_dense(probes, q, q_sq, lists, sqn, ids, hwm=bad)
        with pytest.raises(ValueError):
            ivf_scan_cuda.ivf_scan_dense_int8(probes, q8, rs, codes, dec, ids8, hwm=bad)
    assert counts == (ivf_scan_cuda.ivf_scan_dense.launches,
                      ivf_scan_cuda.ivf_scan_dense_int8.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_dense_plan_puts_two_blocks_on_every_sm(cuda, dtype):
    """At the 1M paths' shapes (B = 128, pad 1152, D = 384; f32 at nprobe
    3, int8 at nprobe 16) the dense grid holds at least two blocks per SM,
    resident and over the run."""
    nprobe = 3 if dtype == torch.float32 else 16
    plan = ivf_scan_cuda.dense_plan(128, nprobe, 1152, 384, dtype, cuda)
    assert plan["blocks_per_sm"] >= 2 and plan["blocks"] >= 2 * plan["sms"]
    assert 1 <= plan["groups"] <= nprobe and plan["splits"] >= 1
