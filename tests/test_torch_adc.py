"""PyTorch port, ops/adc.py against the JAX package's ops/adc_pallas.py on the
CPU: the plain versions of the ADC kernels against the JAX Pallas programs
(interpret mode) for 8-bit, nibble-packed 4-bit and unpacked ksub=64 codes;
a planted exact tie that shows the probe-order rule; the item constants,
nibble packing and code staging; the card route's search programs
(`adc_full_search`, `adc_dense_search` with `return_rows`).

The port's canvas is the JAX canvas without its padding to 128 subspace
rows: its first m rows (m/2 packed).

Tolerances: fed the same probes, coarse distances and QD tables, the plain
versions equal the Pallas programs bit for bit (both add the m table
entries in subspace order and round (coarse - 2 qdot) + const the same
way). The full search programs compute their own coarse distances and QD tables
(torch and XLA sum the matmul and the einsum in other orders), and the
estimate q_sq + c_sq - 2 q.c - 2 qdot + const cancels terms of the size of
q_sq + c_sq: distances there agree within 16 f32 ulps of that size (2e-6
times max q_sq + max c_sq) and ids are equal except inside groups of
distances tied that closely."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu.models.ivf_pq import IVFPQIndex as JPQ
from c99_vectordb_tpu.models.ivf_pq import _adc_search_program
from c99_vectordb_tpu.ops import adc_pallas as jadc
from c99_vectordb_tpu_torch.ops import adc as tadc
from c99_vectordb_tpu_torch.ops import adc_cuda
from c99_vectordb_tpu_torch.ops.topk import merge_topk

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


def _t(a):
    return torch.from_numpy(np.array(a))


LAYOUTS = [(256, 4), (16, 8), (64, 4)]   # 8-bit, nibble-packed 4-bit, unpacked ksub 64


@functools.lru_cache(maxsize=None)
def _build(ksub, m):
    rng = np.random.default_rng(23 + ksub)
    centers = rng.standard_normal((8, 32)).astype(np.float32) * 4.0
    x = np.concatenate([c + rng.standard_normal((180, 32)).astype(np.float32) for c in centers])
    ids = np.sort(rng.permutation(4000)[: x.shape[0]]).astype(np.int64)
    j = JPQ(dim=32, nlist=8, nprobe=3, m=m, ksub=ksub, refine=False)
    j.train(x)
    j.add(x, ids)
    st = j._stage()
    q = (x[rng.choice(x.shape[0], 6)] + 0.05).astype(np.float32)
    return ksub, m, j, st, q


@pytest.fixture(scope="module", params=LAYOUTS, ids=["ksub256", "ksub16", "ksub64"])
def staged(request):
    return _build(*request.param)


@pytest.fixture(scope="module", params=LAYOUTS[:2], ids=["ksub256", "ksub16"])
def staged_kernel_shape(request):
    """The codebook sizes the JAX package scans with its Pallas programs
    (others take its XLA route only)."""
    return _build(*request.param)


def _port_canvas(st, m, ksub):
    rows = m // 2 if tadc.packed_layout(ksub, m) else m
    return _t(np.asarray(st[5])[:, :rows])


def _prologue(st, q, nprobe):
    cents, c_sq, books = (_t(a) for a in st[:3])
    return tadc.adc_prologue(_t(q), cents, c_sq, books, nprobe)


def _atol(st, q):
    """16 f32 ulps of the cancelling magnitude max q_sq + max c_sq."""
    return 2e-6 * float((q * q).sum(1).max() + np.asarray(st[1]).max())


def _qd128(qd):
    b, m, ksub = qd.shape
    out = np.zeros((b, jadc.CODE_LANES, ksub), np.float32)
    out[:, :m] = qd.numpy()
    return jnp.asarray(out)


@pytest.mark.parametrize("k", [1, 7, 40])
def test_select_plain_equals_pallas_program(staged, k):
    ksub, m, _, st, q = staged
    pad, nlist = st[7], int(st[0].shape[0])
    probes, pc, qd = _prologue(st, q, 3)
    jd, ji = jadc.adc_scan_program(nlist, pad, m, ksub, q.shape[0], 3, k)(
        jnp.asarray(probes.numpy()), jnp.asarray(pc.numpy()), _qd128(qd), st[5], st[6], st[4])
    td, ti = adc_cuda.adc_scan_select(probes, pc, qd, _port_canvas(st, m, ksub), _t(st[6]),
                                      _t(st[4]), k, packed=tadc.packed_layout(ksub, m))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_dense_plain_equals_pallas_programs(staged):
    ksub, m, _, st, q = staged
    pad, nlist = st[7], int(st[0].shape[0])
    b = 8
    q8 = np.concatenate([q, q[:2] - 0.1]).astype(np.float32)
    probes, pc, qd = _prologue(st, q8, 4)
    args = (jnp.asarray(probes.numpy()), jnp.asarray(pc.numpy()), _qd128(qd), st[5], st[6],
            st[4])
    td, ti = adc_cuda.adc_scan_dense(probes, pc, qd, _port_canvas(st, m, ksub), _t(st[6]),
                                     _t(st[4]), packed=tadc.packed_layout(ksub, m))
    for prog in (jadc.adc_dense_program(nlist, pad, m, ksub, b, 4),
                 jadc.adc_dense_program_multi(nlist, pad, m, ksub, b, 4, 8)):
        jd, ji = prog(*args)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _planted(seed=0):
    """Two lists scored with equal coarse distances. List 5 (probed first)
    holds ids 90 and 91, list 2 (probed second) ids 10 and 11, all four
    with the same codes; slot 0 has the larger constant. Each estimate ties
    across the two probes, and the earlier probe's (higher) ids must win."""
    rng = np.random.default_rng(seed)
    m, ksub, pad, nlist = 4, 256, 8, 6
    codes = np.zeros((nlist, m, pad), np.uint8)
    const = np.zeros((nlist, pad), np.float32)
    ids = np.full((nlist, pad), -1, np.int32)
    row = rng.integers(0, ksub, (m, 1)).astype(np.uint8)
    for lst, base in ((5, 90), (2, 10)):
        codes[lst, :, :2] = row
        const[lst, :2] = [0.5, 0.25]
        ids[lst, :2] = [base, base + 1]
    qd = rng.integers(-8, 8, (1, m, ksub)).astype(np.float32) / 8.0    # exact sums
    probes = np.array([[5, 2]], np.int32)
    pc = np.array([[100.0, 100.0]], np.float32)
    return m, ksub, pad, nlist, probes, pc, qd, codes, const, ids


@pytest.mark.parametrize("k", [2, 3, 4])
def test_planted_exact_ties_follow_probe_order(k):
    m, ksub, pad, nlist, probes, pc, qd, codes, const, ids = _planted()
    td, ti = tadc.adc_select_plain(_t(probes), _t(pc), _t(qd), _t(codes), _t(const), _t(ids), k,
                                   packed=False)
    c128 = np.zeros((nlist, jadc.CODE_LANES, pad), np.uint8)
    c128[:, :m] = codes
    qd128 = np.zeros((1, jadc.CODE_LANES, ksub), np.float32)
    qd128[:, :m] = qd
    jd, ji = jadc.adc_scan_program(nlist, pad, m, ksub, 1, 2, k)(
        jnp.asarray(probes), jnp.asarray(pc), jnp.asarray(qd128), jnp.asarray(c128),
        jnp.asarray(const), jnp.asarray(ids))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # Slot 1 (smaller constant) before slot 0, each tied across the
    # probes: list 5 first.
    want = [91, 11, 90, 10][:k]
    assert ti[0].tolist() == want
    assert td[0, 0] == td[0, 1] and (k < 4 or td[0, 2] == td[0, 3])
    # The CPU route's rule, a (distance, id) merge, breaks the same ties by id.
    d2, i2 = tadc.adc_dense_plain(_t(probes), _t(pc), _t(qd), _t(codes), _t(const), _t(ids),
                                  packed=False)
    _, mi = merge_topk(d2, i2, k)
    assert mi[0].tolist() == [11, 91, 10, 90][:k]


def test_select_never_admits_inf_and_pads_unfilled():
    m, ksub, pad, nlist, probes, pc, qd, codes, const, ids = _planted(1)
    const = const.copy()
    const[5, 0] = np.inf                        # a masked row (real id, +inf constant)
    td, ti = tadc.adc_select_plain(_t(probes), _t(pc), _t(qd), _t(codes), _t(const), _t(ids), 6,
                                   packed=False)
    assert ti[0].tolist()[3:] == [-1, -1, -1] and 90 not in ti[0].tolist()
    assert bool(torch.isinf(td[0, 3:]).all())


def test_item_constants_host_and_device_match_jax():
    rng = np.random.default_rng(5)
    n, m, dsub, nlist, ksub, pad = 773, 4, 3, 5, 16, 256
    centroids = rng.standard_normal((nlist, m * dsub)).astype(np.float32)
    assign = rng.integers(0, nlist, n).astype(np.int32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    books = rng.standard_normal((m, ksub, dsub)).astype(np.float32)
    order = np.argsort(assign, kind="stable").astype(np.int32)
    sorted_lists = assign[order]
    counts = np.bincount(assign, minlength=nlist)
    starts = np.zeros((nlist,), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slots = (np.arange(n) - starts[sorted_lists]).astype(np.int32)
    args = (centroids, assign, codes, books, order, sorted_lists, slots, nlist, pad)
    want = jadc.build_item_constants(*args)
    np.testing.assert_array_equal(tadc.build_item_constants(*args), want)
    dev = tadc.build_item_constants_device(
        *(_t(a) for a in args[:4]), _t(order).long(), _t(sorted_lists).long(),
        _t(slots).long(), nlist, pad)
    # Another summation order ((2c + y) . y over (j, d) at once): 1e-5.
    np.testing.assert_allclose(dev.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dev.numpy(), np.asarray(jadc.build_item_constants_device(*args)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,ksub", [(6, 16), (5, 16), (4, 256), (3, 64)])
def test_stage_unstage_and_pack_match_jax(m, ksub):
    rng = np.random.default_rng(m * ksub)
    list_codes = rng.integers(0, ksub, (3, 40, m)).astype(np.uint8)
    canvas = tadc.stage_codes_device(_t(list_codes), m, ksub)
    packed = tadc.packed_layout(ksub, m)
    rows = m // 2 if packed else m
    assert canvas.shape == (3, rows, 40) and canvas.is_contiguous()
    want = np.asarray(jadc.stage_codes128_device(jnp.asarray(list_codes), m, ksub))
    np.testing.assert_array_equal(canvas.numpy(), want[:, :rows])
    assert not want[:, rows:].any()
    np.testing.assert_array_equal(tadc.unstage_codes_device(canvas, m, ksub).numpy(), list_codes)
    if packed:
        unpacked = list_codes.transpose(0, 2, 1)
        np.testing.assert_array_equal(tadc.pack_nibbles(unpacked), canvas.numpy())
        np.testing.assert_array_equal(canvas.numpy() & 15, unpacked[:, 0::2])
        np.testing.assert_array_equal(canvas.numpy() >> 4, unpacked[:, 1::2])


@pytest.mark.parametrize("k", [5, 40])
def test_full_search_matches_jax_program(staged_kernel_shape, k):
    ksub, m, j, st, q = staged_kernel_shape
    pad, nlist = st[7], int(st[0].shape[0])
    jd, ji = jadc.adc_full_search_program(nlist, pad, 32, m, ksub, q.shape[0], 3, k)(
        st[0], st[1], st[2], st[5], st[6], st[4], jnp.asarray(q))
    td, ti = tadc.adc_full_search(_t(st[0]), _t(st[1]), _t(st[2]), _port_canvas(st, m, ksub),
                                  _t(st[6]), _t(st[4]), _t(q), 3, k)
    same_up_to_ties(jd, ji, td.numpy(), ti.numpy(), atol=_atol(st, q))
    # The ADC estimate of the kernels equals the XLA route's direct table
    # sum within the QD rounding (the JAX package's own test holds the two
    # at 1e-3).
    xd, _ = _adc_search_program(nlist, pad, 32, m, ksub, q.shape[0], 3, k)(
        st[0], st[1], st[2], st[3], st[4], jnp.asarray(q))
    np.testing.assert_allclose(td.numpy(), np.asarray(xd), rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("qps", [None, 1])
@pytest.mark.parametrize("return_rows", [False, True])
def test_dense_search_matches_jax_program(staged_kernel_shape, qps, return_rows):
    ksub, m, _, st, q = staged_kernel_shape
    q8 = np.concatenate([q, q[:2] + 0.1]).astype(np.float32)
    pad, nlist = st[7], int(st[0].shape[0])
    k_adc = 3 * pad // 2
    out_j = jadc.adc_dense_search_program(nlist, pad, 32, m, ksub, 8, 3, k_adc, qps_step=qps,
                                          return_rows=return_rows)(
        st[0], st[1], st[2], st[5], st[6], st[4], jnp.asarray(q8))
    out_t = tadc.adc_dense_search(_t(st[0]), _t(st[1]), _t(st[2]), _port_canvas(st, m, ksub),
                                  _t(st[6]), _t(st[4]), _t(q8), 3, k_adc, qps_step=qps,
                                  return_rows=return_rows)
    assert len(out_t) == len(out_j) == (3 if return_rows else 2)
    same_up_to_ties(out_j[0], out_j[1], out_t[0].numpy(), out_t[1].numpy(),
                    atol=_atol(st, q8))
    if return_rows:
        # Each candidate's bucket row holds that candidate's id.
        li = np.asarray(st[4]).reshape(-1)
        rows, ids = out_t[2].numpy(), out_t[1].numpy()
        np.testing.assert_array_equal(li[rows], ids)
        fin = np.isfinite(np.asarray(out_j[0]))
        np.testing.assert_array_equal(np.sort(li[np.asarray(out_j[2])][fin]),
                                      np.sort(ids[fin]))


def test_dense_search_shortlist_ties_go_to_lowest_column():
    m, ksub, pad, nlist, probes, pc, qd, codes, const, ids = _planted(2)
    d2, i2 = tadc.adc_dense_plain(_t(probes), _t(pc), _t(qd), _t(codes), _t(const), _t(ids),
                                  packed=False)
    from c99_vectordb_tpu_torch.ops.topk import stable_topk

    d, pos = stable_topk(d2, 3)
    assert pos[0].tolist() == [1, pad + 1, 0]       # list 5's slot 1 before list 2's


def test_wrappers_take_plain_on_cpu_and_count_no_launch():
    m, ksub, pad, nlist, probes, pc, qd, codes, const, ids = _planted(3)
    s0, d0 = adc_cuda.adc_scan_select.launches, adc_cuda.adc_scan_dense.launches
    adc_cuda.adc_scan_select(_t(probes), _t(pc), _t(qd), _t(codes), _t(const), _t(ids), 3,
                             packed=False)
    adc_cuda.adc_scan_dense(_t(probes), _t(pc), _t(qd), _t(codes), _t(const), _t(ids),
                            packed=False, qpb=8)
    assert (adc_cuda.adc_scan_select.launches, adc_cuda.adc_scan_dense.launches) == (s0, d0)


# -- the select kernel's probe groups and high-water marks ----------------------------------


def _split_merge(probes, pc, qd, codes, const, ids, k, groups, hwm=None):
    """The select kernel's split rule emulated with its plain version: each
    contiguous group of ceil(nprobe / groups) probe ranks keeps its own
    first k, then the partial lists, in group order, one stable sort by
    distance: the keys (dist, probe rank * pad + slot) of the single pass
    (csrc/select_merge.cuh)."""
    nprobe = probes.shape[1]
    per = -(-nprobe // groups)
    parts = [tadc.adc_select_plain(probes[:, p0:p0 + per].contiguous(),
                                   pc[:, p0:p0 + per].contiguous(), qd, codes, const, ids, k,
                                   packed=False, hwm=hwm) for p0 in range(0, nprobe, per)]
    d = torch.cat([p[0] for p in parts], 1)
    i = torch.cat([p[1] for p in parts], 1)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    d, i = torch.gather(d, 1, order), torch.gather(i, 1, order)
    return d, torch.where(torch.isinf(d), -1, i)


def _planted_groups(seed, nlist=8, pad=6, k=5):
    """A zero table and zero coarse distances, so each estimate is its
    row's constant: integer constants (many exact ties), padding, masked
    rows (+inf constant, real id); k - 1 rows at 1..k-1 and, tied at the
    k-th place, id 900 in the list probed first and id 5 in the list
    probed last."""
    g = torch.Generator().manual_seed(seed)
    m, ksub = 4, 16
    codes = torch.randint(0, ksub, (nlist, m, pad), generator=g, dtype=torch.uint8)
    ids = (torch.randperm(nlist * pad, generator=g) + 1000).reshape(nlist, pad).to(torch.int32)
    ids[torch.rand((nlist, pad), generator=g) < 0.2] = -1
    const = torch.randint(k + 1, k + 8, (nlist, pad), generator=g).to(torch.float32)
    const[torch.rand((nlist, pad), generator=g) < 0.1] = torch.inf
    probes = torch.randperm(nlist, generator=g)[None, :].to(torch.int32)
    first, last = int(probes[0, 0]), int(probes[0, -1])
    for r in range(k - 1):
        const[int(probes[0, r % nlist]), 1], ids[int(probes[0, r % nlist]), 1] = r + 1, 100 + r
    const[first, 0], ids[first, 0] = k, 900
    const[last, 0], ids[last, 0] = k, 5
    return probes, torch.zeros((1, nlist)), torch.zeros((1, m, ksub)), codes, const, ids


@pytest.mark.parametrize("groups", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_and_merge_equals_single_pass(groups, seed):
    """Probe groups merged in group order by a stable sort give the single
    pass's result, the k-th place tie included: the earlier probe wins
    although its id is the higher one."""
    k = 5
    args = _planted_groups(seed, k=k)
    sd, si = tadc.adc_select_plain(*args, k, packed=False)
    assert si[0, k - 1] == 900 and sd[0, k - 1] == k and sd[0, k - 2] == k - 1
    gd, gi = _split_merge(*args, k, groups)
    assert torch.equal(gd, sd) and torch.equal(gi, si)
    sd, si = tadc.adc_select_plain(*args, 45, packed=False)      # +inf never enters
    gd, gi = _split_merge(*args, 45, groups)
    assert torch.equal(gd, sd) and torch.equal(gi, si) and (si[0, -3:] == -1).all()


def test_select_stops_at_hwm():
    """Slots at or past hwm are padding for the select plain version: live
    rows there are ignored; the true marks change nothing."""
    from c99_vectordb_tpu_torch.models.devbuild import list_hwm

    args = _planted_groups(3)
    ids = args[5]
    true = list_hwm(ids).to(torch.int32)
    want = tadc.adc_select_plain(*args, 20, packed=False)
    got = tadc.adc_select_plain(*args, 20, packed=False, hwm=true)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    low = torch.clamp(true - 2, min=0).to(torch.int32)
    cut = torch.where(torch.arange(ids.shape[1])[None, :] < low[:, None], ids, -1)
    got = tadc.adc_select_plain(*args, 20, packed=False, hwm=low)
    want = tadc.adc_select_plain(*args[:5], cut, 20, packed=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
