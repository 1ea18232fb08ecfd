"""PyTorch port on the card: the hand-written ADC kernels (csrc/adc_scan.cu)
against their plain versions for every code layout, and IVFPQIndex on CUDA
against the same index on the CPU.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU mode). The select kernel splits each query's probes into groups and
merges them; its tests force the group count (`_groups=`) and pass lists'
high-water marks (`hwm=`), true, stale-high, zero or cutting live rows
(which the kernel must then not read). This file imports neither jax nor
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_adc_cuda.py -q

Tolerances: the kernels and their plain versions add the m table entries in
subspace order and round (coarse - 2 qdot) + const the same way, so the
distances and ids are bit-equal, tie order included. The index on the card
and on the CPU computes its probes and QD tables with cuBLAS and with the
CPU's matmul, which sum in other orders: the exactly reranked distances
agree within 1e-5 relative (1e-5 absolute near 0), ids equal except among
distances tied that closely; pure-ADC estimates cancel terms of the size of
q_sq + c_sq, so they agree within 16 f32 ulps of that size."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.models.devbuild import list_hwm
from c99_vectordb_tpu_torch.models.ivf_pq import IVFPQIndex
from c99_vectordb_tpu_torch.ops import adc, adc_cuda

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode (run on the card)")
    return torch.device("cuda", 0)


def same_up_to_ties(want_d, want_i, got_d, got_i, tol=TOL, atol=TOL):
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


def _operands(device, *, m, ksub, packed, nlist=24, pad=300, b=37, nprobe=6, seed=0,
              quantized=False):
    """Random kernel operands: padding slots (id -1), masked rows (+inf
    constants, real ids), underfilled lists. quantized=True puts the table
    and constants on a 1/8 grid, so estimates tie exactly and often."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = m // 2 if packed else m
    codes = torch.randint(0, 256 if packed else ksub, (nlist, rows, pad), generator=g,
                          dtype=torch.uint8)
    ids = torch.randperm(nlist * pad, generator=g).reshape(nlist, pad).to(torch.int32)
    live = torch.rand((nlist, pad), generator=g) < 0.7
    live[: nlist // 4, 3:] = False
    ids = torch.where(live, ids, -1)
    const = torch.randn((nlist, pad), generator=g) * 4.0
    qd = torch.randn((b, m, ksub), generator=g)
    if quantized:
        const, qd = torch.round(const * 8) / 8, torch.round(qd * 8) / 8
    const[torch.rand((nlist, pad), generator=g) < 0.1] = torch.inf
    probes = torch.stack([torch.randperm(nlist, generator=g)[:nprobe] for _ in range(b)])
    pc = torch.rand((b, nprobe), generator=g) * 50.0
    if quantized:
        pc = torch.round(pc)
    return tuple(t.to(device).contiguous() for t in
                 (probes.to(torch.int32), pc, qd, codes, const, ids))


LAYOUTS = [(8, 256, False), (96, 256, False), (8, 16, True), (96, 16, True), (6, 64, False),
           (256, 256, False)]                 # the last table (256 KB) stays in global memory


@pytest.mark.parametrize("m,ksub,packed", LAYOUTS)
@pytest.mark.parametrize("k", [1, 10, 256, 1000])
@pytest.mark.parametrize("quantized", [False, True])
def test_select_matches_plain(cuda, m, ksub, packed, k, quantized):
    ops = _operands(cuda, m=m, ksub=ksub, packed=packed, seed=k + m, quantized=quantized)
    before = adc_cuda.adc_scan_select.launches
    kd, ki = adc_cuda.adc_scan_select(*ops, k, packed=packed)
    assert adc_cuda.adc_scan_select.launches == before + 1
    pd, pi = adc.adc_select_plain(*ops, k, packed=packed)
    torch.cuda.synchronize()
    assert kd.shape == (ops[0].shape[0], k) and ki.dtype == torch.int32
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


@pytest.mark.parametrize("m,ksub,packed", LAYOUTS)
@pytest.mark.parametrize("qpb", [1, 8, 5])
@pytest.mark.parametrize("kind", ["none", "true", "zero", "stale", "cut"])
@pytest.mark.parametrize("pad", [300, 128])
def test_dense_matches_plain(cuda, m, ksub, packed, qpb, kind, pad):
    """Every layout (packed codes, a table in global memory), every qpb
    the wrapper counts, and marks: none, true (lists ending at pad among
    them), some lists at 0, all at pad, or cutting live rows. Masked rows
    (+inf constants) below the marks keep their real ids; the slots past a
    mark come back (+inf, -1). pad 128 loads code tiles with cp.async, pad
    300 with the plain loader."""
    ops = _operands(cuda, m=m, ksub=ksub, packed=packed, pad=pad, seed=qpb + m + pad)
    hwm = _hwm(kind, ops[5], cuda, seed=m + qpb)
    before = dict(adc_cuda.adc_scan_dense.launches_by_qpb)
    kd, ki = adc_cuda.adc_scan_dense(*ops, packed=packed, qpb=qpb, hwm=hwm)
    assert adc_cuda.adc_scan_dense.launches_by_qpb[qpb] == before.get(qpb, 0) + 1
    pd, pi = adc.adc_dense_plain(*ops, packed=packed, hwm=hwm)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    probes = ops[0].long()
    marks = torch.full_like(probes, pad) if hwm is None else hwm.long()[probes]   # (B, nprobe)
    below = torch.arange(pad, device=cuda) < marks[..., None]
    ki3, kd3 = ki.reshape(*ops[0].shape, pad), kd.reshape(*ops[0].shape, pad)
    assert bool((ki3[~below] == -1).all()) and bool(torch.isinf(kd3[~below]).all())
    assert bool((torch.isinf(kd3) & (ki3 >= 0) & below).any())         # masked, real ids
    if kind == "true":
        assert bool((hwm == pad).any()) and bool((hwm < pad).any())
    if kind == "zero":
        assert bool((hwm == 0).any())


@pytest.mark.parametrize("m,ksub,packed", [(96, 256, False), (8, 16, True), (256, 256, False)])
@pytest.mark.parametrize("groups", [None, 1, 3, 7])
@pytest.mark.parametrize("kind", ["true", "cut"])
def test_dense_groups_bit_equal(cuda, m, ksub, packed, groups, kind):
    """Any probe grouping of the dense kernel's grid (7 probes: 3 groups
    of 3, 3, 1) gives the plain version's bits."""
    ops = _operands(cuda, m=m, ksub=ksub, packed=packed, pad=128, nprobe=7, b=21, seed=m + 1)
    hwm = _hwm(kind, ops[5], cuda, seed=m)
    kd, ki = adc_cuda.adc_scan_dense(*ops, packed=packed, qpb=8, hwm=hwm, _groups=groups)
    pd, pi = adc.adc_dense_plain(*ops, packed=packed, hwm=hwm)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_dense_plan_fills_the_card(cuda):
    """At the 1M path's shape (B = 128, nprobe 16, m = 96, ksub 256) the
    dense grid holds at least two blocks per SM resident."""
    plan = adc_cuda.dense_plan(128, 16, 96, 256, False, cuda)
    assert plan["blocks_per_sm"] >= 2 and plan["blocks"] >= 2 * plan["sms"]


def test_planted_ties_follow_probe_order(cuda):
    """Every list holds the same codes and constants: the estimates of a
    slot tie across all probes, and the select kernel keeps them in probe
    order (not id order), as the plain version and the Pallas kernel do."""
    m, ksub, nlist, pad, b, nprobe = 8, 256, 10, 40, 5, 6
    g = torch.Generator(device="cpu").manual_seed(1)
    row = torch.randint(0, ksub, (1, m, pad), generator=g, dtype=torch.uint8)
    codes = row.repeat(nlist, 1, 1).contiguous()
    const = (torch.arange(pad, dtype=torch.float32) % 4)[None, :].repeat(nlist, 1)
    ids = torch.randperm(nlist * pad, generator=g).reshape(nlist, pad).to(torch.int32)
    qd = torch.round(torch.randn((b, m, ksub), generator=g) * 4) / 4
    probes = torch.stack([torch.randperm(nlist, generator=g)[:nprobe] for _ in range(b)])
    pc = torch.full((b, nprobe), 10.0)
    ops = tuple(t.to(cuda).contiguous() for t in
                (probes.to(torch.int32), pc, qd, codes, const, ids))
    kd, ki = adc_cuda.adc_scan_select(*ops, 25, packed=False)
    pd, pi = adc.adc_select_plain(*ops, 25, packed=False)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    # Every list scores alike, so the best value's slots come probe by
    # probe, in slot order inside each probe.
    d2, _ = adc.adc_dense_plain(*(t.cpu() for t in ops), packed=False)
    for r in range(b):
        first = d2[r, :pad]
        slots = torch.nonzero(first == first.min()).flatten().tolist()
        want = [int(ids[probes[r, p], s]) for p in range(nprobe) for s in slots][:25]
        assert ki[r, : len(want)].tolist() == want


def test_kernels_reject_bad_operands(cuda):
    ops = _operands(cuda, m=8, ksub=256, packed=False)
    s0, d0 = adc_cuda.adc_scan_select.launches, adc_cuda.adc_scan_dense.launches
    probes, pc, qd, codes, const, ids = ops
    with pytest.raises(ValueError):
        adc_cuda.adc_scan_select(probes, pc, qd, codes, const, ids, 5, packed=True)
    with pytest.raises(TypeError):
        adc_cuda.adc_scan_dense(probes.long(), pc, qd, codes, const, ids, packed=False)
    with pytest.raises(ValueError):
        adc_cuda.adc_scan_dense(probes, pc, qd, codes, const.cpu(), ids, packed=False)
    with pytest.raises(ValueError):
        adc_cuda.adc_scan_select(probes, pc, qd[:, :, ::2], codes, const, ids, 5, packed=False)
    with pytest.raises(ValueError):
        adc_cuda.adc_scan_dense(probes, pc, qd, codes, const, ids, packed=False, qpb=0)
    with pytest.raises(ValueError):
        adc_cuda.adc_scan_dense(probes, pc, qd, codes, const, ids, packed=False,
                                hwm=torch.zeros(ids.shape[0], dtype=torch.int64, device=cuda))
    assert (adc_cuda.adc_scan_select.launches, adc_cuda.adc_scan_dense.launches) == (s0, d0)


def _corpus(n, d, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((16, d)).astype(np.float32) * 3.0
    return (c[rng.integers(0, 16, n)] + rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("kw", [{}, {"ksub": 16}, {"refine": False}, {"refine_factor": 40},
                                {"opq": True, "opq_iters": 2}])
@pytest.mark.parametrize("masked", [False, True])
def test_index_on_card_matches_cpu(cuda, kw, masked):
    """The same host-mode index (one state) on the card and on the CPU, both
    on the card route (the CPU copy through the plain versions), with a tail
    of rows added after staging."""
    x = _corpus(3000, 64, seed=2)
    ids = np.arange(0, 6000, 2, dtype=np.int64)
    base = IVFPQIndex(dim=64, nlist=32, nprobe=6, m=8, device="cpu", **kw)
    base.train(x)
    base.add(x, ids)
    params, arrays = base.state()
    gpu = IVFPQIndex.from_state(params, arrays, device=cuda)
    cpu = IVFPQIndex.from_state(params, arrays, device="cpu")
    q = (x[:40] + 0.05).astype(np.float32)
    mask = np.random.default_rng(3).random(7000) < 0.5 if masked else None
    for index in (gpu, cpu):
        index.search(q, 5)
        index.add(x[:300] + 0.02, np.arange(6001, 6601, 2))
    sel, den = adc_cuda.adc_scan_select.launches, adc_cuda.adc_scan_dense.launches
    gd, gi = gpu.search(q, 10, id_mask=mask)
    assert (adc_cuda.adc_scan_select.launches - sel) + (adc_cuda.adc_scan_dense.launches
                                                        - den) == 1
    cd, ci = cpu._search(q, 10, id_mask=mask, card_route=True)
    if gpu.refine:
        same_up_to_ties(cd, ci, gd, gi)
    else:
        # Pure ADC: the estimate cancels terms of size q_sq + c_sq.
        c_sq = cpu._stage()[1].numpy()
        atol = 2e-6 * float((q * q).sum(1).max() + c_sq.max())
        same_up_to_ties(cd, ci, gd, gi, atol=atol)


def test_device_mode_build_on_card(cuda):
    """Device mode on the card: train, encode, stage and search; two
    trainings give bit-identical codebooks."""
    x = torch.from_numpy(_corpus(4000, 64, seed=4)).to(cuda)
    a = IVFPQIndex(dim=64, nlist=32, nprobe=8, m=8, device=cuda)
    a.train(x)
    b = IVFPQIndex(dim=64, nlist=32, nprobe=8, m=8, device=cuda)
    b.train(x)
    assert torch.equal(a._codebooks, b._codebooks) and torch.equal(a._centroids, b._centroids)
    a.add(x, torch.arange(4000, dtype=torch.int32, device=cuda))
    d, i = a.search(x[:16].cpu().numpy(), 5)
    assert (i[:, 0] == np.arange(16)).all() and np.all(np.diff(d, axis=1) >= 0)
    assert a._staged[3] is None                     # no unpacked codes on the card route
    assert a.remove_ids(np.arange(8)) == 8
    d, i = a.search(x[:16].cpu().numpy(), 5)
    assert not np.isin(i, np.arange(8)).any()


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


@pytest.mark.parametrize("m,ksub,packed", [(8, 256, False), (96, 256, False), (8, 16, True),
                                           (256, 256, False)])
@pytest.mark.parametrize("pad", [300, 128])
@pytest.mark.parametrize("groups", [None, 1, 3, 7])
@pytest.mark.parametrize("kind", ["none", "true", "stale", "zero", "cut"])
def test_select_groups_and_hwm_bit_equal(cuda, m, ksub, packed, pad, groups, kind):
    """Any probe grouping (7 probes: 3 groups of 3, 3, 1) and any marks:
    bit-equal to the plain version, ties (quantized estimates) included.
    pad 128 loads code tiles with cp.async, pad 300 with the plain loader."""
    ops = _operands(cuda, m=m, ksub=ksub, packed=packed, pad=pad, nprobe=7, b=21,
                    seed=m + pad, quantized=True)
    hwm = _hwm(kind, ops[5], cuda, seed=m)
    before = adc_cuda.adc_scan_select.launches
    kd, ki = adc_cuda.adc_scan_select(*ops, 40, packed=packed, hwm=hwm, _groups=groups)
    assert adc_cuda.adc_scan_select.launches == before + 1
    pd, pi = adc.adc_select_plain(*ops, 40, packed=packed, hwm=hwm)
    torch.cuda.synchronize()
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def _planted(device, k, nlist=8, pad=48, seed=0):
    """A zero table and zero coarse distances, so each estimate is its
    row's constant: integer constants (many exact ties), padding, masked
    rows; k - 1 rows of query 0 at 1..k-1 and, tied at the k-th place, id
    900 in the list probed first and id 5 in the list probed last."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    m, ksub = 8, 256
    codes = torch.randint(0, ksub, (nlist, m, pad), generator=g, dtype=torch.uint8)
    ids = (torch.randperm(nlist * pad, generator=g) + 1000).reshape(nlist, pad).to(torch.int32)
    ids[torch.rand((nlist, pad), generator=g) < 0.2] = -1
    const = torch.randint(k + 1, k + 8, (nlist, pad), generator=g).to(torch.float32)
    const[torch.rand((nlist, pad), generator=g) < 0.1] = torch.inf
    probes = torch.stack([torch.randperm(nlist, generator=g) for _ in range(3)]).to(torch.int32)
    for r in range(k - 1):                      # query 0's k - 1 nearest
        lst = int(probes[0, r % nlist])
        const[lst, 1 + r // nlist], ids[lst, 1 + r // nlist] = r + 1, 100 + r
    first, last = int(probes[0, 0]), int(probes[0, -1])
    const[first, 0], ids[first, 0] = k, 900
    const[last, 0], ids[last, 0] = k, 5
    return tuple(t.to(device).contiguous() for t in
                 (probes, torch.zeros((3, nlist)), torch.zeros((3, m, ksub)), codes, const, ids))


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("k", [5, 40])
def test_select_kth_tie_across_groups_earlier_probe_wins(cuda, groups, k):
    """At the k-th place a tie between id 900 (first probe, first group)
    and id 5 (last probe, last group): the earlier probe wins, as in the
    single pass; every grouping gives the plain version's bits."""
    ops = _planted(cuda, k)
    kd, ki = adc_cuda.adc_scan_select(*ops, k, packed=False, _groups=groups)
    pd, pi = adc.adc_select_plain(*ops, k, packed=False)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    assert int(ki[0, k - 1]) == 900 and float(kd[0, k - 1]) == k


@pytest.mark.parametrize("groups", [None, 2, 16])
def test_select_nprobe_one_and_deep_k(cuda, groups):
    """nprobe = 1 (one group whatever is asked), and k = 1000 (lists in
    global scratch) over 16 probes with true marks."""
    ops = _operands(cuda, m=8, ksub=256, packed=False, nprobe=1, seed=3)
    kd, ki = adc_cuda.adc_scan_select(*ops, 10, packed=False, _groups=groups)
    pd, pi = adc.adc_select_plain(*ops, 10, packed=False)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)
    ops = _operands(cuda, m=8, ksub=256, packed=False, nprobe=16, pad=128, seed=4)
    hwm = _hwm("true", ops[5], cuda)
    kd, ki = adc_cuda.adc_scan_select(*ops, 1000, packed=False, hwm=hwm, _groups=groups)
    pd, pi = adc.adc_select_plain(*ops, 1000, packed=False, hwm=hwm)
    assert torch.equal(kd, pd) and torch.equal(ki, pi)


def test_select_plan_puts_two_blocks_on_every_sm(cuda):
    """At the 1M path's shape (B = 128, nprobe 16, m = 96, ksub 256, k =
    200) the grid holds at least two blocks per SM."""
    plan = adc_cuda.select_plan(128, 16, 96, 256, False, 200, cuda)
    assert plan["blocks_per_sm"] >= 2 and plan["blocks"] >= 2 * plan["sms"]
