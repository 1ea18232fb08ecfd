"""PyTorch port on the card: the three hand-written IVF list-scan kernels
(csrc/ivf_scan.cu) against their plain versions, and IVFFlatIndex on CUDA
against the same index on the CPU.

Every test here is marked `cuda` and skips without a card (the kernels have
no CPU mode). This file imports neither jax nor the JAX package:

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

from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex
from c99_vectordb_tpu_torch.ops import ivf_scan, ivf_scan_cuda
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
