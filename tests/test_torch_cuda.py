"""PyTorch port on the card: the hand-written fused L2 top-k kernel against
its plain version (every mode, int8 codes with bf16 queries included), and
FlatIndex, embedding and MemoDB on CUDA against the
same calls on the CPU.

Every test here is marked `cuda` and skips without a card (the kernel has
no CPU mode). This file imports neither jax nor the JAX package, so it runs
where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: int8 keys bit-equal (both sides round the product, then the
sum); f32/bf16 keys within 1e-4 relative (another summation order), with
positions equal except inside groups of keys tied within that tolerance.
Index and API fixtures are integer-valued or hash embeddings, so their
distances are exact in f32 on both devices."""

import functools
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.api import MemoDB
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.ops import topk_cuda
from c99_vectordb_tpu_torch.ops.embed import embed_texts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode (run on the card)")
    return torch.device("cuda", 0)


def same_up_to_ties(want_k, want_p, got_k, got_p, tol):
    np.testing.assert_allclose(got_k, want_k, rtol=tol, atol=tol)
    for r in range(want_k.shape[0]):
        k, s = want_k.shape[1], 0
        while s < k:
            e = s + 1
            while e < k and (want_k[r, e] == want_k[r, s] or abs(
                    want_k[r, e] - want_k[r, s]) <= tol * max(1.0, abs(want_k[r, s]))):
                e += 1
            if e < k:
                assert sorted(got_p[r, s:e]) == sorted(want_p[r, s:e]), (r, s, e)
            s = e


def _store(dtype, n, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device)
    if dtype == "int8":
        scale = x.abs().amax(0) / 127.0
        codes = torch.clamp(torch.round(x / scale), -127, 127)
        dec = codes * scale
        return codes.to(torch.int8).contiguous(), (dec * dec).sum(1), scale
    return x.to(getattr(torch, dtype)).contiguous(), (x * x).sum(1), None


# k: 128 / 129 straddle the shared-memory / global list boundary; b = 129
# leaves a ragged query tile; d = 392 a partial last feature chunk.
KS = [1, 20, 128, 129, 200, 1024]
BS = [1, 70, 129]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("b", BS)
@pytest.mark.parametrize("d", [384, 392])
def test_kernel_matches_plain(cuda, dtype, k, b, d):
    n = 8192 + 37                               # ragged last row tile
    db, norms, scale = _store(dtype, n, d, cuda, seed=k + b + d)
    g = torch.Generator(device=cuda).manual_seed(3)
    norms[torch.randperm(n, generator=g, device=cuda)[: n // 4]] = torch.inf
    q = torch.randn((b, d), generator=g, device=cuda)
    q_st, rs = topk_cuda.stage_queries(q if scale is None else q * scale, db.dtype)
    before = topk_cuda.fused_l2_topk.launches
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, k, rs)
    assert topk_cuda.fused_l2_topk.launches == before + 1
    pk, pp = topk_cuda.select_plain(q_st, db, norms, k, rs)
    torch.cuda.synchronize()
    assert kk.shape == (b, k) and kp.dtype == torch.int32
    if dtype == "int8":
        assert torch.equal(kk, pk) and torch.equal(kp, pp)
    else:
        same_up_to_ties(pk.cpu().numpy(), pp.cpu().numpy(), kk.cpu().numpy(),
                        kp.cpu().numpy(), 1e-4)


@pytest.mark.parametrize("k", [20, 200])
@pytest.mark.parametrize("b", [1, 63, 65, 1024])
@pytest.mark.parametrize("d", [384, 768, 392, 44])
def test_int8_tensor_core_keys_bit_equal(cuda, d, b, k):
    """Mode 2 (int8 queries x int8 codes, s8 mma.sync): keys and positions
    bit-equal to the plain version at D = 384 and 768 (16-byte rows,
    cp.async) and 392 and 44 (multiples of 4, not of 16: the plain
    loader), around the 64-query tile (63, 65) and at B = 1024, with lists
    in shared memory (k = 20) and in global memory (k = 200 >
    SMEM_LIST_MAX). A run of duplicate rows ties exactly (lowest positions
    first) and a quarter of the norms are +inf (never selected)."""
    n = 8192 + 37
    db, norms, scale = _store("int8", n, d, cuda, seed=d + b + k)
    db[1000:1300] = db[17]
    norms[1000:1300] = norms[17]
    g = torch.Generator(device=cuda).manual_seed(d + k)
    norms[torch.randperm(n, generator=g, device=cuda)[: n // 4]] = torch.inf
    q = torch.randn((b, d), generator=g, device=cuda) * scale
    q[: b // 2] = db[17].float() * scale          # half the queries sit on the duplicates
    q_st, rs = topk_cuda.stage_queries(q, db.dtype)
    before = topk_cuda.fused_l2_topk.launches_by_mode["int8"]
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, k, rs)
    assert topk_cuda.fused_l2_topk.launches_by_mode["int8"] == before + 1
    pk, pp = topk_cuda.select_plain(q_st, db, norms, k, rs)
    torch.cuda.synchronize()
    assert torch.equal(kk, pk) and torch.equal(kp, pp)
    assert bool(torch.isfinite(kk).all())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("b", BS)
@pytest.mark.parametrize("d", [384, 392])
def test_kernel_bf16_queries_on_int8_store_matches_plain(cuda, k, b, d):
    """The q_int8=False mode: int8 codes decoded to bf16 against bf16
    queries, f32 accumulation (another summation order than the plain
    matmul: 1e-4). d = 392 rows are not 16-byte aligned (plain loader)."""
    n = 8192 + 37
    db, norms, scale = _store("int8", n, d, cuda, seed=k + b + d + 1)
    g = torch.Generator(device=cuda).manual_seed(5)
    norms[torch.randperm(n, generator=g, device=cuda)[: n // 4]] = torch.inf
    q = torch.randn((b, d), generator=g, device=cuda) * scale
    q_st, rs = topk_cuda.stage_queries(q, db.dtype, q_int8=False)
    assert q_st.dtype == torch.bfloat16 and rs is None
    before = dict(topk_cuda.fused_l2_topk.launches_by_mode)
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, k)
    assert topk_cuda.fused_l2_topk.launches_by_mode["int8_bf16q"] == before["int8_bf16q"] + 1
    pk, pp = topk_cuda.select_plain(q_st, db, norms, k)
    torch.cuda.synchronize()
    same_up_to_ties(pk.cpu().numpy(), pp.cpu().numpy(), kk.cpu().numpy(), kp.cpu().numpy(), 1e-4)
    # Through the fused_topk contract, on integer codes and queries: exact.
    rng = np.random.default_rng(k)
    codes = torch.from_numpy(rng.integers(-3, 4, (3000, 64)).astype(np.int8)).to(cuda)
    cn = (codes.float() ** 2).sum(1)
    qi = torch.from_numpy(rng.integers(-3, 4, (b, 64)).astype(np.float32)).to(cuda)
    ids = torch.arange(3000, dtype=torch.int32, device=cuda)
    kk = min(k, 3000)
    got = topk_cuda.fused_topk(codes, ids, cn, qi, kk, q_int8=False)
    want = topk_cuda.fused_topk_reference(codes, ids, cn, qi, kk, q_int8=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8_bf16q"])
@pytest.mark.parametrize("d", [21, 40, 1600])
@pytest.mark.parametrize("k", [50, 129])
def test_kernel_odd_width_and_exact_ties(cuda, dtype, d, k):
    """D not a multiple of the kernel's slice (21: rows not 16-byte aligned;
    40: aligned bf16 rows, unaligned int8 rows; 1600: queries too wide to
    stay resident in shared memory); integer rows with many exact ties must
    come back in position order, exactly as the plain version."""
    g = np.random.default_rng(4 + d)
    db = torch.from_numpy(g.integers(-2, 3, (3000, d)).astype(np.float32)).to(cuda)
    norms = (db * db).sum(1)
    q = torch.from_numpy(g.integers(-2, 3, (9, d)).astype(np.float32)).to(cuda)
    store = torch.int8 if dtype == "int8_bf16q" else getattr(torch, dtype)
    q_st, _ = topk_cuda.stage_queries(q, store, q_int8=False)
    db = db.to(store)
    before = topk_cuda.fused_l2_topk.launches_by_mode[dtype]
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, k)
    assert topk_cuda.fused_l2_topk.launches_by_mode[dtype] == before + 1
    pk, pp = topk_cuda.select_plain(q_st, db, norms, k)
    assert torch.equal(kk, pk) and torch.equal(kp, pp)


REL_TOL = 1e-4   # chip_smoke.REL_TOL: |key diff| <= REL_TOL * max(|key|, 1)


def _tf32_hazard_operands(case, n, b, seed):
    """Seeded (store, queries) for the f32 mode's 3xTF32 products:
    unit_norm: MemoDB's regime, unit rows and queries around 1,024 shared
    centres (about 8 rows each), so the selected keys (1 - 2 cos) run from
    about -1 to 1 and cross 0;
    mixed_magnitudes: elements of 1e-3 to 1e3 within every row and query,
    where keys come from large products that cancel;
    wide_768: Gaussian at D = 768, twice the ring stages of D = 384 per
    tile (the staged queries stream through the ring beside the store, as
    at every width)."""
    rng = np.random.default_rng(seed)
    d = 768 if case == "wide_768" else 384
    if case == "unit_norm":
        centres = rng.standard_normal((1024, d))
        spread = rng.uniform(0.05, 2.0, (n, 1))
        x = centres[rng.integers(0, 1024, n)] + spread * rng.standard_normal((n, d))
        q = centres[rng.integers(0, 1024, b)] + 0.3 * rng.standard_normal((b, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    elif case == "mixed_magnitudes":
        x = rng.standard_normal((n, d)) * 10.0 ** rng.uniform(-3, 3, (n, d))
        q = rng.standard_normal((b, d)) * 10.0 ** rng.uniform(-3, 3, (b, d))
    else:
        x = rng.standard_normal((n, d))
        q = rng.standard_normal((b, d))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("case", ["unit_norm", "mixed_magnitudes", "wide_768"])
def test_f32_tensor_core_keys_within_rel_tol(cuda, case):
    """The f32 mode's keys (3xTF32 on the tensor cores) against the plain
    f32 version, |diff| <= REL_TOL * max(|key|, 1), with positions equal
    except inside groups of keys tied within that tolerance."""
    n, b, k = 8192 + 37, 129, 20
    x, q = _tf32_hazard_operands(case, n, b, seed=len(case))
    db = torch.from_numpy(x).to(cuda)
    norms = (db * db).sum(1)
    q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q).to(cuda), db.dtype)
    before = topk_cuda.fused_l2_topk.launches_by_mode["float32"]
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, k)
    assert topk_cuda.fused_l2_topk.launches_by_mode["float32"] == before + 1
    pk, pp = topk_cuda.select_plain(q_st, db, norms, k)
    torch.cuda.synchronize()
    if case == "unit_norm":
        assert float(pk.min()) < 0.0 < float(pk.max())
    want, got = pk.cpu().numpy(), kk.cpu().numpy()
    assert np.all(np.abs(got - want) <= REL_TOL * np.maximum(np.abs(want), 1.0))
    same_up_to_ties(want, pp.cpu().numpy(), got, kp.cpu().numpy(), REL_TOL)


F32_BS = [1, 63, 64, 65, 127, 128, 129, 200, 1024]


def _check_f32(q_st, db, norms, k):
    """One f32 launch against the plain version: keys within REL_TOL
    (relative, at least 1), positions equal except inside groups of keys
    tied within it, unfilled slots (inf, INT32_MAX) exactly where the plain
    version has them. Returns the launch's (keys, positions)."""
    before = topk_cuda.fused_l2_topk.launches_by_mode["float32"]
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, k)
    assert topk_cuda.fused_l2_topk.launches_by_mode["float32"] == before + 1
    pk, pp = topk_cuda.select_plain(q_st, db, norms, k)
    torch.cuda.synchronize()
    assert kk.shape == (q_st.shape[0], k) and kp.dtype == torch.int32
    want, got = pk.cpu().numpy(), kk.cpu().numpy()
    empty = np.isinf(want)
    np.testing.assert_array_equal(np.isinf(got), empty)
    assert bool((kp.cpu().numpy()[empty] == 2**31 - 1).all())
    assert np.all(np.abs(got[~empty] - want[~empty])
                  <= REL_TOL * np.maximum(np.abs(want[~empty]), 1.0))
    same_up_to_ties(want, pp.cpu().numpy(), got, kp.cpu().numpy(), REL_TOL)
    return kk, kp


@pytest.mark.parametrize("k", [1, 20, 128, 129, 200])
@pytest.mark.parametrize("n", [37, 8192 + 37])
@pytest.mark.parametrize("b", F32_BS)
def test_f32_query_tiles_match_plain(cuda, b, n, k):
    """The f32 mode's 128-row x N-query tiles: B around and across 64 (where
    one wgmma group a k step becomes two) and the 128-query tile, N below
    one row tile and off every tile multiple, k from 1 to past the register
    lists (32) and the shared-memory lists;
    a quarter of the rows masked (+inf norms) and a run of duplicate rows
    (exact ties, lowest positions first)."""
    rng = np.random.default_rng(b * 7 + n + k)
    x = rng.standard_normal((n, 384)).astype(np.float32)
    x[n // 2:n // 2 + 9] = x[3]
    db = torch.from_numpy(x).to(cuda)
    norms = (db * db).sum(1)
    norms[torch.from_numpy(rng.permutation(n)[: n // 4]).to(cuda)] = torch.inf
    q = rng.standard_normal((b, 384)).astype(np.float32)
    q[::3] = x[3]
    q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q).to(cuda), db.dtype)
    _check_f32(q_st, db, norms, k)


@pytest.mark.parametrize("b", [128, 200, 1024])
@pytest.mark.parametrize("case", ["unit_norm", "wide_768"])
def test_f32_hazards_on_query_tiles(cuda, case, b):
    """test_f32_tensor_core_keys_within_rel_tol's operands at one whole
    128-query tile, two of 104, and eight of 128."""
    x, q = _tf32_hazard_operands(case, 8192 + 37, b, seed=len(case) + b)
    db = torch.from_numpy(x).to(cuda)
    q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q).to(cuda), db.dtype)
    _check_f32(q_st, db, (db * db).sum(1), 20)


@pytest.mark.parametrize("b", [1024])
def test_f32_mixed_magnitudes_on_query_tiles(cuda, b):
    """Elements of 1e-3 to 1e3 (test_f32_tensor_core_keys_within_rel_tol's
    mixed_magnitudes) on eight 128-query tiles: a fresh accumulator over
    two k steps (16 columns) failed it on the card; one per k step holds."""
    x, q = _tf32_hazard_operands("mixed_magnitudes", 8192 + 37, b, seed=16 + b)
    db = torch.from_numpy(x).to(cuda)
    q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q).to(cuda), db.dtype)
    _check_f32(q_st, db, (db * db).sum(1), 20)


F32_TERMS_ULP = 2.0 ** -20   # f32 rounding of the key's terms: about 8 of f32's 2**-23


@pytest.mark.parametrize("b", [128, 200])
def test_f32_mixed_magnitudes_known_deviation(cuda, b):
    """A known deviation: mixed magnitudes at B = 128 and 200 (seeds 144 and
    216), where one nearest key cancels from terms of about 2e7 (norm +
    sum |q_i x_i|) to about -2.6e3 and -3.6e3, and select_plain's own f32
    key lies farther than REL_TOL from the float64 one (1.4e-3 and 6.4e-4,
    on the CPU and on the card alike), so the check against select_plain
    cannot hold there. tools/f32_mixed_magnitudes.py prints these misses
    and PERF.md records them; on these operands the wgmma kernel picks the
    same positions as the earlier mma.sync one, its keys differing in the
    last bits (another summation order). The kernel is held against float64
    instead: each key within REL_TOL * max(|key|, 1) + F32_TERMS_ULP *
    (norm + sum |q_i x_i|) of its row's exact key, and its rows' exact keys
    within that of the exact k best, slot by slot."""
    x, q = _tf32_hazard_operands("mixed_magnitudes", 8192 + 37, b, seed=16 + b)
    db = torch.from_numpy(x).to(cuda)
    norms = (db * db).sum(1)
    q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q).to(cuda), db.dtype)
    before = topk_cuda.fused_l2_topk.launches_by_mode["float32"]
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, 20)
    assert topk_cuda.fused_l2_topk.launches_by_mode["float32"] == before + 1
    exact = norms.double()[None, :] + q_st.double() @ db.double().T
    terms = norms.double()[None, :] + q_st.double().abs() @ db.double().abs().T
    tol = REL_TOL * exact.abs().clamp_min(1.0) + F32_TERMS_ULP * terms
    rows = kp.long()
    got_exact = torch.gather(exact, 1, rows)
    assert bool(((kk.double() - got_exact).abs() <= torch.gather(tol, 1, rows)).all())
    best = torch.sort(exact, dim=1).values[:, :20]
    assert bool((got_exact <= best + torch.gather(tol, 1, rows)).all())


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [21, 44, 384, 392])
def test_f32_unaligned_and_odd_width(cuda, d, offset):
    """Store and queries whose base is one float past a 16-byte boundary
    (offset 1: the store takes the plain loader), and widths that leave a
    partial last 64-column chunk (21, 44, 392) or are not a multiple of 4
    (21: the plain loader at any base)."""
    rng = np.random.default_rng(d + offset)
    n, b = 5000, 129
    xs = torch.from_numpy(rng.standard_normal(n * d + offset).astype(np.float32)).to(cuda)
    db = xs[offset:].view(n, d)
    assert db.is_contiguous() and (db.data_ptr() % 16 == 0) == (offset == 0)
    qs = torch.from_numpy(rng.standard_normal(b * d + offset).astype(np.float32)).to(cuda)
    q_st = qs[offset:].view(b, d)
    _check_f32(q_st, db, (db * db).sum(1), 20)


# The f32 mode's wgmma pass at MemoDB's row count: D 100 (a partial last
# 16-column stage), 384 and 768; B from one query (query tile 8) through
# 7 (a padded tile), 128 (one tile) and 200 (two tiles of 104) to 1024
# (eight of 128); k 20 (register lists in shared memory), 128 (the edge of
# the shared-memory lists) and 200 (lists in the partial buffer).
F32_WG_D = [100, 384, 768]
F32_WG_B = [1, 7, 128, 200, 1024]
F32_WG_K = [20, 128, 200]


@pytest.mark.parametrize("k", F32_WG_K)
@pytest.mark.parametrize("b", F32_WG_B)
@pytest.mark.parametrize("d", F32_WG_D)
def test_f32_wgmma_tiles_at_131072_rows(cuda, d, b, k):
    """The f32 mode against select_plain at 131,072 rows, a quarter of them
    masked (+inf norms), a run of duplicate rows (exact ties), and the
    launch counted once under the query tile that launch_plan picks."""
    n = 131_072
    g = torch.Generator(device=cuda).manual_seed(d * 10_000 + b * 10 + k)
    db = torch.randn((n, d), generator=g, device=cuda)
    db[n // 2:n // 2 + 9] = db[3]
    norms = (db * db).sum(1)
    norms[torch.randperm(n, generator=g, device=cuda)[: n // 4]] = torch.inf
    q = torch.randn((b, d), generator=g, device=cuda)
    q[::3] = db[3]
    q_st, _ = topk_cuda.stage_queries(q, db.dtype)
    q_tile = topk_cuda.launch_plan(b, n, k, 132, 1, 128, 128, 128, q_step=8)["q_tile"]
    before = dict(topk_cuda.fused_l2_topk.launches_by_qtile)
    _check_f32(q_st, db, norms, k)
    after = topk_cuda.fused_l2_topk.launches_by_qtile
    assert {t: after[t] - before[t] for t in after if after[t] != before[t]} == {q_tile: 1}


@pytest.mark.parametrize("d", [21, 100, 768])
@pytest.mark.parametrize("b", [1, 7, 200])
def test_f32_staging_equals_plain(cuda, b, d):
    """The f32 mode's query staging kernel (hi and lo parts as wgmma's B
    operands) bit for bit against stage_f32_plain, at the query tile that
    launch_plan picks."""
    g = torch.Generator(device=cuda).manual_seed(b * 100 + d)
    q = torch.randn((b, d), generator=g, device=cuda) * 10.0 ** torch.empty(
        (b, d), device=cuda).uniform_(-3, 3, generator=g)
    q_st, _ = topk_cuda.stage_queries(q, torch.float32)
    q_tile = topk_cuda.launch_plan(b, 1 << 20, 20, 132, 1, 128, 128, 128, q_step=8)["q_tile"]
    got = topk_cuda.stage_f32(q_st, q_tile)
    want = topk_cuda.stage_f32_plain(q_st, q_tile)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (topk_cuda.f32_stage_floats(b, d, q_tile),)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# The f32 mode's screen (csrc/fused_l2_topk.cu screen_any, screen_write):
# its keys are held against the lists' last keys in the accumulators, and
# only the survivors reach the selection. Digests of the outputs that the kernel
# gave on these operands before it had the screen (NVIDIA H100 80GB HBM3),
# keyed "order-k<k>-b<b>": SHA-256 of the keys' then the positions' bytes.
SCREEN_DIGESTS = Path(__file__).with_name("data") / "f32_screen_outputs.json"
SCREEN_N, SCREEN_D = 1_000_003, 96


@functools.lru_cache(maxsize=3)
def _screen_store(order, device):
    """A long store (one split of B <= 128 is 61 tiles) of D = 96 whose keys,
    for every query of _screen_queries, come in ascending order of position
    (the norms climb by 1e-3 a row, the products stay below 1e-4: after a
    split's first tile no key passes), in descending order (every key
    passes: the screen's worst case), or repeat with a period of 1,000
    rows (equal keys within and across tiles)."""
    rng = np.random.default_rng(96)
    n, d = SCREEN_N, SCREEN_D
    if order == "duplicates":
        x = rng.standard_normal((1000, d)).astype(np.float32)[np.arange(n) % 1000]
        db = torch.from_numpy(x).to(device)
        return db, (db * db).sum(1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    ramp = (1e-3 * np.arange(n)).astype(np.float32)
    norms = ramp if order == "ascending" else ramp[::-1].copy()
    return torch.from_numpy(x).to(device), torch.from_numpy(norms).to(device)


def _screen_queries(order, b, device):
    rng = np.random.default_rng(b)
    q = rng.standard_normal((b, SCREEN_D)).astype(np.float32)
    if order != "duplicates":
        q *= np.float32(1e-6)
    q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q).to(device), torch.float32)
    return q_st


def _digest(kk, kp):
    return hashlib.sha256(kk.cpu().numpy().tobytes() + kp.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("b", [1, 8, 128, 200])
@pytest.mark.parametrize("k", [1, 20, 32, 33])
@pytest.mark.parametrize("order", ["ascending", "descending", "duplicates"])
def test_f32_screen_matches_plain_and_earlier_outputs(cuda, order, k, b):
    """The f32 mode with its screen against the plain version (_check_f32)
    and, bit for bit, against the outputs of the kernel that selected from
    every key (SCREEN_DIGESTS): rows in ascending key order (nothing passes
    after a split's first tile), in descending order (every key passes),
    and repeated rows (exact ties across tiles, lowest position first); k
    from 1 through 32 (lists in registers) to 33 (warp_insert); B = 1 and
    8 (query tile 8), 128 (one tile) and 200 (two of 104)."""
    db, norms = _screen_store(order, cuda)
    kk, kp = _check_f32(_screen_queries(order, b, cuda), db, norms, k)
    if order != "duplicates":
        first = np.arange(k) if order == "ascending" else SCREEN_N - 1 - np.arange(k)
        assert (kp.cpu().numpy() == first[None, :]).all()
    want = json.loads(SCREEN_DIGESTS.read_text())[f"{order}-k{k}-b{b}"]
    assert _digest(kk, kp) == want


def test_f32_memodb_shape(cuda):
    """MemoDB's own scan: 131,072 rows x 384 of unit vectors around shared
    centres (keys cross 0), B = 128, k_scan = 20."""
    rng = np.random.default_rng(131)
    n, d, b = 131_072, 384, 128
    centres = rng.standard_normal((4096, d))
    x = centres[rng.integers(0, 4096, n)] + rng.uniform(0.05, 2.0, (n, 1)) * rng.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, b)] + 0.1 * rng.standard_normal((b, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db = torch.from_numpy(x.astype(np.float32)).to(cuda)
    q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q.astype(np.float32)).to(cuda), db.dtype)
    _check_f32(q_st, db, (db * db).sum(1), 20)


def test_kernel_rejects_bad_operands(cuda):
    db, norms, _ = _store("float32", 1024, 64, cuda, seed=1)
    q = torch.randn((4, 64), device=cuda)
    before = topk_cuda.fused_l2_topk.launches
    with pytest.raises(TypeError):
        topk_cuda.fused_l2_topk(q.to(torch.bfloat16), db, norms, 5)
    with pytest.raises(ValueError):
        topk_cuda.fused_l2_topk(q[:, ::2], db[:, ::2], norms, 5)      # not contiguous
    with pytest.raises(ValueError):
        topk_cuda.fused_l2_topk(q, db, norms.cpu(), 5)                # mixed devices
    with pytest.raises(TypeError):
        topk_cuda.fused_l2_topk(q, db, norms.double(), 5)
    i8 = torch.zeros((1024, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        topk_cuda.fused_l2_topk(torch.zeros((4, 64), dtype=torch.int8, device=cuda), i8, norms, 5)
    with pytest.raises(ValueError):
        topk_cuda.fused_l2_topk(torch.zeros((4, 62), dtype=torch.int8, device=cuda),
                                i8[:, :62].contiguous(), norms, 5, torch.ones(4, device=cuda))
    assert topk_cuda.fused_l2_topk.launches == before


def _corpus(n, seed, d=32):
    """Integer rows with many exact ties. Row 0 holds 127 in every
    dimension and every query holds 127 in dimension 0, so the SQ8 scale is
    exactly 1 and the int8 query scale exactly 2: the int8 scan's keys are
    exact too, and all three scan stores must equal the CPU result."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    x[0] = 127.0
    ids = np.sort(rng.permutation(2 * n)[:n]).astype(np.int64)
    q = rng.integers(-3, 4, (40, d)).astype(np.float32)
    q[:, 0] = 127.0
    mask = rng.random(2 * n + 3) < 0.2
    return x, ids, q, mask


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,k", [(3000, 10), (3000, 600), (300, 10)])
@pytest.mark.parametrize("masked", [False, True, "sparse"])
def test_flat_on_card_matches_cpu(cuda, scan_dtype, n, k, masked):
    """Kernel route (n=3000, k=10), deep-shortlist route (k_scan > 1024)
    and small-store route (cap < 1024), each against the CPU index.
    masked="sparse" keeps at most 1/64 of the padded store: the kernel
    route scans its compacted rows, the other two its full-store operands."""
    x, ids, q, mask = _corpus(n, seed=n + k)
    if masked == "sparse":
        mask = np.zeros_like(mask)
        mask[ids[:: n // 50]] = True
    on_card = FlatIndex(dim=32, scan_dtype=scan_dtype, device=cuda)
    on_cpu = FlatIndex(dim=32, scan_dtype=scan_dtype, device="cpu")
    on_card.add(torch.from_numpy(x).to(cuda), ids)
    on_cpu.add(x, ids)
    kw = {"id_mask": mask} if masked else {}
    before = topk_cuda.fused_l2_topk.launches
    gd, gi = on_card.search(q, k, **kw)
    launched = topk_cuda.fused_l2_topk.launches - before
    assert launched == (1 if n == 3000 and k == 10 else 0)
    cd, ci = on_cpu.search(q, k, **kw)
    np.testing.assert_array_equal(gi, ci)
    np.testing.assert_array_equal(gd, cd)


def test_ranking_and_embedding_on_card_match_cpu(cuda):
    x, ids, q, _ = _corpus(500, seed=9)
    on_card = FlatIndex(dim=32, device=cuda)
    on_cpu = FlatIndex(dim=32, device="cpu")
    on_card.add(x, ids)
    on_cpu.add(x, ids)
    for r in range(3):
        gd, gi = on_card.ranked_all(q[r])
        cd, ci = on_cpu.ranked_all(q[r])
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_array_equal(gd, cd)
    gd, gi, _ = on_card.ranked_many_device(q)
    cd, ci, _ = on_cpu.ranked_many_device(q)
    np.testing.assert_array_equal(gi.cpu().numpy(), ci.numpy())
    np.testing.assert_array_equal(gd.cpu().numpy(), cd.numpy())
    texts = ["alpha beta", "", "dup dup dup unique", "unicode üñîсö 中文", "x " * 300]
    np.testing.assert_array_equal(embed_texts(texts, device=cuda), embed_texts(texts, device="cpu"))


WORDS = ("tea coffee morning meeting project deadline budget review design kernel memory "
         "cache index vector search query filter record note user agent system").split()


def test_memodb_on_card_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(8)
    records = [{"body": " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), 6)),
                "metadata": {"source": ["user", "agent"][i % 2], "p": int(i % 5)}}
               for i in range(2000)]
    queries = [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), 3)) for _ in range(32)]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    card = MemoDB("notes", cwd=str(tmp_path / "a"), device=cuda)
    cpu = MemoDB("notes", cwd=str(tmp_path / "b"), device="cpu")

    def same(fn):
        a, b = fn(card), fn(cpu)
        if isinstance(a, list) and a and isinstance(a[0], list):
            for ha, hb in zip(a, b):
                assert len(ha) == len(hb)
                scores = {h.doc_id: h.score for h in hb}
                for x, y in zip(ha, hb):
                    assert abs(x.score - y.score) <= 1e-5
                    if x.doc_id != y.doc_id:
                        assert (x.doc_id in scores and abs(scores[x.doc_id] - x.score) <= 1e-5
                                ) or abs(x.score - hb[-1].score) <= 1e-5
        else:
            assert a == b
        for name in ("notes.yaml", "notes.memo"):
            assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
        return a

    same(lambda db: db.save_many(records))
    before = topk_cuda.fused_l2_topk.launches
    same(lambda db: db.recall_many(queries, k=10))
    assert topk_cuda.fused_l2_topk.launches > before
    same(lambda db: db.recall_many(queries, k=10, filter="{p: {$gte: 3}}"))
    same(lambda db: [db.recall(qs, k=5, filter="{source: user}", pushdown=True)
                     for qs in queries[:4]])
    same(lambda db: db.delete(17))
    same(lambda db: db.reindex())
    same(lambda db: db.recall_many(queries, k=10))
