"""PyTorch port on the card: the sharded flat index (parallel/sharded.py)
over the flat kernel (csrc/fused_l2_topk.cu), at W = 1 in this process and
at W = 1, 2 and 4 gloo ranks sharing cuda:0 (tests/torch_parallel_worker.py,
spawned once for the module).

Every test here is marked `cuda` and skips without a card. This file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_sharded_cuda.py -q

On the card search takes the kernel route (flat kernel per shard, exact f32
rerank, merge). Ids must equal the float64 numpy oracle's (or FlatIndex's
on the card); distances agree within TOL relative to the row's largest
distance (the card sums the rerank's squares in another order than
numpy). The kernel must have launched in mode float32 and in mode int8.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.ops import topk_cuda
from c99_vectordb_tpu_torch.ops.rerank import shortlist_depth
from c99_vectordb_tpu_torch.parallel import ShardedFlatIndex

pytestmark = pytest.mark.cuda
TOL = 1e-5
WORLDS = (1, 2, 4)
JOIN_TIMEOUT_S = 300
REPO = Path(__file__).resolve().parent.parent
X, IDS, Q = worker.corpus()
MASK = worker.third_mask()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flat kernel has no CPU mode (run on the card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def card_runs(cuda, tmp_path_factory):
    """{W: [rank results]} of the worker's cases with every rank on cuda:0."""
    root = tmp_path_factory.mktemp("card_ranks")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", C99VDB_PLATFORM="cuda")
    procs = {}
    for w in WORLDS:
        out = root / f"w{w}"
        out.mkdir()
        procs[w] = [subprocess.Popen(
            [sys.executable, worker.__file__, "--world", str(w), "--rank", str(r), "--store",
             str(out / "store"), "--out", str(out)], stdout=(out / f"log{r}").open("w"),
            stderr=subprocess.STDOUT, env=env) for r in range(w)]
    failed = []
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                rc = p.wait(timeout=JOIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in (q for group in procs.values() for q in group):
                    q.kill()
                rc = "timeout"
            if rc != 0:
                failed.append((w, r, rc, (root / f"w{w}" / f"log{r}").read_text()[-3000:]))
    assert not failed, failed
    out = {}
    for w in WORLDS:
        out[w] = []
        for r in range(w):
            with np.load(root / f"w{w}" / f"r{r}.npz") as z:
                out[w].append({key: z[key] for key in z.files})
    return out


def got(runs, w, case):
    pre = case + "."
    return {k[len(pre):]: v for k, v in runs[w][0].items() if k.startswith(pre)}


def oracle(db, dbids, q, k, mask=None):
    d = ((q[:, None, :].astype(np.float64) - db[None, :, :]) ** 2).sum(-1)
    if mask is not None:
        d = np.where(mask[dbids][None, :], d, np.inf)
    order = np.lexsort((np.broadcast_to(dbids, d.shape), d), axis=1)[:, :k]
    out_d = np.take_along_axis(d, order, 1)
    return out_d, np.where(np.isinf(out_d), -1, dbids[order])


def assert_close(got_d, want_d):
    got_d, want_d = np.asarray(got_d, np.float64), np.asarray(want_d, np.float64)
    assert (np.isinf(got_d) == np.isinf(want_d)).all()
    fin = np.isfinite(want_d)
    scale = np.where(fin, want_d, 0).max(axis=-1, keepdims=True)
    diff = np.abs(np.subtract(got_d, want_d, out=np.zeros_like(want_d), where=fin))
    assert (diff <= TOL * np.maximum(scale, 1.0)).all(), diff.max()


@pytest.mark.parametrize("w", WORLDS)
def test_ranks_on_the_card_match_the_oracle(card_runs, w):
    """Both routes, both stores, masked and unmasked, the tail, removal,
    device mode and the restage: the oracle's ids at W ranks on the card."""
    od, oi = oracle(X, IDS, Q, worker.K)
    s = got(card_runs, w, "search")
    for d, i in ((s["d"], s["i"]), (s["kd"], s["ki"])):
        np.testing.assert_array_equal(i, oi)
        assert_close(d, od)
    q8 = got(card_runs, w, "sq8")
    for d, i in ((q8["d"], q8["i"]), (q8["kd"], q8["ki"]), (q8["pd"], q8["pi"])):
        np.testing.assert_array_equal(i, oi)
        assert_close(d, od)
    np.testing.assert_array_equal(q8["mi"], oracle(X, IDS, Q, worker.K, MASK)[1])
    for dt in ("float32", "int8"):
        r = got(card_runs, w, f"round5_1d_{dt}")
        assert bool(r["staged"]) and int(r["tail"]) == 200 and int(r["removed"]) == 10
        np.testing.assert_array_equal(r["i"], oracle(X, IDS, Q, 5)[1])
        np.testing.assert_array_equal(r["mi"], oracle(X, IDS, Q, 5, MASK)[1])
        np.testing.assert_array_equal(r["kmi"], r["mi"])
        keep = IDS >= 10
        np.testing.assert_array_equal(r["ri"], oracle(X[keep], IDS[keep], Q, 5)[1])
    dv = got(card_runs, w, "device_mode")
    assert str(dv["mode"]) == "device" and int(dv["ntotal"]) == 999
    keep = IDS != 42
    np.testing.assert_array_equal(dv["after"], oracle(X[keep], IDS[keep], Q, 5)[1])
    np.testing.assert_array_equal(dv["loaded"], dv["after"])
    rs = got(card_runs, w, "restage")
    np.testing.assert_array_equal(rs["i_fold"], rs["i_tail"])
    np.testing.assert_array_equal(rs["i_tail"], oracle(X, IDS, Q, 5)[1])
    launches = got(card_runs, w, "launches")
    assert int(launches["float32"]) > 0 and int(launches["int8"]) > 0, launches
    for other in card_runs[w][1:]:
        for key, value in card_runs[w][0].items():
            np.testing.assert_array_equal(other[key], value, err_msg=key)


def test_two_level_and_2d_on_the_card(card_runs):
    r = got(card_runs, 4, "two_level")
    np.testing.assert_array_equal(r["ti"], r["fi"])
    np.testing.assert_array_equal(r["td"], r["fd"])
    np.testing.assert_array_equal(r["bi"], r["ai"])
    np.testing.assert_array_equal(r["ai"], oracle(X, IDS, Q, 5)[1])
    np.testing.assert_array_equal(got(card_runs, 4, "two_d")["i"], oracle(X, IDS, Q, 5)[1])
    for dt in ("float32", "int8"):
        r = got(card_runs, 4, f"round5_2level_{dt}")
        np.testing.assert_array_equal(r["mi"], got(card_runs, 4, f"round5_1d_{dt}")["mi"])
    rm = got(card_runs, 4, "remesh")
    np.testing.assert_array_equal(rm["after_i"], rm["before_i"])


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_one_rank_in_process_equals_flat_index(cuda, scan_dtype):
    """W = 1 without a process group at 200k x 384: the flat kernel (mode
    float32 or int8) + per-shard rerank gives FlatIndex's ids on the card,
    and the shard's kernel output equals its plain version on the shard's
    own operands."""
    rng = np.random.default_rng(7)
    n, d = 200_000, 384
    x = rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 64)] + 0.05 * rng.standard_normal((64, d), dtype=np.float32)
    mask = rng.random(n) < 0.1
    flat = FlatIndex(dim=d, scan_dtype=scan_dtype, device=cuda)
    flat.add(x, np.arange(n))
    index = ShardedFlatIndex(dim=d, scan_dtype=scan_dtype, device=cuda)
    index.add(x, np.arange(n))
    mode = "float32" if scan_dtype == "float32" else "int8"
    before = topk_cuda.fused_l2_topk.launches_by_mode[mode]
    got_d, got_i = index.search(q, 10)
    gm_d, gm_i = index.search(q, 10, id_mask=mask)
    assert topk_cuda.fused_l2_topk.launches_by_mode[mode] == before + 2
    for (gd, gi), (wd, wi) in (((got_d, got_i), flat.search(q, 10)),
                               ((gm_d, gm_i), flat.search(q, 10, id_mask=mask))):
        np.testing.assert_array_equal(gi, wi)
        assert_close(gd, wd)
    staged = index._stage()
    qd = torch.from_numpy(q).to(cuda)
    ks = shortlist_depth(10, n)
    if scan_dtype == "int8":
        ops = (staged[3], staged[1], staged[4], qd * staged[5])
    else:
        ops = staged[:3] + (qd,)
    kd, ki, kr = topk_cuda.fused_topk(*ops, ks, return_rows=True)
    pd, pi, pr = topk_cuda.fused_topk_reference(*ops, ks, return_rows=True)
    torch.cuda.synchronize()
    if scan_dtype == "int8":
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
        return
    # f32 (3xTF32 products): distances within 1e-4 relative; a differing id
    # must be a near-tie, its row's exact distance within 1e-4 of the slot's.
    torch.testing.assert_close(kd, pd, rtol=1e-4, atol=1e-4)
    b_idx, s_idx = torch.nonzero(ki != pi, as_tuple=True)
    rows = kr[b_idx, s_idx].long()
    exact = ((qd[b_idx] - staged[0][rows]) ** 2).sum(1)
    want = pd[b_idx, s_idx]
    assert bool(((exact - want).abs() <= 1e-4 * torch.clamp_min(want.abs(), 1.0)).all())
