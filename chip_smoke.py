#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 1234]    # on CUDA device 0

Phases (any failure raises and exits non-zero; none is caught):
  1. build       nvcc builds csrc/fused_l2_topk.cu, csrc/ivf_scan.cu and
                 csrc/adc_scan.cu (both with csrc/select_merge.cuh), in
                 parallel, into c99_vectordb_tpu_torch/_build/. fused_l2_topk
                 runs every mode on the tensor cores: its f32 product
                 (3xTF32 on wgmma, 128-row x N-query tiles with N from B,
                 fed by TMA: scan_topk_f32_wgmma_kernel), its two bf16
                 products (bf16 store; int8 codes with bf16 queries) and its
                 int8 x int8 mode (scan_topk_mma_kernel<2>, s8 -> s32), these
                 three on mma.sync. The IVF and ADC select
                 kernels split each query's probes over blocks, stop each list
                 at its high-water mark and merge exactly; the three dense
                 kernels (IVF f32/bf16, IVF int8, ADC) run the same (query,
                 probe group) grid, the IVF ones also splitting each list's
                 rows, and stop alike.
  2. kernel      fused_l2_topk against its plain torch version on the card,
                 for the f32, bf16 and int8 stores (and int8 codes with bf16
                 queries, q_int8=False) at N=1,048,576 x D=384, B in {128,
                 1024, 100, 1, 64}, k=20; the f32 store also at the
                 benchmark's 1,000,000 x 768 at B in {1, 128} (query tiles of
                 8 and 128, read from launches_by_qtile), and the f32 mode's
                 query staging kernel bit for bit against stage_f32_plain at
                 D in {100, 384, 768} and every query tile those runs take;
                 plus fixtures for every mode (duplicate rows, +inf padding
                 and masked norms, k above the live rows, deep k).
  3. flat        FlatIndex on 1,000,000 seeded clustered unit vectors (D=384),
                 each scan dtype, B=128, k=10: strict recall@10 = 1.0 against a
                 float64 (distance, id) ground truth, unfiltered and with a 10%
                 id_mask; the int8 store also through fused_topk(q_int8=False)
                 and the exact rerank.
  4. memodb      MemoDB on 100,000 seeded synthetic notes: save_many,
                 recall_many (with and without a pushed-down filter),
                 recall(pushdown=True), delete, reindex — each step held
                 against MemoDB(device="cpu") on a copy of the same files;
                 then the kernel against its plain version on this path's own
                 operands.
  5. ivf         IVFFlatIndex on the same 1M corpus, nlist = auto_nlist(1M):
                 k-means once on the card (twice, to show it is
                 deterministic), then the f32, bf16 and int8 indexes from
                 that quantizer; per store a dense-route nprobe and 16,
                 unfiltered and with the 10% id_mask, each held against the
                 same route on the plain versions; f32 select = dense bit for
                 bit; recall@10 (informative); a 10,000-row tail add,
                 remove_ids and the fold-restage, held the same way.
  6. ivf_pq      IVFPQIndex on the same 1M corpus, device mode, nlist 4096,
                 m=96, ksub=256, f32 refine store, refine_factor 20: B=128,
                 nprobe 16, k=10 (shortlist 200: select kernel), k=20 (400:
                 dense kernel, 8 queries per block), B=100 k=20 (dense, 1 per
                 block), each also with the 10% id_mask; a ksub=16
                 nibble-packed index with a bf16 refine store on both
                 kernels; a refine=False index (pure ADC, select, with
                 duplicate rows); a 10,000-row tail add, remove_ids and the
                 restage. Every route equals the same route on the plain
                 versions bit for bit; recall@10 is informative.
  7. memodb_ivf  MemoDB with C99VDB_INDEX=ivf_flat at 100,000 notes (save_many
                 in host mode at nlist 64, reindex in device mode at
                 auto_nlist), each step against MemoDB(device="cpu") on the
                 card's files; queries whose card and CPU routes probe
                 different lists are counted (<= 1%) and skipped.
  8. memodb_ivf_pq  MemoDB with C99VDB_INDEX=ivf_pq at 100,000 notes, as
                 phase 7; queries whose card and CPU routes probe different
                 lists or shortlist different ids are counted (<= 1%) and
                 skipped.
  9. cli         the memo CLI: ./memo-torch in subprocesses on phase 4's
                 100,000 notes, every verb (save; recall -k 10, with --filter,
                 with --yaml; serve; serve --batch 128; analyze; reindex;
                 clean) on the card and with C99VDB_PLATFORM=cpu on a copy of
                 the same files: equal rc, stdout, stderr and files, byte for
                 byte; reindex with ivf_flat, ivf_pq, sharded_flat,
                 sharded_ivf and sharded_ivf_pq (one rank) on the card and
                 serve --batch from its files on both; the launcher without a
                 visible card (one Error line, exit 1); one serve --batch in
                 this process (its peak device memory holds the store). The
                 CLI ranks with plain torch: no kernel is on its path.
 10. times       every kernel, its plain version and a library yardstick
                 (never used by the port) beside the bound, on the paths' own
                 operands (every IVF and ADC kernel with the path's
                 high-water marks; scan and merge timed as one call), and the
                 flat kernel in each
                 mode (int8 codes with bf16 queries included) on 1M x 384
                 seeded Gaussian stores at B = 128 and 1024; each IVF and ADC
                 kernel is first held against its plain version on them. The
                 IVF and ADC kernels also log their grid (probe groups, row
                 splits, blocks per SM); tools/select_breakdown.py times the
                 select and IVF dense kernels at other group counts and in
                 diagnostic builds, tools/flat_mma_breakdown.py the flat
                 kernel's modes.
 11. sharded     (runs after phase 6, on phase 3's corpus) ShardedFlatIndex
                 (parallel/sharded.py) at 1M x 384, f32 and int8 stores, B=128,
                 k=10: at W = 1 in this process (no process group) and at
                 W = 2 (two processes on cuda:0 under gloo, 500,000 rows a
                 rank), unfiltered and with phase 3's 10% id_mask, then a
                 10,000-row tail add, remove_ids and a restage: strict
                 recall@10 = 1.0 against the float64 ground truth, ids equal
                 to phase 3's FlatIndex and across W; the flat kernel launched
                 in modes float32 and int8 on each run's path; on every rank,
                 the kernel against its plain version on that rank's shard;
                 host-clock search ms per W (informative).
 12. sharded_ivf (runs after phase 11, on phase 3's corpus and phase 5's
                 quantizer, nlist 4096) ShardedIVFIndex (parallel/sharded.py)
                 at 1M x 384, device mode, f32 and int8 (f32 rerank) stores,
                 B=128, k=10, at W = 1 in this process and W = 2 (two
                 processes on cuda:0 under gloo, the centroids through a
                 file; each rank holds 1/2 of every list): nprobe 3 (the
                 dense kernel at both W) and 16 (the select kernel),
                 unfiltered and with the 10% id_mask, then a 10,000-row tail
                 add, remove_ids (1,004 rows, folding the tail) and a
                 restage. Every search equals the same route with every IVF
                 kernel on its plain version (int8 bit for bit); f32 ids
                 equal phase 5's IVFFlatIndex at the same nprobe and step,
                 and across W; on every rank, each IVF kernel against its
                 plain version on that rank's block; the select, dense and
                 int8 dense kernels launched at each W; recall@10 and
                 host-clock search ms per W (informative).
 13. sharded_ivf_pq (runs after phase 12, on phase 3's corpus and mask and
                 phase 6's quantizer: nlist 4096, m 96, ksub 256)
                 ShardedIVFPQIndex (parallel/sharded.py) at 1M x 384, device
                 mode, refine_factor 20, nprobe 16, at W = 1 in this process
                 and W = 2 (two processes on cuda:0 under gloo, the quantizer
                 through a file; each rank holds 1/2 of every list's codes
                 and refine rows): B=128 at k=10 and k=20 (shortlists of 200
                 and 400 a rank), unfiltered and with the 10% id_mask, B=100
                 at k=20, then a 10,000-row tail add, remove_ids (1,004 rows,
                 folding the tail) and a restage; at W = 1 also a ksub=16
                 nibble-packed index (phase 6's) on the first 100,000 rows.
                 Every search launches the dense ADC kernel once (qpb 8 at
                 B=128, 1 at B=100), equals the same route with it on its
                 plain version bit for bit, returns the float64 distances of
                 its ids within 1e-5 relative and no masked or removed id;
                 rows_per_chip x W = rows_all_chips; on every rank the kernel
                 equals its plain version on that rank's block; W = 2's ranks
                 agree. Informative: W = 1's rows equal to phase 6's
                 IVFPQIndex dense route at k=20, rows equal across W,
                 recall@10, host-clock search ms per W; W = 2's rank 0 times
                 the kernel on its block.

Before the last line it prints the card line from nvidia-smi and one JSON
object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from c99_vectordb_tpu_torch.api import MemoDB
from c99_vectordb_tpu_torch.commands import auto_nlist
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.models.ivf_flat import DENSE_MAX_BF16, DENSE_MAX_F32, IVFFlatIndex
from c99_vectordb_tpu_torch.models.ivf_pq import LANE_K, IVFPQIndex
from c99_vectordb_tpu_torch.ops import adc as adc_mod
from c99_vectordb_tpu_torch.ops import adc_cuda, cuda_build, ivf_scan, ivf_scan_cuda
from c99_vectordb_tpu_torch.ops import topk as topk_mod
from c99_vectordb_tpu_torch.ops import topk_cuda
from c99_vectordb_tpu_torch.ops.distances import scores_via_matmul
from c99_vectordb_tpu_torch.ops.embed import embed_texts, embed_texts_device
from c99_vectordb_tpu_torch.ops.kmeans import train_kmeans
from c99_vectordb_tpu_torch.ops.rerank import exact_rerank_rows, shortlist_depth
from c99_vectordb_tpu_torch.parallel import ShardedFlatIndex, ShardedIVFIndex, ShardedIVFPQIndex
from c99_vectordb_tpu_torch.storage.index_io import read_index

# Published H100 SXM figures (NVIDIA data sheet): bytes/s and dense
# tensor-core peak operations/s by operand type (TF32 for f32 operands:
# the f32 scan builds a shortlist that the exact f32 rerank corrects).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
REL_TOL = 1e-4     # kernel vs plain keys, f32/bf16 (summation order differs)
SCORE_TOL = 1e-5   # MemoDB on the card vs on the CPU


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 2: kernel against plain ------------------------------------------


def make_store(n, d, dtype_name, device, seed):
    """A (n, d) store in the scan dtype and its f32 norms (decoded space for
    int8), from a seeded generator on `device`."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, d), generator=g, device=device, dtype=torch.float32)
    if dtype_name == "float32":
        return x, (x * x).sum(1)
    if dtype_name == "bfloat16":
        return x.to(torch.bfloat16), (x * x).sum(1)
    scale = x.abs().amax(0) / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127)
    dec = codes * scale
    return codes.to(torch.int8).contiguous(), (dec * dec).sum(1), scale


def check_selection(q_st, db, norms, k, rs, exact: bool, label: str):
    """Run the kernel and the plain version on the same staged inputs.
    Positions must be equal except where keys tie within REL_TOL; keys must
    agree within REL_TOL (bit-equal when `exact`). Returns max |key diff|."""
    kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, k, rs)
    pk, pp = topk_cuda.select_plain(q_st, db, norms, k, rs)
    torch.cuda.synchronize()
    assert kk.shape == pk.shape == (q_st.shape[0], k), label
    finite = torch.isfinite(pk)
    assert torch.equal(finite, torch.isfinite(kk)), f"{label}: inf slots differ"
    assert torch.equal(pp[~finite], kp[~finite]), f"{label}: empty slots not INT32_MAX"
    diff = (kk[finite] - pk[finite]).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        assert torch.equal(kk, pk), f"{label}: int8 keys not bit-equal"
        assert torch.equal(kp, pp), f"{label}: positions differ"
        return max_err
    scale = torch.clamp_min(pk[finite].abs(), 1.0)
    assert bool((diff <= REL_TOL * scale).all()), f"{label}: key error {max_err}"
    miss = (kp != pp) & finite
    if bool(miss.any()):
        # Each mismatched slot must be a near-tie: the kernel's row, scored
        # by the plain arithmetic, sits within REL_TOL of the plain key.
        b_idx, s_idx = torch.nonzero(miss, as_tuple=True)
        rows = kp[b_idx, s_idx].long()
        qv = q_st[b_idx].to(torch.float32)
        xv = db[rows].to(torch.float32)
        ip = (qv * xv).sum(1)
        rescored = (ip * rs[b_idx] + norms[rows]) if rs is not None else norms[rows] + ip
        want = pk[b_idx, s_idx]
        ok = (rescored - want).abs() <= REL_TOL * torch.clamp_min(want.abs(), 1.0)
        assert bool(ok.all()), f"{label}: {int((~ok).sum())} position mismatches are not ties"
    return max_err


def note_err(errs, mode, err):
    errs[mode] = max(errs.get(mode, 0.0), err)


def phase_kernel(device, n, d, batches, k, seed, errs):
    """Every mode against the plain version at (n, d); each mode's max
    |key diff| goes into errs."""
    for dt in ("float32", "bfloat16", "int8"):
        made = make_store(n, d, dt, device, seed)
        db, norms = made[0], made[1]
        g = torch.Generator(device=device).manual_seed(seed + 1)
        for b in batches:
            q = torch.randn((b, d), generator=g, device=device)
            if dt == "int8":
                q = q * made[2]
            q_st, rs = topk_cuda.stage_queries(q, db.dtype)
            err = check_selection(q_st, db, norms, k, rs,
                                  exact=(dt == "int8"), label=f"{dt} B={b}")
            note_err(errs, dt, err)
            log(f"kernel {dt:8s} N={n} D={d} B={b:5d} k={k}: agrees with plain "
                f"(max |key diff| {err:.3e})")
            if dt == "int8":
                q_st, _ = topk_cuda.stage_queries(q, db.dtype, q_int8=False)
                err = check_selection(q_st, db, norms, k, None, exact=False,
                                      label=f"int8 bf16 queries B={b}")
                note_err(errs, "int8_bf16q", err)
                log(f"kernel int8 codes, bf16 queries (q_int8=False) N={n} D={d} B={b:5d} "
                    f"k={k}: agrees with plain (max |key diff| {err:.3e})")
        del db, norms, made


def phase_f32_tiles(device, seed, errs):
    """The f32 mode at the benchmark's 1,000,000 x 768 at B = 1 and 128
    against the plain version, each through the query tile its cell runs
    (8 and 128, as launches_by_qtile counts them); then the queries'
    staging kernel bit for bit against stage_f32_plain at every query tile
    of the kernel phase's batches."""
    n, d, k = 1_000_000, 768, 20
    made = make_store(n, d, "float32", device, seed + 3)
    g = torch.Generator(device=device).manual_seed(seed + 4)
    by_tile = topk_cuda.fused_l2_topk.launches_by_qtile
    for b, tile in ((1, 8), (128, 128)):
        q_st, _ = topk_cuda.stage_queries(torch.randn((b, d), generator=g, device=device),
                                          torch.float32)
        before = dict(by_tile)
        err = check_selection(q_st, made[0], made[1], k, None, exact=False,
                              label=f"float32 N={n} D={d} B={b}")
        ran = {t for t in by_tile if by_tile[t] != before[t]}
        assert ran == {tile}, f"float32 B={b}: query tiles {ran}, expected {tile}"
        note_err(errs, "float32", err)
        log(f"kernel float32  N={n} D={d} B={b:5d} k={k} (query tile {tile}): agrees "
            f"with plain (max |key diff| {err:.3e})")
    del made
    for d in (100, 384, 768):
        for b, tile in ((1, 8), (64, 64), (100, 104), (128, 128), (1024, 128)):
            q_st = torch.randn((b, d), generator=g, device=device) * -2.0
            got = topk_cuda.stage_f32(q_st, tile)
            want = topk_cuda.stage_f32_plain(q_st, tile)
            assert torch.equal(got, want), f"stage_f32 D={d} B={b} tile {tile}: differs from plain"
    log("staging float32: stage_f32 equals stage_f32_plain bit for bit at D in {100, 384, 768}, "
        "B in {1, 64, 100, 128, 1024}")


def phase_fixtures(device, d, seed, errs):
    """Duplicate rows, +inf padding/masked norms, k above the live rows,
    ragged N, and deep k (lists in shared and in global memory), for every
    mode; "int8_bf16q" is the int8 store with bf16 queries (q_int8=False)."""
    g = torch.Generator(device=device).manual_seed(seed + 7)
    for mode in ("float32", "bfloat16", "int8", "int8_bf16q"):
        dt = "int8" if mode == "int8_bf16q" else mode
        q_int8 = False if mode == "int8_bf16q" else None
        exact = mode == "int8"
        # Every row identical: the lowest positions must win, in order.
        n = 4096
        base = torch.randn((1, d), generator=g, device=device)
        if dt == "int8":
            store = torch.clamp(torch.round(base * 40), -127, 127).repeat(n, 1)
            db = store.to(torch.int8).contiguous()
            norms = (store * store).sum(1)
        else:
            db = base.repeat(n, 1).to(getattr(torch, dt)).contiguous()
            norms = (db.float() * db.float()).sum(1)
        q_st, rs = topk_cuda.stage_queries(base.repeat(3, 1), db.dtype, q_int8)
        kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, 16, rs)
        assert kp[:, :16].tolist() == [list(range(16))] * 3, f"{mode}: duplicate rows"
        note_err(errs, mode, check_selection(q_st, db, norms, 16, rs,
                                             exact=exact, label=f"{mode} dup"))
        # +inf norms (padding and masked rows, including the nearest ones) and
        # k above the live rows, at a ragged N.
        n = 5000
        made = make_store(n, d, dt, device, seed + 11)
        db, norms = made[0], made[1].clone()
        q = torch.randn((37, d), generator=g, device=device)
        q_st, rs = topk_cuda.stage_queries(q * made[2] if dt == "int8" else q, db.dtype, q_int8)
        _, near = topk_cuda.select_plain(q_st, db, norms, 3, rs)
        norms[near.flatten().long()] = torch.inf
        norms[torch.randperm(n, generator=g, device=device)[: n // 3]] = torch.inf
        note_err(errs, mode, check_selection(q_st, db, norms, 50, rs,
                                             exact=exact, label=f"{mode} masked"))
        live = torch.zeros(n, dtype=torch.bool, device=device)
        live[torch.randperm(n, generator=g, device=device)[:7]] = True
        few = torch.where(live, made[1], torch.inf)
        kk, kp = topk_cuda.fused_l2_topk(q_st, db, few, 20, rs)
        assert bool(torch.isinf(kk[:, 7:]).all()) and bool((kp[:, 7:] == 2**31 - 1).all())
        note_err(errs, mode, check_selection(q_st, db, few, 20, rs,
                                             exact=exact, label=f"{mode} k>live"))
        for deep in (200, 1024):
            note_err(errs, mode, check_selection(
                q_st, db, made[1], deep, rs, exact=exact, label=f"{mode} k={deep}"))
        log(f"fixtures {mode}: duplicates, +inf norms, k > live rows, k=200/1024 agree")


# -- phase 3: FlatIndex end to end ---------------------------------------------


def clustered_corpus(n, d, seed, n_centers=1024):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d), dtype=np.float32)
    labels = rng.integers(0, n_centers, n)
    x = centers[labels]
    x += 0.6 * rng.standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = centers[rng.integers(0, n_centers, 128)]
    q = q + 0.6 * rng.standard_normal(q.shape, dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q.astype(np.float32), rng


def ground_truth(x_dev64, q, k, keep=None):
    q64 = torch.from_numpy(q).to(x_dev64.device, torch.float64)
    d = ((q64 * q64).sum(1, keepdim=True) + (x_dev64 * x_dev64).sum(1)[None, :]
         - 2.0 * (q64 @ x_dev64.T))
    if keep is not None:
        d = torch.where(keep[None, :], d, torch.inf)
    vals, pos = topk_mod.stable_topk(d, k)
    return vals.cpu().numpy(), pos.cpu().numpy()


def phase_flat(device, n, d, seed, card):
    t0 = time.perf_counter()
    x, q, rng = clustered_corpus(n, d, seed)
    ids = np.arange(n, dtype=np.int64)
    x64 = torch.from_numpy(x).to(device, torch.float64)
    mask = rng.random(n) < 0.10
    keep = torch.from_numpy(mask).to(device)
    gt_d, gt_i = ground_truth(x64, q, 10)
    gtm_d, gtm_i = ground_truth(x64, q, 10, keep)
    del x64
    log(f"flat: corpus {n} x {d} and float64 ground truth in {time.perf_counter() - t0:.1f} s")
    out = {}
    for dt in ("float32", "bfloat16", "int8"):
        index = FlatIndex(dim=d, scan_dtype=dt, device=device)
        index.add(x, ids)
        index.search(q[:1], 10)  # staging
        before = topk_cuda.fused_l2_topk.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_d, got_i = index.search(q, 10)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        gm_d, gm_i = index.search(q, 10, id_mask=mask)
        launched = topk_cuda.fused_l2_topk.launches - before
        for name, (gd, gi, wd, wi) in {
            "unfiltered": (got_d, got_i, gt_d, gt_i),
            "10% id_mask": (gm_d, gm_i, gtm_d, gtm_i),
        }.items():
            recall = np.mean([len(set(gi[r]) & set(wi[r])) / 10 for r in range(len(q))])
            assert recall == 1.0, f"flat {dt} {name}: recall@10 {recall}"
            assert np.abs(gd - wd).max() <= 1e-5, f"flat {dt} {name}: distances"
        assert launched == 2, f"flat {dt}: kernel launches {launched}, expected 2"
        log(f"flat {dt}: strict recall@10 = 1.0 (unfiltered and 10% id_mask), "
            f"B=128 search {t_search * 1e3:.2f} ms host clock, kernel launches {launched} "
            f"[{card}]")
        out[dt] = t_search
        out[f"{dt}_results"] = (got_d, got_i, gm_d, gm_i)
        if dt == "int8":
            # The same SQ8 store through fused_topk(q_int8=False): bf16
            # queries against the codes decoded to bf16, then the exact rerank.
            vecs, ids_t, _, _, _, codes, dec_norms, scale = index._staged()
            qd = torch.from_numpy(q).to(device)
            _, si, rows = topk_cuda.fused_topk(codes, ids_t, dec_norms, qd * scale, 20,
                                               q_int8=False, return_rows=True)
            bd, bi = exact_rerank_rows(vecs, rows, si, qd, 10)
            rec = recall_at(bi.cpu().numpy(), gt_i)
            assert rec == 1.0, f"flat int8 q_int8=False: recall@10 {rec}"
            assert np.abs(bd.cpu().numpy() - gt_d).max() <= 1e-5
            q_st, _ = topk_cuda.stage_queries(qd * scale, codes.dtype, q_int8=False)
            out["bf16q_inputs"] = (q_st, codes, dec_norms, 20, None)
            log("flat int8 through fused_topk(q_int8=False) + exact rerank: strict recall@10 "
                "= 1.0")
        del index
        torch.cuda.empty_cache()
    return out, (x, q, mask, gt_i, gtm_i)


# -- phase 4: MemoDB ---------------------------------------------------------------


WORDS = (
    "tea coffee morning meeting project deadline budget review design kernel "
    "memory cache index vector search query filter record note user agent system "
    "priority release deploy server client latency throughput storage disk network "
    "router replica shard cluster backup restore migrate schema table column row "
    "batch stream event window state log metric trace alert incident report team "
    "garden recipe travel flight hotel train ticket museum concert movie book song "
    "running fitness health sleep doctor appointment dentist pharmacy grocery bread "
    "apple orange banana lemon pepper salt sugar butter cheese milk yogurt pasta rice"
).split()


def synthetic_notes(n, seed):
    rng = np.random.default_rng(seed)
    sources = ["user", "agent", "system"]
    topics = ["work", "home", "travel", "health", "food", "ops"]
    lengths = rng.integers(4, 13, n)
    picks = rng.integers(0, len(WORDS), int(lengths.sum()))
    records, at = [], 0
    for i in range(n):
        body = " ".join(WORDS[j] for j in picks[at : at + lengths[i]])
        at += lengths[i]
        if i % 10 == 9:
            records.append({"body": body})
        else:
            records.append({"body": body, "metadata": {
                "source": sources[int(rng.integers(0, 3))],
                "priority": int(rng.integers(0, 5)),
                "topic": topics[int(rng.integers(0, len(topics)))],
            }})
    queries = [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(2, 6))))
               for _ in range(128)]
    return records, queries


def compare_hits(gpu, cpu, label):
    """Scores agree within SCORE_TOL slot by slot; ids are equal except
    swaps among hits whose scores agree within SCORE_TOL."""
    assert len(gpu) == len(cpu), f"{label}: {len(gpu)} vs {len(cpu)} hit lists"
    swaps = 0
    for qi, (g, c) in enumerate(zip(gpu, cpu)):
        assert len(g) == len(c), f"{label} query {qi}: {len(g)} vs {len(c)} hits"
        c_scores = {h.doc_id: h.score for h in c}
        for hg, hc in zip(g, c):
            assert abs(hg.score - hc.score) <= SCORE_TOL, (
                f"{label} query {qi}: score {hg.score} vs {hc.score}")
            if hg.doc_id != hc.doc_id:
                swaps += 1
                tied = (hg.doc_id in c_scores
                        and abs(c_scores[hg.doc_id] - hg.score) <= SCORE_TOL)
                boundary = abs(hg.score - c[-1].score) <= SCORE_TOL
                assert tied or boundary, f"{label} query {qi}: id {hg.doc_id} is no tie"
    return swaps


def phase_memodb(device, n_records, seed, workdir, card):
    records, queries = synthetic_notes(n_records, seed)
    gdir, cdir = workdir / "gpu", workdir / "cpu"
    gdir.mkdir()
    cdir.mkdir()
    gpu = MemoDB("notes", cwd=str(gdir), device=device)
    t0 = time.perf_counter()
    ids = gpu.save_many(records)
    log(f"memodb: save_many of {len(ids)} notes in {time.perf_counter() - t0:.1f} s")
    for f in gdir.iterdir():
        shutil.copy2(f, cdir / f.name)
    cpu = MemoDB("notes", cwd=str(cdir), device="cpu")

    def both(fn):
        return fn(gpu), fn(cpu)

    def same_files(label):
        assert (gdir / "notes.yaml").read_bytes() == (cdir / "notes.yaml").read_bytes(), (
            f"{label}: notes.yaml differs")
        same_index = (gdir / "notes.memo").read_bytes() == (cdir / "notes.memo").read_bytes()
        log(f"memodb {label}: notes.yaml identical; notes.memo (embeddings) "
            f"{'byte-identical' if same_index else 'DIFFERS'} between card and CPU")

    swaps = 0
    g, c = both(lambda db: db.recall_many(queries, k=10))
    assert all(len(h) == 10 for h in g)
    swaps += compare_hits(g, c, "recall_many")
    g, c = both(lambda db: db.recall_many(
        queries, k=10, filter="{source: user}"))
    assert all(h.metadata and h.metadata["source"] == "user" for hs in g for h in hs)
    swaps += compare_hits(g, c, "recall_many {source: user}")
    g, c = both(lambda db: [db.recall(
        qs, k=10, filter="{priority: {$gte: 3}}", pushdown=True) for qs in queries[:8]])
    swaps += compare_hits(g, c, "recall(pushdown=True)")
    victim = g[0][0].doc_id
    assert gpu.delete(victim) and cpu.delete(victim)
    same_files("delete")
    g, c = both(lambda db: db.recall_many(queries, k=10))
    assert all(h.doc_id != victim for hs in g for h in hs)
    swaps += compare_hits(g, c, "recall_many after delete")
    t0 = time.perf_counter()
    dropped = gpu.reindex()
    assert dropped == cpu.reindex() == 1
    log(f"memodb: reindex in {time.perf_counter() - t0:.1f} s (dropped {dropped})")
    same_files("reindex")
    assert len(gpu) == len(cpu) == n_records - 1
    g, c = both(lambda db: db.recall_many(queries, k=10))
    swaps += compare_hits(g, c, "recall_many after reindex")

    # Serving throughput: the warm batched recall of 128 queries.
    times = []
    before = topk_cuda.fused_l2_topk.launches
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu.recall_many(queries, k=10)
        times.append(time.perf_counter() - t0)
    per_call = (topk_cuda.fused_l2_topk.launches - before) / 5
    t_med = sorted(times)[len(times) // 2]
    log(f"memodb: all steps agree with MemoDB(device='cpu') ({swaps} tie swaps); "
        f"recall_many 128 queries k=10 median {t_med * 1e3:.2f} ms -> "
        f"{128 / t_med:.1f} QPS (host clock, {n_records} notes), "
        f"{per_call:g} kernel launches per call [{card}]")

    # The kernel's operands at the main path's own shapes and data: the
    # resident index's staged store and the 128 staged query embeddings.
    vecs, _, _, sq_norms = gpu._index()._staged()[:4]
    q_st, rs = topk_cuda.stage_queries(embed_texts_device(queries, device=device), vecs.dtype)
    main_inputs = (q_st, vecs, sq_norms, shortlist_depth(10, vecs.shape[0]), rs)
    return 128 / t_med, per_call, main_inputs


# -- phase 5: times --------------------------------------------------------------


def time_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n, d, b, k, dt):
    """dt: the store dtype, or "int8_bf16q" for int8 codes scored (decoded to
    bf16) against bf16 queries, at the bf16 rate."""
    item = {"float32": 4, "bfloat16": 2, "int8": 1, "int8_bf16q": 1}[dt]
    q_item = 2 if dt == "int8_bf16q" else item
    nbytes = n * d * item + n * 4 + b * d * q_item + b * k * 8 + (b * 4 if dt == "int8" else 0)
    ops = 2 * b * n * d
    peak = PEAK_OPS_PER_S["bfloat16" if dt == "int8_bf16q" else dt]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_call(q_st, db, norms, k, rs, dt):
    """Yardstick only: one library matmul + torch.topk on the same staged
    operands (no stable tie-break)."""
    if dt == "float32":
        return lambda: torch.topk(torch.addmm(norms, q_st, db.T), k, largest=False)
    if dt == "bfloat16":
        return lambda: torch.topk(torch.matmul(q_st, db.T) + norms, k, largest=False)
    if dt == "int8_bf16q":
        return lambda: torch.topk(torch.matmul(q_st, db.to(torch.bfloat16).T) + norms, k,
                                  largest=False)
    return lambda: torch.topk(torch._int_mm(q_st, db.T).float() * rs[:, None] + norms,
                              k, largest=False)


# How pass 1 of fused_l2_topk forms each mode's products (csrc/fused_l2_topk.cu):
# every mode runs on the tensor cores, the f32 store in a kernel of its own.
PRODUCT_ROUTE = {
    "float32": "scan_topk_f32_wgmma_kernel: tensor cores, wgmma m64nNk8 tf32, 3xTF32, "
               "128-row x N-query tiles (N from B), TMA ring",
    "bfloat16": "scan_topk_mma_kernel<1>: tensor cores, mma.sync m16n8k16 bf16",
    "int8_bf16q": "scan_topk_mma_kernel<3>: tensor cores, mma.sync m16n8k16 bf16",
    "int8": "scan_topk_mma_kernel<2>: tensor cores, mma.sync m16n8k32 s8 -> s32",
}


def time_case(q_st, db, norms, k, rs, card):
    """Kernel, plain version and library yardstick on the same staged
    operands (CUDA-event means), beside the bound."""
    n, d = db.shape
    b = q_st.shape[0]
    dt = str(db.dtype).removeprefix("torch.")
    if q_st.dtype == torch.bfloat16 and db.dtype == torch.int8:
        dt = "int8_bf16q"
    iters = 20 if b <= 128 else 5
    saved = topk_cuda.fused_l2_topk.launches
    ms = time_ms(lambda: topk_cuda.fused_l2_topk(q_st, db, norms, k, rs), iters)
    topk_cuda.fused_l2_topk.launches = saved  # timing launches are not the path's
    plain = time_ms(lambda: topk_cuda.select_plain(q_st, db, norms, k, rs), iters)
    lib = time_ms(library_call(q_st, db, norms, k, rs, dt), iters)
    bms, by = bound(n, d, b, k, dt)
    row = {"dtype": dt, "B": b, "N": n, "D": d, "k": k, "product": PRODUCT_ROUTE[dt], "ms": ms,
           "plain_ms": plain, "library_ms": lib, "bound_ms": bms, "bound_by": by,
           "kernel_over_bound": ms / bms, "kernel_over_library": ms / lib}
    floor = ""
    if dt == "float32":   # 3xTF32 runs three TF32 products: their own floor (log only)
        floor = f", 3xTF32 product floor {3 * 2 * b * n * d / PEAK_OPS_PER_S[dt] * 1e3:.4f} ms"
    log(f"times {dt:10s} B={b:5d} N={n} D={d} k={k} ({row['product']}): kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms, library yardstick (matmul + topk) {lib:.4f} ms, "
        f"bound {bms:.4f} ms ({by}){floor}; kernel / bound {ms / bms:.2f}, kernel / library "
        f"{ms / lib:.3f} [{card}]")
    return row


def phase_times(device, n, d, batches, k, seed, card):
    rows = []
    for dt in ("float32", "bfloat16", "int8"):
        made = make_store(n, d, dt, device, seed)
        db, norms = made[0], made[1]
        g = torch.Generator(device=device).manual_seed(seed + 1)
        for b in batches:
            q = torch.randn((b, d), generator=g, device=device)
            if dt == "int8":
                q = q * made[2]
            q_st, rs = topk_cuda.stage_queries(q, db.dtype)
            rows.append(time_case(q_st, db, norms, k, rs, card))
            if dt == "int8":   # the same codes with bf16 queries (q_int8=False)
                q_st, _ = topk_cuda.stage_queries(q, db.dtype, q_int8=False)
                rows.append(time_case(q_st, db, norms, k, None, card))
        del db, norms, made
        torch.cuda.empty_cache()
    return rows


# -- IVF: helpers ------------------------------------------------------------------


IVF_KERNELS = ("ivf_scan_select", "ivf_scan_dense", "ivf_scan_dense_int8")
IVF_REL_TOL = 1e-5   # kernel route vs the same route on the plain versions


def ivf_counts() -> dict:
    return {name: getattr(ivf_scan_cuda, name).launches for name in IVF_KERNELS}


def reset_counts() -> None:
    topk_cuda.fused_l2_topk.launches = 0
    for mode in topk_cuda.fused_l2_topk.launches_by_mode:
        topk_cuda.fused_l2_topk.launches_by_mode[mode] = 0
    for q_tile in topk_cuda.fused_l2_topk.launches_by_qtile:
        topk_cuda.fused_l2_topk.launches_by_qtile[q_tile] = 0
    for name in IVF_KERNELS:
        getattr(ivf_scan_cuda, name).launches = 0
    adc_cuda.adc_scan_select.launches = 0
    adc_cuda.adc_scan_dense.launches = 0
    adc_cuda.adc_scan_dense.launches_by_qpb.clear()


class plain_kernels:
    """Run the IVF programs on their plain versions (on the same device):
    the route of ops/ivf_scan.py with each kernel call swapped for its
    plain torch version. For holding a whole route against itself."""

    def __enter__(self):
        self.saved = (ivf_scan.ivf_scan_select, ivf_scan.ivf_scan_dense,
                      ivf_scan.ivf_scan_dense_int8)
        ivf_scan.ivf_scan_select = (
            lambda *a, qpb=1, hwm=None: ivf_scan.scan_select_plain(*a[:7], hwm=hwm))
        ivf_scan.ivf_scan_dense = ivf_scan.scan_dense_plain
        ivf_scan.ivf_scan_dense_int8 = (
            lambda *a, qpb=1, hwm=None: ivf_scan.scan_dense_int8_plain(*a[:6], hwm=hwm))
        return self

    def __exit__(self, *exc):
        (ivf_scan.ivf_scan_select, ivf_scan.ivf_scan_dense,
         ivf_scan.ivf_scan_dense_int8) = self.saved


def compare_topk(want_d, want_i, got_d, got_i, label, tol=IVF_REL_TOL):
    """Distances within tol relative (tol absolute near 0); ids equal except
    inside groups of distances tied within tol. Returns max |diff|."""
    fin = np.isfinite(want_d)
    assert np.array_equal(fin, np.isfinite(got_d)), f"{label}: inf slots differ"
    diff = np.abs(got_d[fin] - want_d[fin])
    assert bool((diff <= tol * np.maximum(np.abs(want_d[fin]), 1.0)).all()), (
        f"{label}: distance error {diff.max()}")
    for r in range(want_d.shape[0]):
        k, s = want_d.shape[1], 0
        while s < k:
            e = s + 1
            while e < k and (want_d[r, e] == want_d[r, s] or abs(
                    want_d[r, e] - want_d[r, s]) <= tol * max(1.0, abs(want_d[r, s]))):
                e += 1
            tied_to_end = e == k
            if not tied_to_end and fin[r, s]:
                assert sorted(got_i[r, s:e]) == sorted(want_i[r, s:e]), (
                    f"{label}: query {r} ids differ beyond ties")
            s = e
    return float(diff.max()) if diff.size else 0.0


def recall_at(got_i, gt_i, k=10):
    return float(np.mean([len(set(got_i[r][:k]) & set(gt_i[r][:k])) / k
                          for r in range(gt_i.shape[0])]))


def route_of(index, scan_dtype, nprobe):
    pad = index._staged[6]
    if scan_dtype == "int8":
        return "dense_int8"
    gate = DENSE_MAX_F32 if scan_dtype == "float32" else DENSE_MAX_BF16
    return "dense" if nprobe * pad <= gate else "select"


# -- phase ivf: IVFFlatIndex at 1M x 384 ----------------------------------------------


def timed_search(index, q, k, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = index._search(q, k, card_route=True, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_route(index, q, k, label, **kw):
    """The index's card route on the kernels against the same route on the
    plain versions. Returns ((dists, ids), seconds, {kernel: max |diff|})
    with the route's max |diff| under each IVF kernel the route launched."""
    before = ivf_counts()
    (kd, ki), secs = timed_search(index, q, k, **kw)
    launched = [name for name, v in ivf_counts().items() if v > before[name]]
    with plain_kernels():
        pd, pi = index._search(q, k, card_route=True, **kw)
    return (kd, ki), secs, dict.fromkeys(launched, compare_topk(pd, pi, kd, ki, label))


def note_errs(errs, got):
    """Fold a {kernel: max |diff|} into the per-kernel maxima."""
    for name, err in got.items():
        errs[name] = max(errs[name], err)


def phase_ivf(device, d, seed, card, corpus):
    x, q, mask, gt_i, gtm_i = corpus
    n = x.shape[0]
    nlist = auto_nlist(n)
    x_dev = torch.from_numpy(x).to(device)
    ids_dev = torch.arange(n, dtype=torch.int32, device=device)
    base = IVFFlatIndex(dim=d, nlist=nlist, nprobe=16, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base.train(x_dev)
    torch.cuda.synchronize()
    t_km = time.perf_counter() - t0
    again = train_kmeans(x_dev, nlist, out_device=True)
    assert torch.equal(again, base._centroids), "k-means on the card is not deterministic"
    del again
    log(f"ivf: k-means (maximin + 10 Lloyd iterations) of {n} x {d} into {nlist} lists "
        f"in {t_km:.2f} s host clock; a second training gave bit-identical centroids [{card}]")
    errs = dict.fromkeys(IVF_KERNELS, 0.0)
    result = {"kmeans_s": t_km, "nlist": nlist, "routes": []}
    operands = {}
    # The f32 index's results by step, and the quantizer: phase sharded_ivf's reference.
    ref = {"centroids": base._centroids.cpu().numpy(), "dense_nprobe": None}
    extra, _, _ = clustered_corpus(10_000, d, seed + 5)
    for dt in ("float32", "bfloat16", "int8"):
        index = base if dt == "float32" else IVFFlatIndex(
            dim=d, nlist=nlist, nprobe=16, scan_dtype=dt, device=device)
        index._centroids = base._centroids      # the one trained quantizer
        t0 = time.perf_counter()
        index.add(x_dev, ids_dev)
        index.search(q[:1], 10)                 # stage
        torch.cuda.synchronize()
        pad = index._staged[6]
        log(f"ivf {dt}: staged {n} rows in {time.perf_counter() - t0:.2f} s, nlist={nlist}, "
            f"pad={pad}")
        dense_np = max(1, (DENSE_MAX_BF16 if dt == "bfloat16" else DENSE_MAX_F32) // pad)
        if dt == "float32":
            ref["dense_nprobe"] = dense_np
        for nprobe in sorted({dense_np, 16}):
            route = route_of(index, dt, nprobe)
            for name, kw, gt in (("unfiltered", {}, gt_i),
                                 ("10% id_mask", {"id_mask": mask}, gtm_i)):
                (gd, gi), secs, got = check_route(index, q, 10, f"ivf {dt} p={nprobe} {name}",
                                                   nprobe=nprobe, **kw)
                note_errs(errs, got)
                if dt == "float32":
                    ref[(nprobe, name)] = (gd, gi)
                err = max(got.values(), default=0.0)
                rec = recall_at(gi, gt)
                log(f"ivf {dt} nprobe={nprobe} {name}: route {route} (pad {pad}, width "
                    f"{nprobe * pad}), agrees with the plain route (max |diff| {err:.2e}), "
                    f"recall@10 {rec:.4f}, B=128 search {secs * 1e3:.2f} ms host clock [{card}]")
                result["routes"].append({"dtype": dt, "nprobe": nprobe, "filter": name,
                                         "route": route, "pad": pad, "recall": rec,
                                         "search_ms": secs * 1e3})
            if dt == "float32":
                # The select and dense routes share one distance routine.
                sd, si = index._search(q, 10, nprobe=nprobe, card_route=True, scan="select")
                dd, di = index._search(q, 10, nprobe=nprobe, card_route=True, scan="dense")
                assert np.array_equal(sd, dd), f"ivf f32 p={nprobe}: select != dense distances"
                fin = np.isfinite(sd)
                assert np.array_equal(si[fin], di[fin]), f"ivf f32 p={nprobe}: select != dense ids"
                log(f"ivf float32 nprobe={nprobe}: select and dense routes bit-identical")
            if dt != "int8":
                operands[(route_of(index, dt, nprobe), dt)] = staged_operands(index, q, nprobe)
        if dt == "int8":
            operands[("dense_int8", dt)] = staged_operands(index, q, 16)
        # Incremental add into the tail, one remove_ids, and the fold.
        index.add(torch.from_numpy(extra).to(device),
                  torch.arange(n, n + extra.shape[0], dtype=torch.int32, device=device))
        assert index._tail is not None and index._tail.count == extra.shape[0]
        tail_out, _, got = check_route(index, q, 10, f"ivf {dt} tail")
        note_errs(errs, got)
        removed = index.remove_ids(np.arange(0, n, 997))    # folds the tail first
        assert removed == len(range(0, n, 997)) and index._tail is None
        removed_out, _, got = check_route(index, q, 10, f"ivf {dt} after remove + fold")
        note_errs(errs, got)
        if dt == "float32":
            ref[(16, "tail")], ref[(16, "after remove")] = tail_out, removed_out
        log(f"ivf {dt}: tail add of {extra.shape[0]} rows, remove_ids of {removed} rows and "
            f"the fold-restage agree with the plain route")
        del index
    del base, x_dev
    torch.cuda.empty_cache()
    return result, errs, operands, ref


def staged_operands(index, q, nprobe):
    """The scan operands of an index's card route at `nprobe` (staged
    lists, probes, staged queries, the lists' high-water marks) for the
    times phase."""
    (centroids, c_sq, store, li, sqn, _, pad, extra) = index._stage()
    qd = torch.from_numpy(q).to(store.device)
    probes = ivf_scan.coarse_probes(qd, centroids, c_sq, nprobe)
    ops = {"probes": probes, "ids": li, "pad": pad, "hwm": index._hwm}
    if extra is not None and extra[0] == "int8":
        q8, rs = ivf_scan.sq8_stage_queries(qd, extra[2])
        ops.update(kind="int8", q8=q8, rs=rs, codes=extra[1], sqn=extra[3])
    else:
        lists = store if extra is None else extra[1]
        ops.update(kind="float", q=qd, q_sq=(qd * qd).sum(1), lists=lists, sqn=sqn)
    return ops


# -- phase memodb_ivf: MemoDB on IVFFlatIndex at 100k notes ------------------------------


def probe_sets(db, q_emb):
    """Per query: (card-route probes, CPU-route probes) of a MemoDB's index,
    each a frozenset."""
    index = db._index()
    centroids, c_sq = index._stage()[:2]
    nprobe = min(index.nprobe, int(centroids.shape[0]))
    qd = torch.from_numpy(q_emb).to(centroids.device)
    card = ivf_scan.coarse_probes(qd, centroids, c_sq, nprobe).cpu().numpy()
    _, cpu = topk_mod.stable_topk(scores_via_matmul(qd, centroids, c_sq), nprobe)
    cpu = cpu.cpu().numpy()
    return [(frozenset(a.tolist()), frozenset(b.tolist())) for a, b in zip(card, cpu)]


def compare_hits_ivf(gpu, cpu, probes_g, probes_c, label):
    """Hits held as compare_hits does, except queries whose card-route probe
    set (on the card index) and CPU-route probe set (on the CPU index)
    differ. Returns (tie swaps, queries skipped)."""
    swaps = skipped = 0
    for qi, (g, c) in enumerate(zip(gpu, cpu)):
        if probes_g[qi][0] != probes_c[qi][1]:
            skipped += 1
            continue
        swaps += compare_hits([g], [c], f"{label} query {qi}")
    return swaps, skipped


def phase_memodb_ivf(device, n_records, seed, workdir, card):
    import os

    records, queries = synthetic_notes(n_records, seed)
    q_emb = embed_texts(queries, device="cpu")
    gdir, cdir = workdir / "gpu", workdir / "cpu"
    gdir.mkdir()
    cdir.mkdir()
    os.environ["C99VDB_INDEX"] = "ivf_flat"
    try:
        gpu = MemoDB("notes", cwd=str(gdir), device=device)
        t0 = time.perf_counter()
        gpu.save_many(records)
        log(f"memodb_ivf: save_many of {n_records} notes (host mode, nlist 64) in "
            f"{time.perf_counter() - t0:.1f} s")

        def copy_card_files():
            for f in gdir.iterdir():
                shutil.copy2(f, cdir / f.name)

        copy_card_files()
        cpu = MemoDB("notes", cwd=str(cdir), device="cpu")
        stats = {"swaps": 0, "skipped": 0, "compared": 0}

        def both(fn, label, n_q):
            g, c = fn(gpu), fn(cpu)
            pg, pc = probe_sets(gpu, q_emb[:n_q]), probe_sets(cpu, q_emb[:n_q])
            sw, sk = compare_hits_ivf(g, c, pg, pc, label)
            stats["swaps"] += sw
            stats["skipped"] += sk
            stats["compared"] += n_q
            return g

        def describe(label):
            index = gpu._index()
            staged = index._stage()
            pad, nlist = staged[6], int(staged[0].shape[0])
            route = "dense" if index.nprobe * pad <= DENSE_MAX_F32 else "select"
            log(f"memodb_ivf {label}: {index._mode} mode, nlist {nlist}, pad {pad}, nprobe "
                f"{index.nprobe} -> route {route}")
            return route

        before = ivf_counts()
        g = both(lambda db: db.recall_many(queries, k=10), "recall_many", len(queries))
        assert all(len(h) == 10 for h in g)
        routes = {"before_reindex": describe("recall_many"),
                  "launches_first_call": {k: v - before[k] for k, v in ivf_counts().items()}}
        ops_before = staged_operands(gpu._index(), q_emb, gpu._index().nprobe)
        both(lambda db: db.recall_many(queries, k=10, filter="{source: user}"),
             "recall_many {source: user}", len(queries))
        both(lambda db: [db.recall(qs, k=10, filter="{priority: {$gte: 3}}", pushdown=True)[:10]
                         for qs in queries[:8]], "recall(pushdown=True)", 8)
        victim = gpu.recall_many(queries[:1], k=1)[0][0].doc_id
        assert gpu.delete(victim) and cpu.delete(victim)
        g = both(lambda db: db.recall_many(queries, k=10), "recall_many after delete",
                 len(queries))
        assert all(h.doc_id != victim for hs in g for h in hs)
        t0 = time.perf_counter()
        dropped = gpu.reindex()
        t_reindex = time.perf_counter() - t0
        assert dropped == cpu.reindex() == 1
        own_g = read_index(gdir / "notes.memo", device="cpu").state()[1]
        own_c = read_index(cdir / "notes.memo", device="cpu").state()[1]
        cdiff = float(np.abs(own_g["centroids"] - own_c["centroids"]).max())
        ag = own_g["assign"][np.argsort(own_g["ids"])]
        ac = own_c["assign"][np.argsort(own_c["ids"])]
        log(f"memodb_ivf: reindex (device mode, nlist {auto_nlist(n_records - 1)}) in "
            f"{t_reindex:.1f} s on the card; the two sides' own k-means: centroid max |diff| "
            f"{cdiff:.3e}, assignment agreement {float(np.mean(ag == ac)):.4f}")
        copy_card_files()
        routes["after_reindex"] = describe("after reindex")
        g = both(lambda db: db.recall_many(queries, k=10), "recall_many after reindex",
                 len(queries))
        ops_after = staged_operands(gpu._index(), q_emb, gpu._index().nprobe)
        share = stats["skipped"] / stats["compared"]
        assert share <= 0.01, f"memodb_ivf: {stats['skipped']} queries with differing probes"
        log(f"memodb_ivf: all steps agree with MemoDB(device='cpu') ({stats['swaps']} tie swaps; "
            f"{stats['skipped']} of {stats['compared']} query results skipped for differing "
            f"probe sets between the card and CPU routes)")
        times = []
        before = ivf_counts()
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu.recall_many(queries, k=10)
            times.append(time.perf_counter() - t0)
        per_call = {k: (v - before[k]) / 5 for k, v in ivf_counts().items()}
        t_med = sorted(times)[len(times) // 2]
        log(f"memodb_ivf: recall_many 128 queries k=10 median {t_med * 1e3:.2f} ms -> "
            f"{128 / t_med:.1f} QPS (host clock, {n_records} notes), kernel launches per call "
            f"{per_call} [{card}]")
    finally:
        os.environ.pop("C99VDB_INDEX", None)
    return ({"qps": 128 / t_med, "per_call": per_call, "routes": routes,
             "skipped": stats["skipped"], "compared": stats["compared"]},
            {routes["before_reindex"]: ops_before, routes["after_reindex"]: ops_after})


# -- IVF times --------------------------------------------------------------------------------


PEAK_EXACT_F32 = 67e12      # f32 FMA outside the tensor cores: the exact f32 route


def slot_bytes(ops, stops_at_hwm, uniq_lists):
    """Bytes of the per-slot norms (or constants) and ids of the unique
    probed lists, 8 per slot: every slot for a scan that walks to pad, the
    slots below each list's hwm (and the marks themselves) for a kernel
    that stops at the path's hwm (every IVF and ADC kernel)."""
    if stops_at_hwm and ops.get("hwm") is not None:
        return int(ops["hwm"][uniq_lists].sum()) * 8 + int(uniq_lists.numel()) * 4
    return int(uniq_lists.numel()) * ops["pad"] * 8


def ivf_bound(ops, kernel, k=None):
    """Least time for the scan on this run's operands. Bytes: the vectors of
    the live rows (id >= 0) of the unique probed lists, and the norms and ids
    of their slots below the path's marks (every IVF kernel stops there; a
    padding slot is told by its id alone), each read once; the queries and
    probes read once; the outputs written once (a dense kernel's (B,
    nprobe * pad), the tails past the marks included).
    Operations: 2*D for each live row of each (query, probe). Returns
    (ms, what bounds it, unique lists, live share of their slots)."""
    probes = ops["probes"]
    b, nprobe = probes.shape
    pad = ops["pad"]
    lists = ops["codes"] if ops["kind"] == "int8" else ops["lists"]
    d, item = lists.shape[2], lists.element_size()
    uniq_lists = torch.unique(probes).long()
    uniq = int(uniq_lists.numel())
    live_per_list = (ops["ids"] >= 0).sum(dim=1)
    live = int(live_per_list[uniq_lists].sum())
    live_pairs = int(live_per_list[probes.long()].sum())
    out_cols = k if kernel == "ivf_scan_select" else nprobe * pad
    nbytes = (live * d * item + slot_bytes(ops, True, uniq_lists)
              + b * d * (1 if ops["kind"] == "int8" else 4) + b * 4 + b * nprobe * 4
              + b * out_cols * 8)
    n_ops = 2 * live_pairs * d
    peak = {torch.float32: PEAK_EXACT_F32, torch.bfloat16: PEAK_OPS_PER_S["bfloat16"],
            torch.int8: PEAK_OPS_PER_S["int8"]}[lists.dtype]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, n_ops / peak
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), uniq,
            live / (uniq * pad))


def ivf_calls(ops, kernel, k):
    """(kernel call, plain call, library yardstick) on the same operands. The
    yardstick gathers the probed lists and scores them with one
    torch.baddbmm (f32 product, int8 codes widened to f32), plus torch.topk
    for the select kernel; it is timed only and never called by the port.
    Every kernel and its plain version stop at the path's hwm."""
    p, hwm = ops["probes"], ops["hwm"]
    if ops["kind"] == "int8":
        args = (p, ops["q8"], ops["rs"], ops["codes"], ops["sqn"], ops["ids"])
        kern = lambda: ivf_scan_cuda.ivf_scan_dense_int8(*args, qpb=8, hwm=hwm)  # noqa: E731
        plain = lambda: ivf_scan.scan_dense_int8_plain(*args, hwm=hwm)  # noqa: E731
        qv, lists, scale = ops["q8"].float() * ops["rs"][:, None], ops["codes"], ops["rs"]
        qv_sq = None
    else:
        args = (p, ops["q"], ops["q_sq"], ops["lists"], ops["sqn"], ops["ids"])
        if kernel == "ivf_scan_select":
            kern = lambda: ivf_scan_cuda.ivf_scan_select(*args, k, hwm=hwm)  # noqa: E731
            plain = lambda: ivf_scan.scan_select_plain(*args, k, hwm=hwm)  # noqa: E731
        else:
            kern = lambda: ivf_scan_cuda.ivf_scan_dense(*args, hwm=hwm)  # noqa: E731
            plain = lambda: ivf_scan.scan_dense_plain(*args, hwm=hwm)  # noqa: E731
        qv, lists, scale = ops["q"].to(ops["lists"].dtype).float(), ops["lists"], None
        qv_sq = ops["q_sq"]
    b, nprobe = p.shape
    d = lists.shape[2]
    flat_l = p.long().reshape(-1)

    def library():
        x = lists[flat_l].reshape(b, -1, d).float()
        sq = ops["sqn"][flat_l].reshape(b, -1)
        ip = torch.baddbmm(sq[:, :, None], x, qv[:, :, None],
                           alpha=-2.0 if scale is None else 1.0)[..., 0]
        if qv_sq is not None:
            ip = ip + qv_sq[:, None]
        if kernel == "ivf_scan_select":
            return torch.topk(ip, k, largest=False)
        return ip

    return kern, plain, library


def time_ivf(ops, kernel, k, label, card):
    kern, plain, library = ivf_calls(ops, kernel, k)
    iters = 10
    saved = ivf_counts()
    ms = time_ms(kern, iters)
    b, nprobe = ops["probes"].shape
    lists = ops["codes"] if ops["kind"] == "int8" else ops["lists"]
    if kernel == "ivf_scan_select":
        select = ivf_scan_cuda.select_plan(b, nprobe, lists.shape[2], k, lists.dtype,
                                           lists.device)
    else:
        select = ivf_scan_cuda.dense_plan(b, nprobe, ops["pad"], lists.shape[2], lists.dtype,
                                          lists.device)
    for name, v in saved.items():        # timing launches are not the path's
        getattr(ivf_scan_cuda, name).launches = v
    plain_ms = time_ms(plain, 3)
    lib_ms = time_ms(library, iters)
    bms, by, uniq, live_share = ivf_bound(ops, kernel, k)
    shape = {"dtype": str(lists.dtype).removeprefix("torch."), "B": b, "nprobe": nprobe,
             "nlist": lists.shape[0], "pad": ops["pad"], "D": lists.shape[2],
             "unique_lists": uniq, "live_share": live_share}
    if kernel == "ivf_scan_select":
        shape["k"] = k
    log(f"times {kernel} {label} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library yardstick {lib_ms:.3f} ms, bound {bms:.3f} ms ({by}) [{card}]")
    log_select_plan(kernel, label, select, card)
    return {"label": label, **shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bms, "bound_by": by, "select": select}


def check_ivf_kernel(ops, kernel, k, label):
    """Kernel against its plain version on one set of operands; returns max
    |diff| (int8 keys must be bit-equal)."""
    kern, plain, _ = ivf_calls(ops, kernel, k)
    kd, ki = kern()
    pd, pi = plain()
    torch.cuda.synchronize()
    if kernel == "ivf_scan_dense_int8":
        assert torch.equal(kd, pd) and torch.equal(ki, pi), f"{label}: int8 keys not bit-equal"
        return 0.0
    if kernel == "ivf_scan_dense":
        assert torch.equal(ki, pi), f"{label}: ids differ"
        kd, pd = kd.cpu().numpy(), pd.cpu().numpy()
        fin = np.isfinite(pd)
        assert np.array_equal(fin, np.isfinite(kd)), f"{label}: inf slots differ"
        diff = np.abs(kd[fin] - pd[fin])
        assert bool((diff <= IVF_REL_TOL * np.maximum(np.abs(pd[fin]), 1.0)).all()), label
        return float(diff.max()) if diff.size else 0.0
    return compare_topk(pd.cpu().numpy(), pi.cpu().numpy(), kd.cpu().numpy(),
                        ki.cpu().numpy(), label)


# -- IVF-PQ: helpers ----------------------------------------------------------------


ADC_COUNTS = ("adc_scan_select", "adc_scan_dense[qpb=8]", "adc_scan_dense[qpb=1]")
# Published H100 SXM figures for the ADC lookups: 132 SMs, each serving 32
# four-byte shared-memory reads per clock, at the 1.98 GHz boost clock.
SMEM_LOOKUPS_PER_S = 132 * 32 * 1.98e9


def adc_counts() -> dict:
    by_qpb = adc_cuda.adc_scan_dense.launches_by_qpb
    return {"adc_scan_select": adc_cuda.adc_scan_select.launches,
            "adc_scan_dense[qpb=8]": by_qpb.get(8, 0), "adc_scan_dense[qpb=1]": by_qpb.get(1, 0)}


class plain_adc:
    """Run the ADC programs on the plain versions of the kernels (on the
    same device): for holding a whole route against itself."""

    def __enter__(self):
        self.saved = (adc_mod.adc_scan_select, adc_mod.adc_scan_dense)
        adc_mod.adc_scan_select = (
            lambda *a, packed, hwm=None: adc_mod.adc_select_plain(*a, packed=packed, hwm=hwm))
        adc_mod.adc_scan_dense = (
            lambda *a, packed, qpb=1, hwm=None: adc_mod.adc_dense_plain(*a, packed=packed,
                                                                        hwm=hwm))
        return self

    def __exit__(self, *exc):
        adc_mod.adc_scan_select, adc_mod.adc_scan_dense = self.saved


def check_route_pq(index, q, k, label, **kw):
    """The index's card route on the kernels against the same route on the
    plain versions: bit for bit. Returns ((dists, ids), seconds, the ADC
    counts the route raised)."""
    before = adc_counts()
    (kd, ki), secs = timed_search(index, q, k, **kw)
    launched = [name for name, v in adc_counts().items() if v > before[name]]
    with plain_adc():
        pd, pi = index._search(q, k, card_route=True, **kw)
    assert np.array_equal(kd, pd) and np.array_equal(ki, pi), f"{label}: not bit-equal"
    return (kd, ki), secs, launched


def adc_operands(index, q, qpb=None):
    """The ADC kernel operands of an index's card route for queries q
    (numpy): staged canvas, probes, coarse distances, QD tables, the lists'
    high-water marks."""
    (cents, c_sq, books, _, li, canvas, ic, pad) = index._stage()
    q_adc = index._rotate_device(torch.from_numpy(q).to(cents.device))
    nprobe = min(index.nprobe, int(cents.shape[0]))
    probes, pc, qd = adc_mod.adc_prologue(q_adc, cents, c_sq, books, nprobe)
    return {"probes": probes, "pc": pc, "qd": qd, "codes": canvas, "const": ic, "ids": li,
            "packed": adc_mod.packed_layout(int(books.shape[1]), index.m), "pad": pad,
            "qpb": qpb, "hwm": index._hwm}


def adc_args(ops):
    return (ops["probes"], ops["pc"], ops["qd"], ops["codes"], ops["const"], ops["ids"])


def adc_calls(ops, kernel, k):
    """(kernel call, plain call, library yardstick) on the same operands. The
    yardstick gathers every probed slot's table entries with one
    torch.gather and sums them (plus torch.topk for the select kernel); it
    is timed only and never called by the port. The kernels and their plain
    versions stop at the path's hwm."""
    args, packed, hwm = adc_args(ops), ops["packed"], ops["hwm"]
    if kernel == "adc_scan_select":
        kern = lambda: adc_cuda.adc_scan_select(*args, k, packed=packed, hwm=hwm)  # noqa: E731
        plain = lambda: adc_mod.adc_select_plain(*args, k, packed=packed, hwm=hwm)  # noqa: E731
    else:
        kern = lambda: adc_cuda.adc_scan_dense(*args, packed=packed, qpb=ops["qpb"],  # noqa: E731
                                               hwm=hwm)
        plain = lambda: adc_mod.adc_dense_plain(*args, packed=packed, hwm=hwm)  # noqa: E731
    probes, pc, qd, codes, const, ids = args
    b, nprobe = probes.shape
    m, pad = qd.shape[1], ops["pad"]
    flat = probes.long().reshape(-1)

    def library():
        c = codes[flat]
        if packed:
            c = torch.stack([c & 15, c >> 4], dim=2).reshape(c.shape[0], m, pad)
        idx = c.long().reshape(b, nprobe, m, pad).permute(0, 2, 1, 3).reshape(b, m, -1)
        qdot = torch.gather(qd, 2, idx).sum(dim=1)
        d = (pc.repeat_interleave(pad, dim=1) - 2.0 * qdot) + const[flat].reshape(b, -1)
        d = torch.where(ids[flat].reshape(b, -1) >= 0, torch.clamp_min(d, 0.0), torch.inf)
        return torch.topk(d, k, largest=False) if kernel == "adc_scan_select" else d

    return kern, plain, library


def adc_bound(ops, kernel, k):
    """Least time for the scan on this run's operands. Bytes: the codes of
    the live rows (id >= 0) of the unique probed lists (m bytes each, m/2
    packed), the constants and ids of their slots below the path's marks
    (both kernels stop there), the QD tables, the probes and coarse
    distances, the outputs. Work: m table lookups per live
    row per (query, probe), at the card's shared-memory rate. Returns (ms,
    what bounds it, unique lists, live share of their slots)."""
    probes, qd = ops["probes"], ops["qd"]
    b, nprobe = probes.shape
    m, ksub = qd.shape[1], qd.shape[2]
    pad = ops["pad"]
    uniq_lists = torch.unique(probes).long()
    uniq = int(uniq_lists.numel())
    live_per_list = (ops["ids"] >= 0).sum(dim=1)
    live = int(live_per_list[uniq_lists].sum())
    live_pairs = int(live_per_list[probes.long()].sum())
    code_bytes = m // 2 if ops["packed"] else m
    out_cols = k if kernel == "adc_scan_select" else nprobe * pad
    nbytes = (live * code_bytes + slot_bytes(ops, True, uniq_lists)
              + b * m * ksub * 4 + b * nprobe * 8 + b * out_cols * 8)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, live_pairs * m / SMEM_LOOKUPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), uniq,
            live / (uniq * pad))


def check_adc_kernel(ops, kernel, k, label):
    """Kernel against its plain version on one set of operands: bit for bit.
    Returns max |diff| over finite distances (0.0 when equal)."""
    kern, plain, _ = adc_calls(ops, kernel, k)
    saved = adc_counts()
    kd, ki = kern()
    restore_adc_counts(saved)
    pd, pi = plain()
    torch.cuda.synchronize()
    assert torch.equal(ki, pi), f"{label}: ids differ"
    assert torch.equal(kd, pd), f"{label}: distances not bit-equal"
    fin = torch.isfinite(pd)
    return float((kd[fin] - pd[fin]).abs().max()) if bool(fin.any()) else 0.0


def restore_adc_counts(saved):
    """Put the counts back: launches made to compare or time a kernel are
    not the path's."""
    adc_cuda.adc_scan_select.launches = saved["adc_scan_select"]
    by_qpb = adc_cuda.adc_scan_dense.launches_by_qpb
    by_qpb[8], by_qpb[1] = saved["adc_scan_dense[qpb=8]"], saved["adc_scan_dense[qpb=1]"]
    adc_cuda.adc_scan_dense.launches = sum(by_qpb.values())


def time_adc(ops, kernel, k, label, card):
    kern, plain, library = adc_calls(ops, kernel, k)
    saved = adc_counts()
    ms = time_ms(kern, 10)
    b, nprobe = ops["probes"].shape
    m, ksub = ops["qd"].shape[1], ops["qd"].shape[2]
    if kernel == "adc_scan_select":
        select = adc_cuda.select_plan(b, nprobe, m, ksub, ops["packed"], k, ops["codes"].device)
    else:
        select = adc_cuda.dense_plan(b, nprobe, m, ksub, ops["packed"], ops["codes"].device)
    restore_adc_counts(saved)
    plain_ms = time_ms(plain, 3)
    lib_ms = time_ms(library, 5)
    bms, by, uniq, live_share = adc_bound(ops, kernel, k)
    shape = {"B": b, "nprobe": nprobe, "nlist": ops["codes"].shape[0], "pad": ops["pad"],
             "m": m, "ksub": ksub, "packed": ops["packed"], "unique_lists": uniq,
             "live_share": live_share}
    if kernel == "adc_scan_select":
        shape["k"] = k
    else:
        shape["qpb"] = ops["qpb"]
    log(f"times {kernel} {label} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library yardstick {lib_ms:.3f} ms, bound {bms:.4f} ms ({by}) [{card}]")
    log_select_plan(kernel, label, select, card)
    return {"label": label, **shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bms, "bound_by": by, "select": select}


def log_select_plan(kernel, label, select, card):
    """One line on a select or dense launch's grid: probe groups (and an IVF
    dense grid's row splits), blocks, blocks per SM (from the occupancy
    query)."""
    splits = f", {select['splits']} row splits" if "splits" in select else ""
    log(f"times {kernel} {label}: grid of {select['blocks']} blocks ({select['groups']} probe "
        f"groups{splits}), {select['blocks_per_sm']} resident per SM on {select['sms']} SMs "
        f"({select['blocks'] / select['sms']:.2f} blocks per SM over the run) [{card}]")


def tie_pairs(dists):
    """Adjacent exactly equal finite distances in the result rows."""
    d = np.asarray(dists)
    return int((np.isfinite(d[:, 1:]) & (d[:, 1:] == d[:, :-1])).sum())


# -- phase ivf_pq: IVFPQIndex at 1M x 384 ------------------------------------------------


def phase_ivf_pq(device, d, seed, card, corpus):
    x, q, mask, gt_i, gtm_i = corpus
    n = x.shape[0]
    nlist = auto_nlist(n)
    x_dev = torch.from_numpy(x).to(device)
    ids_dev = torch.arange(n, dtype=torch.int32, device=device)
    result = {"nlist": nlist, "routes": []}
    operands = []
    # Phase sharded_ivf_pq's reference: the quantizers and results by step.
    pq_ref = {}

    def run_routes(index, name, cases):
        for label, qq, k, kw, gt in cases:
            (gd, gi), secs, launched = check_route_pq(index, qq, k, f"{name} {label}", **kw)
            pq_ref[(name, label)] = (gd, gi)
            rec = recall_at(gi, gt[: qq.shape[0]])
            log(f"ivf_pq {name} {label}: kernels {launched}, equals the plain route bit for bit, "
                f"recall@10 {rec:.4f}, exact-tie pairs {tie_pairs(gd)}, search "
                f"{secs * 1e3:.2f} ms host clock [{card}]")
            result["routes"].append({"index": name, "case": label, "kernels": launched,
                                     "recall": rec, "search_ms": secs * 1e3})

    def build(name, **kw):
        index = IVFPQIndex(dim=d, nlist=nlist, nprobe=16, m=96, device=device, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.train(x_dev)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        t0 = time.perf_counter()
        index.add(x_dev, ids_dev)
        index.search(q[:1], 10)                                  # stage
        torch.cuda.synchronize()
        t_stage = time.perf_counter() - t0
        st = index._staged
        log(f"ivf_pq {name}: trained (k-means {nlist} lists + {index.m} codebooks of "
            f"{index.ksub}) in {t_train:.2f} s, encoded and staged {n} rows in {t_stage:.2f} s, "
            f"pad {st[7]}, canvas {tuple(st[5].shape)} {st[5].dtype} [{card}]")
        result[name] = {"train_s": t_train, "stage_s": t_stage, "pad": st[7]}
        return index

    q100 = np.ascontiguousarray(q[:100])
    idx = build("m96_ksub256", ksub=256, refine_factor=20)
    pq_ref["ksub256"] = {"centroids": idx._centroids.cpu().numpy(),
                         "codebooks": idx._codebooks.cpu().numpy()}
    run_routes(idx, "m96_ksub256", [
        ("B=128 k=10 (shortlist 200, select)", q, 10, {}, gt_i),
        ("B=128 k=20 (shortlist 400, dense qpb 8)", q, 20, {}, gt_i),
        ("B=100 k=20 (dense qpb 1)", q100, 20, {}, gt_i),
        ("B=128 k=10 10% id_mask", q, 10, {"id_mask": mask}, gtm_i),
        ("B=128 k=20 10% id_mask", q, 20, {"id_mask": mask}, gtm_i),
    ])
    assert 20 * 20 > 2 * LANE_K >= 20 * 10
    operands += [("ivf_pq m96 ksub256", "adc_scan_select", 200, adc_operands(idx, q)),
                 ("ivf_pq m96 ksub256", "adc_scan_dense", None, adc_operands(idx, q, 8)),
                 ("ivf_pq m96 ksub256 B=100", "adc_scan_dense", None,
                  adc_operands(idx, q100, 1)),
                 # qpb 1 on qpb 8's B=128 operands: the two block shapes timed
                 # on the same work.
                 ("ivf_pq m96 ksub256 B=128", "adc_scan_dense", None, adc_operands(idx, q, 1))]
    # The pure-ADC index on the same quantizer, with 256 duplicated rows:
    # duplicates tie exactly and keep their slot (probe) order.
    pure = IVFPQIndex(dim=d, nlist=nlist, nprobe=16, m=96, refine=False, device=device)
    pure._centroids, pure._codebooks = idx._centroids, idx._codebooks
    dup_rows = torch.from_numpy(gt_i[:, :2].reshape(-1)).to(device).long()
    pure.add(torch.cat([x_dev, x_dev[dup_rows]]),
             torch.arange(n + dup_rows.numel(), dtype=torch.int32, device=device))
    run_routes(pure, "pure_adc", [("B=128 k=10 (select, probe-order ties)", q, 10, {}, gt_i)])
    del pure
    # Tail, removal, restage on the first index.
    extra, _, _ = clustered_corpus(10_000, d, seed + 5)
    idx.add(torch.from_numpy(extra).to(device),
            torch.arange(n, n + extra.shape[0], dtype=torch.int32, device=device))
    assert idx._tail is not None and idx._tail.count == extra.shape[0]
    run_routes(idx, "m96_ksub256", [("tail k=10", q, 10, {}, gt_i), ("tail k=20", q, 20, {}, gt_i)])
    removed = idx.remove_ids(np.arange(0, n, 997))             # restages with the tail
    assert removed == len(range(0, n, 997)) and idx._tail is None
    run_routes(idx, "m96_ksub256", [("after remove + restage k=10", q, 10, {}, gt_i),
                                    ("after remove + restage k=20", q, 20, {}, gt_i)])
    del idx
    torch.cuda.empty_cache()
    idx16 = build("m96_ksub16_packed_bf16", ksub=16, refine_factor=20, refine_dtype="bfloat16")
    pq_ref["ksub16"] = {"centroids": idx16._centroids.cpu().numpy(),
                        "codebooks": idx16._codebooks.cpu().numpy()}
    run_routes(idx16, "m96_ksub16_packed_bf16", [
        ("B=128 k=10 (select)", q, 10, {}, gt_i),
        ("B=128 k=20 (dense qpb 8)", q, 20, {}, gt_i),
        ("B=128 k=10 10% id_mask", q, 10, {"id_mask": mask}, gtm_i),
    ])
    operands += [("ivf_pq m96 ksub16 packed", "adc_scan_select", 200, adc_operands(idx16, q)),
                 ("ivf_pq m96 ksub16 packed", "adc_scan_dense", None,
                  adc_operands(idx16, q, 8))]
    del idx16, x_dev
    torch.cuda.empty_cache()
    return result, operands, pq_ref


# -- phase memodb_ivf_pq: MemoDB on IVFPQIndex at 100k notes --------------------------------


def pq_keys(db, q_emb, k_adc, card):
    """Per query: (probe set, ADC shortlist id set) of a MemoDB's index on its
    own route (the card route through the plain versions, which equal the
    kernels bit for bit and launch nothing)."""
    index = db._index()
    (cents, c_sq, books, lc, li, canvas, ic, _) = index._stage()
    q = index._rotate_device(torch.from_numpy(q_emb).to(cents.device))
    nprobe = min(index.nprobe, int(cents.shape[0]))
    k_adc = min(k_adc, index.ntotal)
    if card:
        probes = adc_mod.adc_prologue(q, cents, c_sq, books, nprobe)[0]
        search = adc_mod.adc_dense_search if k_adc > 2 * LANE_K else adc_mod.adc_full_search
        with plain_adc():
            _, ids = search(cents, c_sq, books, canvas, ic, li, q, nprobe, k_adc)
    else:
        _, probes = topk_mod.stable_topk(scores_via_matmul(q, cents, c_sq), nprobe)
        if lc is None:
            lc = adc_mod.unstage_codes_device(canvas, index.m, int(books.shape[1]))
        _, ids = index._cpu_route(cents, c_sq, books, lc, li, q, nprobe, k_adc)
    return [(frozenset(p.tolist()), frozenset(i[i >= 0].tolist()))
            for p, i in zip(probes.cpu(), ids.cpu())]


def phase_memodb_ivf_pq(device, n_records, seed, workdir, card):
    import os

    records, queries = synthetic_notes(n_records, seed)
    q_emb = embed_texts(queries, device="cpu")
    gdir, cdir = workdir / "gpu", workdir / "cpu"
    gdir.mkdir()
    cdir.mkdir()
    os.environ["C99VDB_INDEX"] = "ivf_pq"
    try:
        gpu = MemoDB("notes", cwd=str(gdir), device=device)
        t0 = time.perf_counter()
        gpu.save_many(records)
        log(f"memodb_ivf_pq: save_many of {n_records} notes (host mode, nlist 64, m 8, "
            f"ksub 256) in {time.perf_counter() - t0:.1f} s")

        def copy_card_files():
            for f in gdir.iterdir():
                shutil.copy2(f, cdir / f.name)

        copy_card_files()
        cpu = MemoDB("notes", cwd=str(cdir), device="cpu")
        stats = {"swaps": 0, "skipped": 0, "compared": 0}

        def both(fn, label, n_q, k_adc):
            g, c = fn(gpu), fn(cpu)
            kg = pq_keys(gpu, q_emb[:n_q], k_adc, card=True)
            kc = pq_keys(cpu, q_emb[:n_q], k_adc, card=False)
            for qi, (hg, hc) in enumerate(zip(g, c)):
                if kg[qi] != kc[qi]:
                    stats["skipped"] += 1
                    continue
                stats["swaps"] += compare_hits([hg], [hc], f"{label} query {qi}")
            stats["compared"] += n_q
            return g

        def describe(label):
            index = gpu._index()
            st = index._stage()
            log(f"memodb_ivf_pq {label}: {index._mode} mode, nlist {int(st[0].shape[0])}, pad "
                f"{st[7]}, m {index.m}, nprobe {index.nprobe}, shortlist "
                f"{10 * index.refine_factor} -> select kernel")

        g = both(lambda db: db.recall_many(queries, k=10), "recall_many", len(queries), 40)
        assert all(len(h) == 10 for h in g)
        describe("recall_many")
        # The filtered fetch is 4k deep: its shortlist is 160.
        both(lambda db: db.recall_many(queries, k=10, filter="{source: user}"),
             "recall_many {source: user}", len(queries), 160)
        both(lambda db: [db.recall(qs, k=10, filter="{priority: {$gte: 3}}", pushdown=True)[:10]
                         for qs in queries[:8]], "recall(pushdown=True)", 8, 160)
        victim = gpu.recall_many(queries[:1], k=1)[0][0].doc_id
        assert gpu.delete(victim) and cpu.delete(victim)
        g = both(lambda db: db.recall_many(queries, k=10), "recall_many after delete",
                 len(queries), 40)
        assert all(h.doc_id != victim for hs in g for h in hs)
        t0 = time.perf_counter()
        dropped = gpu.reindex()
        t_reindex = time.perf_counter() - t0
        assert dropped == cpu.reindex() == 1
        log(f"memodb_ivf_pq: reindex (device mode, nlist {auto_nlist(n_records - 1)}) in "
            f"{t_reindex:.1f} s on the card")
        copy_card_files()
        describe("after reindex")
        both(lambda db: db.recall_many(queries, k=10), "recall_many after reindex",
             len(queries), 40)
        share = stats["skipped"] / stats["compared"]
        assert share <= 0.01, f"memodb_ivf_pq: {stats['skipped']} queries skipped"
        log(f"memodb_ivf_pq: all steps agree with MemoDB(device='cpu') ({stats['swaps']} tie "
            f"swaps; {stats['skipped']} of {stats['compared']} query results skipped for "
            f"differing probe sets or ADC shortlists between the card and CPU routes)")
        ops = adc_operands(gpu._index(), q_emb)
        times = []
        before = adc_counts()
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gpu.recall_many(queries, k=10)
            times.append(time.perf_counter() - t0)
        per_call = {k: (v - before[k]) / 5 for k, v in adc_counts().items()}
        t_med = sorted(times)[len(times) // 2]
        log(f"memodb_ivf_pq: recall_many 128 queries k=10 median {t_med * 1e3:.2f} ms -> "
            f"{128 / t_med:.1f} QPS (host clock, {n_records} notes), kernel launches per call "
            f"{per_call} [{card}]")
    finally:
        os.environ.pop("C99VDB_INDEX", None)
    return ({"qps": 128 / t_med, "per_call": per_call, "reindex_s": t_reindex,
             "skipped": stats["skipped"], "compared": stats["compared"],
             "swaps": stats["swaps"]}, ops)


# -- phase cli: the memo CLI at 100k notes, on the card against the CPU ------------------

CLI = Path(__file__).resolve().parent / "memo-torch"


def save_input(records) -> str:
    """The notes as the multi-doc YAML that `save` reads."""
    out = []
    for r in records:
        m = r.get("metadata")
        meta = (f"metadata: {{source: {m['source']}, priority: {m['priority']}, "
                f"topic: {m['topic']}}}\n" if m else "")
        out.append(f"---\n{meta}body: {r['body']}\n")
    return "".join(out)


def run_cli(jobs):
    """Run (side, side dir, argv, stdin, env) jobs of ./memo-torch at once,
    each in its side's directory; returns [(rc, stdout, stderr, seconds)]
    with the side's directory in the output replaced by <dir>."""
    from concurrent.futures import ThreadPoolExecutor

    def one(job):
        _, cwd, argv, stdin, env = job
        t0 = time.perf_counter()
        p = subprocess.run([str(CLI), *argv], input=stdin, capture_output=True, text=True,
                           cwd=cwd, env=env, timeout=600)
        seconds = time.perf_counter() - t0
        return (p.returncode, p.stdout.replace(str(cwd), "<dir>"),
                p.stderr.replace(str(cwd), "<dir>"), seconds)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(one, jobs))


def same_output(label, card, cpu):
    """The card's (rc, stdout, stderr) equals the CPU's, byte for byte."""
    if card[:3] != cpu[:3]:
        g, c = card[1].splitlines(), cpu[1].splitlines()
        differing = sum(a != b for a, b in zip(g, c)) + abs(len(g) - len(c))
        raise AssertionError(
            f"cli {label}: card and CPU differ (rc {card[0]} vs {cpu[0]}; {differing} of "
            f"{max(len(g), len(c))} stdout lines; stderr {card[2][:200]!r} vs {cpu[2][:200]!r})")
    assert card[0] == 0 and card[2] == "", f"cli {label}: rc {card[0]}, stderr {card[2][:300]!r}"
    return card[1]


def same_files(label, gdir, cdir, names=("notes.yaml", "notes.memo")):
    for name in names:
        assert (gdir / name).read_bytes() == (cdir / name).read_bytes(), (
            f"cli {label}: {name} differs between the card's and the CPU's run")


def phase_cli(n_records, seed, workdir, card):
    """The memo CLI through ./memo-torch in subprocesses at `n_records`
    notes (phase 4's corpus): every verb on the card (C99VDB_PLATFORM unset)
    and with C99VDB_PLATFORM=cpu on a copy of the same files; their (rc,
    stdout, stderr) and files must be equal. Steps that only read run at
    the same time (12 to 16 processes), the others in card/CPU pairs. Then
    reindex with ivf_flat, ivf_pq, sharded_flat, sharded_ivf and
    sharded_ivf_pq on the card, and serve --batch from the card's files on
    both; the launcher without a visible card; one serve --batch in this
    process on the card."""
    import io
    import os
    from contextlib import redirect_stdout

    from c99_vectordb_tpu_torch import cli as torch_cli

    records, queries = synthetic_notes(n_records, seed)
    gdir, cdir = workdir / "gpu", workdir / "cpu"
    for d in (gdir, cdir):
        d.mkdir()
        (d / "notes_in.yaml").write_text(save_input(records))
    env_card = {k: v for k, v in os.environ.items()
                if k not in ("C99VDB_PLATFORM", "C99VDB_INDEX")}
    env_cpu = dict(env_card, C99VDB_PLATFORM="cpu")
    times: dict[str, dict] = {}

    def note_time(verb, side, seconds, at_once):
        entry = times.setdefault(verb, {"card": [], "cpu": [], "at_once": at_once})
        entry[side].append(seconds)

    def both(steps, dirs=(gdir, cdir)):
        """Run every (label, argv, stdin) step on the card (in dirs[0]) and
        on the CPU (in dirs[1]), all at once; hold each card result equal to
        the CPU's and return the card's stdout of each step."""
        jobs = [job for _, argv, stdin in steps
                for job in (("card", dirs[0], argv, stdin, env_card),
                            ("cpu", dirs[1], argv, stdin, env_cpu))]
        results = run_cli(jobs)
        outs = []
        for i, (label, _, _) in enumerate(steps):
            card_out, cpu_out = results[2 * i], results[2 * i + 1]
            note_time(label.split()[0], "card", card_out[3], len(jobs))
            note_time(label.split()[0], "cpu", cpu_out[3], len(jobs))
            outs.append(same_output(label, card_out, cpu_out))
        return outs

    f = ["-f", "notes"]
    single_in = "\n".join(queries[:16]) + "\n"
    stream = "\n".join(queries[:100]) + "\n\n" + "\n".join(queries[100:128]) + "\n"
    out, = both([("save", [*f, "save", "notes_in.yaml"], None)])
    assert out.count("Memorized: ") == n_records
    same_files("save", gdir, cdir)
    shutil.copy2(gdir / "notes.yaml", workdir / "notes.yaml")
    reads = (
        [(f"recall -k 10 #{i}", [*f, "recall", "-k", "10", q], None)
         for i, q in enumerate(queries[:2])]
        + [(f"recall --filter #{i}", [*f, "recall", "-k", "10", "--filter", "{source: user}", q],
            None) for i, q in enumerate(queries[2:4])]
        + [(f"recall --yaml #{i}", [*f, "recall", "--yaml", "-k", "10", q], None)
           for i, q in enumerate(queries[4:6])]
        + [("analyze table", [*f, "analyze", "--filter", "{source: user}"], None),
           ("analyze --stats", [*f, "analyze", "--filter", "{}", "--stats", "priority"], None)])
    outs = both(reads)
    assert all(o.startswith("Top 10 results:\n") and o.count("] Score: ") == 10
               for o in outs[:4])
    assert all(len(yaml.safe_load(o)["results"]) == 10 for o in outs[4:6])
    assert outs[6].startswith("Matched: ") and "Range (numeric):" in outs[7]
    single, batched = both([
        ("serve -k 10", [*f, "serve", "-k", "10"], single_in),
        ("serve --batch 128", [*f, "serve", "--batch", "128", "-k", "10"], stream)])
    assert single.count("Top 10 results:") == 16
    assert batched.count("Top 10 results:") == 128 and batched.startswith(single)
    # Where a recall's time goes: its -v stage lines (timings blanked for
    # the comparison), and a process that only imports torch and wakes the card.
    verbose = run_cli([(side, d, [*f, "-v", "recall", "-k", "10", queries[0]], None, env)
                       for side, d, env in (("card", gdir, env_card), ("cpu", cdir, env_cpu))])
    blank = [(rc, out, re.sub(r"(\[timing\] [^:\n]+: )[0-9.]+ ms", r"\1<ms> ms", err), t)
             for rc, out, err, t in verbose]
    assert blank[0][:3] == blank[1][:3], f"cli -v recall: {blank[0][2]!r} vs {blank[1][2]!r}"
    assert blank[0][0] == 0 and blank[0][1] == outs[0], "cli -v recall differs from recall"
    for side, res in zip(("card", "cpu"), verbose):
        log(f"cli -v recall on the {side}: {res[3]:.2f} s wall; "
            + "; ".join(res[2].strip().splitlines()))
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", "import torch; torch.zeros(1, device='cuda')"],
                   check=True, env=env_card)
    log(f"cli: a process that imports torch and wakes the card: "
        f"{time.perf_counter() - t0:.2f} s wall [{card}]")
    out, = both([("reindex", [*f, "reindex"], None)])
    assert out == "Rebuilt index from notes.yaml\nWrote index: notes.memo\n"
    same_files("reindex", gdir, cdir)
    out, = both([("clean", [*f, "clean"], None)])
    assert out.startswith("Cleared memory database (<dir>/notes.memo")
    log(f"cli flat: save, recall (-k 10, --filter, --yaml), serve (16 queries), serve "
        f"--batch 128 (100 + 28 queries), analyze (table, --stats), reindex, clean: the "
        f"card's rc, stdout and stderr equal the CPU run's byte for byte, and so do the "
        f"files ({n_records} notes)")

    # ivf_flat, ivf_pq, sharded_flat, sharded_ivf and sharded_ivf_pq: reindex on
    # the card (all at once), then serve --batch from the card's files on the
    # card and on the CPU (all ten at once).
    kinds = ("ivf_flat", "ivf_pq", "sharded_flat", "sharded_ivf", "sharded_ivf_pq")
    dirs = {kind: (workdir / kind / "gpu", workdir / kind / "cpu") for kind in kinds}
    for kind in kinds:
        for d in dirs[kind]:
            d.mkdir(parents=True)
        shutil.copy2(workdir / "notes.yaml", dirs[kind][0] / "notes.yaml")
    built = run_cli([("card", dirs[kind][0], [*f, "-v", "reindex"], None,
                      dict(env_card, C99VDB_INDEX=kind)) for kind in kinds])
    for kind, res in zip(kinds, built):
        assert res[0] == 0 and f"Rebuilt index with {n_records} vectors" in res[2], (
            f"cli {kind} reindex: rc {res[0]}, stderr {res[2][:300]!r}")
        note_time(f"reindex[{kind}]", "card", res[3], len(kinds))
        for p in dirs[kind][0].iterdir():
            shutil.copy2(p, dirs[kind][1] / p.name)
        assert read_index(dirs[kind][0] / "notes.memo", device="cpu").kind == kind
    jobs = [job for kind in kinds
            for job in (("card", dirs[kind][0], [*f, "serve", "--batch", "128", "-k", "10"],
                         stream, env_card),
                        ("cpu", dirs[kind][1], [*f, "serve", "--batch", "128", "-k", "10"],
                         stream, env_cpu))]
    served = run_cli(jobs)
    for i, kind in enumerate(kinds):
        out = same_output(f"serve[{kind}] --batch 128", served[2 * i], served[2 * i + 1])
        note_time(f"serve[{kind}]", "card", served[2 * i][3], len(jobs))
        note_time(f"serve[{kind}]", "cpu", served[2 * i + 1][3], len(jobs))
        assert out == batched, f"cli {kind}: serve --batch differs from the flat index's"
        built_as = ", ".join(
            ([] if kind == "sharded_flat" else [f"nlist {auto_nlist(n_records)}"])
            + (["one rank"] if kind.startswith("sharded_") else []))
        log(f"cli {kind}: reindex on the card ({built_as}); serve --batch 128 from its files "
            f"equals the CPU run's byte for byte and the flat index's output")
    pq_dir = dirs["ivf_pq"][0]

    no_card, = run_cli([("card", pq_dir, [*f, "recall", "tea"], None,
                         dict(env_card, CUDA_VISIBLE_DEVICES=""))])
    assert no_card[0] == 1 and no_card[1] == "", no_card[:3]
    assert no_card[2].count("\n") == 1 and no_card[2].startswith("Error: "), no_card[2]
    log(f"cli without a visible card: exit 1, one stderr line: {no_card[2].strip()}")

    # One serve --batch in this process, on the card: the store lives there
    # (the peak is counted above what earlier phases still hold).
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    old = {k: os.environ.pop(k, None) for k in ("C99VDB_PLATFORM", "C99VDB_INDEX")}
    cwd, stdin = os.getcwd(), sys.stdin
    buf = io.StringIO()
    try:
        os.chdir(pq_dir)
        sys.stdin = io.StringIO(stream)
        with redirect_stdout(buf):
            rc = torch_cli.main(["memo", *f, "serve", "--batch", "128", "-k", "10"])
    finally:
        os.chdir(cwd)
        sys.stdin = stdin
        os.environ.update({k: v for k, v in old.items() if v is not None})
    peak = torch.cuda.max_memory_allocated() - held
    store_bytes = n_records * 384 * 4
    assert rc == 0 and buf.getvalue() == batched, "cli in-process serve --batch differs"
    assert peak > store_bytes, f"cli: peak device memory {peak} <= store {store_bytes}"
    launches = {"fused_l2_topk": topk_cuda.fused_l2_topk.launches, **ivf_counts(),
                **adc_counts()}
    log(f"cli in-process serve --batch 128 (ivf_pq files): equal output; peak device memory "
        f"above the {held / 2**20:.1f} MiB held before it {peak / 2**20:.1f} MiB > the store's "
        f"{store_bytes / 2**20:.1f} MiB; kernel launches "
        f"{launches} (the CLI ranks with plain torch)")

    for verb, sides in times.items():
        card_s = ", ".join(f"{t:.2f}" for t in sides["card"])
        cpu_s = ", ".join(f"{t:.2f}" for t in sides["cpu"]) or "-"
        log(f"cli {verb}: card {card_s} s, cpu {cpu_s} s (wall, per process; "
            f"{sides['at_once']} processes at once) [{card}]")


# -- phase sharded: ShardedFlatIndex at 1M x 384, one rank and two --------------------

SHARDED_WORLD = 2           # ranks of the multi-rank run, all on cuda:0 under gloo
SHARDED_TIMEOUT_S = 600     # the ranks' join timeout (a hang fails the phase)


def sharded_corpus(seed):
    """Phase 3's corpus and mask (the same draws), and phase 5's 10,000
    tail rows."""
    x, q, rng = clustered_corpus(1_000_000, 384, seed)
    mask = rng.random(x.shape[0]) < 0.10
    extra, _, _ = clustered_corpus(10_000, 384, seed + 5)
    return x, q, mask, extra


def run_sharded(mesh, x, q, mask, extra):
    """ShardedFlatIndex's path on `mesh`, for the f32 and int8 stores:
    B = 128, k = 10 search, unfiltered and with `mask`; a tail add of
    `extra`, remove_ids of every 997th id (which folds the tail), and a
    forced restage. Counts are reset before and read after the path; then
    the flat kernel is held against its plain version on this rank's shard
    (its first staging's operands). Returns {dtype: {step: (dists, ids)},
    "search_ms": {dtype: ms}, "launches": by mode, "kernel_err": {dtype:
    max |key diff|}, "per": {dtype: rows of this rank's shard}}."""
    n = x.shape[0]
    ids = np.arange(n, dtype=np.int64)
    out = {"search_ms": {}, "per": {}}
    checks = {}
    reset_counts()
    for dt in ("float32", "int8"):
        index = ShardedFlatIndex(dim=x.shape[1], scan_dtype=dt, mesh=mesh)
        index.add(x, ids)
        index.search(q[:1], 10)                  # stage
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = index.search(q, 10)
        torch.cuda.synchronize()
        out["search_ms"][dt] = (time.perf_counter() - t0) * 1e3
        steps = {"unfiltered": got, "10% id_mask": index.search(q, 10, id_mask=mask)}
        staged = index._stage()
        out["per"][dt] = int(staged[0].shape[0])
        qd = torch.from_numpy(q).to(staged[0].device)
        ks = min(shortlist_depth(10, n), staged[0].shape[0])
        if dt == "int8":
            q_st, rs = topk_cuda.stage_queries(qd * staged[5], torch.int8)
            checks[dt] = (q_st, staged[3], staged[4], ks, rs)
        else:
            q_st, rs = topk_cuda.stage_queries(qd, torch.float32)
            checks[dt] = (q_st, staged[0], staged[2], ks, rs)
        index.add(extra, np.arange(n, n + extra.shape[0]))
        assert index._tail is not None and index._tail.count == extra.shape[0]
        steps["tail"] = index.search(q, 10)
        removed = index.remove_ids(np.arange(0, n, 997))
        assert removed == len(range(0, n, 997)) and index._tail is None
        steps["after remove"] = index.search(q, 10)
        index._restage_needed = True
        steps["restaged"] = index.search(q, 10)
        out[dt] = steps
        del index, staged
        torch.cuda.empty_cache()
    out["launches"] = dict(topk_cuda.fused_l2_topk.launches_by_mode)
    out["kernel_err"] = {dt: check_selection(*ops, exact=dt == "int8",
                                             label=f"sharded {dt} shard operands")
                         for dt, ops in checks.items()}
    return out


def sharded_rank(args) -> int:
    """One rank of phase sharded's (with --ivf-centroids, phase
    sharded_ivf's; with --pq-quantizer, phase sharded_ivf_pq's) multi-rank
    run (a child process): regenerates the corpus from the seed, runs
    run_sharded (run_sharded_ivf on those centroids, run_sharded_pq on that
    quantizer) on the world's data mesh, and writes this rank's results to
    --out."""
    import datetime
    import pickle

    import torch.distributed as dist

    from c99_vectordb_tpu_torch.parallel import default_data_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{args.store}", rank=args.sharded_rank,
                            world_size=args.world,
                            timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    try:
        x, q, mask, extra = sharded_corpus(args.seed)
        mesh = default_data_mesh(torch.device("cuda", 0))
        if args.ivf_centroids:
            res = run_sharded_ivf(mesh, x, q, mask, extra, np.load(args.ivf_centroids),
                                  time_shard=True)
        elif args.pq_quantizer:
            with np.load(args.pq_quantizer) as z:
                quant = {"ksub256": {"centroids": z["centroids"], "codebooks": z["codebooks"]}}
            res = run_sharded_pq(mesh, x, q, mask, extra, quant, time_shard=True)
        else:
            res = run_sharded(mesh, x, q, mask, extra)
        with open(Path(args.out) / f"rank{args.sharded_rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(seed, label, centroids=None, pq_quantizer=None):
    """The multi-rank run of a sharded phase: SHARDED_WORLD processes of this
    script on cuda:0 (gloo), each regenerating the corpus from the seed
    (the IVF run also reads `centroids` from a file, the IVF-PQ run the
    "ksub256" quantizer of `pq_quantizer`). Returns every rank's results;
    fails if a rank fails or outlives SHARDED_TIMEOUT_S."""
    import pickle

    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_", dir=str(Path.cwd())))
    try:
        t0 = time.perf_counter()
        extra = []
        if centroids is not None:
            np.save(workdir / "centroids.npy", centroids)
            extra = ["--ivf-centroids", str(workdir / "centroids.npy")]
        if pq_quantizer is not None:
            np.savez(workdir / "quantizer.npz", **pq_quantizer["ksub256"])
            extra = ["--pq-quantizer", str(workdir / "quantizer.npz")]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
             "--sharded-rank", str(r), "--world", str(SHARDED_WORLD),
             "--store", str(workdir / "store"), "--out", str(workdir), *extra],
            stdout=(workdir / f"log{r}").open("w"), stderr=subprocess.STDOUT)
            for r in range(SHARDED_WORLD)]
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=SHARDED_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                for other in procs:
                    other.kill()
                rcs.append("timeout")
        for r, rc in enumerate(rcs):
            assert rc == 0, f"{label} rank {r}: rc {rc}\n" + (
                workdir / f"log{r}").read_text()[-4000:]
        ranks = []
        for r in range(SHARDED_WORLD):
            with open(workdir / f"rank{r}.pkl", "rb") as fh:
                ranks.append(pickle.load(fh))
        log(f"{label} W={SHARDED_WORLD}: {time.perf_counter() - t0:.1f} s in "
            f"{SHARDED_WORLD} processes, launches {ranks[0]['launches']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return ranks


def phase_sharded(device, seed, card, flat_results, corpus):
    """ShardedFlatIndex on phase 3's 1M x 384 corpus at W = 1 (this process,
    no process group) and W = 2 (two processes on cuda:0 under gloo, 500,000
    rows a rank): strict recall@10 = 1.0 against the float64 ground truth,
    ids equal to phase 3's FlatIndex, the tail, removal and restage against
    the ground truth of their rows; W = 2's ids equal W = 1's. Returns
    (summary, W = 1 launches by mode, W = 2 launches, kernel errors)."""
    from c99_vectordb_tpu_torch.parallel import default_data_mesh

    x, q, mask, gt_i, gtm_i = corpus
    extra = clustered_corpus(10_000, x.shape[1], seed + 5)[0]
    n = x.shape[0]
    t0 = time.perf_counter()
    one = run_sharded(default_data_mesh(device), x, q, mask, extra)
    log(f"sharded W=1: {time.perf_counter() - t0:.1f} s, launches {one['launches']}")
    ranks = spawn_ranks(seed, "sharded")
    two = ranks[0]

    # Ground truth of the tail's and the removal's rows.
    x_all = np.concatenate([x, extra])
    x64 = torch.from_numpy(x_all).to(device, torch.float64)
    keep = torch.ones(x_all.shape[0], dtype=torch.bool, device=device)
    keep[torch.arange(0, n, 997, device=device)] = False
    gt = {"tail": ground_truth(x64, q, 10), "after remove": ground_truth(x64, q, 10, keep)}
    del x64
    gt["restaged"] = gt["after remove"]
    summary = {"search_ms": {1: one["search_ms"], SHARDED_WORLD: two["search_ms"]},
               "per": {1: one["per"], SHARDED_WORLD: two["per"]}}
    for dt in ("float32", "int8"):
        fd, fi, fmd, fmi = flat_results[dt]
        for step, (gd, gi) in one[dt].items():
            if step in ("unfiltered", "10% id_mask"):
                want_d, want_i = (fd, fi) if step == "unfiltered" else (fmd, fmi)
                assert np.array_equal(gi, want_i), f"sharded {dt} {step}: ids differ from FlatIndex"
                assert np.abs(gd - want_d).max() <= SCORE_TOL, f"sharded {dt} {step}: distances"
                truth = gt_i if step == "unfiltered" else gtm_i
            else:
                wd, truth = gt[step]
                assert np.abs(gd - wd).max() <= 1e-5, f"sharded {dt} {step}: distances"
            rec = recall_at(gi, truth)
            assert rec == 1.0, f"sharded {dt} {step}: recall@10 {rec}"
            for r, res in enumerate(ranks):
                od, oi = res[dt][step]
                assert np.array_equal(oi, gi), (
                    f"sharded {dt} {step}: rank {r} of W={SHARDED_WORLD} differs from W=1")
                assert np.abs(od - gd).max() <= SCORE_TOL
        log(f"sharded {dt}: W=1 and W={SHARDED_WORLD} (every rank): strict recall@10 = 1.0 "
            f"unfiltered, with the 10% id_mask, after a {extra.shape[0]}-row tail add, after "
            f"remove_ids of {len(range(0, n, 997))} rows and after a restage; ids equal to "
            f"FlatIndex's and across W; B=128 search {one['search_ms'][dt]:.2f} ms (W=1), "
            f"{two['search_ms'][dt]:.2f} ms (W={SHARDED_WORLD}, rank 0) host clock [{card}]")
    for mode in ("float32", "int8"):
        assert one["launches"][mode] > 0 and two["launches"][mode] > 0, (
            f"sharded: the flat kernel's mode {mode} was not launched "
            f"(W=1 {one['launches']}, W={SHARDED_WORLD} {two['launches']})")
    errs = {dt: max([one["kernel_err"][dt]] + [res["kernel_err"][dt] for res in ranks])
            for dt in ("float32", "int8")}
    log(f"sharded: the flat kernel agrees with its plain version on every rank's shard "
        f"(max |key diff| {errs})")
    return summary, one["launches"], two["launches"], errs


# -- phase sharded_ivf: ShardedIVFIndex at 1M x 384, one rank and two ------------------

# nprobe 3: the dense route at W = 1 (3 x pad 1152 <= 4096) and W = 2 (pad_local 576);
# 16: the select route at both.
SHARDED_IVF_NPROBES = (3, 16)


def sharded_ivf_operands(index, q, nprobe):
    """The scan operands of this rank's block at `nprobe` (its lists, its
    marks, the probes and staged queries), in staged_operands' form."""
    staged = index._stage()
    qd = torch.from_numpy(q).to(staged[2].device)
    probes = ivf_scan.coarse_probes(qd, staged[0], staged[1], nprobe)
    ops = {"probes": probes, "pad": index._params[1], "hwm": index._hwm}
    if index.scan_dtype == "int8":
        q8, rs = ivf_scan.sq8_stage_queries(qd, staged[3])
        ops.update(kind="int8", q8=q8, rs=rs, codes=staged[2], sqn=staged[4], ids=staged[5])
    else:
        ops.update(kind="float", q=qd, q_sq=(qd * qd).sum(1), lists=staged[2], sqn=staged[3],
                   ids=staged[4])
    return ops


def sharded_ivf_step(index, q, label, **kw):
    """One B = 128, k = 10 search on the card route, against the same route
    with every IVF kernel swapped for its plain version (f32 within
    IVF_REL_TOL, int8 bit for bit). Returns ((dists, ids), host seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kd, ki = index.search(q, 10, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with plain_kernels():
        pd, pi = index.search(q, 10, **kw)
    if index.scan_dtype == "int8":
        assert np.array_equal(kd, pd) and np.array_equal(ki, pi), (
            f"{label}: the route differs from its plain version")
    else:
        compare_topk(pd, pi, kd, ki, label)
    return (kd, ki), secs


def run_sharded_ivf(mesh, x, q, mask, extra, centroids, time_shard=False):
    """ShardedIVFIndex's path on `mesh`, device mode, on `centroids`, for the
    f32 store and the int8 store (f32 rerank): B = 128, k = 10 search at
    nprobe 3 and 16, unfiltered and with `mask`; a tail add of `extra`,
    remove_ids of every 997th id (which folds the tail) and a forced
    restage, at nprobe 16. Every search is held against the same route on
    the plain versions. Counts are reset before and read after the path;
    then each IVF kernel the path ran is held against its plain version on
    this rank's block. time_shard (a multi-rank run): rank 0 then times each
    kernel on its block while the other ranks wait (time_ivf; its
    "kernel_times"). Returns {dtype: {(nprobe, step): (dists, ids)},
    "search_ms": {(dtype, nprobe, step): ms}, "pad_local", "launches",
    "kernel_err": {kernel: max |diff|}}."""
    device = mesh.device
    n, d = x.shape
    x_dev = torch.from_numpy(x).to(device)
    ids_dev = torch.arange(n, dtype=torch.int32, device=device)
    extra_dev = torch.from_numpy(extra).to(device)
    extra_ids = torch.arange(n, n + extra.shape[0], dtype=torch.int32, device=device)
    out = {"search_ms": {}}
    checks = []
    reset_counts()
    for dt in ("float32", "int8"):
        index = ShardedIVFIndex(dim=d, nlist=centroids.shape[0], nprobe=16, scan_dtype=dt,
                                mesh=mesh)
        index._centroids = torch.from_numpy(centroids).to(device)    # phase ivf's quantizer
        index.add(x_dev, ids_dev)
        index.search(q[:1], 10)                  # stage
        out["pad_local"] = index._params[1]
        steps = {}
        for nprobe in SHARDED_IVF_NPROBES:
            for name, kw in (("unfiltered", {}), ("10% id_mask", {"id_mask": mask})):
                steps[(nprobe, name)], secs = sharded_ivf_step(
                    index, q, f"sharded_ivf {dt} p={nprobe} {name}", nprobe=nprobe, **kw)
                out["search_ms"][(dt, nprobe, name)] = secs * 1e3
        if dt == "int8":
            checks.append(("ivf_scan_dense_int8", sharded_ivf_operands(index, q, 16),
                           shortlist_depth(10, n)))
        else:
            checks += [("ivf_scan_dense", sharded_ivf_operands(index, q, 3), 10),
                       ("ivf_scan_select", sharded_ivf_operands(index, q, 16), 10)]
        index.add(extra_dev, extra_ids)
        assert index._tail is not None and index._tail.count == extra.shape[0]
        steps[(16, "tail")] = sharded_ivf_step(index, q, f"sharded_ivf {dt} tail")[0]
        removed = index.remove_ids(np.arange(0, n, 997))     # folds the tail first
        assert removed == len(range(0, n, 997)) and index._tail is None
        steps[(16, "after remove")] = sharded_ivf_step(index, q, f"sharded_ivf {dt} removed")[0]
        index._restage_needed = True
        steps[(16, "restaged")] = sharded_ivf_step(index, q, f"sharded_ivf {dt} restaged")[0]
        out[dt] = steps
        del index
    out["launches"] = ivf_counts()
    out["kernel_err"] = {}
    for kernel, ops, k in checks:
        err = check_ivf_kernel(ops, kernel, k, f"sharded_ivf {kernel} shard operands")
        out["kernel_err"][kernel] = max(out["kernel_err"].get(kernel, 0.0), err)
    if time_shard:
        import torch.distributed as dist

        dist.barrier()
        if dist.get_rank() == 0:
            card = card_line()
            out["kernel_times"] = {
                kernel: time_ivf(ops, kernel, k, f"sharded_ivf W={dist.get_world_size()} rank 0",
                                 card)
                for kernel, ops, k in checks}
        dist.barrier()
    del checks, x_dev
    torch.cuda.empty_cache()
    return out


def phase_sharded_ivf(device, seed, card, ivf_ref, corpus):
    """ShardedIVFIndex on phase 3's 1M x 384 corpus with phase ivf's
    quantizer (nlist 4096) at W = 1 (this process, no process group) and
    W = 2 (two processes on cuda:0 under gloo, the centroids through a
    file): every search equals the same route on the plain versions; f32
    ids equal phase ivf's IVFFlatIndex at the same nprobe and step, and
    across W; each rank's kernels equal their plain versions on its block;
    every IVF kernel launched at both W; W = 2's rank 0 times each kernel
    on its block (its rows go into the kernels line's variants). Returns
    (summary, W = 1 launches, W = 2 launches (rank 0), kernel errors,
    {kernel: [W = 2 rank 0's time row]})."""
    from c99_vectordb_tpu_torch.parallel import default_data_mesh

    x, q, mask, gt_i, gtm_i = corpus
    extra = clustered_corpus(10_000, x.shape[1], seed + 5)[0]
    assert ivf_ref["dense_nprobe"] == SHARDED_IVF_NPROBES[0], ivf_ref["dense_nprobe"]
    t0 = time.perf_counter()
    one = run_sharded_ivf(default_data_mesh(device), x, q, mask, extra, ivf_ref["centroids"])
    log(f"sharded_ivf W=1: {time.perf_counter() - t0:.1f} s, pad_local {one['pad_local']}, "
        f"launches {one['launches']}")
    ranks = spawn_ranks(seed, "sharded_ivf", ivf_ref["centroids"])
    two = ranks[0]
    summary = {"pad_local": {1: one["pad_local"], SHARDED_WORLD: two["pad_local"]},
               "search_ms": {}, "recall": {}, "int8_rows_equal_across_w": {}}
    for dt in ("float32", "int8"):
        for key, (gd, gi) in one[dt].items():
            nprobe, step = key
            label = f"sharded_ivf {dt} p={nprobe} {step}"
            ref_key = (nprobe, "after remove") if step == "restaged" else key
            if dt == "float32":
                wd, wi = ivf_ref[ref_key]
                assert np.array_equal(gi, wi), f"{label}: ids differ from IVFFlatIndex's"
                compare_topk(wd, wi, gd, gi, f"{label} against IVFFlatIndex")
            for r, res in enumerate(ranks):
                od, oi = res[dt][key]
                assert np.array_equal(oi, ranks[0][dt][key][1]), f"{label}: rank {r} differs"
                if dt == "float32":
                    assert np.array_equal(oi, gi), f"{label}: W={SHARDED_WORLD} ids differ"
                    compare_topk(gd, gi, od, oi, f"{label} W={SHARDED_WORLD}")
            if dt == "int8":
                summary["int8_rows_equal_across_w"][f"p{nprobe} {step}"] = int(
                    (two[dt][key][1] == gi).all(axis=1).sum())
            if step in ("unfiltered", "10% id_mask"):
                truth = gt_i if step == "unfiltered" else gtm_i
                for w, res in ((1, one), (SHARDED_WORLD, two)):
                    summary["recall"][f"W={w} {dt} p{nprobe} {step}"] = recall_at(
                        res[dt][key][1], truth)
                    summary["search_ms"][f"W={w} {dt} p{nprobe} {step}"] = res["search_ms"][
                        (dt, nprobe, step)]
        rec = {k: v for k, v in summary["recall"].items() if f" {dt} " in k}
        ms = {k: round(v, 2) for k, v in summary["search_ms"].items() if f" {dt} " in k}
        log(f"sharded_ivf {dt}: W=1 and W={SHARDED_WORLD} (every rank) equal their plain "
            f"routes at nprobe {SHARDED_IVF_NPROBES}, unfiltered and with the 10% id_mask, after "
            f"a {extra.shape[0]}-row tail add, remove_ids of {len(range(0, x.shape[0], 997))} "
            f"rows and a restage" + (
                "; ids equal IVFFlatIndex's at every step and across W" if dt == "float32"
                else f"; rows equal across W: {summary['int8_rows_equal_across_w']}")
            + f"; recall@10 {rec}; B=128 search ms (host clock) {ms} [{card}]")
    for w, res in [(1, one)] + [(SHARDED_WORLD, r) for r in ranks]:
        assert all(v > 0 for v in res["launches"].values()), (
            f"sharded_ivf W={w}: an IVF kernel was not launched: {res['launches']}")
    errs = {}
    for res in [one] + ranks:
        for kernel, err in res["kernel_err"].items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    log(f"sharded_ivf: every IVF kernel agrees with its plain version on every rank's block "
        f"(max |diff| {errs})")
    for kernel, row in two["kernel_times"].items():
        log(f"times {kernel} {row['label']} (pad_local {row['pad']}, nprobe {row['nprobe']}): "
            f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library yardstick "
            f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}) "
            f"[{card}]")
    return (summary, one["launches"], two["launches"], errs,
            {kernel: [row] for kernel, row in two["kernel_times"].items()})


# -- phase sharded_ivf_pq: ShardedIVFPQIndex at 1M x 384, one rank and two -------------

SHARDED_PQ_KS = (10, 20)      # shortlists of 200 and 400 rows a shard at refine_factor 20
PQ_EXACT_TOL = 1e-5           # returned distances against the float64 ones of their ids


def sharded_pq_operands(index, q, qpb):
    """The dense ADC kernel's operands on this rank's block for queries q
    (numpy), in adc_operands' form."""
    cents, c_sq, books, canvas, const, li, _ = index._stage()
    q_adc = index._rotate_device(torch.from_numpy(q).to(cents.device))
    nprobe = min(index.nprobe, int(cents.shape[0]))
    probes, pc, qd = adc_mod.adc_prologue(q_adc, cents, c_sq, books, nprobe)
    return {"probes": probes, "pc": pc, "qd": qd, "codes": canvas, "const": const, "ids": li,
            "packed": adc_mod.packed_layout(int(books.shape[1]), index.m),
            "pad": index._params[1], "qpb": qpb, "hwm": index._hwm}


def sharded_pq_step(index, q, k, label, rows_of, banned=None, **kw):
    """One search on the card route: one dense ADC kernel launch (qpb 8 when
    B divides by 8, else 1), the same route with the kernel on its plain
    version bit for bit, every returned distance within PQ_EXACT_TOL
    relative of the float64 distance of its id's row (rows_of(ids)), and
    no id that `banned` (bool by id) marks. Returns ((dists, ids), host
    seconds)."""
    before = adc_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kd, ki = index.search(q, k, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = adc_counts()
    launched = {name: after[name] - before[name] for name in after if after[name] != before[name]}
    want = f"adc_scan_dense[qpb={8 if q.shape[0] % 8 == 0 else 1}]"
    assert launched == {want: 1}, f"{label}: launches {launched}, expected one {want}"
    with plain_adc():
        pd, pi = index._search(q, k, kernel_route=True, **kw)
    assert np.array_equal(kd, pd) and np.array_equal(ki, pi), f"{label}: not bit-equal"
    assert (ki >= 0).all(), f"{label}: fewer than k results"
    q64 = q.astype(np.float64)
    true = ((q64[:, None, :] - rows_of(ki).astype(np.float64)) ** 2).sum(-1)
    err = np.abs(kd - true) / np.maximum(true, 1e-30)
    assert float(err.max()) <= PQ_EXACT_TOL, f"{label}: distance error {err.max()} (relative)"
    if banned is not None:
        assert not banned[ki].any(), f"{label}: a masked or removed id came back"
    return (kd, ki), secs


def run_sharded_pq(mesh, x, q, mask, extra, quant, time_shard=False):
    """ShardedIVFPQIndex's path on `mesh`, device mode, on phase ivf_pq's
    quantizer `quant` (nlist 4096, m 96, ksub 256): refine_factor 20,
    nprobe 16, B = 128 at k 10 and 20 (shortlists 200 and 400), unfiltered
    and with `mask`, and B = 100 at k 20; a tail add of `extra`, remove_ids
    of every 997th id (which folds the tail) and a forced restage, at k 10
    and 20. On a one-rank mesh, also a ksub-16 (nibble-packed) index on the
    first 100,000 rows with quant's "ksub16" quantizer. Every search is
    sharded_pq_step. Counts are reset before and read after the path; then
    the kernel is held against its plain version on this rank's blocks.
    time_shard (a multi-rank run): rank 0 then times the kernel on its
    block while the other ranks wait. Returns {(k, step): (dists, ids)},
    the ksub-16 index's {"ksub16": ...}, "search_ms", "pad_local",
    "rows", "stage_s", "launches", "kernel_err"."""
    device = mesh.device
    n, d = x.shape
    n_extra = extra.shape[0]
    x_dev = torch.from_numpy(x).to(device)
    ids_dev = torch.arange(n, dtype=torch.int32, device=device)
    removed_ids = np.arange(0, n, 997)
    banned = np.zeros(n + n_extra, bool)
    banned[removed_ids] = True

    def rows_of(ids):
        return np.where((ids < n)[..., None], x[np.minimum(ids, n - 1)],
                        extra[np.clip(ids - n, 0, n_extra - 1)])

    def built(key, rows):
        index = ShardedIVFPQIndex(dim=d, nlist=quant[key]["centroids"].shape[0], nprobe=16, m=96,
                                  ksub=quant[key]["codebooks"].shape[1], refine_factor=20,
                                  mesh=mesh)
        index._centroids = torch.from_numpy(quant[key]["centroids"]).to(device)
        index._codebooks = torch.from_numpy(quant[key]["codebooks"]).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.add(x_dev[:rows], ids_dev[:rows])
        index.search(q[:1], 10)                  # stage
        torch.cuda.synchronize()
        return index, time.perf_counter() - t0

    out = {"search_ms": {}, "stage_s": {}}
    checks = []
    reset_counts()
    index, out["stage_s"]["ksub256"] = built("ksub256", n)
    out["pad_local"] = index._params[1]
    out["rows"] = index.scan_rows_per_chip(q.shape[0])
    assert out["rows"]["rows_per_chip"] * index._shards == out["rows"]["rows_all_chips"]

    def step(key, qq, k, **kw):
        label = f"sharded_ivf_pq W={index._shards} k={k} {key}"
        out[(k, key)], secs = sharded_pq_step(index, qq, k, label, rows_of, **kw)
        out["search_ms"][(k, key)] = secs * 1e3

    for k in SHARDED_PQ_KS:
        step("unfiltered", q, k)
        step("10% id_mask", q, k, banned=~np.concatenate([mask, np.zeros(n_extra, bool)]),
             id_mask=mask)
    step("B=100", np.ascontiguousarray(q[:100]), 20)
    checks.append(("B=128 qpb 8", sharded_pq_operands(index, q, 8)))
    index.add(torch.from_numpy(extra).to(device),
              torch.arange(n, n + n_extra, dtype=torch.int32, device=device))
    assert index._tail is not None and index._tail.count == n_extra
    for k in SHARDED_PQ_KS:
        step("tail", q, k)
    assert index.remove_ids(removed_ids) == removed_ids.size and index._tail is None
    for k in SHARDED_PQ_KS:
        step("after remove", q, k, banned=banned)
    index._restage_needed = True
    for k in SHARDED_PQ_KS:
        step("restaged", q, k, banned=banned)
    del index
    torch.cuda.empty_cache()
    if mesh.shape["data"] == 1:
        index, out["stage_s"]["ksub16"] = built("ksub16", 100_000)
        out["ksub16_pad"] = index._params[1]
        for k in SHARDED_PQ_KS:
            step("ksub16 100k rows", q, k)
        checks.append(("ksub16 packed 100k rows qpb 8", sharded_pq_operands(index, q, 8)))
        del index
    out["launches"] = adc_counts()
    out["kernel_err"] = max(check_adc_kernel(ops, "adc_scan_dense", None,
                                             f"sharded_ivf_pq {label} block operands")
                            for label, ops in checks)
    if time_shard:
        import torch.distributed as dist

        dist.barrier()
        if dist.get_rank() == 0:
            out["kernel_times"] = [time_adc(
                ops, "adc_scan_dense", None,
                f"sharded_ivf_pq W={dist.get_world_size()} rank 0 {label}", card_line())
                for label, ops in checks]
        dist.barrier()
    del checks, x_dev
    torch.cuda.empty_cache()
    return out


def phase_sharded_ivf_pq(device, seed, card, pq_ref, corpus):
    """ShardedIVFPQIndex on phase 3's 1M x 384 corpus with phase ivf_pq's
    quantizer at W = 1 (this process, no process group) and W = 2 (two
    processes on cuda:0 under gloo, the quantizer through a file): every
    search is sharded_pq_step on every rank, and every rank of W = 2 has the
    same results; the dense ADC kernel launched at both W, and equal to its
    plain version on every rank's block. Informative: W = 1's rows equal
    to phase ivf_pq's IVFPQIndex dense route at k 20, rows equal across W,
    recall@10, host-clock search ms. Returns (summary, W = 1 launches, W = 2
    launches (rank 0), the kernel's max |diff|, W = 2 rank 0's time rows)."""
    from c99_vectordb_tpu_torch.parallel import default_data_mesh

    x, q, mask, gt_i, gtm_i = corpus
    extra = clustered_corpus(10_000, x.shape[1], seed + 5)[0]
    quant = {key: pq_ref[key] for key in ("ksub256", "ksub16")}
    t0 = time.perf_counter()
    one = run_sharded_pq(default_data_mesh(device), x, q, mask, extra, quant)
    log(f"sharded_ivf_pq W=1: {time.perf_counter() - t0:.1f} s, pad_local {one['pad_local']} "
        f"(ksub16 100k rows: {one['ksub16_pad']}), staged in {one['stage_s']} s, "
        f"rows {one['rows']}, launches {one['launches']}")
    ranks = spawn_ranks(seed, "sharded_ivf_pq", pq_quantizer=quant)
    two = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        for key in (key for key in two if isinstance(key, tuple)):
            assert np.array_equal(res[key][1], two[key][1]), (
                f"sharded_ivf_pq {key}: rank {r} differs")
    summary = {"pad_local": {1: one["pad_local"], SHARDED_WORLD: two["pad_local"]},
               "rows": {1: one["rows"], SHARDED_WORLD: two["rows"]},
               "stage_s": {1: one["stage_s"], SHARDED_WORLD: two["stage_s"]},
               "search_ms": {}, "recall": {}, "rows_equal_across_w": {},
               "rows_equal_ivf_pq": {}}
    for step, ref in (("unfiltered", "B=128 k=20 (shortlist 400, dense qpb 8)"),
                      ("10% id_mask", "B=128 k=20 10% id_mask")):
        want = pq_ref[("m96_ksub256", ref)][1]
        summary["rows_equal_ivf_pq"][step] = float((one[(20, step)][1] == want).all(1).mean())
    for key in (key for key in one if isinstance(key, tuple)):
        gi = one[key][1]
        k, step = key
        name = f"k{k} {step}"
        if key in two:
            summary["rows_equal_across_w"][name] = float((two[key][1] == gi).all(1).mean())
        for w, res in ((1, one), (SHARDED_WORLD, two)):
            if key in res:
                summary["search_ms"][f"W={w} {name}"] = res["search_ms"][key]
                if step in ("unfiltered", "10% id_mask"):
                    truth = gt_i if step == "unfiltered" else gtm_i
                    summary["recall"][f"W={w} {name}"] = recall_at(res[key][1], truth)
    for w, res in [(1, one)] + [(SHARDED_WORLD, r) for r in ranks]:
        assert res["launches"]["adc_scan_dense[qpb=8]"] > 0 and (
            res["launches"]["adc_scan_dense[qpb=1]"] > 0), (
            f"sharded_ivf_pq W={w}: the dense ADC kernel was not launched: {res['launches']}")
    err = max([one["kernel_err"]] + [r["kernel_err"] for r in ranks])
    ms = {key: round(v, 2) for key, v in summary["search_ms"].items()}
    log(f"sharded_ivf_pq: W=1 and W={SHARDED_WORLD} (every rank): every search launched one "
        f"dense ADC kernel, equals its plain route bit for bit, returns exact distances "
        f"(<= {PQ_EXACT_TOL} relative of float64) and no masked or removed id, unfiltered and "
        f"with the 10% id_mask at k {SHARDED_PQ_KS}, B=100, after a {extra.shape[0]}-row tail "
        f"add, remove_ids of {len(range(0, x.shape[0], 997))} rows and a restage; the kernel "
        f"agrees with its plain version on every rank's block (max |diff| {err}); W=1 rows "
        f"equal to IVFPQIndex's dense route at k 20: {summary['rows_equal_ivf_pq']}; rows equal "
        f"across W: {summary['rows_equal_across_w']}; recall@10 {summary['recall']}; search ms "
        f"(host clock) {ms} [{card}]")
    for row in two["kernel_times"]:
        log(f"times adc_scan_dense {row['label']} (pad_local {row['pad']}, nprobe "
            f"{row['nprobe']}): kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
            f"yardstick {row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}) [{card}]")
    return summary, one["launches"], two["launches"], err, two["kernel_times"]


# -- main ------------------------------------------------------------------------


def ptxas_resources(source, kernel):
    """{entry function: {"registers", "spill_stores", "spill_loads"}} of the
    entry functions of csrc/<source>.cu whose (mangled) names hold
    `kernel`, from the build's -Xptxas -v report."""
    out, cur = {}, None
    path = cuda_build.ptxas_log(source)
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            if cur:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


# The kernels with a (query, probe group) grid: their source and entry functions.
GRID_KERNELS = {
    "ivf_scan_select": ("ivf_scan", ("ivf_select_kernel", "ivf_merge_kernel")),
    "ivf_scan_dense": ("ivf_scan", ("ivf_dense_kernel",)),
    "ivf_scan_dense_int8": ("ivf_scan", ("ivf_dense_int8_kernel",)),
    "adc_scan_select": ("adc_scan", ("adc_select_kernel", "adc_merge_kernel")),
    "adc_scan_dense[qpb=8]": ("adc_scan", ("adc_dense_kernel",)),
    "adc_scan_dense[qpb=1]": ("adc_scan", ("adc_dense_kernel",)),
}


def select_extras(name, head, compiled):
    """For the row of a kernel with a probe-group grid in the kernels line:
    its grid at the head case (probe groups, blocks, blocks per SM, SMs; for
    a select kernel, where its lists live), and, when this run compiled its
    source (`compiled`), the registers and spills of its entry functions."""
    if name not in GRID_KERNELS:
        return {}
    source, entries = GRID_KERNELS[name]
    out = dict(head["select"])
    if source in compiled:
        out["ptxas"] = {fn: res for entry in entries
                        for fn, res in ptxas_resources(source, entry).items()}
    return out


def build_all():
    """Build every CUDA source at once (one nvcc each, in parallel); returns
    the names of the sources this run compiled (not found built)."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("fused_l2_topk", "ivf_scan", "adc_scan")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(cuda_build.build, names))
    log(f"build: {len(names)} sources in {time.perf_counter() - t0:.1f} s wall (nvcc, sm_90a)")
    compiled = set()
    for name, (path, seconds) in zip(names, built):
        log(f"build: {path.name} in {seconds:.1f} s")
        if seconds > 0:
            compiled.add(name)
            for line in cuda_build.ptxas_log(name).read_text().splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")
    return compiled


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    # One rank of phase sharded's multi-rank run (the phase spawns these).
    for flag, kind in (("--sharded-rank", int), ("--world", int), ("--store", str),
                       ("--out", str), ("--ivf-centroids", str), ("--pq-quantizer", str)):
        ap.add_argument(flag, type=kind, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    if args.sharded_rank is not None:
        return sharded_rank(args)

    device = torch.device("cuda", 0)
    n_kernel, d, batches = 1_048_576, 384, (128, 1024, 100, 1, 64)
    card = card_line()
    log(f"card: {card}")
    t_start = time.perf_counter()

    # 1. build
    compiled = build_all()

    # 2. kernel against plain
    t0 = time.perf_counter()
    errs = {}   # max |key diff| by mode
    phase_kernel(device, n_kernel, d, batches, 20, args.seed, errs)
    phase_f32_tiles(device, args.seed, errs)
    phase_fixtures(device, d, args.seed, errs)
    log(f"phase kernel: {time.perf_counter() - t0:.1f} s")

    # 3. FlatIndex end to end (a path: counts reset before, read after)
    t0 = time.perf_counter()
    reset_counts()
    flat_out, corpus = phase_flat(device, 1_000_000, d, args.seed, card)
    flat_launches = topk_cuda.fused_l2_topk.launches
    flat_by_mode = dict(topk_cuda.fused_l2_topk.launches_by_mode)
    bf16q_launches = flat_by_mode["int8_bf16q"]
    log(f"flat path launches by mode: {flat_by_mode}")
    assert flat_launches > 0, "FlatIndex did not reach the kernel"
    assert bf16q_launches > 0, "fused_topk(q_int8=False) did not reach the kernel"
    bf16q_inputs = flat_out["bf16q_inputs"]
    note_err(errs, "int8_bf16q", check_selection(
        *bf16q_inputs, exact=False, label="flat int8 q_int8=False operands"))
    log(f"phase flat: {time.perf_counter() - t0:.1f} s")

    # 4. MemoDB on the flat index (counts reset before, read after)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=str(Path.cwd())) as tmp:
        reset_counts()
        qps, per_call, main_inputs = phase_memodb(device, 100_000, args.seed, Path(tmp), card)
        main_launches = topk_cuda.fused_l2_topk.launches
    assert main_launches > 0, "MemoDB did not reach the kernel"
    q_st, db = main_inputs[:2]
    note_err(errs, str(db.dtype).removeprefix("torch."), check_selection(
        *main_inputs, exact=db.dtype == torch.int8, label="memodb operands"))
    log(f"kernel {str(db.dtype).removeprefix('torch.'):8s} N={db.shape[0]} D={db.shape[1]} "
        f"B={q_st.shape[0]:5d} k={main_inputs[3]}: agrees with plain on the MemoDB "
        f"path's own operands")
    log(f"phase memodb: {time.perf_counter() - t0:.1f} s, kernel launches {main_launches}")

    # 5. IVFFlatIndex at 1M x 384 (counts reset before, read after)
    t0 = time.perf_counter()
    reset_counts()
    ivf_result, ivf_errs, ivf_ops, ivf_ref = phase_ivf(device, d, args.seed, card, corpus)
    ivf_launches = ivf_counts()
    assert all(v > 0 for v in ivf_launches.values()), f"ivf path launches {ivf_launches}"
    log(f"phase ivf: {time.perf_counter() - t0:.1f} s, kernel launches {ivf_launches}")

    # 6. IVFPQIndex at 1M x 384 (counts reset before, read after)
    t0 = time.perf_counter()
    reset_counts()
    pq_result, pq_ops, pq_ref = phase_ivf_pq(device, d, args.seed, card, corpus)
    pq_launches = adc_counts()
    assert all(v > 0 for v in pq_launches.values()), f"ivf_pq path launches {pq_launches}"
    log(f"phase ivf_pq: {time.perf_counter() - t0:.1f} s, kernel launches {pq_launches}")

    # 11. ShardedFlatIndex at W = 1 and W = 2 (each run resets the counts
    # before its path and reads them after)
    t0 = time.perf_counter()
    sharded_out, sharded_launches, sharded_w2_launches, sharded_errs = phase_sharded(
        device, args.seed, card,
        {dt: flat_out[f"{dt}_results"] for dt in ("float32", "int8")}, corpus)
    for mode, err in sharded_errs.items():
        note_err(errs, mode, err)
    log(f"phase sharded: {time.perf_counter() - t0:.1f} s, kernel launches W=1 "
        f"{sharded_launches}, W={SHARDED_WORLD} (rank 0) {sharded_w2_launches}")

    # 12. ShardedIVFIndex at W = 1 and W = 2 on phase 5's quantizer (each
    # run resets the counts before its path and reads them after)
    t0 = time.perf_counter()
    sivf_out, sivf_launches, sivf_w2_launches, sivf_errs, sivf_times = phase_sharded_ivf(
        device, args.seed, card, ivf_ref, corpus)
    del ivf_ref
    note_errs(ivf_errs, sivf_errs)
    log(f"phase sharded_ivf: {time.perf_counter() - t0:.1f} s, kernel launches W=1 "
        f"{sivf_launches}, W={SHARDED_WORLD} (rank 0) {sivf_w2_launches}")

    # 13. ShardedIVFPQIndex at W = 1 and W = 2 on phase 6's quantizer (each
    # run resets the counts before its path and reads them after)
    t0 = time.perf_counter()
    spq_out, spq_launches, spq_w2_launches, spq_err, spq_times = phase_sharded_ivf_pq(
        device, args.seed, card, pq_ref, corpus)
    del corpus, pq_ref
    log(f"phase sharded_ivf_pq: {time.perf_counter() - t0:.1f} s, kernel launches W=1 "
        f"{spq_launches}, W={SHARDED_WORLD} (rank 0) {spq_w2_launches}")

    # 7. MemoDB on IVFFlatIndex (counts reset before, read after)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=str(Path.cwd())) as tmp:
        reset_counts()
        memo_ivf, memo_ops = phase_memodb_ivf(device, 100_000, args.seed, Path(tmp), card)
        memo_ivf_launches = ivf_counts()
    assert memo_ivf_launches["ivf_scan_select"] + memo_ivf_launches["ivf_scan_dense"] > 0, (
        f"MemoDB(ivf_flat) did not reach the scan kernels: {memo_ivf_launches}")
    log(f"phase memodb_ivf: {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{memo_ivf_launches}")

    # 8. MemoDB on IVFPQIndex (counts reset before, read after)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=str(Path.cwd())) as tmp:
        reset_counts()
        memo_pq, memo_pq_ops = phase_memodb_ivf_pq(device, 100_000, args.seed, Path(tmp), card)
        memo_pq_launches = adc_counts()
    assert memo_pq_launches["adc_scan_select"] > 0, (
        f"MemoDB(ivf_pq) did not reach the select kernel: {memo_pq_launches}")
    log(f"phase memodb_ivf_pq: {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{memo_pq_launches}")
    pq_ops.append(("memodb_ivf_pq", "adc_scan_select", 40, memo_pq_ops))

    # 9. the memo CLI on the card against the CPU (no kernel on its path)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=str(Path.cwd())) as tmp:
        phase_cli(100_000, args.seed, Path(tmp), card)
    log(f"phase cli: {time.perf_counter() - t0:.1f} s")
    adc_errs = {}
    for label, kernel, k, ops in pq_ops:
        name = kernel if kernel == "adc_scan_select" else f"adc_scan_dense[qpb={ops['qpb']}]"
        adc_errs[name] = max(adc_errs.get(name, 0.0), check_adc_kernel(ops, kernel, k, label))
        log(f"{name} {label}: equals plain bit for bit on the path's own operands")

    # Each IVF kernel against its plain version on the paths' own operands.
    cases = {"ivf_scan_select": [], "ivf_scan_dense": [], "ivf_scan_dense_int8": []}
    kernel_of = {"select": "ivf_scan_select", "dense": "ivf_scan_dense",
                 "dense_int8": "ivf_scan_dense_int8"}
    for (route, dt), ops in ivf_ops.items():
        k = 10 if dt == "float32" else shortlist_depth(10, 1_000_000)
        cases[kernel_of[route]].append((f"ivf {dt}", ops, k))
    for route, ops in memo_ops.items():
        cases[kernel_of[route]].append(("memodb_ivf f32", ops, 10))
    for kernel, items in cases.items():
        for label, ops, k in items:
            note_errs(ivf_errs, {kernel: check_ivf_kernel(ops, kernel, k, f"{kernel} {label}")})
            log(f"{kernel} {label}: agrees with plain on the path's own operands")

    # 10. times
    t0 = time.perf_counter()
    main_row = time_case(*main_inputs, card)
    rows = [main_row] + phase_times(device, n_kernel, d, (128, 1024), 20, args.seed, card)
    ivf_rows = {kernel: [time_ivf(ops, kernel, k, label, card) for label, ops, k in items]
                + sivf_times.get(kernel, []) for kernel, items in cases.items()}
    adc_rows = {}
    for label, kernel, k, ops in pq_ops:
        name = kernel if kernel == "adc_scan_select" else f"adc_scan_dense[qpb={ops['qpb']}]"
        adc_rows.setdefault(name, []).append(time_adc(ops, kernel, k, label, card))
    adc_rows["adc_scan_dense[qpb=8]"] += spq_times
    qpb8_ms = next(r["ms"] for r in adc_rows["adc_scan_dense[qpb=8]"]
                   if r["label"] == "ivf_pq m96 ksub256")
    qpb1_ms = next(r["ms"] for r in adc_rows["adc_scan_dense[qpb=1]"]
                   if r["label"] == "ivf_pq m96 ksub256 B=128")
    log(f"adc_scan_dense on the same 1M B=128 operands: qpb 8 {qpb8_ms:.3f} ms, "
        f"qpb 1 {qpb1_ms:.3f} ms [{card}]")
    bf16q_row = time_case(*bf16q_inputs, card)
    log(f"phase times: {time.perf_counter() - t0:.1f} s")
    kernels = [{
        "name": "fused_l2_topk",
        "route": "cuda",
        "source": "c99_vectordb_tpu_torch/csrc/fused_l2_topk.cu",
        "replaces": "c99_vectordb_tpu/ops/topk_pallas.py:44",
        "launches": main_launches,
        "launches_by_path": {"memodb": main_launches, "flat": flat_launches,
                             "sharded": sum(sharded_launches.values()),
                             f"sharded_w{SHARDED_WORLD}": sum(sharded_w2_launches.values())},
        "launches_by_mode": {"flat": flat_by_mode, "sharded": sharded_launches,
                             f"sharded_w{SHARDED_WORLD}": sharded_w2_launches},
        "max_abs_err": max(errs[m] for m in ("float32", "bfloat16", "int8")),
        "max_abs_err_by_mode": errs,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": {k: main_row[k] for k in ("dtype", "B", "N", "D", "k")},
        "variants": rows,
        "pass1_by_mode": PRODUCT_ROUTE,
        **({"ptxas": ptxas_resources("fused_l2_topk", "scan_topk_")}
           if "fused_l2_topk" in compiled else {}),
        "check": "pass",
        "recall_many_qps": qps,
        "launches_per_recall_many": per_call,
        "sharded": sharded_out,
    }]
    replaces = {
        "ivf_scan_select": "c99_vectordb_tpu/ops/ivf_scan_pallas.py:113 (and :202)",
        "ivf_scan_dense": "c99_vectordb_tpu/ops/ivf_scan_pallas.py:362",
        "ivf_scan_dense_int8": "c99_vectordb_tpu/ops/ivf_scan_pallas.py:462 (and :496)",
    }
    for kernel, variants in ivf_rows.items():
        head = variants[0]        # the 1M ivf path's first case for this kernel
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": "c99_vectordb_tpu_torch/csrc/ivf_scan.cu",
            "replaces": replaces[kernel],
            "launches": ivf_launches[kernel],
            "launches_by_path": {"ivf": ivf_launches[kernel],
                                 "memodb_ivf": memo_ivf_launches[kernel],
                                 "sharded_ivf": sivf_launches[kernel],
                                 f"sharded_ivf_w{SHARDED_WORLD}": sivf_w2_launches[kernel]},
            "max_abs_err": ivf_errs[kernel],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: v for k, v in head.items()
                      if k not in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                   "select")},
            "variants": variants,
            "check": "pass",
            **select_extras(kernel, head, compiled),
        })
    kernels[1]["ivf"] = ivf_result
    kernels[1]["memodb_ivf"] = memo_ivf
    kernels[1]["sharded_ivf"] = sivf_out
    kernels.append({
        "name": "fused_l2_topk[q_int8=False]",
        "route": "cuda",
        "source": "c99_vectordb_tpu_torch/csrc/fused_l2_topk.cu",
        "replaces": "c99_vectordb_tpu/ops/topk_pallas.py:44 (mode :76-80, :348)",
        "launches": bf16q_launches,
        "launches_by_path": {"flat": bf16q_launches},
        "max_abs_err": errs["int8_bf16q"],
        **{key: bf16q_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
        "shape": {key: bf16q_row[key] for key in ("dtype", "B", "N", "D", "k")},
        "check": "pass",
    })
    adc_replaces = {
        "adc_scan_select": "c99_vectordb_tpu/ops/adc_pallas.py:201",
        "adc_scan_dense[qpb=8]": "c99_vectordb_tpu/ops/adc_pallas.py:368",
        "adc_scan_dense[qpb=1]": "c99_vectordb_tpu/ops/adc_pallas.py:349",
    }
    for name in ADC_COUNTS:
        head = adc_rows[name][0]       # the 1M ivf_pq path's first case for this kernel
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "c99_vectordb_tpu_torch/csrc/adc_scan.cu",
            "replaces": adc_replaces[name],
            "launches": pq_launches[name],
            "launches_by_path": {"ivf_pq": pq_launches[name],
                                 "memodb_ivf_pq": memo_pq_launches[name],
                                 "sharded_ivf_pq": spq_launches[name],
                                 f"sharded_ivf_pq_w{SHARDED_WORLD}": spq_w2_launches[name]},
            "max_abs_err": max(adc_errs[name], spq_err) if name != "adc_scan_select"
            else adc_errs[name],
            **{key: head[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
            "shape": {key: v for key, v in head.items()
                      if key not in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "select")},
            "variants": adc_rows[name],
            "check": "pass",
            **select_extras(name, head, compiled),
        })
    kernels[-3]["ivf_pq"] = pq_result
    kernels[-3]["memodb_ivf_pq"] = memo_pq
    kernels[-2]["sharded_ivf_pq"] = spq_out
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
