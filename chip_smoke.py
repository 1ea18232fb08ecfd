#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 1234]    # on CUDA device 0

Phases (any failure raises and exits non-zero; none is caught):
  1. build       nvcc builds csrc/fused_l2_topk.cu and csrc/ivf_scan.cu, in
                 parallel, into c99_vectordb_tpu_torch/_build/.
  2. kernel      fused_l2_topk against its plain torch version on the card,
                 for the f32, bf16 and int8 stores at N=1,048,576 x D=384, B in
                 {128, 1024, 100}, k=20, plus fixtures (duplicate rows, +inf
                 padding and masked norms, k above the live rows, deep k).
  3. flat        FlatIndex on 1,000,000 seeded clustered unit vectors (D=384),
                 each scan dtype, B=128, k=10: strict recall@10 = 1.0 against a
                 float64 (distance, id) ground truth, unfiltered and with a 10%
                 id_mask.
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
  6. memodb_ivf  MemoDB with C99VDB_INDEX=ivf_flat at 100,000 notes (save_many
                 in host mode at nlist 64, reindex in device mode at
                 auto_nlist), each step against MemoDB(device="cpu") on the
                 card's files; queries whose card and CPU routes probe
                 different lists are counted (<= 1%) and skipped.
  7. times       every kernel, its plain version and a library yardstick
                 (never used by the port) beside the bound, on the paths' own
                 operands; each IVF kernel is first held against its plain
                 version on them.

Before the last line it prints the card line from nvidia-smi and one JSON
object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from c99_vectordb_tpu_torch.api import MemoDB
from c99_vectordb_tpu_torch.commands import auto_nlist
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.models.ivf_flat import DENSE_MAX_BF16, DENSE_MAX_F32, IVFFlatIndex
from c99_vectordb_tpu_torch.ops import cuda_build, ivf_scan, ivf_scan_cuda
from c99_vectordb_tpu_torch.ops import topk as topk_mod
from c99_vectordb_tpu_torch.ops import topk_cuda
from c99_vectordb_tpu_torch.ops.distances import scores_via_matmul
from c99_vectordb_tpu_torch.ops.embed import embed_texts, embed_texts_device
from c99_vectordb_tpu_torch.ops.kmeans import train_kmeans
from c99_vectordb_tpu_torch.ops.rerank import shortlist_depth
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


def phase_kernel(device, n, d, batches, k, seed):
    max_err = 0.0
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
            max_err = max(max_err, err)
            log(f"kernel {dt:8s} N={n} D={d} B={b:5d} k={k}: agrees with plain "
                f"(max |key diff| {err:.3e})")
        del db, norms, made
    return max_err


def phase_fixtures(device, d, seed):
    """Duplicate rows, +inf padding/masked norms, k above the live rows,
    ragged N, and deep k (lists in shared and in global memory)."""
    max_err = 0.0
    g = torch.Generator(device=device).manual_seed(seed + 7)
    for dt in ("float32", "bfloat16", "int8"):
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
        q_st, rs = topk_cuda.stage_queries(base.repeat(3, 1), db.dtype)
        kk, kp = topk_cuda.fused_l2_topk(q_st, db, norms, 16, rs)
        assert kp[:, :16].tolist() == [list(range(16))] * 3, f"{dt}: duplicate rows"
        max_err = max(max_err, check_selection(q_st, db, norms, 16, rs,
                                               exact=(dt == "int8"), label=f"{dt} dup"))
        # +inf norms (padding and masked rows, including the nearest ones) and
        # k above the live rows, at a ragged N.
        n = 5000
        made = make_store(n, d, dt, device, seed + 11)
        db, norms = made[0], made[1].clone()
        q = torch.randn((37, d), generator=g, device=device)
        q_st, rs = topk_cuda.stage_queries(q * made[2] if dt == "int8" else q, db.dtype)
        _, near = topk_cuda.select_plain(q_st, db, norms, 3, rs)
        norms[near.flatten().long()] = torch.inf
        norms[torch.randperm(n, generator=g, device=device)[: n // 3]] = torch.inf
        max_err = max(max_err, check_selection(q_st, db, norms, 50, rs,
                                               exact=(dt == "int8"), label=f"{dt} masked"))
        live = torch.zeros(n, dtype=torch.bool, device=device)
        live[torch.randperm(n, generator=g, device=device)[:7]] = True
        few = torch.where(live, made[1], torch.inf)
        kk, kp = topk_cuda.fused_l2_topk(q_st, db, few, 20, rs)
        assert bool(torch.isinf(kk[:, 7:]).all()) and bool((kp[:, 7:] == 2**31 - 1).all())
        max_err = max(max_err, check_selection(q_st, db, few, 20, rs,
                                               exact=(dt == "int8"), label=f"{dt} k>live"))
        for deep in (200, 1024):
            max_err = max(max_err, check_selection(
                q_st, db, made[1], deep, rs,
                exact=(dt == "int8"), label=f"{dt} k={deep}"))
        log(f"fixtures {dt}: duplicates, +inf norms, k > live rows, k=200/1024 agree")
    return max_err


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
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dt]
    nbytes = n * d * item + n * 4 + b * d * item + b * k * 8 + (b * 4 if dt == "int8" else 0)
    ops = 2 * b * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dt]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def library_call(q_st, db, norms, k, rs, dt):
    """Yardstick only: one library matmul + torch.topk on the same staged
    operands (no stable tie-break)."""
    if dt == "float32":
        return lambda: torch.topk(torch.addmm(norms, q_st, db.T), k, largest=False)
    if dt == "bfloat16":
        return lambda: torch.topk(torch.matmul(q_st, db.T) + norms, k, largest=False)
    return lambda: torch.topk(torch._int_mm(q_st, db.T).float() * rs[:, None] + norms,
                              k, largest=False)


def time_case(q_st, db, norms, k, rs, card):
    """Kernel, plain version and library yardstick on the same staged
    operands (CUDA-event means), beside the bound."""
    n, d = db.shape
    b = q_st.shape[0]
    dt = str(db.dtype).removeprefix("torch.")
    iters = 20 if b <= 128 else 5
    saved = topk_cuda.fused_l2_topk.launches
    ms = time_ms(lambda: topk_cuda.fused_l2_topk(q_st, db, norms, k, rs), iters)
    topk_cuda.fused_l2_topk.launches = saved  # timing launches are not the path's
    plain = time_ms(lambda: topk_cuda.select_plain(q_st, db, norms, k, rs), iters)
    lib = time_ms(library_call(q_st, db, norms, k, rs, dt), iters)
    bms, by = bound(n, d, b, k, dt)
    log(f"times {dt:8s} B={b:5d} N={n} D={d} k={k}: kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, library yardstick (matmul + topk) {lib:.3f} ms, "
        f"bound {bms:.3f} ms ({by}) [{card}]")
    return {"dtype": dt, "B": b, "N": n, "D": d, "k": k, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bms, "bound_by": by}


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
    for name in IVF_KERNELS:
        getattr(ivf_scan_cuda, name).launches = 0


class plain_kernels:
    """Run the IVF programs on their plain versions (on the same device):
    the route of ops/ivf_scan.py with each kernel call swapped for its
    plain torch version. For holding a whole route against itself."""

    def __enter__(self):
        self.saved = (ivf_scan.ivf_scan_select, ivf_scan.ivf_scan_dense,
                      ivf_scan.ivf_scan_dense_int8)
        ivf_scan.ivf_scan_select = (lambda *a, qpb=1: ivf_scan.scan_select_plain(*a[:7]))
        ivf_scan.ivf_scan_dense = ivf_scan.scan_dense_plain
        ivf_scan.ivf_scan_dense_int8 = (
            lambda *a, qpb=1: ivf_scan.scan_dense_int8_plain(*a[:6]))
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
        for nprobe in sorted({dense_np, 16}):
            route = route_of(index, dt, nprobe)
            for name, kw, gt in (("unfiltered", {}, gt_i),
                                 ("10% id_mask", {"id_mask": mask}, gtm_i)):
                (gd, gi), secs, got = check_route(index, q, 10, f"ivf {dt} p={nprobe} {name}",
                                                   nprobe=nprobe, **kw)
                note_errs(errs, got)
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
        note_errs(errs, check_route(index, q, 10, f"ivf {dt} tail")[2])
        removed = index.remove_ids(np.arange(0, n, 997))    # folds the tail first
        assert removed == len(range(0, n, 997)) and index._tail is None
        note_errs(errs, check_route(index, q, 10, f"ivf {dt} after remove + fold")[2])
        log(f"ivf {dt}: tail add of {extra.shape[0]} rows, remove_ids of {removed} rows and "
            f"the fold-restage agree with the plain route")
        del index
    del base, x_dev
    torch.cuda.empty_cache()
    return result, errs, operands


def staged_operands(index, q, nprobe):
    """The scan operands of an index's card route at `nprobe` (staged
    lists, probes, staged queries) for the times phase."""
    (centroids, c_sq, store, li, sqn, _, pad, extra) = index._stage()
    qd = torch.from_numpy(q).to(store.device)
    probes = ivf_scan.coarse_probes(qd, centroids, c_sq, nprobe)
    ops = {"probes": probes, "ids": li, "pad": pad}
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


def ivf_bound(ops, kernel, k=None):
    """Least time for the scan on this run's operands. Bytes: the vectors of
    the live rows (id >= 0) of the unique probed lists, and the norms and ids
    of all their slots (a padding slot is told by its id alone), each read
    once; the queries and probes read once; the outputs written once.
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
    nbytes = (live * d * item + uniq * pad * 8 + b * d * (1 if ops["kind"] == "int8" else 4)
              + b * 4 + b * nprobe * 4 + b * out_cols * 8)
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
    for the select kernel; it is timed only and never called by the port."""
    p = ops["probes"]
    if ops["kind"] == "int8":
        args = (p, ops["q8"], ops["rs"], ops["codes"], ops["sqn"], ops["ids"])
        kern = lambda: ivf_scan_cuda.ivf_scan_dense_int8(*args, qpb=8)  # noqa: E731
        plain = lambda: ivf_scan.scan_dense_int8_plain(*args)  # noqa: E731
        qv, lists, scale = ops["q8"].float() * ops["rs"][:, None], ops["codes"], ops["rs"]
        qv_sq = None
    else:
        args = (p, ops["q"], ops["q_sq"], ops["lists"], ops["sqn"], ops["ids"])
        if kernel == "ivf_scan_select":
            kern = lambda: ivf_scan_cuda.ivf_scan_select(*args, k)  # noqa: E731
            plain = lambda: ivf_scan.scan_select_plain(*args, k)  # noqa: E731
        else:
            kern = lambda: ivf_scan_cuda.ivf_scan_dense(*args)  # noqa: E731
            plain = lambda: ivf_scan.scan_dense_plain(*args)  # noqa: E731
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
    for name, v in saved.items():        # timing launches are not the path's
        getattr(ivf_scan_cuda, name).launches = v
    plain_ms = time_ms(plain, 3)
    lib_ms = time_ms(library, iters)
    bms, by, uniq, live_share = ivf_bound(ops, kernel, k)
    b, nprobe = ops["probes"].shape
    lists = ops["codes"] if ops["kind"] == "int8" else ops["lists"]
    shape = {"dtype": str(lists.dtype).removeprefix("torch."), "B": b, "nprobe": nprobe,
             "nlist": lists.shape[0], "pad": ops["pad"], "D": lists.shape[2],
             "unique_lists": uniq, "live_share": live_share}
    if kernel == "ivf_scan_select":
        shape["k"] = k
    log(f"times {kernel} {label} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library yardstick {lib_ms:.3f} ms, bound {bms:.3f} ms ({by}) [{card}]")
    return {"label": label, **shape, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bms, "bound_by": by}


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


# -- main ------------------------------------------------------------------------


def build_all():
    """Build both CUDA sources at once (one nvcc each, in parallel)."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("fused_l2_topk", "ivf_scan")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(cuda_build.build, names))
    log(f"build: {len(names)} sources in {time.perf_counter() - t0:.1f} s wall (nvcc, sm_90a)")
    for name, (path, seconds) in zip(names, built):
        log(f"build: {path.name} in {seconds:.1f} s")
        ptxas = cuda_build.ptxas_log(name)
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas: {line.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    n_kernel, d, batches = 1_048_576, 384, (128, 1024, 100)
    card = card_line()
    log(f"card: {card}")
    t_start = time.perf_counter()

    # 1. build
    build_all()

    # 2. kernel against plain
    t0 = time.perf_counter()
    max_err = phase_kernel(device, n_kernel, d, batches, 20, args.seed)
    max_err = max(max_err, phase_fixtures(device, d, args.seed))
    log(f"phase kernel: {time.perf_counter() - t0:.1f} s")

    # 3. FlatIndex end to end (a path: counts reset before, read after)
    t0 = time.perf_counter()
    reset_counts()
    _, corpus = phase_flat(device, 1_000_000, d, args.seed, card)
    flat_launches = topk_cuda.fused_l2_topk.launches
    assert flat_launches > 0, "FlatIndex did not reach the kernel"
    log(f"phase flat: {time.perf_counter() - t0:.1f} s")

    # 4. MemoDB on the flat index (counts reset before, read after)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=str(Path.cwd())) as tmp:
        reset_counts()
        qps, per_call, main_inputs = phase_memodb(device, 100_000, args.seed, Path(tmp), card)
        main_launches = topk_cuda.fused_l2_topk.launches
    assert main_launches > 0, "MemoDB did not reach the kernel"
    q_st, db = main_inputs[:2]
    max_err = max(max_err, check_selection(*main_inputs, exact=db.dtype == torch.int8,
                                           label="memodb operands"))
    log(f"kernel {str(db.dtype).removeprefix('torch.'):8s} N={db.shape[0]} D={db.shape[1]} "
        f"B={q_st.shape[0]:5d} k={main_inputs[3]}: agrees with plain on the MemoDB "
        f"path's own operands")
    log(f"phase memodb: {time.perf_counter() - t0:.1f} s, kernel launches {main_launches}")

    # 5. IVFFlatIndex at 1M x 384 (counts reset before, read after)
    t0 = time.perf_counter()
    reset_counts()
    ivf_result, ivf_errs, ivf_ops = phase_ivf(device, d, args.seed, card, corpus)
    ivf_launches = ivf_counts()
    del corpus
    assert all(v > 0 for v in ivf_launches.values()), f"ivf path launches {ivf_launches}"
    log(f"phase ivf: {time.perf_counter() - t0:.1f} s, kernel launches {ivf_launches}")

    # 6. MemoDB on IVFFlatIndex (counts reset before, read after)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=str(Path.cwd())) as tmp:
        reset_counts()
        memo_ivf, memo_ops = phase_memodb_ivf(device, 100_000, args.seed, Path(tmp), card)
        memo_ivf_launches = ivf_counts()
    assert memo_ivf_launches["ivf_scan_select"] + memo_ivf_launches["ivf_scan_dense"] > 0, (
        f"MemoDB(ivf_flat) did not reach the scan kernels: {memo_ivf_launches}")
    log(f"phase memodb_ivf: {time.perf_counter() - t0:.1f} s, kernel launches "
        f"{memo_ivf_launches}")

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

    # 7. times
    t0 = time.perf_counter()
    main_row = time_case(*main_inputs, card)
    rows = [main_row] + phase_times(device, n_kernel, d, (128, 1024), 20, args.seed, card)
    ivf_rows = {kernel: [time_ivf(ops, kernel, k, label, card) for label, ops, k in items]
                for kernel, items in cases.items()}
    log(f"phase times: {time.perf_counter() - t0:.1f} s")
    kernels = [{
        "name": "fused_l2_topk",
        "route": "cuda",
        "source": "c99_vectordb_tpu_torch/csrc/fused_l2_topk.cu",
        "replaces": "c99_vectordb_tpu/ops/topk_pallas.py:44",
        "launches": main_launches,
        "launches_by_path": {"memodb": main_launches, "flat": flat_launches},
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": {k: main_row[k] for k in ("dtype", "B", "N", "D", "k")},
        "variants": rows,
        "check": "pass",
        "recall_many_qps": qps,
        "launches_per_recall_many": per_call,
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
                                 "memodb_ivf": memo_ivf_launches[kernel]},
            "max_abs_err": ivf_errs[kernel],
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {k: v for k, v in head.items()
                      if k not in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "variants": variants,
            "check": "pass",
        })
    kernels[1]["ivf"] = ivf_result
    kernels[1]["memodb_ivf"] = memo_ivf
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
