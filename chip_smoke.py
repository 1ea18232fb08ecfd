#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 1234]    # on CUDA device 0

Phases (any failure raises and exits non-zero; none is caught):
  1. build    nvcc builds csrc/fused_l2_topk.cu into c99_vectordb_tpu_torch/_build/.
  2. kernel   fused_l2_topk against its plain torch version on the card, for
              the f32, bf16 and int8 stores at N=1,048,576 x D=384, B in
              {128, 1024, 100}, k=20, plus fixtures (duplicate rows, +inf
              padding and masked norms, k above the live rows, deep k).
  3. flat     FlatIndex on 1,000,000 seeded clustered unit vectors (D=384),
              each scan dtype, B=128, k=10: strict recall@10 = 1.0 against a
              float64 (distance, id) ground truth, unfiltered and with a 10%
              id_mask.
  4. memodb   MemoDB on 100,000 seeded synthetic notes: save_many,
              recall_many (with and without a pushed-down filter),
              recall(pushdown=True), delete, reindex — each step held
              against MemoDB(device="cpu") on a copy of the same files;
              then the kernel against its plain version on this path's own
              operands (the resident store and the 128 staged queries).
  5. times    kernel, plain version and a library yardstick (torch matmul +
              torch.topk on the same staged operands; never used by the
              port) beside the bound, on the MemoDB path's operands and per
              store dtype and batch at N=1,048,576.

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
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.ops import topk as topk_mod
from c99_vectordb_tpu_torch.ops import topk_cuda
from c99_vectordb_tpu_torch.ops.embed import embed_texts_device
from c99_vectordb_tpu_torch.ops.rerank import shortlist_depth

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
    return out


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


# -- main ------------------------------------------------------------------------


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
    path, seconds = topk_cuda.build()
    log(f"build: {path.name} in {seconds:.1f} s (nvcc, sm_90a)")
    ptxas = path.with_name(path.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # 2. kernel against plain
    t0 = time.perf_counter()
    max_err = phase_kernel(device, n_kernel, d, batches, 20, args.seed)
    max_err = max(max_err, phase_fixtures(device, d, args.seed))
    log(f"phase kernel: {time.perf_counter() - t0:.1f} s")

    # 3. FlatIndex end to end (a path: counts reset before, read after)
    t0 = time.perf_counter()
    topk_cuda.fused_l2_topk.launches = 0
    phase_flat(device, 1_000_000, d, args.seed, card)
    flat_launches = topk_cuda.fused_l2_topk.launches
    assert flat_launches > 0, "FlatIndex did not reach the kernel"
    log(f"phase flat: {time.perf_counter() - t0:.1f} s")

    # 4. MemoDB, the main path (counts reset before, read after)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=str(Path.cwd())) as tmp:
        topk_cuda.fused_l2_topk.launches = 0
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

    # 5. times
    t0 = time.perf_counter()
    main_row = time_case(*main_inputs, card)
    rows = [main_row] + phase_times(device, n_kernel, d, (128, 1024), 20, args.seed, card)
    log(f"phase times: {time.perf_counter() - t0:.1f} s")
    kernels = {"kernels": [{
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
    }]}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
