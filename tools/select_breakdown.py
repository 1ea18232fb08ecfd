#!/usr/bin/env python3
"""Where the IVF and ADC select kernels and the IVF dense kernels spend their
time on the card.

    python3 tools/select_breakdown.py [--seed 1234]

Builds csrc/ivf_scan.cu and csrc/adc_scan.cu as they ship and in diagnostic
variants (the SEL_* preprocessor switches of csrc/select_merge.cuh), then
times each select call (the kernel and its merge) on seeded operands shaped
like the paths of chip_smoke.py: lists of nlist 4096 and pad 1152 whose live
rows (a Poisson count of mean 244 per list, 5% of them removed as holes)
fill about 0.2 of the slots, like the 1M paths'; B = 128 random probes of
nprobe 16; IVF f32 (k 10) and bf16 (k 20) at D = 384, ADC m 96, ksub 256,
K 200; MemoDB(ivf_pq)'s shape, ADC m 8, K 40, nlist 1280, pad 256,
nprobe 8 (mean 78 live rows); and the IVF dense kernels on the same IVF
lists, f32 at nprobe 3 and int8 codes at nprobe 16 (qpb 8), as the 1M
path's dense routes, and on that path's own operands: chip_smoke.py's
clustered 1M x 384 corpus in an IVFFlatIndex of nlist 4096 (f32 and int8
stores), whose list lengths are skewed (pad 1152 is set by the longest).
Every list stops at its high-water mark.
  - shipped:     the kernels as built by ops/cuda_build.py;
  - no_select:   loads and scores, without admission, compaction or merges;
  - no_score:    loads and the selection, with every score computed from a
                 zero product (IVF) or a zero table sum (ADC);
  - loads_only:  the tile pipeline alone.
The dense kernels have no selection, so they run in the shipped and
no_score builds only (no_score: the tile pipeline and the output writes).
For each: CUDA-event mean per call over 10 calls, and the device time per
call of each kernel from a torch.profiler trace (`device_ms`). The
shipped build is also timed at 1, 2, 4, 8 and 16 probe groups (cut to
nprobe), the dense kernels also at 1, 2, 3, 4, 6, 8, 12 and 16 row
splits, and first held against the plain version. Prints the card line from nvidia-smi
first, then one line per (variant, case) and the ptxas lines of the
shipped builds. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = {
    "shipped": (),
    "no_select": ("SEL_NO_SELECT=1",),
    "no_score": ("SEL_NO_SCORE=1",),
    "loads_only": ("SEL_NO_SELECT=1", "SEL_NO_SCORE=1"),
}


# The builds each kind of case runs in: a dense kernel has no selection.
CASE_VARIANTS = {"select": tuple(VARIANTS), "dense": ("shipped", "no_score")}
SWEEP_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def operands(torch, device, seed):
    """The seeded cases: (label, source, kind, call(groups=None, **kw), plain
    call); a call's groups forces the kernel's probe groups (None: its own
    choice), a dense call's `splits` its row splits."""
    from c99_vectordb_tpu_torch.models.devbuild import list_hwm
    from c99_vectordb_tpu_torch.ops import adc, adc_cuda, ivf_scan, ivf_scan_cuda

    g = torch.Generator(device=device).manual_seed(seed)

    def layout(nlist, pad, mean):
        cnt = torch.poisson(torch.full((nlist,), float(mean), device=device), generator=g)
        cnt = torch.clamp(cnt, 0, pad).long()
        slot = torch.arange(pad, device=device)[None, :]
        ids = torch.arange(nlist * pad, device=device, dtype=torch.int32).reshape(nlist, pad)
        ids = torch.where(slot < cnt[:, None], ids, -1)
        holes = torch.rand((nlist, pad), device=device, generator=g) < 0.05
        ids = torch.where(holes, -1, ids).to(torch.int32).contiguous()
        return ids, list_hwm(ids).to(torch.int32)

    def probes_of(b, nlist, nprobe):
        return torch.stack([torch.randperm(nlist, device=device, generator=g)[:nprobe]
                            for _ in range(b)]).to(torch.int32)

    cases = []
    nlist, pad, d, b, nprobe = 4096, 1152, 384, 128, 16
    ids, hwm = layout(nlist, pad, 244)
    lists = torch.randn((nlist, pad, d), device=device, generator=g)
    lists /= lists.norm(dim=2, keepdim=True)
    sqn = (lists * lists).sum(2)
    q = torch.randn((b, d), device=device, generator=g)
    q /= q.norm(dim=1, keepdim=True)
    q_sq = (q * q).sum(1)
    probes = probes_of(b, nlist, nprobe)
    for dt, k in ((torch.float32, 10), (torch.bfloat16, 20)):
        lv = lists if dt == torch.float32 else lists.to(dt)
        args = (probes, q, q_sq, lv, sqn, ids)
        cases.append((f"ivf {str(dt).removeprefix('torch.')} k={k}", "ivf", "select",
                      lambda groups=None, a=args, k=k, h=hwm: ivf_scan_cuda.ivf_scan_select(
                          *a, k, hwm=h, _groups=groups),
                      lambda a=args, k=k, h=hwm: ivf_scan.scan_select_plain(*a, k, hwm=h)))
    ivf_ops = (pad, d, probes, q, q_sq, lists, sqn, ids, hwm)
    for nlist, pad, m, k, nprobe, mean in ((4096, 1152, 96, 200, 16, 244),
                                           (1280, 256, 8, 40, 8, 78)):
        ids, hwm = layout(nlist, pad, mean)
        codes = torch.randint(0, 256, (nlist, m, pad), device=device, generator=g,
                              dtype=torch.uint8)
        const = torch.randn((nlist, pad), device=device, generator=g) * 4
        qd = torch.randn((b, m, 256), device=device, generator=g)
        pc = torch.rand((b, nprobe), device=device, generator=g) * 50
        args = (probes_of(b, nlist, nprobe), pc, qd, codes, const, ids)
        cases.append((f"adc m={m} K={k} nprobe={nprobe}", "adc", "select",
                      lambda groups=None, a=args, k=k, h=hwm: adc_cuda.adc_scan_select(
                          *a, k, packed=False, hwm=h, _groups=groups),
                      lambda a=args, k=k, h=hwm: adc.adc_select_plain(
                          *a, k, packed=False, hwm=h)))
    # The dense cases last, so the select cases' seeded operands stay as they were.
    pad, d, probes, q, q_sq, lists, sqn, ids, hwm = ivf_ops
    args = (probes[:, :3].contiguous(), q, q_sq, lists, sqn, ids)
    cases.append(("ivf dense float32 nprobe=3", "ivf", "dense",
                  lambda groups=None, splits=None, a=args, h=hwm: ivf_scan_cuda.ivf_scan_dense(
                      *a, hwm=h, _groups=groups, _splits=splits),
                  lambda a=args, h=hwm: ivf_scan.scan_dense_plain(*a, hwm=h)))
    codes = torch.randint(-127, 128, (lists.shape[0], pad, d), device=device, generator=g,
                          dtype=torch.int8)
    dec = torch.rand((lists.shape[0], pad), device=device, generator=g) * 50
    q8, rs = ivf_scan.sq8_stage_queries(q, torch.full((d,), 0.01, device=device))
    args = (probes, q8, rs, codes, dec, ids)
    cases.append(("ivf dense int8 nprobe=16 qpb=8", "ivf", "dense",
                  lambda groups=None, splits=None, a=args, h=hwm:
                  ivf_scan_cuda.ivf_scan_dense_int8(*a, qpb=8, hwm=h, _groups=groups,
                                                    _splits=splits),
                  lambda a=args, h=hwm: ivf_scan.scan_dense_int8_plain(*a, hwm=h)))
    return cases


def path_operands(torch, device, seed):
    """The dense cases on the 1M IVF path's own operands (chip_smoke.py
    phase 5: its corpus, nlist, stores and dense-route nprobe), as
    operands' cases."""
    import chip_smoke as cs
    from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex
    from c99_vectordb_tpu_torch.ops import ivf_scan, ivf_scan_cuda

    x, q, _ = cs.clustered_corpus(1_000_000, 384, seed)
    x_dev = torch.from_numpy(x).to(device)
    ids_dev = torch.arange(x.shape[0], dtype=torch.int32, device=device)
    cases, centroids = [], None
    for dt, nprobe in (("float32", 3), ("int8", 16)):
        index = IVFFlatIndex(dim=384, nlist=cs.auto_nlist(x.shape[0]), nprobe=16, scan_dtype=dt,
                             device=device)
        if centroids is None:
            index.train(x_dev)
            centroids = index._centroids
        index._centroids = centroids               # one quantizer, as the path
        index.add(x_dev, ids_dev)
        index.search(q[:1], 10)
        ops = cs.staged_operands(index, q, nprobe)
        hwm = ops["hwm"]
        if dt == "int8":
            args = (ops["probes"], ops["q8"], ops["rs"], ops["codes"], ops["sqn"], ops["ids"])
            call = (lambda groups=None, splits=None, a=args, h=hwm:
                    ivf_scan_cuda.ivf_scan_dense_int8(*a, qpb=8, hwm=h, _groups=groups,
                                                      _splits=splits))
            plain = lambda a=args, h=hwm: ivf_scan.scan_dense_int8_plain(*a, hwm=h)  # noqa: E731
        else:
            args = (ops["probes"], ops["q"], ops["q_sq"], ops["lists"], ops["sqn"], ops["ids"])
            call = (lambda groups=None, splits=None, a=args, h=hwm:
                    ivf_scan_cuda.ivf_scan_dense(*a, hwm=h, _groups=groups, _splits=splits))
            plain = lambda a=args, h=hwm: ivf_scan.scan_dense_plain(*a, hwm=h)  # noqa: E731
        marks = hwm[ops["probes"].long()].float()
        cases.append((f"ivf dense {dt} nprobe={nprobe} (1M path; probed marks mean "
                       f"{marks.mean().item():.1f}, max {marks.max().item():.0f}, pad "
                       f"{ops['pad']})", "ivf", "dense", call, plain))
    return cases


def device_ms(fn, iters=10):
    """Device time per call of the kernels fn launches, from a
    torch.profiler trace of `iters` calls (CUDA activity): {kernel name:
    ms per call}, or None when the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    return out or None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from c99_vectordb_tpu_torch.ops import adc_cuda, cuda_build, ivf_scan_cuda

    if not torch.cuda.is_available():
        print("select_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card, flush=True)
    sources = {"ivf": ("ivf_scan", ivf_scan_cuda), "adc": ("adc_scan", adc_cuda)}
    jobs = [(v, src) for v in VARIANTS for src in sources]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda job: cuda_build.build(sources[job[1]][0], VARIANTS[job[0]])[0], jobs)))
    for src, (name, _) in sources.items():
        for line in cuda_build.ptxas_log(name).read_text().splitlines():
            if ("select_kernel" in line or "merge_kernel" in line or "dense" in line
                    or "registers" in line or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")

    device = torch.device("cuda", 0)
    cases = operands(torch, device, args.seed) + path_operands(torch, device, args.seed)
    for variant in VARIANTS:
        for src, (name, module) in sources.items():
            lib = ctypes.CDLL(str(built[(variant, src)]))
            for fn, (argtypes, restype) in module.signatures().items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            module._load = lambda lib=lib: lib
            module._select_occupancy.cache_clear()
            if src == "ivf":
                module._dense_occupancy.cache_clear()
        for label, src, kind, call, plain in cases:
            if variant not in CASE_VARIANTS[kind]:
                continue
            if variant == "shipped":
                kd, ki = call()
                pd, pi = plain()
                torch.cuda.synchronize()
                assert torch.equal(ki, pi), f"{label}: ids differ from the plain version"
                assert torch.allclose(kd, pd, rtol=1e-5, atol=1e-5), label
            ms = cs.time_ms(call, 10)
            dev = device_ms(call, 10) or {}
            parts = ", ".join(f"{n} {t:.4f}" for n, t in dev.items())
            line = (f"{variant:10s} {label}: {ms:.4f} ms per call (events); device "
                    f"{sum(dev.values()):.4f} ms ({parts})")
            if variant == "shipped":
                sweep = {gr: sum((device_ms(lambda gr=gr: call(gr), 10) or {}).values())
                         for gr in (1, 2, 4, 8, 16)}
                line += "; device ms by groups " + ", ".join(
                    f"G={gr} {t:.4f}" for gr, t in sweep.items())
                if kind == "dense":
                    sweep = {sp: sum((device_ms(lambda sp=sp: call(splits=sp), 10)
                                      or {}).values()) for sp in SWEEP_SPLITS}
                    line += "; by row splits " + ", ".join(
                        f"S={sp} {t:.4f}" for sp, t in sweep.items())
            print(f"{line} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
