#!/usr/bin/env python3
"""Where the flat kernel's tensor-core pass spends its time on the card.

    python3 tools/flat_mma_breakdown.py [--seed 1234] [--k 20] [--modes all|f32]
                                        [--variants shipped,no_select,...] [--yardstick]
                                        [--save DIR | --compare DIR] [--store N,D,B[,B...]]

Builds csrc/fused_l2_topk.cu as it ships and in diagnostic variants (the
FL2_* preprocessor switches of its source note), then times the four
tensor-core modes: the f32 store (3xTF32 on wgmma), the bf16 store, the
int8 codes with bf16 queries, and int8 queries on the int8 codes (s8
products), on 1,048,576 x 384 seeded Gaussian stores at B = 128 and 1024,
the f32 store also at MemoDB's 131,072 rows at B = 128 and at the
benchmark's 1,000,000 x 768 at B = 128 and 1 (CUDA-event means, k = 20;
`--modes f32` keeps the f32 cases only; each `--store` adds an f32 store
of N rows of width D at its batches, such as 10,000,000 x 96 at B = 128
for the sharded DEEP-1B cell's rank shape cut to a size the plain check
holds):
  - shipped:    the kernel as built by ops/cuda_build.py;
  - no_select:  the products, keys and the f32 mode's screen, without the
    selection (modes 1-3: the keys tile; mode 0: every tile ends at the
    screen's barrier, so no key survives);
  - no_mma:     the ring and the selection, without the products;
  - ring_only:  the ring alone (loads, splits, decode, keys tile);
  - stages4, dk128_stages2: other ring shapes of modes 1-3 (FL2_DK 128:
    128 bf16 and 256 int8 columns a chunk);
  - profile:    the shipped kernel whose f32 warps count their clock cycles
    by role and phase (FL2_PROFILE, counters in shared memory): each f32
    case prints the producer warp's split between waiting for a free stage
    and issuing its copies, the consumer warps' split between waiting for a
    full stage, loading and splitting the store, issuing wgmma groups,
    waiting for groups, folding (and handing stages back), the screen of
    the keys against the lists' thresholds with the keys tile and its
    barriers, and the selection; then the survivor share, the keys the
    screen passed over the keys it compared (rows before the split's end,
    queries before B; "not counted" from a kernel without the counts).
The variants that compute the contract (all but the FL2_NO_* cuts) are
first held against the plain version in every case (chip_smoke.check_selection;
bit-equal for int8 queries). At MemoDB's shape (f32, 131,072 rows, B = 128)
every variant also reports each kernel's device time per call from a
torch.profiler trace (pass 1 and pass 2 = merge_splits_kernel alone), and
the shipped build the host time of one fused_l2_topk call with no device
work queued (median of 200, the device idle before each). `--yardstick` also times, in the shipped build, each
case's plain version and library yardstick (addmm or matmul + topk) beside
its bound (chip_smoke.time_case). `--save DIR` writes the shipped build's
keys and positions for every case to DIR/outputs.pt; `--compare DIR` holds
them against that file, written from another tree on the same card, and
prints per case whether they are equal bit for bit. Each variant is loaded
through ops/cuda_build as the wrapper loads the shipped one, so the tool
runs on any tree whose fused_l2_topk wrapper it finds. Prints the card line
from nvidia-smi first, then one line per variant and the ptxas lines of its
build (each kernel's registers and spill bytes).
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

VARIANTS = {
    "shipped": (),
    "no_select": ("FL2_NO_SELECT=1",),
    "no_mma": ("FL2_NO_MMA=1",),
    "ring_only": ("FL2_NO_MMA=1", "FL2_NO_SELECT=1"),
    "stages4": ("FL2_STAGES=4",),
    "dk128_stages2": ("FL2_DK=128", "FL2_STAGES=2"),
    "profile": ("FL2_PROFILE=1",),
}
# FL2_PROFILE's phases: the producer's two, then the consumers' seven; then
# its counts of keys screened and keys passed.
PRODUCER_PHASES = ("free_wait", "copy_issue")
CONSUMER_PHASES = ("full_wait", "split", "wgmma_issue", "wgmma_wait", "fold", "screen", "select")
PROFILE_COUNTS = 2
MEMODB_CASE = "f32 N=131072 D=384 B=128"


def device_ms(fn, iters):
    """{kernel name: device ms per call} from a torch.profiler trace of
    `iters` calls, or None when the trace holds no device events."""
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


def host_us(fn, iters=200):
    """Median host time of one call in µs, the device idle before each."""
    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--modes", choices=("all", "f32"), default="all")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--yardstick", action="store_true")
    ap.add_argument("--save", type=Path)
    ap.add_argument("--compare", type=Path)
    ap.add_argument("--store", action="append", default=[],
                    type=lambda t: [int(v) for v in t.split(",")])
    args = ap.parse_args()
    variants = {name: VARIANTS[name] for name in args.variants.split(",")}

    import torch

    import chip_smoke as cs
    from c99_vectordb_tpu_torch.ops import cuda_build, topk_cuda

    if not torch.cuda.is_available():
        print("flat_mma_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        paths = dict(zip(variants, pool.map(
            lambda defs: cuda_build.build("fused_l2_topk", defs)[0], variants.values())))

    device = torch.device("cuda", 0)
    stores = [("float32", 131_072, 384, (128,)), ("float32", 1 << 20, 384, (128, 1024)),
              ("float32", 1_000_000, 768, (128, 1))]
    stores += [("float32", n, d, tuple(batches)) for n, d, *batches in args.store]
    if args.modes == "all":
        stores += [("bfloat16", 1 << 20, 384, (128, 1024)), ("int8", 1 << 20, 384, (128, 1024))]
    cases = []
    for dt, n, d, batches in stores:
        made = cs.make_store(n, d, dt, device, args.seed)
        g = torch.Generator(device=device).manual_seed(args.seed + 1)
        for b in batches:
            q = torch.randn((b, d), generator=g, device=device)
            if dt == "int8":
                q = q * made[2]
            q_st, _ = topk_cuda.stage_queries(q, made[0].dtype, q_int8=False)
            label = {"float32": "f32", "bfloat16": "bf16", "int8": "int8_bf16q"}[dt]
            cases.append((f"{label} N={n} D={d} B={b}", q_st, made[0], made[1], None))
            if dt == "int8":
                q8, rs = topk_cuda.stage_queries(q, made[0].dtype)
                cases.append((f"int8 N={n} D={d} B={b}", q8, made[0], made[1], rs))

    shipped_build = cuda_build.build
    for name, defines in variants.items():
        # The wrapper loads this variant's library (and asks it anew for its
        # blocks per SM).
        cuda_build._loaded.pop("fused_l2_topk", None)
        cuda_build.build = lambda src, defs=(), path=paths[name]: (
            (path, 0.0) if src == "fused_l2_topk" else shipped_build(src, defs))
        cached = getattr(topk_cuda, "_kernel_shape", None)
        if cached is not None:
            cached.cache_clear()
        parts = []
        outputs = {}
        for label, q_st, db, norms, rs in cases:
            if not any(d.startswith("FL2_NO_") for d in defines):
                cs.check_selection(q_st, db, norms, args.k, rs, exact=rs is not None,
                                   label=f"{name} {label}")
            call = lambda q_st=q_st, db=db, norms=norms, rs=rs: topk_cuda.fused_l2_topk(
                q_st, db, norms, args.k, rs)
            if name == "shipped":
                outputs[label] = tuple(t.cpu() for t in call())
            if args.yardstick and name == "shipped":
                row = cs.time_case(q_st, db, norms, args.k, rs, "")
                ms = row["ms"]
            else:
                ms = cs.time_ms(call, 20 if q_st.shape[0] <= 128 else 5)
            parts.append(f"{label} {ms:.4f} ms")
            if "FL2_PROFILE=1" in defines and label.startswith("f32"):
                phases = PRODUCER_PHASES + CONSUMER_PHASES
                cycles = (ctypes.c_uint64 * (len(phases) + PROFILE_COUNTS))()
                prof = ctypes.CDLL(str(paths[name])).fused_l2_topk_profile
                torch.cuda.synchronize()
                prof(cycles)                       # clear what earlier cases left
                cs.time_ms(call, 5)
                torch.cuda.synchronize()
                assert prof(cycles) == 0
                np_ = len(PRODUCER_PHASES)
                for role, names, got in (("producer", PRODUCER_PHASES, cycles[:np_]),
                                         ("consumers", CONSUMER_PHASES, cycles[np_:len(phases)])):
                    total = sum(got) or 1
                    parts.append(f"({role}: " + " ".join(
                        f"{ph} {100 * c / total:.1f}%" for ph, c in zip(names, got)) + ")")
                screened, passed = cycles[len(phases):]
                parts.append(f"survivors {passed} of {screened} keys ({100 * passed / screened:.4f}%)"
                             if screened else "survivors not counted")
            if label == MEMODB_CASE:
                dev = device_ms(call, 20)
                if dev is None:
                    parts.append("device split: no device events in the trace")
                else:
                    parts.append("device " + " + ".join(
                        f"{kern} {t:.4f}" for kern, t in sorted(dev.items())) + " ms")
                if name == "shipped":
                    parts.append(f"host: one call {host_us(call):.1f} us")
        print(f"{name:14s} " + ", ".join(parts), flush=True)
        if name == "shipped" and args.save:
            args.save.mkdir(parents=True, exist_ok=True)
            torch.save(outputs, args.save / "outputs.pt")
        if name == "shipped" and args.compare:
            theirs = torch.load(args.compare / "outputs.pt")
            for label, (kk, kp) in outputs.items():
                ok, op = theirs[label]
                same = torch.equal(kk, ok) and torch.equal(kp, op)
                print(f"  compare {label}: " + ("equal bit for bit" if same else
                      f"{int((kk != ok).sum())} keys and {int((kp != op).sum())} positions differ"),
                      flush=True)
        for line in cuda_build.ptxas_log("fused_l2_topk", defines).read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
