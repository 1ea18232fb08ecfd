#!/usr/bin/env python3
"""Where the flat kernel's tensor-core pass spends its time on the card.

    python3 tools/flat_mma_breakdown.py [--seed 1234] [--k 20]

Builds csrc/fused_l2_topk.cu as it ships and in diagnostic variants (the
FL2_* preprocessor switches of its source note), then times the four
tensor-core modes: the f32 store (3xTF32), the bf16 store, the int8 codes
with bf16 queries, and int8 queries on the int8 codes (s8 products), on
1,048,576 x 384 seeded Gaussian stores at
B = 128 and 1024, and the f32 store at MemoDB's 131,072 rows at B = 128
(CUDA-event means, k = 20):
  - shipped:    the kernel as built by ops/cuda_build.py;
  - no_select:  the products and keys, without the warp selection;
  - no_mma:     the ring and the selection, without the products;
  - ring_only:  the cp.async ring alone (loads, decode, keys tile);
  - stages4, dk128_stages2: other ring shapes (FL2_DK 128: 128 bf16 and
    256 int8 columns a chunk; f32 keeps its 32-column chunks).
The variants that compute the contract (all but the FL2_NO_* cuts) are
first held against the plain version at B = 128 (chip_smoke.check_selection;
bit-equal for int8 queries).
Prints the card line from nvidia-smi first, then one line per variant and
the ptxas lines of its build (each kernel's registers and spill bytes).
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
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
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from c99_vectordb_tpu_torch.ops import cuda_build, topk_cuda

    if not torch.cuda.is_available():
        print("flat_mma_breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(
            lambda defs: cuda_build.build("fused_l2_topk", defs)[0], VARIANTS.values())))

    device = torch.device("cuda", 0)
    cases = []
    for dt, n, batches in (("float32", 131_072, (128,)), ("float32", 1 << 20, (128, 1024)),
                           ("bfloat16", 1 << 20, (128, 1024)), ("int8", 1 << 20, (128, 1024))):
        made = cs.make_store(n, 384, dt, device, args.seed)
        g = torch.Generator(device=device).manual_seed(args.seed + 1)
        for b in batches:
            q = torch.randn((b, 384), generator=g, device=device)
            if dt == "int8":
                q = q * made[2]
            q_st, _ = topk_cuda.stage_queries(q, made[0].dtype, q_int8=False)
            label = {"float32": "f32", "bfloat16": "bf16", "int8": "int8_bf16q"}[dt]
            cases.append((f"{label} N={n} B={b}", q_st, made[0], made[1], None))
            if dt == "int8":
                q8, rs = topk_cuda.stage_queries(q, made[0].dtype)
                cases.append((f"int8 N={n} B={b}", q8, made[0], made[1], rs))

    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, defines in VARIANTS.items():
        lib = ctypes.CDLL(str(paths[name]))
        lib.fused_l2_topk.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp]
        lib.fused_l2_topk.restype = ci
        lib.fused_l2_topk_splits.argtypes = [ci, ci, ci, ci, ci, ci]
        lib.fused_l2_topk_splits.restype = ci
        topk_cuda._load = lambda lib=lib: lib
        parts = []
        for label, q_st, db, norms, rs in cases:
            if not any(d.startswith("FL2_NO_") for d in defines) and q_st.shape[0] == 128:
                cs.check_selection(q_st, db, norms, args.k, rs, exact=rs is not None,
                                   label=f"{name} {label}")
            ms = cs.time_ms(lambda: topk_cuda.fused_l2_topk(q_st, db, norms, args.k, rs),
                            20 if q_st.shape[0] <= 128 else 5)
            parts.append(f"{label} {ms:.4f} ms")
        print(f"{name:14s} " + ", ".join(parts), flush=True)
        for line in cuda_build.ptxas_log("fused_l2_topk", defines).read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
