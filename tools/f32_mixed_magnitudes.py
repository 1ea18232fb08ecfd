#!/usr/bin/env python3
"""How far the f32 keys of the mixed-magnitude operands lie from float64.

    python3 tools/f32_mixed_magnitudes.py [--save DIR | --compare DIR]

The operands are tests/test_torch_cuda.py's
_tf32_hazard_operands("mixed_magnitudes", 8,229 rows, B, seed) at the
batches and seeds of its mixed-magnitude tests (B = 129 with seed 16; B =
128, 200 and 1024 with seed 16 + B): elements of 1e-3 to 1e3 in every row
and query, whose nearest keys come from large products that cancel. For
each B it prints, at k = 20, the worst relative miss |key - exact| /
max(|exact|, 1) (exact: the float64 key of the same row) of select_plain on
the CPU and, on a card, of select_plain there and of fused_l2_topk's f32
mode; then the kernel's worst miss against select_plain on the card, slot
by slot, which the card tests hold to REL_TOL = 1e-4; each with the count
of keys past REL_TOL. `--save DIR` writes the kernel's keys and positions
to DIR/mixed.pt; `--compare DIR` holds them against that file, written from
another tree on the same card, and prints per B whether they are equal bit
for bit. Without a card only the CPU rows print.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

CASES = [(129, 16), (128, 16 + 128), (200, 16 + 200), (1024, 16 + 1024)]   # (B, seed)
N, K = 8192 + 37, 20


def miss(keys, ref, rel_tol):
    """(worst |keys - ref| / max(|ref|, 1), count of keys past rel_tol)."""
    rel = (keys.double() - ref.double()).abs() / ref.double().abs().clamp_min(1.0)
    return float(rel.max()), int((rel > rel_tol).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", type=Path)
    ap.add_argument("--compare", type=Path)
    args = ap.parse_args()

    import torch
    from test_torch_cuda import REL_TOL, _tf32_hazard_operands

    import chip_smoke as cs
    from c99_vectordb_tpu_torch.ops import topk_cuda

    card = torch.cuda.is_available()
    if card:
        print(cs.card_line(), flush=True)
    outputs = {}
    theirs = torch.load(args.compare / "mixed.pt") if args.compare else None
    for b, seed in CASES:
        x, q = _tf32_hazard_operands("mixed_magnitudes", N, b, seed=seed)
        db = torch.from_numpy(x)
        norms = (db * db).sum(1)
        q_st, _ = topk_cuda.stage_queries(torch.from_numpy(q), db.dtype)
        exact = norms.double()[None, :] + q_st.double() @ db.double().T
        pk, pp = topk_cuda.select_plain(q_st, db, norms, K)
        w, c = miss(pk, torch.gather(exact, 1, pp.long()), REL_TOL)
        parts = [f"select_plain (cpu) vs float64 {w:.3e} ({c} past)"]
        if card:
            dev = torch.device("cuda", 0)
            dq, dd, dn = q_st.to(dev), db.to(dev), norms.to(dev)
            gk, gp = (t.cpu() for t in topk_cuda.select_plain(dq, dd, dn, K))
            kk, kp = (t.cpu() for t in topk_cuda.fused_l2_topk(dq, dd, dn, K))
            w, c = miss(gk, torch.gather(exact, 1, gp.long()), REL_TOL)
            parts.append(f"select_plain (card) vs float64 {w:.3e} ({c} past)")
            w, c = miss(kk, torch.gather(exact, 1, kp.long()), REL_TOL)
            parts.append(f"kernel vs float64 {w:.3e} ({c} past)")
            w, c = miss(kk, gk, REL_TOL)
            parts.append(f"kernel vs select_plain (card) {w:.3e} ({c} past)")
            outputs[b] = (kk, kp)
            if theirs is not None:
                ok, op = theirs[b]
                same = torch.equal(kk, ok) and torch.equal(kp, op)
                parts.append("compare: " + ("equal bit for bit" if same else
                             f"{int((kk != ok).sum())} keys and {int((kp != op).sum())} "
                             "positions differ"))
        print(f"mixed_magnitudes B={b} seed={seed}: " + ", ".join(parts), flush=True)
    if args.save and outputs:
        args.save.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, args.save / "mixed.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
