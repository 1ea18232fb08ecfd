"""Why the flat kernel's f32 mode multiplies in 3xTF32 and not in one TF32
pass (csrc/fused_l2_topk.cu, scan_topk_mma_kernel<0>).

The tensor cores read an f32 operand as TF32: 10 stored mantissa bits. The
kernel splits each element x into hi = tf32(x) and lo = tf32(x - hi) (both
rounded to nearest, ties away from zero: cvt.rna) and adds lo.hi + hi.lo +
hi.hi. Here that rounding is emulated in torch on the CPU, over every key
norms[row] + q_staged . x[row] of seeded operands at D = 384, with the
products and sums in float64, so that what is measured is the operands'
representation alone. Against the exact key, one TF32 pass must break the
kernel's tolerance |diff| <= REL_TOL * max(|key|, 1), and the three-pass sum
must stay below 1% of it: a later "one pass is enough" fails here."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.ops import topk_cuda

REL_TOL = 1e-4   # chip_smoke.REL_TOL: the flat kernel's f32 keys against the plain version


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32: the 13 low mantissa bits cleared, to
    nearest, ties away from zero (on the magnitude bits, so for either
    sign), as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rna_rounding():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's spacing at 1.0
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, -(one + ulp / 2), one + 3 * ulp / 4,
                      3.0e-3, -7.5e2], dtype=torch.float32)
    got = tf32_rna(x)
    assert got[:5].tolist() == [one, one + ulp, one, -(one + ulp), one + ulp]
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((got - x).abs() <= x.abs() * 2.0 ** -11).all())


def _operands(kind, rng):
    d = 384
    if kind == "unit":
        x = rng.standard_normal((16_384, d))
        q = rng.standard_normal((256, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    else:
        x = rng.standard_normal((16_384, d))
        q = rng.standard_normal((128, d))
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(q.astype(np.float32))


@pytest.mark.parametrize("kind", ["unit", "gaussian"])
def test_one_tf32_pass_breaks_rel_tol_and_three_keep_it(kind):
    x, q = _operands(kind, np.random.default_rng(384 if kind == "unit" else 385))
    q_st, _ = topk_cuda.stage_queries(q, torch.float32)     # -2 q, f32: what the kernel reads
    norms = (x.double() ** 2).sum(1).float()
    exact = norms.double()[None, :] + q_st.double() @ x.double().T

    q_hi, x_hi = tf32_rna(q_st), tf32_rna(x)
    q_lo, x_lo = tf32_rna(q_st - q_hi), tf32_rna(x - x_hi)
    hi_hi = q_hi.double() @ x_hi.double().T
    one_pass = norms.double()[None, :] + hi_hi
    three_pass = norms.double()[None, :] + (
        q_lo.double() @ x_hi.double().T + q_hi.double() @ x_lo.double().T + hi_hi)

    limit = REL_TOL * exact.abs().clamp_min(1.0)
    one_share = float(((one_pass - exact).abs() / limit).max())
    three_share = float(((three_pass - exact).abs() / limit).max())
    assert one_share > 1.0, f"one TF32 pass stays within REL_TOL ({one_share:.3f} of it)"
    assert three_share < 0.01, f"3xTF32 reaches {three_share:.4f} of REL_TOL"
