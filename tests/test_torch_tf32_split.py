"""Why the flat kernel's f32 mode multiplies in 3xTF32 and not in one TF32
pass (csrc/fused_l2_topk.cu, scan_topk_f32_wgmma_kernel), and how its
wgmma pass composes the three products with a fold every k step.

The tensor cores read an f32 operand as TF32: 10 stored mantissa bits. The
kernel splits each element x into hi = tf32(x) and lo = tf32(x - hi) (both
rounded to nearest, ties away from zero: cvt.rna) and adds lo.hi + hi.lo +
hi.hi. Here that rounding is emulated in torch on the CPU, over every key
norms[row] + q_staged . x[row] of seeded operands at D = 384, with the
products and sums in float64, so that what is measured is the operands'
representation alone. Against the exact key, one TF32 pass must break the
kernel's tolerance |diff| <= REL_TOL * max(|key|, 1), and the three-pass sum
must stay below 1% of it: a later "one pass is enough" fails here. Then the
wgmma pass's own arithmetic is emulated (wgmma_keys) and held against
select_plain."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.ops import topk_cuda

REL_TOL = 1e-4   # chip_smoke.REL_TOL: the flat kernel's f32 keys against the plain version


# x (f32) rounded to TF32 as the kernel rounds it (cvt.rna: the 13 low
# mantissa bits cleared, to nearest, ties away from zero, for either sign).
tf32_rna = topk_cuda.tf32_rna


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


# -- the wgmma pass's arithmetic, emulated --------------------------------------

F32_TERMS_ULP = 2.0 ** -20   # test_torch_cuda.F32_TERMS_ULP: f32 rounding of the key's terms


def round_toward_zero(s: np.ndarray) -> np.ndarray:
    r = s.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(s)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def wgmma_keys(q_st, x, norms, nq, fold=1):
    """The f32 mode's keys (B, rows) as pass 1 forms them, emulated: the
    queries' hi and lo parts read from stage_f32_plain's blob (one query
    tile of nq), each store element split once into hi and lo; for each k
    step of 8 logical columns of a 16-column box (the store columns
    f32_stage_perm() names), three products x_hi . q_lo, x_lo . q_hi,
    x_hi . q_hi, each a sum of 8 exact TF32 products added to the fresh
    accumulator and rounded toward zero (a pessimistic model of the tensor
    cores' accumulation; the first product of a fold replaces it); every
    `fold` k steps (the kernel: every one) one round-to-nearest f32 add into
    the key's sum; the key norm + sum, rounded to nearest."""
    b, d = q_st.shape
    boxes = -(-d // topk_cuda.F32_STAGE_COLS) * topk_cuda.F32_STAGE_COLS // 16
    blob = topk_cuda.stage_f32_plain(q_st, nq).view(-1, boxes, 2, 4, nq // 8, 8, 4)
    # -> (part, query, box, logical column)
    parts = blob.permute(2, 0, 4, 5, 1, 3, 6).reshape(2, -1, boxes, 16)[:, :b].double().numpy()
    xp = torch.zeros(x.shape[0], boxes * 16)
    xp[:, :d] = x
    xh = topk_cuda.tf32_rna(xp)
    xl = topk_cuda.tf32_rna(xp - xh)
    xh, xl = xh.double().numpy(), xl.double().numpy()
    perm = topk_cuda.f32_stage_perm().numpy()
    key_sum = fresh = None
    steps = 2 * boxes
    for ks in range(steps):
        c, e = divmod(ks, 2)
        logical = slice(8 * e, 8 * e + 8)
        cols = 16 * c + perm[logical]
        q_hi, q_lo = parts[0][:, c, logical], parts[1][:, c, logical]
        for i, (xa, qb) in enumerate(((xh, q_lo), (xl, q_hi), (xh, q_hi))):
            s = qb @ xa[:, cols].T
            if i > 0 or ks % fold:
                s = s + fresh
            fresh = round_toward_zero(s)
        if ks % fold == fold - 1 or ks == steps - 1:
            key_sum = fresh if key_sum is None else key_sum + fresh   # f32 + f32: round to nearest
    return norms.numpy()[None, :] + key_sum


@pytest.mark.parametrize("case", ["gaussian", "mixed_magnitudes"])
@pytest.mark.parametrize("d", [100, 384, 768])
@pytest.mark.parametrize("nq", [8, 16, 64, 128])
def test_wgmma_fold_keeps_keys_within_rel_tol(nq, d, case):
    """wgmma_keys (a fold every k step) against select_plain's keys of the
    same operands (one query tile of nq queries, one 128-row tile):
    |diff| <= REL_TOL * max(|key|, 1); mixed_magnitudes (elements of 1e-3
    to 1e3 in every row and query, test_torch_cuda's operands) with the
    allowance that the card tests give it, F32_TERMS_ULP * (norm + sum
    |q_i x_i|), since select_plain's own f32 keys stray that far there."""
    rng = np.random.default_rng(nq * 10_000 + d + len(case))
    x = rng.standard_normal((128, d))
    q = rng.standard_normal((nq, d))
    if case == "mixed_magnitudes":
        x *= 10.0 ** rng.uniform(-3, 3, x.shape)
        q *= 10.0 ** rng.uniform(-3, 3, q.shape)
    x, q = torch.from_numpy(x.astype(np.float32)), torch.from_numpy(q.astype(np.float32))
    q_st, _ = topk_cuda.stage_queries(q, torch.float32)
    norms = (x * x).sum(1)
    got = wgmma_keys(q_st, x, norms, nq)
    want = (norms[None, :] + q_st @ x.T).double().numpy()
    limit = REL_TOL * np.maximum(np.abs(want), 1.0)
    if case == "mixed_magnitudes":
        limit += F32_TERMS_ULP * (norms.double().numpy()[None, :]
                                  + np.abs(q_st.double().numpy()) @ np.abs(x.double().numpy()).T)
    assert np.all(np.abs(got - want) <= limit), float((np.abs(got - want) / limit).max())
    # The selection's input: select_plain's top 20 of these keys hold the
    # kernel's keys of the same rows within the same limit.
    _, pos = topk_cuda.select_plain(q_st, x, norms, 20)
    pick = np.take_along_axis(got, pos.long().numpy(), 1)
    assert np.all(np.abs(pick - np.take_along_axis(want, pos.long().numpy(), 1))
                  <= np.take_along_axis(limit, pos.long().numpy(), 1))
