"""Fused squared-L2 score + top-k selection: the hand-written Hopper kernel.

Counterpart of the JAX package's ops/topk_pallas.py (`fused_topk`, whose
Pallas kernel `_fused_kernel` this replaces). The CUDA source is
csrc/fused_l2_topk.cu; ops/cuda_build.py compiles it with nvcc for sm_90a
on first use into `_build/` (keyed on a hash of the source) and loads it
with ctypes.

Layers:
  - `fused_l2_topk(q_staged, db, norms, k, rs)`: the kernel wrapper. It
    selects, per query, the k smallest keys norms[row] + q_staged . x_row
    (int8: float(ip) * rs + norms) by (key, position), and returns
    (keys (B, k) f32, positions (B, k) int32) with (inf, INT32_MAX) in
    unfilled slots. A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version `select_plain`. `fused_l2_topk.launches`
    counts kernel launches.
  - `fused_topk(db, ids, sq_norms, queries, k)`: the JAX package's
    `fused_topk` contract: query staging, the selection above, and the
    epilogue (+ ||q||^2, clamp at 0, positions -> ids).
  - `fused_topk_reference`: the same contract with the plain selection on
    any device; the tests and chip_smoke.py hold the kernel against it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .distances import INT32_MAX
from .topk import stable_topk

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _load() -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("fused_l2_topk", "fused_l2_topk_abi_version", 2, {
        "fused_l2_topk": ([ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp], ci),
        "fused_l2_topk_splits": ([ci, ci, ci], ci),
    })


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# -- the kernel wrapper and its plain version ---------------------------------


def select_plain(q_staged, db, norms, k: int, rs=None):
    """Plain torch version of the kernel's selection: same key arithmetic
    (f32 accumulation; int8 as an exact f32 product of integers), top-k by
    (key, position) with +inf keys never entering."""
    n, d = db.shape
    # For int8 there is no int32 matmul on CUDA: the f32 product of int8
    # values is exact while every partial sum stays below 2**24.
    if db.dtype == torch.int8 and 127 * 127 * d >= (1 << 24):
        raise ValueError(f"int8 dot not exact in f32 at D={d}")
    ip = q_staged.to(torch.float32) @ db.to(torch.float32).T
    if db.dtype == torch.int8:
        keys = ip * rs[:, None] + norms[None, :]
    else:
        keys = norms[None, :] + ip
    kk = min(k, n)
    vals, pos = stable_topk(keys, kk)
    pos = torch.where(vals < torch.inf, pos, INT32_MAX).to(torch.int32)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=torch.inf)
        pos = torch.nn.functional.pad(pos, (0, k - kk), value=INT32_MAX)
    return vals, pos


def fused_l2_topk(q_staged, db, norms, k: int, rs=None):
    """Top-k selection on key = norms + q_staged . x (see the module doc).

    q_staged (B, D) and db (N, D) in the store dtype (f32, bf16 or int8);
    norms (N,) f32; rs (B,) f32 for int8 stores. Returns (keys (B, k) f32,
    positions (B, k) int32)."""
    if db.device.type == "cpu":
        return select_plain(q_staged, db, norms, k, rs)
    if db.device.type != "cuda":
        raise ValueError(f"fused_l2_topk: unsupported device {db.device}")
    b, d = q_staged.shape
    n = db.shape[0]
    if db.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_l2_topk: unsupported store dtype {db.dtype}")
    if q_staged.dtype != db.dtype:
        raise TypeError(f"queries {q_staged.dtype} must match the store {db.dtype}")
    if db.ndim != 2 or db.shape[1] != d or norms.shape != (n,):
        raise ValueError("fused_l2_topk: shapes must be q (B, D), db (N, D), norms (N,)")
    if norms.dtype != torch.float32:
        raise TypeError("fused_l2_topk: norms must be float32")
    is_int8 = db.dtype == torch.int8
    if is_int8:
        if rs is None or rs.shape != (b,) or rs.dtype != torch.float32:
            raise ValueError("fused_l2_topk: int8 stores need rs (B,) float32")
        if d % 4 != 0:
            raise ValueError(f"fused_l2_topk: int8 stores need D % 4 == 0 (D={d})")
    tensors = [q_staged, db, norms] + ([rs] if is_int8 else [])
    for t in tensors:
        if t.device != db.device:
            raise ValueError("fused_l2_topk: all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("fused_l2_topk: operands must be contiguous")
    if b == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=db.device),
                torch.empty((0, k), dtype=torch.int32, device=db.device))
    if k < 1 or n < 1:
        raise ValueError(f"fused_l2_topk: need k >= 1 and a non-empty store (k={k}, N={n})")
    lib = _load()
    splits = lib.fused_l2_topk_splits(b, n, _sm_count(db.device.index))
    part_k = torch.empty((splits, b, k), dtype=torch.float32, device=db.device)
    part_p = torch.empty((splits, b, k), dtype=torch.int32, device=db.device)
    out_k = torch.empty((b, k), dtype=torch.float32, device=db.device)
    out_p = torch.empty((b, k), dtype=torch.int32, device=db.device)
    with torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        err = lib.fused_l2_topk(
            _DTYPE_CODE[db.dtype], q_staged.data_ptr(), db.data_ptr(), norms.data_ptr(),
            rs.data_ptr() if is_int8 else None, b, n, d, k, splits,
            part_k.data_ptr(), part_p.data_ptr(), out_k.data_ptr(), out_p.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_l2_topk launch failed: CUDA error {err}")
    fused_l2_topk.launches += 1
    return out_k, out_p


fused_l2_topk.launches = 0


# -- the fused_topk contract --------------------------------------------------


def stage_queries(queries, db_dtype):
    """Stage queries for the scan: x -2 (a lossless exponent shift) in the
    store dtype, or for int8 stores quantised per row with scale rs:
    rs = max(max|q * -2|, 1e-30) / 127, q8 = clip(rint(q * -2 / rs), +-127).
    Returns (q_staged, rs or None)."""
    q_m2 = queries.to(torch.float32) * -2.0
    if db_dtype == torch.int8:
        rs = torch.clamp_min(q_m2.abs().amax(dim=1), 1e-30) / 127.0
        q8 = torch.clamp(torch.round(q_m2 / rs[:, None]), -127, 127).to(torch.int8)
        return q8.contiguous(), rs.contiguous()
    return q_m2.to(db_dtype).contiguous(), None


def _epilogue(keys, pos, queries, ids, n: int, return_rows: bool):
    # The kernel selects on ||x||^2 - 2 q.x; restore true squared L2 here
    # (order-preserving, so once on (B, k) instead of per tile).
    qf = queries.to(torch.float32)
    q_sq = (qf * qf).sum(dim=1, keepdim=True)
    out_d = torch.clamp_min(keys + q_sq, 0.0)
    rows = torch.clamp(pos, 0, n - 1)
    out_i = torch.where(torch.isinf(out_d), -1, ids.to(torch.int32)[rows.to(torch.int64)])
    if return_rows:
        return out_d, out_i, rows
    return out_d, out_i


def _check_k(k: int, n: int) -> None:
    if k < 1:
        raise ValueError(f"k must be >= 1 (got {k})")
    if n < 1:
        raise ValueError("the store is empty")


def fused_topk(db, ids, sq_norms, queries, k: int, *, return_rows: bool = False):
    """Exact batched top-k through the kernel.

    db: (N, D) f32/bf16/int8 rows ascending by id; ids: (N,) int32 with -1
    on padding rows; sq_norms: (N,) f32 with +inf on padding (and masked)
    rows; queries: (B, D), with the SQ8 scale already folded in for int8
    stores. Returns ascending (distances (B, k), ids (B, k)) with (inf, -1)
    in empty slots, and with return_rows=True the (B, k) int32 store rows
    (clamped; meaningless where id == -1)."""
    n = db.shape[0]
    _check_k(k, n)
    q_staged, rs = stage_queries(queries, db.dtype)
    keys, pos = fused_l2_topk(q_staged, db, sq_norms, k, rs)
    return _epilogue(keys, pos, queries, ids, n, return_rows)


def fused_topk_reference(db, ids, sq_norms, queries, k: int, *, return_rows: bool = False):
    """fused_topk with the plain torch selection, on any device."""
    n = db.shape[0]
    _check_k(k, n)
    q_staged, rs = stage_queries(queries, db.dtype)
    keys, pos = select_plain(q_staged, db, sq_norms, k, rs)
    return _epilogue(keys, pos, queries, ids, n, return_rows)
