"""Fused squared-L2 score + top-k selection: the hand-written Hopper kernel.

Counterpart of the JAX package's ops/topk_pallas.py (`fused_topk`, whose
Pallas kernel `_fused_kernel` this replaces). The CUDA source is
csrc/fused_l2_topk.cu; ops/cuda_build.py compiles it with nvcc for sm_90a
on first use into `_build/` (keyed on a hash of the source) and loads it
with ctypes.

Layers:
  - `fused_l2_topk(q_staged, db, norms, k, rs)`: the kernel wrapper. It
    selects, per query, the k smallest keys norms[row] + q_staged . x_row
    (int8 queries: float(ip) * rs + norms) by (key, position), and returns
    (keys (B, k) f32, positions (B, k) int32) with (inf, INT32_MAX) in
    unfilled slots. Modes: f32, bf16 and int8 stores with queries of the
    same type, and int8 codes with bf16 queries (the codes decode to bf16,
    exactly). Every mode runs on the tensor cores: f32 in 3xTF32 on
    wgmma m64nNk8 (store rows on M, 128 a tile; the batch's queries on N,
    a multiple of 8 up to 128, split into hi and lo once a call by a
    staging kernel, `stage_f32_plain` its plain version; the store through
    a TMA ring); mma.sync m16n8k16 bf16 -> f32 for the bf16 store and for
    int8 codes with bf16 queries, m16n8k32 s8 -> s32 for int8 x int8
    (store chunks through a cp.async ring). The source note says what
    bounds each. A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version `select_plain`.
    `fused_l2_topk.launches` counts kernel launches,
    `fused_l2_topk.launches_by_mode` by mode and
    `fused_l2_topk.launches_by_qtile` the f32 launches by their query
    tile N (`launch_counts` reads all three, `add_launch_counts` adds a
    replayed CUDA graph's launches). `launch_plan` sizes the grid and the
    scratch (on the CPU too, where the tests hold it).
  - `fused_topk(db, ids, sq_norms, queries, k, q_int8=None)`: the JAX
    package's `fused_topk` contract: query staging, the selection above,
    and the epilogue (+ ||q||^2, clamp at 0, positions -> ids).
  - `fused_topk_reference`: the same contract with the plain selection on
    any device; the tests and chip_smoke.py hold the kernel against it.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from . import cuda_build
from .distances import INT32_MAX
from .topk import stable_topk

# (store dtype, query dtype) -> the kernel's mode code and name.
_MODES = {
    (torch.float32, torch.float32): (0, "float32"),
    (torch.bfloat16, torch.bfloat16): (1, "bfloat16"),
    (torch.int8, torch.int8): (2, "int8"),
    (torch.int8, torch.bfloat16): (3, "int8_bf16q"),
}


_VP, _CI = ctypes.c_void_p, ctypes.c_int
ABI_VERSION = 8
SIGNATURES = {
    "fused_l2_topk": ([_CI, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _VP, _VP, _VP, _VP,
                       _VP, _VP], _CI),
    "fused_l2_topk_shape": ([_CI, _CI, _CI, ctypes.POINTER(ctypes.c_int)], _CI),
    "fused_l2_topk_stage_f32": ([_VP, _CI, _CI, _CI, _VP, _VP], _CI),
}
# The f32 mode's query tiles are multiples of F32_Q_STEP (wgmma's N); its
# queries are staged in boxes of F32_BOX_COLS columns, whole ring stages of
# F32_STAGE_COLS (the source's FW_DK and FW_SC, which the staging kernel and
# pass 1 lay out; tests/test_torch_topk.py holds the two to the same values).
F32_Q_STEP = 8
F32_BOX_COLS = 16
F32_STAGE_COLS = 32
# The deepest shortlist the index routes ask of the kernel: the JAX
# package's routes bound theirs so (its Pallas kernel keeps k within one
# 1024-row tile), and deeper shortlists take both packages' exact routes.
SHORTLIST_MAX = 1024


def _load() -> ctypes.CDLL:
    return cuda_build.load("fused_l2_topk", "fused_l2_topk_abi_version", ABI_VERSION, SIGNATURES)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _kernel_shape(device_index: int, mode: int, d: int, k: int) -> tuple[int, ...]:
    """Pass 1's (blocks per SM, queries a block, store rows a tile, most
    splits) in mode `mode` at (D, k), from the kernel (the occupancy query
    for its shared memory, pass 2's cap), once per device and shape."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        _load().fused_l2_topk_shape(mode, d, k, out)
    return tuple(out)


def launch_plan(b: int, n: int, k: int, sms: int, per_sm: int, q_tile: int, row_tile: int,
                max_splits: int, q_step: int | None = None) -> dict:
    """How fused_l2_topk launches B queries over N rows at depth k on a card
    of `sms` multiprocessors, each holding `per_sm` pass-1 blocks of
    `q_tile` queries that take the store in tiles of `row_tile` rows:
    (query tiles x splits) fills the card in one wave with no tail, with at
    least one row tile per split and at most `max_splits` (all four from
    the kernel's fused_l2_topk_shape). With `q_step` (the f32 mode, whose
    blocks take up to `q_tile` queries) the query tile shrinks to the
    smallest multiple of q_step that holds the batch's share of a tile:
    B = 1 runs 8 queries, B = 128 one tile of 128, B = 200 two of 104.
    Returns the query tiles, the query tile, the splits and the shape of
    the partial lists (splits, B, k)."""
    q_tiles = -(-b // q_tile)
    if q_step:
        q_tile = -(-(-(-b // q_tiles)) // q_step) * q_step
    splits = max(1, min(per_sm * sms // q_tiles, -(-n // row_tile), max_splits))
    return {"q_tiles": q_tiles, "q_tile": q_tile, "splits": splits, "part": (splits, b, k)}


def f32_stage_floats(b: int, d: int, q_tile: int) -> int:
    """Floats of the f32 mode's staged queries (stage_f32_plain's output)."""
    return -(-b // q_tile) * -(-d // F32_STAGE_COLS) * F32_STAGE_COLS * 2 * q_tile


# -- the kernel wrapper and its plain versions --------------------------------


def tf32_rna(x):
    """x (f32) rounded to TF32 as the kernel rounds it: the 13 low mantissa
    bits cleared, to nearest, ties away from zero (cvt.rna's rounding)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def f32_stage_perm():
    """Column kappa (0-15) of an f32 box's B operand -> the query column (of
    the box's 16) it holds: a lane's float4 of a store row is its A
    fragment's (k t, k t + 4) of the box's first k step, then of its second
    (the source's fw_perm)."""
    kappa = torch.arange(F32_BOX_COLS)
    return 4 * (kappa & 3) + 2 * (kappa >> 3) + ((kappa >> 2) & 1)


def stage_f32_plain(q_staged, q_tile: int):
    """Plain version of the f32 mode's query staging (the source's
    stage_f32_queries_kernel): the (B, D) f32 staged queries split once
    into hi = tf32(q) and lo = tf32(q - hi), zero-padded to whole query
    tiles and ring stages of F32_STAGE_COLS columns, laid out as pass 1's
    wgmma B operands: [query tile][box][hi, lo][k unit 4][query group
    q_tile / 8][query 8][4 floats], box column 4 (k unit) + float holding
    query column 16 box + f32_stage_perm(); flat, f32."""
    b, d = q_staged.shape
    q_tiles = -(-b // q_tile)
    boxes = -(-d // F32_STAGE_COLS) * F32_STAGE_COLS // F32_BOX_COLS
    qp = torch.zeros(q_tiles * q_tile, boxes * F32_BOX_COLS, dtype=torch.float32,
                     device=q_staged.device)
    qp[:b, :d] = q_staged
    hi = tf32_rna(qp)
    lo = tf32_rna(qp - hi)
    parts = torch.stack([hi, lo]).view(2, q_tiles, q_tile, boxes, F32_BOX_COLS)
    parts = parts[..., f32_stage_perm().to(qp.device)]
    parts = parts.view(2, q_tiles, q_tile // 8, 8, boxes, 4, 4)   # part, qt, group, query, box, unit, float
    return parts.permute(1, 4, 0, 5, 2, 3, 6).contiguous().view(-1)


def select_plain(q_staged, db, norms, k: int, rs=None):
    """Plain torch version of the kernel's selection: same key arithmetic
    (f32 accumulation; int8 queries as an exact f32 product of integers),
    top-k by (key, position) with +inf keys never entering."""
    n, d = db.shape
    int8_q = q_staged.dtype == torch.int8
    # For int8 there is no int32 matmul on CUDA: the f32 product of int8
    # values is exact while every partial sum stays below 2**24.
    if int8_q and 127 * 127 * d >= (1 << 24):
        raise ValueError(f"int8 dot not exact in f32 at D={d}")
    ip = q_staged.to(torch.float32) @ db.to(torch.float32).T
    if int8_q:
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

    q_staged (B, D) and db (N, D) in the store dtype (f32, bf16 or int8),
    or bf16 queries against an int8 store; norms (N,) f32; rs (B,) f32 for
    int8 queries. Returns (keys (B, k) f32, positions (B, k) int32)."""
    if db.device.type == "cpu":
        return select_plain(q_staged, db, norms, k, rs)
    if db.device.type != "cuda":
        raise ValueError(f"fused_l2_topk: unsupported device {db.device}")
    b, d = q_staged.shape
    n = db.shape[0]
    mode = _MODES.get((db.dtype, q_staged.dtype))
    if mode is None:
        raise TypeError(f"fused_l2_topk: unsupported store/query dtypes {db.dtype}/"
                        f"{q_staged.dtype}")
    if db.ndim != 2 or db.shape[1] != d or norms.shape != (n,):
        raise ValueError("fused_l2_topk: shapes must be q (B, D), db (N, D), norms (N,)")
    if norms.dtype != torch.float32:
        raise TypeError("fused_l2_topk: norms must be float32")
    is_int8 = q_staged.dtype == torch.int8
    if is_int8:
        if rs is None or rs.shape != (b,) or rs.dtype != torch.float32:
            raise ValueError("fused_l2_topk: int8 queries need rs (B,) float32")
        if d % 4 != 0:
            raise ValueError(f"fused_l2_topk: int8 queries need D % 4 == 0 (D={d})")
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
    dev = db.device.index
    shape = _kernel_shape(dev, mode[0], d, k)
    plan = launch_plan(b, n, k, _sm_count(dev), *shape,
                       q_step=F32_Q_STEP if mode[0] == 0 else None)
    # One scratch buffer: the f32 mode's staged queries (at its start, which
    # the allocator aligns past the 16 bytes the bulk copies need) and its
    # B cuts, the partial keys, then their positions.
    staged = f32_stage_floats(b, d, plan["q_tile"]) + b if mode[0] == 0 else 0
    part = plan["splits"] * b * k
    scratch = torch.empty(staged + 2 * part, dtype=torch.int32, device=db.device)
    base = scratch.data_ptr()
    part_k = base + staged * scratch.element_size()
    out_k = torch.empty((b, k), dtype=torch.float32, device=db.device)
    out_p = torch.empty((b, k), dtype=torch.int32, device=db.device)
    with torch.cuda.device(db.device):
        stream = torch.cuda.current_stream(db.device).cuda_stream
        err = lib.fused_l2_topk(
            mode[0], q_staged.data_ptr(), db.data_ptr(), norms.data_ptr(),
            rs.data_ptr() if is_int8 else None, b, n, d, k, plan["splits"], plan["q_tile"],
            base if staged else None, part_k, part_k + part * scratch.element_size(),
            out_k.data_ptr(), out_p.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_l2_topk launch failed: CUDA error {err}")
    _count_launch(mode[1], plan["q_tile"])
    return out_k, out_p


def _count_launch(mode_name: str, q_tile: int) -> None:
    """One launch of fused_l2_topk in mode `mode_name`: f32 launches are
    also counted by their query tile."""
    fused_l2_topk.launches += 1
    fused_l2_topk.launches_by_mode[mode_name] += 1
    if mode_name == "float32":
        fused_l2_topk.launches_by_qtile[q_tile] += 1


fused_l2_topk.launches = 0
fused_l2_topk.launches_by_mode = dict.fromkeys((name for _, name in _MODES.values()), 0)
fused_l2_topk.launches_by_qtile = dict.fromkeys(range(F32_Q_STEP, 129, F32_Q_STEP), 0)


def launch_counts() -> Counter:
    """fused_l2_topk's launch counters as one Counter: the total under
    "launches", each mode under its name, each f32 query tile under its N.
    The difference of two readings goes to add_launch_counts."""
    f = fused_l2_topk
    return Counter({"launches": f.launches, **f.launches_by_mode, **f.launches_by_qtile})


def add_launch_counts(delta: Counter, sign: int = 1) -> None:
    """Add `sign` times `delta`, a difference of launch_counts readings, to
    the counters: what a CUDA graph's capture launched, counted again at
    each replay (and taken back at the capture, which runs nothing)."""
    f = fused_l2_topk
    for key, n in delta.items():
        if key == "launches":
            f.launches += sign * n
        elif isinstance(key, str):
            f.launches_by_mode[key] += sign * n
        else:
            f.launches_by_qtile[key] += sign * n


def stage_f32(q_staged, q_tile: int):
    """The f32 mode's query staging on the card (the kernel's own, as pass 1
    launches it); stage_f32_plain on CPU tensors."""
    if q_staged.device.type == "cpu":
        return stage_f32_plain(q_staged, q_tile)
    b, d = q_staged.shape
    if q_staged.dtype != torch.float32 or not q_staged.is_contiguous():
        raise ValueError("stage_f32: queries must be contiguous float32")
    out = torch.empty(f32_stage_floats(b, d, q_tile), dtype=torch.float32,
                      device=q_staged.device)
    with torch.cuda.device(q_staged.device):
        err = _load().fused_l2_topk_stage_f32(
            q_staged.data_ptr(), b, d, q_tile, out.data_ptr(),
            torch.cuda.current_stream(q_staged.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_l2_topk_stage_f32 failed: CUDA error {err}")
    return out


# -- the fused_topk contract --------------------------------------------------


def stage_queries(queries, db_dtype, q_int8: bool | None = None):
    """Stage queries for the scan: x -2 (a lossless exponent shift) in the
    store dtype, or for int8 stores quantised per row with scale rs:
    rs = max(max|q * -2|, 1e-30) / 127, q8 = clip(rint(q * -2 / rs), +-127);
    with q_int8=False an int8 store takes bf16 queries instead (None: int8).
    Returns (q_staged, rs or None)."""
    q_m2 = queries.to(torch.float32) * -2.0
    if db_dtype == torch.int8 and q_int8 is False:
        return q_m2.to(torch.bfloat16).contiguous(), None
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


def fused_topk(db, ids, sq_norms, queries, k: int, *, q_int8: bool | None = None,
               return_rows: bool = False):
    """Exact batched top-k through the kernel.

    db: (N, D) f32/bf16/int8 rows ascending by id; ids: (N,) int32 with -1
    on padding rows; sq_norms: (N,) f32 with +inf on padding (and masked)
    rows; queries: (B, D), with the SQ8 scale already folded in for int8
    stores. q_int8 (int8 stores): None or True quantises the queries to
    int8, False scores bf16 queries against the codes decoded to bf16.
    Returns ascending (distances (B, k), ids (B, k)) with (inf, -1) in
    empty slots, and with return_rows=True the (B, k) int32 store rows
    (clamped; meaningless where id == -1)."""
    n = db.shape[0]
    _check_k(k, n)
    q_staged, rs = stage_queries(queries, db.dtype, q_int8)
    keys, pos = fused_l2_topk(q_staged, db, sq_norms, k, rs)
    return _epilogue(keys, pos, queries, ids, n, return_rows)


def fused_topk_reference(db, ids, sq_norms, queries, k: int, *, q_int8: bool | None = None,
                         return_rows: bool = False):
    """fused_topk with the plain torch selection, on any device."""
    n = db.shape[0]
    _check_k(k, n)
    q_staged, rs = stage_queries(queries, db.dtype, q_int8)
    keys, pos = select_plain(q_staged, db, sq_norms, k, rs)
    return _epilogue(keys, pos, queries, ids, n, return_rows)
