"""IVF list scans: wrappers of the hand-written Hopper kernels.

The CUDA source is csrc/ivf_scan.cu (three kernels replacing the five
Pallas kernels of the JAX package's ops/ivf_scan_pallas.py);
ops/cuda_build.py compiles it with nvcc for sm_90a on first use and loads
it with ctypes. Each wrapper takes the plain version (ops/ivf_scan.py)
for CPU tensors only; on a CUDA tensor it launches its kernel or raises.
Each wrapper counts its launches in `<wrapper>.launches`.

  - `ivf_scan_select(probes, queries, q_sq, lists, sqn, ids, k, qpb=1,
    hwm=None)`: per query, the k nearest (dist, id) over its
    probed lists, lowest id first on ties, (inf, -1) in unfilled slots
    (rows 2 and 3 of the kernel table: `_ivf_scan_kernel`,
    `_ivf_scan_kernel_multi`). hwm (nlist,) int32: each list's high-water
    mark (slots at or past it are padding and are not read); None = pad.
    The probes of each query split into contiguous groups, each scanned
    by its own block, then merged exactly (one launch of the select
    kernel and one of its merge, counted as one launch); the group count
    comes from the kernel's occupancy (ops/select_common.probe_groups;
    tests force it with `_groups`);
  - `ivf_scan_dense(probes, queries, q_sq, lists, sqn, ids, hwm=None)`:
    every probed slot's distance and raw id, (B, nprobe * pad)
    (`_ivf_scan_kernel_dense`);
  - `ivf_scan_dense_int8(probes, q8, rs, codes, dec_sqn, ids, qpb=1,
    hwm=None)`: every probed slot's SQ8 key and raw id
    (`_ivf_scan_kernel_dense_int8` at qpb 1,
    `_ivf_scan_kernel_dense_int8_multi` at qpb 8: the JAX package's queries
    per grid step, kept as a keyword; the kernel's grid ignores it).
  Both dense kernels run the select kernel's tile pipeline without the
  selection on a (query, probe group, row split) grid (`dense_plan`; tests
  force it with `_groups` and `_splits`), stop each list at hwm and write
  the slots from the mark to pad as (+inf, -1) without reading them.

Operands: probes (B, nprobe) int32; queries (B, D) f32, unstaged; q_sq (B,)
f32; lists (nlist, pad, D) f32 or bf16 (codes int8, D % 4 == 0); sqn/
dec_sqn (nlist, pad) f32; ids (nlist, pad) int32 with -1 padding; q8 (B, D)
int8 with per-row scales rs (B,) f32; hwm (nlist,) int32 or None. All
contiguous, on one device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build, select_common

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DENSE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def signatures() -> dict:
    """{exported function: (argtypes, restype)} of csrc/ivf_scan.cu."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return {
        "ivf_select_occupancy": ([ci, ci, ci, vp], ci),
        "ivf_scan_select": ([ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                             vp, vp, vp, vp, vp, vp, vp], ci),
        "ivf_dense_occupancy": ([ci, ci, vp], ci),
        "ivf_scan_dense": ([ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp],
                           ci),
        "ivf_scan_dense_int8": ([vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp],
                                ci),
    }


def _load() -> ctypes.CDLL:
    return cuda_build.load("ivf_scan", "ivf_scan_abi_version", 3, signatures())


def _check(name, probes, rows, lists, list_aux, want_lists):
    """Shared operand checks: devices, dtypes, shapes, contiguity."""
    dev = lists.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if lists.dtype not in want_lists:
        raise TypeError(f"{name}: unsupported list dtype {lists.dtype}")
    if lists.ndim != 3:
        raise ValueError(f"{name}: lists must be (nlist, pad, D)")
    nlist, pad, d = lists.shape
    b, nprobe = probes.shape
    if probes.dtype != torch.int32:
        raise TypeError(f"{name}: probes must be int32")
    for t, shape, dtype in rows:
        if t.shape != shape(b, d) or t.dtype != dtype:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape(b, d)} {dtype}")
    sqn, ids = list_aux
    if sqn.shape != (nlist, pad) or sqn.dtype != torch.float32:
        raise ValueError(f"{name}: norms must be (nlist, pad) float32")
    if ids.shape != (nlist, pad) or ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be (nlist, pad) int32")
    for t in [probes, lists, sqn, ids] + [r[0] for r in rows]:
        if t.device != dev:
            raise ValueError(f"{name}: all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return b, nprobe, nlist, pad, d


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


@functools.cache
def _select_occupancy(dtype_code: int, d: int, k: int,
                      device_index: int) -> tuple[int, bool, int]:
    lib = _load()
    out = (ctypes.c_int * 3)()
    with torch.cuda.device(device_index):
        err = lib.ivf_select_occupancy(dtype_code, d, k, out)
    if err != 0:
        raise RuntimeError(f"ivf_select_occupancy failed: CUDA error {err}")
    return max(1, out[0]), bool(out[1]), out[2]


def select_plan(b: int, nprobe: int, d: int, k: int, dtype, device, qpb: int = 1,
                _groups: int | None = None) -> dict:
    """How `ivf_scan_select` launches on `device` for these shapes: probe
    groups, blocks, blocks per SM (occupancy query), SMs, where the running
    lists live (ops/select_common.select_plan)."""
    return select_common.select_plan(
        lambda index: _select_occupancy(_DTYPE_CODE[dtype], d, k, index), b, nprobe, k, qpb,
        device, _groups)


def ivf_scan_select(probes, queries, q_sq, lists, sqn, ids, k: int, qpb: int = 1, hwm=None,
                    _groups: int | None = None):
    """The k nearest (dist (B, k) f32, ids (B, k) int32) per query over its
    probed lists (see the module doc)."""
    if lists.device.type == "cpu":
        from .ivf_scan import scan_select_plain

        return scan_select_plain(probes, queries, q_sq, lists, sqn, ids, k, hwm=hwm)
    b, nprobe, nlist, pad, d = _check(
        "ivf_scan_select", probes,
        [(queries, lambda b, d: (b, d), torch.float32), (q_sq, lambda b, d: (b,), torch.float32)],
        lists, (sqn, ids), _DTYPE_CODE)
    select_common.check_hwm("ivf_scan_select", hwm, nlist, lists.device)
    if k < 1 or qpb < 1:
        raise ValueError(f"ivf_scan_select: need k >= 1 and qpb >= 1 (k={k}, qpb={qpb})")
    dev = lists.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = _load()
    plan = select_plan(b, nprobe, d, k, lists.dtype, dev, qpb, _groups)
    g = plan["groups"]
    scratch, _keep = select_common.select_scratch(b, g, k, plan["lists_in_smem"], dev)
    with torch.cuda.device(dev):
        err = lib.ivf_scan_select(
            _DTYPE_CODE[lists.dtype], probes.data_ptr(), queries.data_ptr(), q_sq.data_ptr(),
            lists.data_ptr(), sqn.data_ptr(), ids.data_ptr(),
            None if hwm is None else hwm.data_ptr(), b, nprobe, pad, d, k, qpb, g, *scratch,
            out_d.data_ptr(), out_i.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"ivf_scan_select launch failed: CUDA error {err}")
    ivf_scan_select.launches += 1
    return out_d, out_i


ivf_scan_select.launches = 0


@functools.cache
def _dense_occupancy(dtype_code: int, d: int, device_index: int) -> int:
    lib = _load()
    out = (ctypes.c_int * 1)()
    with torch.cuda.device(device_index):
        err = lib.ivf_dense_occupancy(dtype_code, d, out)
    if err != 0:
        raise RuntimeError(f"ivf_dense_occupancy failed: CUDA error {err}")
    return max(1, out[0])


def dense_plan(b: int, nprobe: int, pad: int, d: int, dtype, device,
               _groups: int | None = None, _splits: int | None = None) -> dict:
    """How `ivf_scan_dense` (f32, bf16 lists) or `ivf_scan_dense_int8` (int8)
    launches on `device` for these shapes: probe groups (no merge, so up to
    nprobe), row splits (ops/select_common.row_splits), blocks, blocks per
    SM (occupancy query), SMs."""
    index = torch.device(device).index or 0
    per_sm = _dense_occupancy(_DENSE_CODE[dtype], d, index)
    sms = select_common.sm_count(index)
    g = select_common.probe_groups(b, nprobe, 1, per_sm, sms, nprobe, _groups)
    s = select_common.row_splits(b * g, per_sm, sms, -(-pad // select_common.DENSE_TILE_ROWS),
                                 _splits)
    return {"groups": g, "splits": s, "blocks": b * g * s, "blocks_per_sm": per_sm, "sms": sms}


def _dense_launch(name, dtype, operands, b, nprobe, pad, d, hwm, dev, groups, splits):
    """Allocate the (B, nprobe * pad) outputs and launch the dense kernel of
    csrc export `name` on its plan's grid for lists of `dtype`."""
    out_d = torch.empty((b, nprobe * pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, nprobe * pad), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = _load()
    plan = dense_plan(b, nprobe, pad, d, dtype, dev, groups, splits)
    with torch.cuda.device(dev):
        err = getattr(lib, name)(*operands, None if hwm is None else hwm.data_ptr(), b, nprobe,
                               pad, d, plan["groups"], plan["splits"], out_d.data_ptr(),
                               out_i.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out_d, out_i


def ivf_scan_dense(probes, queries, q_sq, lists, sqn, ids, hwm=None,
                   _groups: int | None = None, _splits: int | None = None):
    """Every probed slot's (dist, raw id), each (B, nprobe * pad); (+inf,
    -1) from each list's hwm to pad."""
    if lists.device.type == "cpu":
        from .ivf_scan import scan_dense_plain

        return scan_dense_plain(probes, queries, q_sq, lists, sqn, ids, hwm=hwm)
    b, nprobe, nlist, pad, d = _check(
        "ivf_scan_dense", probes,
        [(queries, lambda b, d: (b, d), torch.float32), (q_sq, lambda b, d: (b,), torch.float32)],
        lists, (sqn, ids), _DTYPE_CODE)
    select_common.check_hwm("ivf_scan_dense", hwm, nlist, lists.device)
    out = _dense_launch(
        "ivf_scan_dense", lists.dtype,
        (_DTYPE_CODE[lists.dtype], probes.data_ptr(), queries.data_ptr(), q_sq.data_ptr(),
         lists.data_ptr(), sqn.data_ptr(), ids.data_ptr()),
        b, nprobe, pad, d, hwm, lists.device, _groups, _splits)
    if b:
        ivf_scan_dense.launches += 1
    return out


ivf_scan_dense.launches = 0


def ivf_scan_dense_int8(probes, q8, rs, codes, dec_sqn, ids, qpb: int = 1, hwm=None,
                        _groups: int | None = None, _splits: int | None = None):
    """Every probed slot's SQ8 key float(q8 . code) * rs + dec_sqn and raw
    id, each (B, nprobe * pad); (+inf, -1) from each list's hwm to pad.
    qpb is the JAX package's queries per grid step: checked, and ignored
    by the grid."""
    if codes.device.type == "cpu":
        from .ivf_scan import scan_dense_int8_plain

        return scan_dense_int8_plain(probes, q8, rs, codes, dec_sqn, ids, hwm=hwm)
    b, nprobe, nlist, pad, d = _check(
        "ivf_scan_dense_int8", probes,
        [(q8, lambda b, d: (b, d), torch.int8), (rs, lambda b, d: (b,), torch.float32)],
        codes, (dec_sqn, ids), (torch.int8,))
    select_common.check_hwm("ivf_scan_dense_int8", hwm, nlist, codes.device)
    if d % 4 != 0 or q8.data_ptr() % 4 or codes.data_ptr() % 4:
        raise ValueError(f"ivf_scan_dense_int8: needs D % 4 == 0 and 4-byte aligned rows (D={d})")
    if qpb < 1:
        raise ValueError(f"ivf_scan_dense_int8: qpb must be >= 1 (got {qpb})")
    out = _dense_launch(
        "ivf_scan_dense_int8", torch.int8,
        (probes.data_ptr(), q8.data_ptr(), rs.data_ptr(), codes.data_ptr(), dec_sqn.data_ptr(),
         ids.data_ptr()),
        b, nprobe, pad, d, hwm, codes.device, _groups, _splits)
    if b:
        ivf_scan_dense_int8.launches += 1
    return out


ivf_scan_dense_int8.launches = 0
